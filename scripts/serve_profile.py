#!/usr/bin/env python3
"""Where a serving step's time goes on one NVIDIA GPU: the host's clock,
the device's busy time and the kernel launches of one decode step and one
prefill chunk of the paged engine.

    PYTHONPATH=src python3 scripts/serve_profile.py

granite-3-2b whole (chip_smoke.py's serve_at_scale model: 40 layers, f32
weights drawn on the card from seed 0) in a ServeEngine(max_batch=16,
max_len=2048, page=16) at 4-bit pages and at exact (bf16) pages: 16
requests of 32 tokens admitted, two warm-up ticks, then STEPS decode ticks
timed by the host clock ending in a synchronize and three more under
torch.profiler; likewise STEPS prefill chunks of one slot.  One JSON line
per (pages, step kind): host ms per call, device busy ms per call (the sum
of the kernels' device times in the profiled calls), the device's idle
share (1 - busy / host), kernel launches per call and per layer, and the
five kernels with the most device time.  The decode view covers every
page of every lane (the reference's static shapes), so the prompt length
does not change a decode step's work.
"""
import json
import subprocess
import sys
import time

import torch

STEPS = 10
PROFILED = 3


def _profile(fn, calls):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us, launches, by_kernel = 0.0, 0, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += evt.count
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += dev_us
            by_kernel[evt.key[:60]] = dev_us / 1e3 / calls
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5])
    return busy_us / 1e3 / calls, launches / calls, top


def main():
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeConfig, ServeEngine

    dev = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config("granite-3-2b")
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    for kv_bits in (4, None):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_batch=16, max_len=2048, page=16, kv_bits=kv_bits), device=dev)
        for i in range(16):
            eng.submit(list(range(i, i + 32)), max_new=10 * STEPS)
        chunk = torch.zeros((1, 16), dtype=torch.int64, device=dev)
        starts = iter(range(0, 10 ** 6, 16))
        calls = {"decode": eng.step,
                 "prefill": lambda: eng._prefill(chunk, eng.cache, 0,
                                                 next(starts), 16)}
        with torch.no_grad():
            eng.step()
            eng.step()
            for kind, fn in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    fn()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) / STEPS * 1e3
                busy_ms, launches, top = _profile(fn, PROFILED)
                print(json.dumps({
                    "pages": f"{kv_bits}-bit" if kv_bits else "exact",
                    "call": kind, "nvidia_smi": smi, "arch": cfg.name,
                    "n_layers": cfg.n_layers, "host_ms": host_ms,
                    "device_busy_ms": busy_ms,
                    "idle_share": 1.0 - busy_ms / host_ms,
                    "launches": launches,
                    "launches_per_layer": launches / cfg.n_layers,
                    "top_kernels_ms": top}), flush=True)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
