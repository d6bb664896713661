#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper GPU.

    PYTHONPATH=src python3 chip_smoke.py

Builds the kernels from src/repro_torch/csrc, then runs four phases, each
printing one JSON line; a failed check exits nonzero.

  env            card name and power limit, torch and CUDA versions, build time
  kernels        K1 lead_diff_encode, K2 quantize decode (each at b = 2, 4, 7)
                 and K3 lead_update held bit for bit against their plain
                 PyTorch versions at both shapes of the main path: the
                 headline's (8 rows, d = 64 zero-padded to one block per
                 agent) and the real size's (8 agents x 65,536 rows of 512);
                 then timed at the real size with CUDA events against their
                 byte bounds
  headline       the README's run on the card: ring-8 linear regression, LEAD
                 with the 2-bit quantizer against DGD for 300 iterations,
                 every kernel launched once per LEAD step; plus uncompressed
                 LEAD on the card against the same run on the CPU
  lead_at_scale  the main path at real size: n = 8 agents, d = 2^25 f32
                 parameters each, 2-bit LEAD for 20 steps through run(), then
                 a per-stage breakdown of run() itself from CUDA events at
                 its stage marks (core/stage_timer.py)

The line before the last lists every kernel with its launches on the main
path, its error against the plain version and its times; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
nonzero before printing anything.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

ROWS = 8 * 65536            # n_agents * nb at the real size
BLOCK = 512
D_SCALE = 2 ** 25           # per-agent parameters at the real size
HEADLINE_D = 64             # per-agent parameters of the README's run
# run()'s stage marks (core/stage_timer.py) by what each stage runs
STAGE_NAMES = {"gradient": "gradient", "dither": "dither",
               "diff_encode": "K1_diff_encode", "decode": "K2_decode",
               "mix": "dense_mix", "update": "K3_update",
               "comp_err": "comp_err", "metrics": "metrics"}
REPS = 20
TRACE_RTOL = 1e-5           # trajectory tolerance, as the CPU parity tests
TRACE_FLOOR = 1e-2

# the H100 SXM's data sheet (dense): HBM bytes/s, fp32 non-tensor flop/s
H100_SXM = ("H100 80GB HBM3", 3.35e12, 67e12)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name):
    key, bw, flops = H100_SXM
    if key not in name:
        raise SystemExit(f"chip_smoke: {name!r} is not an H100 SXM, the one "
                         "card whose data-sheet rates the bounds use")
    return bw, flops


def time_ms(fn, reps=REPS, warmup=3):
    """Median over `reps` launches of fn's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


class Quadratic:
    """f_i(x) = 0.5 ||x - t_i||^2, x* = mean_i t_i: the objective that
    benchmarks/bench_lead_step.py drives at scale (a local copy)."""

    def __init__(self, gen, n, d, device):
        self.T = torch.randn((n, d), generator=gen, device=device)
        self.n, self.d = n, d
        self.x_star = self.T.mean(0)

    def full_grad(self, X):
        return X - self.T

    def loss(self, X):
        return 0.5 * torch.mean(torch.sum((X - self.T) ** 2, -1))


def hold_against_plain(dev, d):
    """K1 and K2 at b = 2, 4 and 7, and K3, against their plain versions on
    the planes that the flat engine gives them at per-agent dimension d:
    n = 8 agents blockified (zero past d, as blockify pads), the engine's
    own dither plane and hypers, and one zero row.  Every output must be
    bit-identical; the zero row and the padding must stay zero.  Returns
    each kernel's max |kernel - plain| and the rows it was held at."""
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.engines import engine_for
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q

    n = 8
    eng = engine_for(topology.ring(n), QuantizePNorm(bits=2), d, device=dev)
    gen = torch.Generator(dev).manual_seed(d)
    pad = eng.nb * BLOCK - d                    # zero columns of each agent

    def plane():
        rows = eng._rows(eng.blockify(
            torch.randn((n, d), generator=gen, device=dev)))
        rows[0] = 0.0                           # a zero row stays zero
        return rows

    x, g, dd, h, hw, qh, wqh = (plane() for _ in range(7))
    k0 = torch.zeros((), dtype=torch.int64, device=dev)
    u = eng._rows(eng._dither_plane(12345, k0))
    hy = eng.hypers_at(k0)
    rows = x.shape[0]
    where = f"rows={rows} d={d}"

    def padded(t):                              # agent-major pad columns
        return t.reshape(n, -1)[:, d:] if pad else t[:0]

    err = {"lead_diff_encode": 0.0, "quantize_decode": 0.0, "lead_update": 0.0}
    for bits in (2, 4, 7):
        c1, s1 = lu.lead_diff_encode(x, g, dd, h, u, hy["eta"], bits=bits)
        c2, s2 = lu.lead_diff_encode_plain(x, g, dd, h, u, hy["eta"], bits)
        n_code = int((c1 != c2).sum())
        n_scale = int((s1 != s2).sum())
        check(n_code == 0 and n_scale == 0,
              f"K1 {where} b={bits}: {n_code} codes, {n_scale} scales differ")
        check(float(s1[0]) == 0.0 and not bool(c1[0].any())
              and not bool(padded(c1).any()),
              f"K1 {where} b={bits}: the zero row or the padding is not zero")
        err["lead_diff_encode"] = max(err["lead_diff_encode"],
                                      max_abs(c1, c2), max_abs(s1, s2))
        o1 = q.decode(c1, s1, bits=bits)
        o2 = q.decode_plain(c1, s1, bits)
        e = max_abs(o1, o2)
        check(e == 0.0, f"K2 {where} b={bits}: max |kernel - plain| = {e}")
        err["quantize_decode"] = max(err["quantize_decode"], e)
        del c1, c2, s1, s2, o1, o2

    planes = (x, g, dd, h, hw, qh, wqh)
    hyp = (hy["eta"], hy["gamma"], hy["alpha"])
    outs1 = lu.lead_update(*planes, *hyp)
    outs2 = lu.lead_update_plain(*planes, *hyp)
    e = max(max_abs(a, b) for a, b in zip(outs1, outs2))
    check(e == 0.0, f"K3 {where}: max |kernel - plain| = {e} (built "
          "-fmad=false, so bit-identity is the bar)")
    check(not any(bool(o[0].any()) or bool(padded(o).any()) for o in outs1),
          f"K3 {where}: the zero row or the padding is not zero")
    err["lead_update"] = e
    return err, rows


def phase_kernels(dev, bw, flops):
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q

    # bit-identity at both shapes of the main path: the headline's (d = 64,
    # one zero-padded block per agent, 8 rows) and the real size's
    held = [hold_against_plain(dev, d) for d in (HEADLINE_D, D_SCALE)]
    torch.cuda.empty_cache()
    err = {k: max(e[k] for e, _ in held) for k in held[0][0]}
    check(held[1][1] == ROWS, f"real-size rows {held[1][1]} != {ROWS}")

    # device time at the real size
    n = ROWS * BLOCK
    gen = torch.Generator(dev).manual_seed(0)
    x, g, d, h, hw, qh, wqh = (torch.randn(ROWS, BLOCK, generator=gen,
                                           device=dev) for _ in range(7))
    u = torch.rand(ROWS, BLOCK, generator=gen, device=dev)
    eta = torch.full((), 0.07, device=dev)
    k1_ms = time_ms(lambda: lu.lead_diff_encode(x, g, d, h, u, eta, bits=2))
    k1_plain = time_ms(lambda: lu.lead_diff_encode_plain(x, g, d, h, u, eta, 2))
    code, scale = lu.lead_diff_encode(x, g, d, h, u, eta, bits=2)
    k2_ms = time_ms(lambda: q.decode(code, scale, bits=2))
    k2_plain = time_ms(lambda: q.decode_plain(code, scale, 2))
    del u, code, scale
    planes = (x, g, d, h, hw, qh, wqh)
    hyp = tuple(torch.full((), v, device=dev) for v in (0.5, 1.0, 0.5))
    k3_ms = time_ms(lambda: lu.lead_update(*planes, *hyp))
    k3_plain = time_ms(lambda: lu.lead_update_plain(*planes, *hyp))
    del planes, x, g, d, h, hw, qh, wqh
    torch.cuda.empty_cache()

    # least device time for the same work: each input read once, each output
    # written once, over the HBM rate; operations over the fp32 rate
    specs = {
        "lead_diff_encode": dict(
            replaces="src/repro/kernels/lead_update.py:90",
            bytes=n * 21 + ROWS * 4 + 4, ops=n * 13, ms=k1_ms,
            plain_ms=k1_plain),
        "quantize_decode": dict(
            replaces="src/repro/kernels/quantize.py:84",
            bytes=n * 5 + ROWS * 4, ops=n + ROWS, ms=k2_ms,
            plain_ms=k2_plain),
        "lead_update": dict(
            replaces="src/repro/kernels/lead_update.py:49",
            bytes=n * 44 + 12, ops=n * 15, ms=k3_ms, plain_ms=k3_plain),
    }
    rows = []
    for name, s in specs.items():
        byte_ms = s["bytes"] / bw * 1e3
        op_ms = s["ops"] / flops * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/lead_kernels.cu",
            "replaces": s["replaces"], "max_abs_err": err[name],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None, "bytes": s["bytes"],
            "achieved_GBps": s["bytes"] / (s["ms"] * 1e-3) / 1e9})
    emit({"phase": "kernels", "held_at_rows": [r for _, r in held],
          "timed_rows": ROWS, "block": BLOCK, "hbm_Bps": bw, "kernels": rows})
    return rows


def phase_headline(dev):
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.convex import LinearRegression
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    prob = LinearRegression.generate(torch.Generator(dev).manual_seed(0),
                                     n_agents=8, m=64, d=64, device=dev)
    topo = topology.ring(8)
    mu, L = prob.mu_L
    eta = 1.0 / L
    x_star = prob.x_star

    lead = LEADSim(topology=topo, compressor=QuantizePNorm(bits=2), eta=eta,
                   device=dev)
    cuda_lib.reset_launch_counts()
    tr = run(lead, prob, x_star, iters=300)
    launches = cuda_lib.launch_counts()
    check(all(c == 300 for c in launches.values()),
          f"headline: kernel launches {launches}, expected 300 each")
    dgd = engine_for(topo, None, prob.d, algorithm="dgd", eta=eta, device=dev)
    tr_dgd = run(dgd, prob, x_star, iters=300)
    for t in (tr, tr_dgd):
        check(all(np.isfinite(a).all() for a in t), "headline: non-finite trace")
    ratio = tr.dist[-1] / tr_dgd.dist[-1]
    check(ratio < 1e-3, f"headline: LEAD dist {tr.dist[-1]} is not below "
          f"1e-3 x DGD's {tr_dgd.dist[-1]}")

    # uncompressed LEAD on the card (K3 kernel, cuBLAS mix) against the same
    # run on the CPU (plain versions), which the CPU tests hold against the
    # JAX reference
    cpu_prob = LinearRegression.from_arrays(prob.A, prob.b, prob.lam,
                                            device="cpu")
    runs = [run(LEADSim(topology=topo, eta=eta, device=p.A.device), p,
                x_star.to(p.A.device), iters=100)
            for p in (prob, cpu_prob)]
    # the CPU tests' trajectory bound (tests/test_torch_engine.py::
    # _trace_close): pointwise 1e-5 relative wherever the CPU trace is at
    # least 1e-2 of its first value, and at every step in norm space,
    # |sqrt(cuda) - sqrt(cpu)| within 1e-5 of sqrt(cpu[0]); dist falls ~9
    # decades in 100 steps, below which f32 rounding of the iterates rules
    gap = {}
    for f, a, b in zip(("dist", "consensus", "loss"), runs[0], runs[1]):
        keep = b >= TRACE_FLOOR * b[0]
        rel = float(np.max(np.abs(a[keep] - b[keep]) / b[keep]))
        norm = float(np.max(np.abs(np.sqrt(a) - np.sqrt(b))) / np.sqrt(b[0]))
        gap[f] = {"pointwise_rel": rel, "steps": int(keep.sum()),
                  "norm_space": norm}
        check(rel <= TRACE_RTOL and norm <= TRACE_RTOL,
              f"headline: uncompressed LEAD {f} cuda vs cpu {gap[f]}")
    emit({"phase": "headline", "lead_dist": tr.dist[-1],
          "dgd_dist": tr_dgd.dist[-1], "ratio": ratio,
          "bits_saving": tr_dgd.bits_per_agent[-1] / tr.bits_per_agent[-1],
          "launches": launches, "uncompressed_cuda_vs_cpu": gap,
          "mu": mu, "L": L})
    return launches


def phase_lead_at_scale(dev):
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.core.stage_timer import StageTimer
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    hyper = dict(eta=0.5, gamma=1.0, alpha=0.5)
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    lead = LEADSim(topology=topology.ring(n), compressor=QuantizePNorm(bits=2),
                   device=dev, **hyper)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    tr = run(lead, prob, prob.x_star, iters=iters)   # ends in one .cpu()
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(c == iters for c in launches.values()),
          f"lead_at_scale: kernel launches {launches}, expected {iters} each")
    check(all(np.isfinite(a).all() for a in tr), "lead_at_scale: non-finite")
    check(tr.dist[-1] < 1e-2 * tr.dist[0],
          f"lead_at_scale: dist {tr.dist[0]} -> {tr.dist[-1]}")
    check(tr.consensus[-1] < 1e-2 * tr.consensus[0],
          f"lead_at_scale: consensus {tr.consensus[0]} -> {tr.consensus[-1]}")

    # per-stage device time of run() itself: StageTimer records a CUDA event
    # at each stage mark of the step's own code (after the counted run, so
    # its launches are not counted); step 0 warms up and is dropped
    with StageTimer(dev) as timer:
        run(lead, prob, prob.x_star, iters=6)
    stages = timer.stages()
    first = [name for name, _ in stages].index("metrics") + 1
    acc = {}
    for name, ms in stages[first:]:
        acc.setdefault(STAGE_NAMES.get(name, name), []).append(ms)
    check(set(acc) == set(STAGE_NAMES.values()),
          f"lead_at_scale: stages {sorted(acc)}")
    breakdown = {s: statistics.median(v) for s, v in acc.items()}
    emit({"phase": "lead_at_scale", "n": n, "d": d, "iters": iters,
          "ms_per_step": wall * 1e3 / iters, "breakdown_ms": breakdown,
          "breakdown_total_ms": sum(breakdown.values()),
          "max_memory_allocated_GB": peak / 1e9, "launches": launches,
          "dist": [tr.dist[0], tr.dist[-1]],
          "consensus": [tr.consensus[0], tr.consensus[-1]],
          "loss": [tr.loss[0], tr.loss[-1]], "comp_err_last": tr.comp_err[-1]})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})

    rows = phase_kernels(dev, bw, flops)
    headline = phase_headline(dev)
    at_scale = phase_lead_at_scale(dev)
    for r in rows:
        r["launches"] = at_scale[r["name"]]
        r["headline_launches"] = headline[r["name"]]
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
