#!/usr/bin/env python3
"""Serving across ranks on NVIDIA GPUs, alone: chip_smoke.py's
serve_at_scale/ranks phase without the other phases.

    PYTHONPATH=src python3 scripts/serve_ranks.py

granite-3-2b whole through dist/serve.py in a one-rank NCCL group against
the no-group path (16 lanes, 4-bit pages, 32 decode steps, bit for bit),
then, on a machine with 2 or 4 cards, with one rank per card (each rank's
lanes, the pools kept equal by the per-layer all-gather).  Prints the
cards' names and power limits, the phase's JSON line and the script's
seconds; exits nonzero without a card or when a check fails.
"""
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("serve_ranks: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    dev = resolve_device("cuda:0")
    torch.zeros(1, device=dev)             # the card's context, first
    cuda_lib.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    chip_smoke.phase_serve_ranks(dev, smi[0])
    print(json.dumps({"script_seconds": time.perf_counter() - start,
                      "cards": torch.cuda.device_count(),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
