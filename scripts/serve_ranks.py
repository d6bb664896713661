#!/usr/bin/env python3
"""One phase of chip_smoke.py alone, on NVIDIA GPUs: the serving phases
across ranks, and the trainer's MoE cell.

    PYTHONPATH=src python3 scripts/serve_ranks.py [PHASE]

PHASE (default serve_at_scale/ranks):

  serve_at_scale/ranks  granite-3-2b whole through dist/serve.py in a
                        one-rank NCCL group against the no-group path (16
                        lanes, 4-bit pages, 32 decode steps, bit for bit);
  moe_ep_at_scale       granite-moe-1b-a400m whole with moe_ep_axis "data"
                        the same way (16 lanes of a 256-token prompt, the
                        all-to-all dispatch of models/moe_ep.py in prefill,
                        4-bit pages, 4 decode steps);
  moe_at_scale          the trainer's MoE cell (granite-moe-1b-a400m at its
                        published width, 4 layers, 4 agents).

On a machine with 2 or 4 cards the two rank phases run again with one
rank per card.  The phase is looked up in the chip_smoke.py of the
checkout this script lies in, so a copy of the script in another checkout
runs that checkout's phase.  Prints the cards' names and power limits,
the phase's JSON line and the script's seconds; exits nonzero without a
card, for an unknown phase, or when a check fails.
"""
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {
    "serve_at_scale/ranks": lambda cs, dev, smi: cs.phase_serve_ranks(
        dev, smi),
    "moe_ep_at_scale": lambda cs, dev, smi: cs.phase_moe_ep(dev, smi),
    "moe_at_scale": lambda cs, dev, smi: cs.phase_train_at_scale(
        dev, smi, cs.card_rates(torch.cuda.get_device_name(0))[1],
        "moe_at_scale"),
}


def main(argv):
    start = time.perf_counter()
    phase = argv[0] if argv else "serve_at_scale/ranks"
    if phase not in PHASES:
        print(f"serve_ranks: {phase!r} is none of {sorted(PHASES)}",
              file=sys.stderr)
        return 2
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
    PHASES[phase](chip_smoke, dev, smi[0])
    print(json.dumps({"phase_alone": phase,
                      "script_seconds": time.perf_counter() - start,
                      "cards": torch.cuda.device_count(),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
