"""Opt-in per-stage timing of the simulator's step.

The step's own code marks the end of each of its stages with
``mark(name)``: ``simulator.run`` after the gradient ("gradient") and after
the metric writes ("metrics"); the flat LEAD engine after the dither plane
("dither"), the fused diff-encode K1 ("diff_encode"), the fused update K3
("update") and the compression error ("comp_err"); the flat engines' wire
after the receiver decode K2 ("decode") and the mix ("mix"); on a
TopologyBank the reference mix with the step's round graph
("round_mix"), on the hier wire the intra-node projection
("intra_project"), and on an interval's skipped step the local step
("local").

With no timer active a mark costs one global read.  Inside
``with StageTimer(device) as t:`` every mark records a CUDA event on the
current stream (a host-clock reading on the CPU), so a stage's time is the
gap between its mark and the one before it, and what is timed is exactly
the code that ``run()`` executes.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

_active = None


def mark(name: str) -> None:
    """End of stage `name` of the current step; nothing unless a StageTimer
    is active."""
    if _active is not None:
        _active.record(name)


class StageTimer:
    """Collects the marks of the code run inside its ``with`` block."""

    def __init__(self, device: DeviceLike = None):
        self.cuda = resolve_device(device).type == "cuda"
        self.marks: list = []

    def record(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((name, ev))

    def __enter__(self) -> "StageTimer":
        global _active
        if _active is not None:
            raise RuntimeError("a StageTimer is already active")
        _active = self
        self.record("start")
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = None
        if self.cuda:
            torch.cuda.synchronize()

    def stages(self) -> List[Tuple[str, float]]:
        """(name, ms) of every marked stage, in order: each mark's time
        since the mark before it."""
        out = []
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out.append((name, a.elapsed_time(b) if self.cuda
                        else (b - a) * 1e3))
        return out
