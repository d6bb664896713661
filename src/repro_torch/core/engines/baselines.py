"""Flat engines for the paper's baselines.

Only DGD is ported so far: it is the headline's comparison.  The exact
baselines take no compressor; the raw buffer is the payload (d * 32 bits on
the wire) and comp_err is exactly zero.  NIDS, EXTRA, D2 and the
compressed baselines (CHOCO-SGD, DeepSqueeze, QDGD, DCD-SGD) are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.compression import Identity
from repro_torch.core.engines.base import FlatEngineBase
from repro_torch.core.lead import Schedule


class SimpleState(NamedTuple):
    x: torch.Tensor
    k: torch.Tensor


def _zero_err(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class _FlatExactEngine(FlatEngineBase):
    """Shared base of the exact (uncompressed) flat engines: the message
    buffer itself is the payload - d * 32 bits per transmission, decode is
    the identity, and comp_err is exactly zero."""
    eta: Schedule = 0.1

    def __post_init__(self):
        super().__post_init__()
        if not (self.compressor is None
                or isinstance(self.compressor, Identity)):
            raise ValueError(
                f"{type(self).__name__} is an exact baseline; it does not "
                f"compress (got {type(self.compressor).__name__})")


@dataclasses.dataclass(frozen=True)
class FlatDGDEngine(_FlatExactEngine):
    """DGD / D-PSGD: X+ = W X - eta g."""

    def init(self, x0, g0, key=None):
        return SimpleState(x=self.blockify(x0),
                           k=torch.zeros((), dtype=torch.int64,
                                         device=self.device))

    def message(self, s: SimpleState, gb, hy):
        return s.x, None

    def apply_stage(self, s: SimpleState, gb, q, wx, hy, ctx):
        return (SimpleState(x=wx - hy["eta"] * gb, k=s.k + 1),
                _zero_err(wx.device))
