"""State tuples of the paper's baseline algorithms (§2, §5).

The port's copies of the NamedTuples of ``src/repro/core/baselines.py``,
field for field, so a reference state carries across with
``core/convert.state_from_numpy``.  The flat engines
(core/engines/baselines.py) keep each float field as an
``(n_agents, nb, block)`` f32 tensor and the iteration counter ``k`` as a
0-d int64 tensor.  The tree algorithms of that module, and their
``flat_twin``, are not ported yet (ROADMAP.md, 'Modules still to port').
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SimpleState(NamedTuple):
    """DGD, QDGD."""
    x: torch.Tensor
    k: torch.Tensor


class PrevGradState(NamedTuple):
    """D2."""
    x: torch.Tensor
    x_prev: torch.Tensor
    g_prev: torch.Tensor
    k: torch.Tensor


class HatState(NamedTuple):
    """CHOCO-SGD, DCD-SGD."""
    x: torch.Tensor
    xhat: torch.Tensor       # public (quantized) copies, one per agent
    xhat_w: torch.Tensor     # sum_j w_ij xhat_j, tracked incrementally
    k: torch.Tensor


class ErrorState(NamedTuple):
    """DeepSqueeze."""
    x: torch.Tensor
    e: torch.Tensor          # error-compensation memory
    k: torch.Tensor


class DualState(NamedTuple):
    """NIDS."""
    x: torch.Tensor
    d: torch.Tensor
    k: torch.Tensor
