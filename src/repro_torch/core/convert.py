"""Carry a reference state, fault state or problem across to the port.

The reference's engine states are NamedTuples of arrays; ``np.asarray`` of
each field is the common currency the parity tests feed both packages.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.convex import LinearRegression, LogisticRegression
from repro_torch.core.faults import FaultState
from repro_torch.device import DeviceLike, resolve_device


def state_from_numpy(state_cls, arrays, device: DeviceLike = None):
    """The port's `state_cls` (FlatLEADState or a baseline's state:
    SimpleState, HatState, ErrorState, DualState, PrevGradState,
    ExtraState) on `device` from the reference's state: a NamedTuple, a
    mapping of field name to array, or a sequence in field order.  Float
    fields become f32, the counter k int64; every field is copied."""
    dev = resolve_device(device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(state_cls._fields, arrays))
    fields = {}
    for name in state_cls._fields:
        dtype = torch.int64 if name == "k" else torch.float32
        fields[name] = torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                                    device=dev)
    return state_cls(**fields)


def fault_state_from_numpy(arrays, device: DeviceLike = None) -> FaultState:
    """The port's FaultState on `device` from the reference's (a
    NamedTuple, a mapping or a (cache, age) sequence): cache as f32, age
    as int32, both copied."""
    dev = resolve_device(device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(FaultState._fields, arrays))
    return FaultState(
        cache=torch.tensor(np.asarray(arrays["cache"]), dtype=torch.float32,
                           device=dev),
        age=torch.tensor(np.asarray(arrays["age"]), dtype=torch.int32,
                         device=dev))


def problem_from_numpy(A, b, lam: float,
                       device: DeviceLike = None) -> LinearRegression:
    """The port's LinearRegression with the reference's data."""
    return LinearRegression.from_arrays(A, b, lam, device=device)


def logreg_from_numpy(feats, labels, n_classes: int, lam: float,
                      device: DeviceLike = None) -> LogisticRegression:
    """The port's LogisticRegression with the reference's data."""
    return LogisticRegression.from_arrays(feats, labels, n_classes, lam,
                                          device=device)
