"""Carry a reference state, fault state, problem, model, train state or
serving cache across to the port.

The reference's engine states are NamedTuples of arrays; ``np.asarray`` of
each field is the common currency the parity tests feed both packages.
Model parameters and train states are pytrees (dicts, tuples, NamedTuples)
of arrays; ``params_from_numpy`` and ``train_state_from_numpy`` rebuild them
with the port's tensors, the same structure and the same leaf order.
Serving caches (``cache_from_numpy``, ``paged_cache_from_numpy``) are read
by their fields' names, as the reference's cache classes are its own.
"""
from __future__ import annotations

from typing import Any, Mapping

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


def _leaf_tensor(x, dev: torch.device) -> torch.Tensor:
    """An array as a tensor on `dev`: bfloat16 stays bfloat16, other floats
    become f32, integers int64 (a 0-d integer too); always a copy."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    if np.issubdtype(arr.dtype, np.floating):
        return torch.tensor(arr, dtype=torch.float32, device=dev)
    if np.issubdtype(arr.dtype, np.bool_):
        return torch.tensor(arr, dtype=torch.bool, device=dev)
    return torch.tensor(arr, dtype=torch.int64, device=dev)


def _convert(tree, dev: torch.device, classes: Mapping[str, type]) -> Any:
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = classes.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(_convert(c, dev, classes) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(c, dev, classes) for c in tree)
    if isinstance(tree, Mapping):
        return {k: _convert(tree[k], dev, classes) for k in tree}
    return _leaf_tensor(tree, dev)


def params_from_numpy(tree, device: DeviceLike = None):
    """The port's parameter pytree on `device` from the reference's
    ``init_params`` pytree (arrays, e.g. after ``jax.device_get``): the
    same dicts and tuples, so the same leaf order, with every leaf copied
    to a tensor (floats f32, bfloat16 kept)."""
    return _convert(tree, resolve_device(device), {})


def train_state_from_numpy(state, device: DeviceLike = None):
    """The port's dist/trainer.TrainState on `device` from the reference's
    TrainState (or a mapping with its four fields): params and the algo
    fields as in params_from_numpy, the optimizer state as the port's
    MomentumState / AdamState (or ``()`` for SGD), step a 0-d int64.
    (The trainer and the optimizers are imported here, not by the module:
    core sits below dist.)"""
    from repro_torch.dist.trainer import TrainState
    from repro_torch.optim import optimizers

    dev = resolve_device(device)
    if hasattr(state, "_asdict"):
        state = state._asdict()
    classes = {"MomentumState": optimizers.MomentumState,
               "AdamState": optimizers.AdamState}
    opt = _convert(state["opt"], dev, classes)
    if isinstance(opt, optimizers.AdamState):
        opt = opt._replace(t=opt.t.to(torch.int32))
    return TrainState(
        params=_convert(state["params"], dev, {}),
        algo={f: _convert(t, dev, {}) for f, t in state["algo"].items()},
        opt=opt,
        step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int64,
                          device=dev))


def _exact_tensor(x, dev: torch.device) -> torch.Tensor:
    """An array as a tensor of its own dtype (bfloat16 kept) on `dev`."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(arr, device=dev)


def cache_from_numpy(cache, device: DeviceLike = None):
    """The port's contiguous serving cache (models/transformer.init_cache's
    layout) on `device` from the reference's: {"layers": a KVCache (fields
    k, v, rolling) or a recurrent state (MLSTMState, SLSTMState,
    RGLRUState) per layer, "pos": 0-d} and the vlm's "cross_mem" and the
    audio model's "enc_mem" (k, v) pairs, as arrays.  Every tensor keeps
    its dtype (bf16 caches stay bf16); pos becomes int64."""
    from repro_torch.models import attention as attn
    from repro_torch.models import recurrent as rec

    dev = resolve_device(device)
    states = {c.__name__: c for c in (rec.MLSTMState, rec.SLSTMState,
                                      rec.RGLRUState)}
    layers = []
    for c in cache["layers"]:
        if hasattr(c, "rolling"):
            layers.append(attn.KVCache(_exact_tensor(c.k, dev),
                                       _exact_tensor(c.v, dev),
                                       bool(c.rolling)))
        elif type(c).__name__ in states:
            layers.append(states[type(c).__name__](
                *(_exact_tensor(f, dev) for f in c)))
        else:
            raise TypeError(f"no port counterpart for {type(c).__name__}")
    out = {"layers": tuple(layers),
           "pos": torch.tensor(int(np.asarray(cache["pos"])),
                               dtype=torch.int64, device=dev)}
    for key in ("cross_mem", "enc_mem"):
        if key in cache:
            out[key] = tuple(tuple(_exact_tensor(m, dev) for m in kv)
                             for kv in cache[key])
    return out


def paged_cache_from_numpy(cache, device: DeviceLike = None):
    """The port's paged serving cache (serve/paged_cache.init_paged_cache's
    layout) on `device` from the reference's: {"layers": a PagedKVCache per
    layer (fields page, rolling, spec, page_table, tail_k, tail_v and the
    pools kp, vp or kc, ksc, vc, vsc), "pos": (B,), "active": (B,)}, as
    arrays.  Each pool gains the port's spare row; codes stay int8, page
    ids and positions become int64; the layers of one kind share one page
    table, as they do in the reference."""
    from repro_torch.serve.kv_quant import KVQuantSpec
    from repro_torch.serve.paged_cache import (_POOL_FIELDS, PagedKVCache,
                                               _with_spare)

    dev = resolve_device(device)
    tables = {}
    layers = []
    for c in cache["layers"]:
        pt = np.asarray(c.page_table)
        shared = tables.setdefault(bool(c.rolling), (pt, torch.tensor(
            pt, dtype=torch.int64, device=dev)))
        if not np.array_equal(shared[0], pt):
            raise ValueError("layers of one kind must share one page table")
        spec = None if c.spec is None else KVQuantSpec(int(c.spec.bits),
                                                       int(c.spec.block))
        pools = {n: _with_spare(_exact_tensor(getattr(c, n), dev))
                 for n in _POOL_FIELDS if getattr(c, n, None) is not None}
        layers.append(PagedKVCache(
            page=int(c.page), rolling=bool(c.rolling), spec=spec,
            page_table=shared[1], tail_k=_exact_tensor(c.tail_k, dev),
            tail_v=_exact_tensor(c.tail_v, dev), **pools))
    return {"layers": tuple(layers),
            "pos": torch.tensor(np.asarray(cache["pos"]), dtype=torch.int64,
                                device=dev),
            "active": torch.tensor(np.asarray(cache["active"]),
                                   dtype=torch.bool, device=dev)}
