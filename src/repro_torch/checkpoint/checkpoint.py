"""Pytree checkpoints: the port of ``src/repro/checkpoint/checkpoint.py``,
in its file format, so a file written by either package restores into the
other.

A file is one ``np.savez`` archive: the leaves as ``leaf_0 .. leaf_{n-1}``
in flatten order and ``__meta__``, a json ``{"keys": [...]}`` of their path
keys, built as the reference's ``_paths`` builds them from jax's key path:
a NamedTuple field as ``str(GetAttrKey(name))`` (".params"), a dict entry
by its key, a list or tuple entry by its index, joined by "/" (e.g.
".algo/h/embed").  Restore matches leaves by these keys, never by position,
and casts each to the target's dtype (the reference's step is int32, the
port's int64).  A truncated, corrupt or mismatched file raises ValueError.
Writes go to a temporary file in the same directory, renamed into place.

``save(ckpt_dir, step, tree)`` writes ``step_XXXXXXXX.npz`` and a ``LATEST``
file naming the step; ``restore(ckpt_dir, like)`` reads the latest (or a
given) step.  Across ranks (a ``dist/sharding.AgentLayout``), global rank 0
gathers every agent's rows into host arrays, leaf by leaf and peer by peer,
and writes the file; on restore every rank reads each leaf on the host and
copies only its own agents' rows to its device.  So no rank's device ever
holds more than its own state and one peer's rows of one leaf, as the
reference copies to the host (``jax.device_get``) and places each shard.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _paths(tree):
    """(path keys, leaves, treedef) in flatten order, the keys as the
    reference's ``_paths`` spells them."""
    leaves, treedef = tree_flatten(tree)
    keys = []

    def walk(node, prefix):
        kind = node[0]
        if kind == "leaf":
            keys.append("/".join(prefix))
        elif kind == "namedtuple":
            for name, child in zip(node[1]._fields, node[2]):
                walk(child, prefix + [f".{name}"])
        elif kind == "dict":
            for k, child in zip(node[1], node[2]):
                walk(child, prefix + [str(k)])
        elif kind != "none":
            for i, child in enumerate(node[2]):
                walk(child, prefix + [str(i)])

    walk(treedef, [])
    return keys, leaves, treedef


def host_array(leaf) -> np.ndarray:
    """`leaf` (a tensor on any device, or an array) as a host numpy array,
    a bf16 tensor as f32 (numpy has no bfloat16).  A strided tensor on a
    device (the trainer's leaves are views of padded blocks) is copied one
    leading row at a time: copying it whole would first make a contiguous
    copy of all of it on the device."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach()
    if t.device.type != "cpu" and t.numel() and not t.is_contiguous():
        out = None
        for i, r in enumerate(t):
            a = host_array(r)
            if out is None:
                out = np.empty(tuple(t.shape), a.dtype)
            out[i] = a
        return out
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def save_pytree(path: str, tree: Any) -> None:
    """Write `tree` (tensors or arrays) to `path`, atomically."""
    keys, leaves, _ = _paths(tree)
    arrays = {f"leaf_{i}": host_array(l) for i, l in enumerate(leaves)}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps({"keys": keys}), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any, device=None, rows=None) -> Any:
    """Restore `path` into the structure of `like` (tensors: each leaf
    takes its dtype and, unless `device` is given, its device).  `rows` (a
    slice) keeps those rows of every leaf of one or more dimensions, cut on
    the host before the copy to the device; `like` has the file's shapes.

    Leaves are matched by their saved path keys; a checkpoint written
    without them falls back to positional order.  A truncated or corrupt
    file, a leaf-count mismatch, a target path the file lacks and a shape
    mismatch each raise ValueError naming the file."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = (json.loads(z["__meta__"].item())
                    if "__meta__" in z.files else None)
            n = len([k for k in z.files if k.startswith("leaf_")])
            arrays = [z[f"leaf_{i}"] for i in range(n)]
    except FileNotFoundError:
        raise
    except (OSError, EOFError, KeyError, ValueError,
            zipfile.BadZipFile) as e:
        raise ValueError(
            f"checkpoint {path} is corrupt or truncated and cannot be "
            f"deserialized ({type(e).__name__}: {e}); restore from an "
            "earlier step") from e
    keys, leaves, treedef = _paths(like)
    if len(leaves) != len(arrays):
        raise ValueError(
            f"checkpoint {path} holds {len(arrays)} leaves but the target "
            f"pytree has {len(leaves)}: it was written for a different "
            "state structure")
    saved_keys = (meta or {}).get("keys")
    if saved_keys:
        by_key = dict(zip(saved_keys, arrays))
        missing = [k for k in keys if k not in by_key]
        if missing:
            raise ValueError(
                f"checkpoint {path} does not match the target pytree: "
                f"target paths {missing[:3]} are absent from the saved "
                f"paths (e.g. {saved_keys[:3]}); refusing a positional "
                "restore, which would permute state leaves")
        arrays = [by_key[k] for k in keys]
    out = []
    for key, a, ref in zip(keys, arrays, leaves):
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint {path}: leaf {key!r} has shape {a.shape} but "
                f"the target expects {tuple(ref.shape)}; refusing a "
                "reshaping restore")
        if rows is not None and a.ndim:
            a = a[rows]
        if isinstance(ref, torch.Tensor):
            dev = ref.device if device is None else device
            a = a if a.flags.c_contiguous else a.copy()   # 0-d stays 0-d
            out.append(torch.from_numpy(a).to(ref.dtype).to(dev))
        else:
            out.append(a.astype(np.asarray(ref).dtype))
    return tree_unflatten(treedef, out)


# -- step-numbered training checkpoints --------------------------------------

def _path_of(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save(ckpt_dir: str, step: int, tree: Any, layout=None) -> str:
    """Write `tree` as step `step` of `ckpt_dir` and point LATEST at it.
    With a rank `layout` (dist/sharding.AgentLayout) every rank calls this:
    global rank 0 gathers every agent's rows to the host and writes, and
    all ranks leave once the file is in place."""
    path = _path_of(ckpt_dir, step)
    if layout is None or not layout.distributed:
        _write(ckpt_dir, step, path, tree)
        return path
    whole = layout.gather(tree)
    if layout.mesh.rank == 0:
        _write(ckpt_dir, step, path, whole)
    dist.barrier()
    return path


def _write(ckpt_dir: str, step: int, path: str, tree: Any) -> None:
    save_pytree(path, tree)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(str(step))


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            layout=None):
    """(tree, step) of `ckpt_dir`'s LATEST step (or `step`), restored into
    the structure of `like`; (None, -1) when the directory holds none.
    With a rank `layout`, `like` is the rank's own state: each leaf of the
    file is read on the host and only the rank's agents' rows reach its
    device."""
    latest = os.path.join(ckpt_dir, "LATEST")
    if step is None:
        if not os.path.exists(latest):
            return None, -1
        with open(latest) as f:
            step = int(f.read().strip())
    path = _path_of(ckpt_dir, step)
    if layout is None or not layout.distributed:
        return load_pytree(path, like), step
    # checked against the whole tree's shapes (each stacked leaf with every
    # agent's rows), the rank's rows cut on the host
    device = next((l.device for l in tree_flatten(like)[0]), None)
    return load_pytree(path, _widened(like, layout.n_agents), device,
                       rows=slice(layout.first, layout.stop)), step


def _widened(tree, n_agents: int):
    """`tree` with each stacked leaf's leading axis widened to n_agents
    (meta tensors: the shapes and dtypes only)."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for l in leaves:
        if l.ndim == 0:
            out.append(l)
        else:
            out.append(torch.empty((n_agents,) + tuple(l.shape[1:]),
                                   dtype=l.dtype, device="meta"))
    return tree_unflatten(treedef, out)
