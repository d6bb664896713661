"""Env-gated finite-value guards for long-running loops.

Fault injection (core/faults.py) admits failure modes that can poison a
trajectory with inf or NaN (an undetected bit flip lands in the mix), and
a long run should fail at the step that went nonfinite.  The guards are
off by default and enabled by setting ``REPRO_ASSERT_FINITE`` to anything
truthy (``1``, ``true``, ...).  ``simulator.run`` calls
``assert_finite_tree`` on every recorded step.  When the guard is off it
returns before touching a tensor; when on, each check reads one flag per
leaf back to the host, so it synchronises a card once per recorded step.
"""
from __future__ import annotations

import os

import torch

from repro_torch.utils.tree import _is_namedtuple

_ENV = "REPRO_ASSERT_FINITE"
_FALSY = ("", "0", "false", "no", "off")


def finite_checks_enabled() -> bool:
    """True when REPRO_ASSERT_FINITE is set truthy (read on every call, so
    tests and drivers can flip it without reimporting)."""
    return os.environ.get(_ENV, "0").strip().lower() not in _FALSY


def _leaves_with_path(tree, path=""):
    """(name, leaf) pairs in the reference's key-path notation: ``['x']``
    for a dict key, ``.x`` for a NamedTuple field, ``[0]`` for an index."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{path}[{key!r}]")
    else:
        yield path, tree


def assert_finite_tree(tree, where: str = "") -> None:
    """Raise FloatingPointError naming the leaves of `tree` that hold a
    nonfinite value; a no-op unless ``finite_checks_enabled()``.  Integer
    and bool leaves (counters, masks) are skipped."""
    if not finite_checks_enabled():
        return
    names, oks = [], []
    for name, leaf in _leaves_with_path(tree):
        t = torch.as_tensor(leaf)
        if not (t.is_floating_point() or t.is_complex()):
            continue
        names.append(name or "<leaf>")
        oks.append(torch.isfinite(t).all())
    if not names:
        return
    flags = torch.stack([o.to(oks[0].device) for o in oks]).cpu().tolist()
    bad = [n for n, ok in zip(names, flags) if not ok]
    if bad:
        at = f" at {where}" if where else ""
        raise FloatingPointError(
            f"nonfinite values{at} in leaves: {', '.join(bad)} "
            f"(guard enabled via {_ENV})")
