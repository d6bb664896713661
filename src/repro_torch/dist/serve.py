"""Serving entry points across ranks: prefill and decode with the batch
split over the "data" axis of a launch/mesh.RankMesh (the port of
``src/repro/dist/serve.py``).

Serving runs ONE model (no agent stacking).  Each make_* returns

    (fn, sds, shardings, cfg)

where ``sds`` is the arguments' tree as ``device="meta"`` tensors (shapes
and dtypes, nothing allocated: the reference's ShapeDtypeStructs),
``shardings`` the matching tree of this rank's placements
(``dist/sharding.BatchRows``; ``place`` cuts a whole tree to them, as
``jax.device_put`` with the reference's NamedShardings) and ``fn`` runs on
the rank's part.  Every rank calls the make_* functions, in the same
order (they create process groups).

How the reference's placements map onto ranks:

  * params: replicated, every rank holds every weight;
  * tokens, memory, the contiguous cache's k/v and recurrent states, and
    the paged cache's per-sequence leaves (page_table, tail_k, tail_v, the
    (B,) pos and active): rows [start, stop) of B on the rank at that
    "data" index (``serve_batch_spec``), the same rows on every rank along
    "pod" and "model" (replicas); every rank holds every row when "data"
    does not divide B;
  * 0-d leaves (the contiguous cache's pos) and the page pool
    (serve/paged_cache ``_POOL_FIELDS``): replicated.  Leaves are told
    apart by key path, never by shape.

The pool.  The reference's contract is that every shard can gather any
page: under GSPMD the scatter of data-sharded page writes into a
replicated pool leaves every device with the same pool.  Here each rank
writes its own lanes' pages, so make_paged_decode's fn gives every layer's
cache the rank's data group (the ranks that differ from it only along
"data"), and each decode step's written page rows - the int8 codes and f32
scales that K4 made, or fp pages of an exact pool - and their page ids
(the spare row n_pages for a write that does not land) are all-gathered
over it, one collective of fixed size per layer, and every rank writes all
of them (``PagedKVCache.update``).  After every step each rank's pool
equals the one-process pool, and a page that a lane of one rank flushes is
read by a lane of another from the next step on.  ``paged_from_rows``
builds that cache from the rank's rows of a prefill.  In one process (no
process group) nothing is gathered: fn is the one-process path.

MoE.  The reference's fns are one GSPMD program, so a batch split over
"data" does not change what its MoE layers compute: each routes the whole
batch, its capacity counted over every token.  So with the rows split,
every fn hands the model the data group (``models/moe_ep.MoEGroups``):
each plain MoE layer all-gathers its input over it, routes the whole
batch and keeps the rank's rows.  With ``cfg.moe_ep_axis`` ("data"),
make_prefill's fn runs the expert-parallel dispatch instead
(models/moe_ep.py): the data group is its ep group when the rows are
split (each rank then runs E / data of the experts), the "model" group
its tp group; decode keeps the plain MoE, as the reference's does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import (BatchRows, ShardingProfile,
                                       serve_batch_spec)
from repro_torch.launch.mesh import all_gather_bytes
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.moe_ep import MoEGroups
from repro_torch.serve.paged_cache import (PagedKVCache, _POOL_FIELDS,
                                           _with_spare, init_paged_cache,
                                           paged_from_contiguous)


def _map(fn, tree, *rest, path=()):
    """fn(path, leaf, *the other trees' leaves) over a serving tree, the
    structure rebuilt around the results.  Path entries: a dict key, a
    named-tuple field or a PagedKVCache field by name (str), a tuple or
    list entry and a KVCache's k and v by position (int: the reference
    flattens KVCache positionally)."""
    def sub(key, child, others):
        return _map(fn, child, *others, path=path + (key,))

    if isinstance(tree, dict):
        return {k: sub(str(k), v, [r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, PagedKVCache):
        kw = {n: sub(n, t, [getattr(r, n) for r in rest])
              for n, t in tree.tensors().items()}
        return PagedKVCache(page=tree.page, rolling=tree.rolling,
                            spec=tree.spec, group=tree.group, **kw)
    if isinstance(tree, KVCache):
        return KVCache(sub(0, tree.k, [r.k for r in rest]),
                       sub(1, tree.v, [r.v for r in rest]),
                       rolling=tree.rolling)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub(f, c, [getattr(r, f) for r in rest])
                            for f, c in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(i, c, [r[i] for r in rest])
                          for i, c in enumerate(tree))
    return fn(path, tree, *rest)


def _leaf_name(path) -> str:
    """Last named component of a key path ('' when none, e.g. the k/v of
    the contiguous KVCache, which are positional)."""
    return next((e for e in reversed(path) if isinstance(e, str)), "")


def _replicated(mesh, sds_tree):
    return _map(lambda path, s: BatchRows(), sds_tree)


def _batched(mesh, sds_tree, batch: int):
    """Rows over "data" for leaves whose key path marks them per-sequence;
    scalars and page-pool leaves replicated.  A pool leaf whose page count
    equals the batch, or a cache whose length does, keeps its role's
    placement.  A leaf classified per-sequence must lead with the batch."""
    pool = set(_POOL_FIELDS)

    def one(path, s):
        if s.ndim == 0 or _leaf_name(path) in pool:
            return BatchRows()
        if s.shape[0] != batch:
            raise ValueError(
                f"per-sequence cache leaf {'/'.join(map(str, path))} has "
                f"leading dim {s.shape[0]}, expected batch={batch}")
        return serve_batch_spec(mesh, s.ndim, batch)
    return _map(one, sds_tree)


def place(tree, shardings):
    """The rank's part of a whole tree (``BatchRows.take`` of each leaf)."""
    return _map(lambda path, t, rows: rows.take(t), tree, shardings)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _params(cfg, mesh):
    sds = tfm.init_params(cfg, device="meta")
    return sds, _replicated(mesh, sds)


def _data_group(mesh):
    """The rank's data group (created collectively), None in one process."""
    if not dist.is_initialized():
        return None
    return mesh.subgroup(mesh.partition(("data",)))


def _moe_groups(cfg, mesh, rows: BatchRows, expert_parallel=False):
    """The MoE layers' groups for a make_* function's fn (module
    docstring); None for a dense model or in one process.  Created
    collectively."""
    if not cfg.n_experts or not dist.is_initialized():
        return None
    data = _data_group(mesh) if rows.split else None
    if not (expert_parallel and cfg.moe_ep_axis):
        return MoEGroups(rows=data)
    if cfg.moe_ep_axis != "data":
        raise ValueError(f"{cfg.name}: moe_ep_axis={cfg.moe_ep_axis!r}; "
                         "serving splits the batch over 'data' only")
    tp = (mesh.subgroup(mesh.partition(("model",)))
          if "model" in mesh.dims else None)
    return MoEGroups(rows=data, ep=data, tp=tp)


def make_decode(cfg, mesh, prof: ShardingProfile, shape):
    """Single-token decode step over a prefilled contiguous cache.

    shape: InputShape with global_batch=B and seq_len=cache length.  The
    cache's k/v split into rows over "data", its 0-d pos replicated."""
    B, cache_len = shape.global_batch, shape.seq_len
    params_sds, params_sh = _params(cfg, mesh)
    cache_sds = tfm.init_cache(cfg, B, cache_len, device="meta")
    sds = {"params": params_sds, "token": _meta((B, 1), torch.int64),
           "cache": cache_sds}
    shardings = {"params": params_sh,
                 "token": serve_batch_spec(mesh, 2, B),
                 "cache": _batched(mesh, cache_sds, B)}
    groups = _moe_groups(cfg, mesh, shardings["token"])

    def fn(params, token, cache):
        return tfm.decode_step(params, cfg, token, cache, moe_groups=groups)

    return fn, sds, shardings, cfg


def make_paged_decode(cfg, mesh, prof: ShardingProfile, shape, *,
                      page: int = 16, kv_bits=None):
    """Decode step over the serving subsystem's paged cache (serve/).

    Same (fn, sds, shardings, cfg) contract as make_decode, but the cache
    is a paged pool and per-sequence page tables: pool leaves replicated
    (every rank gathers any page), per-sequence leaves - page_table, exact
    tails, the (B,) pos and active - split into rows over "data".  With the
    rows split across ranks, fn all-gathers each step's page writes over
    the data group (module docstring)."""
    B, cache_len = shape.global_batch, shape.seq_len
    params_sds, params_sh = _params(cfg, mesh)
    cache_sds = init_paged_cache(cfg, B, cache_len, page=page,
                                 kv_bits=kv_bits, device="meta")
    sds = {"params": params_sds, "token": _meta((B, 1), torch.int64),
           "cache": cache_sds}
    shardings = {"params": params_sh,
                 "token": serve_batch_spec(mesh, 2, B),
                 "cache": _batched(mesh, cache_sds, B)}
    group = _data_group(mesh) if shardings["cache"]["pos"].split else None
    groups = _moe_groups(cfg, mesh, shardings["token"])

    def fn(params, token, cache):
        for c in cache["layers"]:
            c.group = group
        return tfm.decode_step(params, cfg, token, cache, moe_groups=groups)

    return fn, sds, shardings, cfg


def make_prefill(cfg, mesh, prof: ShardingProfile, shape):
    """Full-prompt prefill: (last-token logits, populated contiguous cache)
    of the rank's rows of tokens (and of memory, for vlm and audio); an
    MoE routes the whole batch, or dispatches over the ep and tp groups
    with ``cfg.moe_ep_axis`` (module docstring)."""
    B, S = shape.global_batch, shape.seq_len
    params_sds, params_sh = _params(cfg, mesh)
    sds: Dict[str, Any] = {"params": params_sds,
                           "tokens": _meta((B, S), torch.int64)}
    shardings: Dict[str, Any] = {"params": params_sh,
                                 "tokens": serve_batch_spec(mesh, 2, B)}
    groups = _moe_groups(cfg, mesh, shardings["tokens"], expert_parallel=True)
    if cfg.family in ("vlm", "audio"):
        M = cfg.vis_tokens if cfg.family == "vlm" else cfg.n_audio_frames
        sds["memory"] = _meta((B, M, cfg.d_model), torch.float32)
        shardings["memory"] = serve_batch_spec(mesh, 3, B)

        def fn(params, tokens, memory):
            return tfm.prefill(params, cfg, tokens, memory=memory,
                               cache_len=S, moe_groups=groups)
    else:
        def fn(params, tokens):
            return tfm.prefill(params, cfg, tokens, cache_len=S,
                               moe_groups=groups)

    return fn, sds, shardings, cfg


def paged_from_rows(cache, cfg, mesh, batch: int, *, page: int = 16,
                    kv_bits=None):
    """The rank's part (make_paged_decode's placement) of
    ``paged_from_contiguous`` of the whole batch's contiguous cache, built
    from the rank's rows of it (make_prefill's fn): the rank encodes its
    lanes' pages, which hold one block of the slot-major page ids, and the
    pools are all-gathered over the data group once.  In one process, or
    where every rank holds every lane, ``paged_from_contiguous`` itself."""
    paged = paged_from_contiguous(cache, cfg, page=page, kv_bits=kv_bits)
    rows = serve_batch_spec(mesh, 1, batch)
    group = _data_group(mesh) if rows.split else None
    if group is None:
        return paged
    for c in paged["layers"]:
        c.page_table = c.page_table + rows.start * c.pages_per_seq
        for name in c.pool_fields:
            mine = getattr(c, name)[:-1]           # without the spare row
            whole = all_gather_bytes(mine, group).view(mine.dtype)
            setattr(c, name, _with_spare(
                whole.reshape((-1,) + tuple(mine.shape[1:]))))
    return paged
