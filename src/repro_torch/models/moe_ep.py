"""The MoE layer across ranks (the port of ``src/repro/models/moe_ep.py``,
plus the route that serving takes when its batch rows are split).

Two routes, each chosen by the caller through ``MoEGroups``:

* ``moe_apply_rows``: the batch's rows are split over a group (serving
  with ``dist/serve.serve_batch_spec``).  The reference's serving
  functions are one GSPMD program, so sharding the batch does not change
  what they compute: the MoE routes the whole batch, its capacity counted
  over every token.  Here each rank all-gathers its (B_loc, S, d) input
  over the group (the rows are contiguous blocks in rank order, so the
  gathered tensor is the global batch in its order), runs
  ``moe.moe_apply`` on it, and keeps its rows.  That replication is the
  cost the expert-parallel route exists to avoid.

* ``moe_apply_ep``: the manual expert-parallel dispatch over (ep, tp)
  groups, step for step the reference's ``_moe_ep_body`` on
  ``torch.distributed``:

    1. the rank's E / ep experts, with their full d_ff;
    2. routing: the rank's d / tp columns of the router product,
       all-reduced over tp (the same logits on every tp rank), softmax,
       top-k, the gates renormalised;
    3. hop 1 over ep (``all_to_all_single``): each (token, choice) sent,
       in its d / tp columns, to the rank that holds its expert, in fixed
       (ep, C_s, d / tp) buffers with its expert id and a valid flag;
    4. each received pair's slot within its expert (capacity C_e), then
       the Ulysses all-to-all over tp that turns the d-split (E_loc, C_e,
       d / tp) buffer into the rank's C_e / tp slots at full d, and the
       expert SwiGLU on them;
    5. the reverse transpose over tp, hop 2 back to the token owners, and
       the combine with the gates; the d / tp columns of the output are
       all-gathered over tp, since every tp rank holds the whole residual.

  The capacities are the reference's, counted on the rank's own tokens:
  C_s = max(tp, int(cf T k / ep) // tp * tp) slots per destination rank
  and C_e = max(tp, int(cf ep C_s / E_loc) // tp * tp) per local expert,
  pairs beyond them dropped (``_slots``); ``seq_chunk`` routes the
  sequence in chunks, the capacities per chunk.  With no groups (ep =
  tp = 1) it is the reference's on a (1, 1) mesh.

  Weights: every rank holds every weight (``dist/serve`` replicates the
  params, as the reference's ``make_prefill`` does) and slices its expert
  block and its router columns locally, so the reference's all-gather of
  the f-split expert weights over tp is a local slice here, and its
  ``optimization_barrier`` has no counterpart.  The aux loss is 0, as the
  reference's.

Collectives run only where a group is given, a one-rank group included,
in the same order on every rank.  Serving runs them under no_grad.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import all_gather_bytes
from repro_torch.models import moe as moe_mod


class MoEGroups(NamedTuple):
    """The process groups an MoE layer runs over (None: one process).

    rows: the group over which the batch's rows are split; the plain MoE
    then routes the whole batch (``moe_apply_rows``).  ep, tp: the
    expert-parallel and tensor-parallel groups of ``moe_apply_ep``."""
    rows: Optional[object] = None
    ep: Optional[object] = None
    tp: Optional[object] = None


def _size_rank(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def moe_apply_rows(p, x: torch.Tensor, group, *, top_k: int,
                   capacity_factor: float = 1.25, seq_chunk: int = 0):
    """``moe.moe_apply`` of the whole batch whose rows [r B_loc, (r + 1)
    B_loc) lie on rank r of `group`: (the rank's rows of the output, the
    whole batch's aux loss)."""
    n, r = _size_rank(group)
    rows = x.shape[0]
    whole = all_gather_bytes(x, group).view(x.dtype).reshape(
        (n * rows,) + tuple(x.shape[1:]))
    out, aux = moe_mod.moe_apply(p, whole, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 seq_chunk=seq_chunk)
    return out[r * rows:(r + 1) * rows], aux


def _slots(ids: torch.Tensor, n_bins: int, cap: int):
    """Each element's slot within its bin, in order, and whether it is
    kept (slot < cap).  An id outside [0, n_bins) gets slot -1 and is not
    kept.  Slots are clipped to [0, cap - 1], as the reference's."""
    oh = F.one_hot(torch.clamp(ids, 0, n_bins), n_bins + 1)[:, :n_bins]
    slot = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1
    keep = (slot >= 0) & (slot < cap)
    return torch.clamp(slot, 0, cap - 1), keep


def _a2a(t: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over `group` along dim 0 in equal blocks: block j
    goes to rank j, and the result holds rank i's block for this rank at
    block i.  Without a group, `t` itself."""
    if group is None:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _to_tokens(buf: torch.Tensor, tp) -> torch.Tensor:
    """The Ulysses transpose: (E_loc, C, d / tp) with this rank's d
    columns -> (E_loc, C / tp, d): this rank's block of the slots at full
    d (the reference's all_to_all over tp, split axis 1, concat axis 2)."""
    if tp is None:
        return buf
    n = dist.get_world_size(tp)
    E, C, dl = buf.shape
    recv = _a2a(buf.reshape(E, n, C // n, dl).transpose(0, 1), tp)
    return recv.reshape(n, E, C // n, dl).permute(1, 2, 0, 3) \
        .reshape(E, C // n, n * dl)


def _to_columns(out: torch.Tensor, tp) -> torch.Tensor:
    """The reverse of ``_to_tokens``: (E_loc, C / tp, d) -> (E_loc, C,
    d / tp) (split axis 2, concat axis 1)."""
    if tp is None:
        return out
    n = dist.get_world_size(tp)
    E, Cn, d = out.shape
    recv = _a2a(out.reshape(E, Cn, n, d // n).permute(2, 0, 1, 3), tp)
    return recv.reshape(n, E, Cn, d // n).transpose(0, 1) \
        .reshape(E, n * Cn, d // n)


def _gather_columns(out: torch.Tensor, tp) -> torch.Tensor:
    """(B, S, d / tp) on each tp rank -> (B, S, d) on every one."""
    if tp is None:
        return out
    n = dist.get_world_size(tp)
    parts = all_gather_bytes(out, tp).view(out.dtype) \
        .reshape((n,) + tuple(out.shape))
    return parts.permute(1, 2, 0, 3).reshape(
        tuple(out.shape[:2]) + (n * out.shape[2],))


def _ep_chunk(xc, router, wg, wu, wd, *, top_k, cap, ep, tp):
    """One chunk (Bc, Sc, d / tp) of the rank's tokens through the
    dispatch (the reference's ``one_chunk``); its d / tp output columns."""
    nsh, _ = _size_rank(ep)
    ntp, _ = _size_rank(tp)
    E_loc = wg.shape[0]
    Bc, Sc, d_loc = xc.shape
    T = Bc * Sc
    xt = xc.reshape(T, d_loc)
    dev, dtype = xc.device, xc.dtype

    # 2. routing (the same on every tp rank)
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    if tp is not None:
        dist.all_reduce(logits, group=tp)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = moe_mod.top_k_of(probs, top_k)                 # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    dest = torch.div(eid, E_loc, rounding_mode="floor").reshape(T * top_k)
    e_in = torch.remainder(eid, E_loc).reshape(T * top_k)
    tok = torch.arange(T, device=dev).repeat_interleave(top_k)

    # 3. hop 1 over ep: fixed (ep, C_s, d / tp) buffers
    C_s = max(ntp, int(cap * T * top_k / nsh) // ntp * ntp)
    slot, keep = _slots(dest, nsh, C_s)
    row = dest * C_s + slot
    send_x = torch.zeros((nsh * C_s, d_loc), dtype=dtype, device=dev) \
        .index_add(0, row, torch.where(keep[:, None], xt[tok], 0.0))
    send_e = torch.zeros(nsh * C_s, dtype=torch.int64, device=dev) \
        .scatter_reduce(0, row, torch.where(keep, e_in, 0), "amax")
    send_v = torch.zeros(nsh * C_s, dtype=torch.float32, device=dev) \
        .scatter_reduce(0, row, keep.to(torch.float32), "amax")
    rx, re, rv = _a2a(send_x, ep), _a2a(send_e, ep), _a2a(send_v, ep)

    # 4. slots per local expert, the Ulysses transpose, the expert FFN
    C_e = max(ntp, int(cap * nsh * C_s / E_loc) // ntp * ntp)
    valid = rv > 0
    eslot, ekeep = _slots(torch.where(valid, re, E_loc), E_loc, C_e)
    ekeep = ekeep & valid
    erow = re * C_e + eslot
    buf = torch.zeros((E_loc * C_e, d_loc), dtype=dtype, device=dev) \
        .index_add(0, erow, torch.where(ekeep[:, None], rx, 0.0)) \
        .reshape(E_loc, C_e, d_loc)
    buf_t = _to_tokens(buf, tp)
    g = torch.bmm(buf_t, wg.to(dtype))
    u = torch.bmm(buf_t, wu.to(dtype))
    out_t = torch.bmm(F.silu(g) * u, wd.to(dtype))          # (E, C / tp, d)
    out_buf = _to_columns(out_t, tp).reshape(E_loc * C_e, d_loc)

    # 5. back to the token owners, combined with the gates
    back = _a2a(out_buf[erow] * ekeep[:, None].to(dtype), ep)
    vals = back[row] * keep[:, None].to(dtype)
    w = gate.reshape(T * top_k).to(dtype)
    return moe_mod.combine(vals * w[:, None], T, top_k).reshape(Bc, Sc, d_loc)


def moe_apply_ep(p, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float = 1.25, ep_group=None,
                 tp_group=None, seq_chunk: int = 0):
    """Drop-in for ``moe.moe_apply`` on the serving path: x (B_loc, S, d),
    this rank's rows (every tp rank of an ep index holds the same rows)
    -> (out (B_loc, S, d), aux 0).  p holds every expert; the rank uses
    its block of E / ep and its d / tp router columns."""
    B, S, d = x.shape
    nsh, r_ep = _size_rank(ep_group)
    ntp, r_tp = _size_rank(tp_group)
    E = p["router"].shape[1]
    if E % nsh or d % ntp:
        raise ValueError(f"moe_apply_ep: {E} experts over ep {nsh}, d_model "
                         f"{d} over tp {ntp}")
    E_loc, d_loc = E // nsh, d // ntp
    cols = slice(r_tp * d_loc, (r_tp + 1) * d_loc)
    mine = slice(r_ep * E_loc, (r_ep + 1) * E_loc)
    weights = (p["router"][cols], p["w_gate"][mine], p["w_up"][mine],
               p["w_down"][mine])
    kw = dict(top_k=top_k, cap=capacity_factor, ep=ep_group, tp=tp_group)
    x_loc = x[..., cols]
    if seq_chunk and S > seq_chunk and S % seq_chunk == 0:
        out = torch.cat([_ep_chunk(x_loc[:, i:i + seq_chunk], *weights, **kw)
                         for i in range(0, S, seq_chunk)], dim=1)
    else:
        out = _ep_chunk(x_loc, *weights, **kw)
    return (_gather_columns(out, tp_group),
            torch.zeros((), dtype=torch.float32, device=x.device))


__all__ = ["MoEGroups", "moe_apply_ep", "moe_apply_rows"]
