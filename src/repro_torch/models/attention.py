"""Attention for training: RoPE, grouped-query scores and values, chunked
causal attention and sliding-window attention (the training part of
``src/repro/models/attention.py``).

Plain torch matmuls and softmax, as the reference's are plain XLA: no
Pallas kernel stands behind them.  Both variants keep the reference's
chunking, so the same sums are formed in the same groups:

* ``chunked_causal_attention`` is online-softmax over kv chunks (the S x S
  score matrix is never formed), query chunk by query chunk;
* ``windowed_attention`` slices a kv band of ``chunk + window`` keys per
  query chunk, so sliding-window layers cost O(S * (window + chunk)).

GQA: kv heads are broadcast over their group of query heads inside the
einsums.  ``cross_attention`` is full (non-causal) attention to a fixed
memory: the vlm's gated cross-attention, the audio encoder's bidirectional
self-attention and its decoder's cross-attention.

The decode side serves one token per sequence against a cache:
``KVCache`` (contiguous, full or a rolling ring for sliding-window layers),
``update_cache``, ``decode_attention`` (a scalar position or one per
sequence, against a ``KVCache`` or a paged cache's ``view``),
``chunk_attention`` (one prompt chunk against a paged cache's
``prefill_view``) and ``init_cache``.  The caches are updated in place: a
serving step owns its cache and hands the same object back.  Where JAX
promotes an f32 query against a bf16 cache, the operands are cast to the
promoted dtype first (torch's einsum does not promote), and the result is
cast back to the query's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# -- RoPE ------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- grouped-query attention pieces ---------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Cq, nq, hd), k: (B, Ck, nkv, hd) -> (B, nq, Cq, Ck)."""
    B, Cq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, Cq, nkv, nq // nkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    return s.reshape(B, nq, Cq, k.shape[1])


def _gqa_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, nq, Cq, Ck), v: (B, Ck, nkv, hd) -> (B, Cq, nq, hd)."""
    B, nq, Cq, Ck = p.shape
    nkv = v.shape[2]
    pg = p.reshape(B, nkv, nq // nkv, Cq, Ck)
    o = torch.einsum("bkgqs,bskh->bqkgh", pg, v)
    return o.reshape(B, Cq, nq, v.shape[-1])


# -- chunked causal attention (full mask) ----------------------------------------

def chunked_causal_attention(q, k, v, *, chunk: int = 1024,
                             q_offset: int = 0) -> torch.Tensor:
    """Online-softmax causal attention.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd).  q position i attends to
    kv positions <= i + q_offset."""
    B, Sq, nq, hd = q.shape
    Sk = k.shape[1]
    c = min(chunk, Sq, Sk)
    while Sq % c or Sk % c:
        c -= 1
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for qi in range(Sq // c):
        q_blk = q[:, qi * c:(qi + 1) * c]
        q_pos = q_offset + qi * c + torch.arange(c, device=dev)
        m = torch.full((B, nq, c), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, nq, c), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, nq, c, hd), dtype=torch.float32, device=dev)
        for ki in range(Sk // c):
            k_blk = k[:, ki * c:(ki + 1) * c]
            v_blk = v[:, ki * c:(ki + 1) * c]
            k_pos = ki * c + torch.arange(c, device=dev)
            s = _gqa_scores(q_blk, k_blk) * scale             # (B, nq, c, c)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + _gqa_values(p, v_blk).transpose(1, 2)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                      # (B, c, nq, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def windowed_attention(q, k, v, *, window: int,
                       chunk: int = 512) -> torch.Tensor:
    """Sliding-window causal attention with banded kv slicing: each query
    chunk [t, t+c) attends only to kv [t + c - 1 - window, t + c)."""
    B, S, nq, hd = q.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    band = c + window
    scale = hd ** -0.5
    dev = q.device
    # left-pad keys by `window` so every band slice is in range
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    outs = []
    for qi in range(S // c):
        start = qi * c
        q_blk = q[:, start:start + c]
        k_blk = kp[:, start:start + band]
        v_blk = vp[:, start:start + band]
        q_pos = start + torch.arange(c, device=dev)
        k_pos = start - window + torch.arange(band, device=dev)
        s = _gqa_scores(q_blk, k_blk) * scale                 # (B, nq, c, band)
        mask = ((k_pos[None, :] <= q_pos[:, None])
                & (k_pos[None, :] > q_pos[:, None] - window - 1)
                & (k_pos[None, :] >= 0))
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(_gqa_values(p, v_blk))                    # (B, c, nq, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def cross_attention(q, mem_k, mem_v) -> torch.Tensor:
    """Full (non-causal) attention of q: (B, Sq, nq, hd) to a fixed memory
    mem_k, mem_v: (B, M, nkv, hd); the result in q's dtype.  Operands of
    two dtypes (a bf16 query against an f32 memory) are promoted, as JAX
    promotes them."""
    dt = torch.promote_types(q.dtype, mem_k.dtype)
    scale = q.shape[-1] ** -0.5
    s = _gqa_scores(q.to(dt), mem_k.to(dt)) * scale
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, mem_v.to(dt)).to(q.dtype)


# -- decode (one token, cached) ---------------------------------------------------

class KVCache:
    """k, v: (B, L, nkv, hd); L = the cache length (full) or the window
    (``rolling``: a ring buffer, position p at slot p % L)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 rolling: bool = False):
        self.k, self.v, self.rolling = k, v, rolling


def _promoted(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def decode_attention(q: torch.Tensor, cache, pos: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, nq, hd); pos: the current position, a 0-d tensor or one
    per sequence (B,).  The cache already holds the new token's k/v (see
    update_cache).  ``cache`` is a KVCache or a paged cache exposing
    ``view(pos) -> (k, v)`` and ``rolling`` (serve/paged_cache.py): the
    paged view reproduces the contiguous slot order, so both run the same
    masked softmax."""
    B = q.shape[0]
    if isinstance(cache, KVCache):
        k, v = cache.k, cache.v
    else:
        k, v = cache.view(pos if pos.ndim else pos.expand(B))
    L = k.shape[1]
    qf, kf, vf = _promoted(q, k, v)
    s = _gqa_scores(qf, kf) * q.shape[-1] ** -0.5               # (B, nq, 1, L)
    slot = torch.arange(L, device=q.device)
    posb = pos[:, None] if pos.ndim else pos                    # (B, 1) | ()
    if cache.rolling:
        # the ring holds the last L positions once pos >= L - 1
        valid = (slot <= torch.clamp_max(posb, L - 1)) | (posb >= L - 1)
    else:
        valid = slot <= posb
    valid = valid if valid.ndim == 2 else valid[None]           # (B|1, L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, vf).to(q.dtype)


def update_cache(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor):
    """Write one token's k/v (B, 1, nkv, hd) at position ``pos`` (in place;
    returns the cache).  A KVCache takes one shared 0-d position (the slot
    pos % L when rolling); a paged cache takes one per sequence (B,) and
    writes through its page table."""
    if not isinstance(cache, KVCache):
        return cache.update(k_new, v_new,
                            pos if pos.ndim else pos.expand(k_new.shape[0]))
    if pos.ndim:
        raise ValueError("a contiguous KVCache decodes at one shared pos")
    L = cache.k.shape[1]
    idx = (torch.remainder(pos, L) if cache.rolling else pos).reshape(1)
    cache.k.index_copy_(1, idx, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v_new.to(cache.v.dtype))
    return cache


def chunk_attention(q, k_chunk, v_chunk, k_past, v_past, past_pos,
                    past_valid, start: int, *, window=None) -> torch.Tensor:
    """Prefill-continuation attention for one chunk of one sequence.

    q, k_chunk, v_chunk: (1, C, nq|nkv, hd) at positions start..start+C-1;
    k_past, v_past: (1, L, nkv, hd) whose slot j holds position
    past_pos[j] (valid where past_valid[j]), as a paged cache's
    prefill_view gives them.  window=None is full causal, else the
    sliding-window band (k_pos > q_pos - window - 1) of windowed_attention.
    One softmax over the L + C keys."""
    C = q.shape[1]
    dt = q.dtype
    k = torch.cat([k_past.to(dt), k_chunk.to(dt)], 1)
    v = torch.cat([v_past.to(dt), v_chunk.to(dt)], 1)
    chunk_pos = start + torch.arange(C, device=q.device)
    k_pos = torch.cat([past_pos, chunk_pos])                     # (L + C,)
    k_valid = torch.cat([past_valid,
                         torch.ones((C,), dtype=torch.bool, device=q.device)])
    mask = k_valid[None, :] & (k_pos[None, :] <= chunk_pos[:, None])
    if window is not None:
        mask &= k_pos[None, :] > chunk_pos[:, None] - window - 1
    s = _gqa_scores(q, k) * q.shape[-1] ** -0.5                 # (1, nq, C, L+C)
    s = torch.where(mask[None, None], s, NEG_INF)
    return _gqa_values(torch.softmax(s, dim=-1), v)             # (1, C, nq, hd)


def init_cache(batch: int, length: int, nkv: int, hd: int, dtype,
               rolling: bool = False, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, length, nkv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, length, nkv, hd), dtype=dtype, device=device),
        rolling=rolling)
