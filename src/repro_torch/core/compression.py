"""Communication-compression operators (paper §5 / Appendix C).

The paper's workhorse is the unbiased p-norm b-bit stochastic quantizer
(Theorem 3):

    Q_p(x) = (||x||_p * sign(x) * 2^{-(b-1)}) .* floor( 2^{b-1} |x| / ||x||_p + u )

with u ~ Uniform[0,1]^d, applied blockwise (block = 512, b = 2).

Every operator implements the flat-layout wire protocol of the flat
engines, on the kernels' blocked ``(n_agents, nb, block)`` f32 buffers
(zero-padded past the logical per-agent dimension ``dim``):

    encode_blocks(buf, dim, ...) -> (payload, bits)
        payload: dict of tensors with leading agent axis n - exactly what
        crosses agents; bits: 0-d f32 tensor, bits per agent on the wire
        this step, counted from the payload (data-dependent for RandK and
        approximate TopK).
    decode_blocks(payload) -> (n, nb, block) f32 decoded estimate.

The kernels carry the wire: the p=inf quantizer encodes with
``kernels.quantize.encode`` (K4) and every quantizer decodes with
``kernels.quantize.decode`` (K2); RandK keeps with
``kernels.sparsify.randk_encode`` (K5); TopK applies its exact-k mask with
``kernels.sparsify.mask_apply`` (K6).  The p != inf quantizer is plain
torch, as the reference leaves it to XLA outside Pallas.

Every operator also has the reference's per-agent tree path, over one
agent's array of any shape (the tree algorithms of core/lead.py and
core/baselines.py):

    compress(x, **draws)    -> xhat
    encode(x, **draws)      -> (payload, spec)
    decode(payload, spec)   -> xhat
    compress_agents(X, **draws)  the same for a stack of agents (row i of
                                 X is agent i's array), one kernel pass for
                                 all of them: the reference's vmapped
                                 compress

On the card the p=inf quantizer's compress is K4 then K2 on each agent's
(ceil(size/block), block) block matrix, RandK's is K5, TopK's is K6 on the
tie-stable exact-k mask; the p != inf quantizer encodes in plain torch.

Randomness.  The reference draws RandK's and the p != inf quantizer's
uniforms, and approximate TopK's sample indices, from threefry keys, which
torch cannot reproduce.  So each ``encode_blocks`` here takes its random
input explicitly: ``u``, a (n, dim) f32 plane of U[0, 1) draws for the
logical elements (the quantizers and RandK), or ``idx``, the (n, m) int64
sample indices (approximate TopK).  The flat engines supply them from their
own counter-hash stream (engines/base.py).  The tree path takes its draws
(``u``: the quantizer's dither over each agent's block matrix, RandK's
uniforms over the agent's array; none for TopK and Identity) through one
replaceable function, ``agent_draws``, which ``compress_each`` calls: the
counter hash ``fast_uniform`` seeded with the step's seed.  The parity
tests replace ``agent_draws`` (or the engine's ``_draws``) to inject the
reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.stage_timer import mark
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.quantize import DEFAULT_BLOCK
from repro_torch.kernels.sparsify import mask_apply, randk_encode
from repro_torch.utils.tree import tree_flatten, tree_unflatten

_MASK32 = 0xFFFFFFFF


def _mix32(z: int) -> int:
    """murmur3's 32-bit finalizer, on the host."""
    z &= _MASK32
    z ^= z >> 16
    z = (z * 0x85EBCA6B) & _MASK32
    z ^= z >> 13
    z = (z * 0xC2B2AE35) & _MASK32
    return z ^ (z >> 16)


def sub_seed(seed: int, j: int) -> int:
    """The uint32 seed of substream j of `seed` (a run's iteration j, a
    pytree's leaf j)."""
    return _mix32(_mix32(seed) * 0x9E3779B9 + j)


def fast_uniform(shape, seed, device: DeviceLike = None) -> torch.Tensor:
    """Counter-based U[0,1) dither: the murmur3-style integer finalizer of
    ``src/repro/core/engines/base.py::fast_uniform`` over an iota, keyed by
    a uint32 seed (an int, or a 0-d integer tensor on the target device).
    Bit for bit the reference's stream: the uint32 arithmetic runs in int64
    masked to 32 bits (int64 products wrap modulo 2^64, so their low 32 bits
    are the uint32 product's).  Updates in place to hold the temporaries
    to two int64 planes."""
    m = 1
    for s in shape:
        m *= int(s)
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64)
        dev = seed.device
    else:
        dev = resolve_device(device)
        s = torch.full((), int(seed) & _MASK32, dtype=torch.int64, device=dev)
    z = torch.arange(m, dtype=torch.int64, device=dev)
    z += (s * 0x9E3779B9) & _MASK32
    z &= _MASK32
    z *= 0x85EBCA6B
    z &= _MASK32
    z ^= z >> 13
    z *= 0xC2B2AE35
    z &= _MASK32
    z ^= z >> 16
    z >>= 8
    # top 24 bits -> [0, 1) with full f32 mantissa coverage
    u = z.to(torch.float32)
    del z
    return u.mul_(1.0 / (1 << 24)).reshape(shape)


def rel_err(q: torch.Tensor, target: torch.Tensor,
            ref: torch.Tensor) -> torch.Tensor:
    """||q - target|| / ||ref||: relative compression error of a transmitted
    message `target` with estimate `q`, normalized by the pre-communication
    iterate `ref` that carries it (the Trace comp_err convention)."""
    return (torch.linalg.vector_norm((q - target).reshape(-1))
            / (torch.linalg.vector_norm(ref.reshape(-1)) + 1e-12))


def _is_inf(p) -> bool:
    return p in (math.inf, "inf")


def _pnorm(x: torch.Tensor, p, axis=-1, keepdims=True) -> torch.Tensor:
    if _is_inf(p):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdims)
    return torch.sum(torch.abs(x) ** p, dim=axis,
                     keepdim=keepdims) ** (1.0 / p)


def _stochastic_quantize(blocks: torch.Tensor, u: torch.Tensor, bits: int,
                         p):
    """The paper's p-norm b-bit stochastic quantize step (Thm 3), blockwise
    over the LAST axis, in the plain torch of the reference's formula.
    Returns (code int8, scale f32), shapes (..., block) / (..., 1)."""
    blocks = blocks.to(torch.float32)
    scale = _pnorm(blocks, p)
    safe = torch.where(scale > 0, scale, 1.0)
    lvl = torch.floor((2.0 ** (bits - 1)) * torch.abs(blocks) / safe + u)
    # levels live in [0, 2^{b-1}] (the upper end is reached when |x| ==
    # scale and u -> 1), which fits b bits alongside the sign
    lvl = torch.clamp_max(lvl, 2.0 ** (bits - 1))
    code = (torch.sign(blocks) * lvl).to(torch.int8)
    return code, torch.where(scale > 0, scale, 0.0).to(torch.float32)


def _nb_logical(dim: int, block: int) -> int:
    return -(-dim // block)


def _flat_to_rows(buf: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, ...) blocked -> (n, dim): drop the padding past the logical dim
    (a view)."""
    n = buf.shape[0]
    return buf.reshape(n, -1)[:, :dim]


def _rows_to_flat(rows: torch.Tensor, nb: int, block: int,
                  value: float = 0.0) -> torch.Tensor:
    """(n, dim) -> (n, nb, block) f32, padded with `value` past dim (a view
    when there is nothing to pad and rows is contiguous f32)."""
    n, dim = rows.shape
    rows = rows.to(torch.float32)
    pad = nb * block - dim
    if pad:
        rows = F.pad(rows, (0, pad), value=value)
    return rows.reshape(n, nb, block)


def _agent_rows(X: torch.Tensor, block: int, value: float = 0.0):
    """Each agent's array of X (n, ...) flattened and padded to whole
    blocks: (n * ceil(size/block), block) f32, one kernel call for all
    agents."""
    rows = X.reshape(X.shape[0], -1)
    return _rows_to_flat(rows, _nb_logical(rows.shape[1], block), block,
                         value).reshape(-1, block)


def _agents_from_rows(rows: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Inverse of _agent_rows: the agents' arrays of `shape` in `dtype`,
    the padding dropped."""
    return _flat_to_rows(rows.reshape(shape[0], -1),
                         math.prod(shape[1:])).reshape(shape).to(dtype)


_SCAN_CHUNK = 1024       # chunk of _first_true's count


def _first_true(mask: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """mask (n, d) bool, budget (n, 1) int -> the first budget[i] True
    entries of each row i: mask where its running count along the row is
    at most the budget.

    Without a scan over the row (torch's scan along a few long rows runs
    on one block per row: 52 ms on 8 rows of 2^25 on an H100): the row is
    cut into chunks of _SCAN_CHUNK, the chunks whose running total stays
    within the budget (a prefix) are kept whole, and only the one chunk
    per row where the budget runs out is scanned."""
    n, d = mask.shape
    width = min(_SCAN_CHUNK, d)
    chunks = -(-d // width)
    if chunks * width > d:
        mask = F.pad(mask, (0, chunks * width - d))
    m = mask.reshape(n, chunks, width)
    total = m.sum(dim=2, dtype=torch.int32)
    upto = torch.cumsum(total, dim=1, dtype=torch.int32)
    whole = upto <= budget
    keep = m & whole[:, :, None]
    j = whole.sum(dim=1, keepdim=True).clamp_(max=chunks - 1)
    at = j[:, :, None].expand(n, 1, width)
    part = m.gather(1, at)
    left = budget - (upto.gather(1, j) - total.gather(1, j))
    part &= torch.cumsum(part, dim=2, dtype=torch.int32) <= left[:, :, None]
    keep.scatter_(1, at, part)
    return keep.reshape(n, chunks * width)[:, :d]


def _bits(value, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class QuantizePNorm:
    """Unbiased blockwise p-norm b-bit stochastic quantizer (paper Thm 3).

    bits:  total bits per element for the integer code (paper uses 2).
    p:     norm order; inf is the paper's choice.
    block: block size for the blockwise application (paper uses 512).
    """
    bits: int = 2
    p: float = math.inf
    block: int = 512

    def __post_init__(self):
        # codes live in [-(2^{b-1}), 2^{b-1}] and are stored in int8 lanes:
        # bits <= 7 keeps the top level representable (the paper uses 2).
        if not 1 <= self.bits <= 7:
            raise ValueError("int8 code container supports bits in [1, 7]")

    def wire_bits(self, n_elements: int) -> float:
        # b bits of code per element + a sign bit + one f32 scale per block
        nb = -(-n_elements // self.block)
        return n_elements * (self.bits + 1) + nb * 32

    # -- tree path ---------------------------------------------------------
    def draw_shape(self, shape) -> tuple:
        """Shape of one agent's dither for an array of `shape`: its block
        matrix (ceil(size/block), block), as the reference draws it."""
        size = 1
        for s in shape:
            size *= int(s)
        return (_nb_logical(size, self.block), self.block)

    def _encode_agents(self, X: torch.Tensor, u: torch.Tensor):
        """X: (n, ...) agents, u: (n, nb, block) dither -> code int8
        (n, nb, block), scale f32 (n, nb, 1): each agent's array flattened
        and zero-padded to its block matrix (a padded element is zero, so
        its code is 0 whatever its dither); p=inf encodes with K4."""
        n = X.shape[0]
        blocks = _agent_rows(X, self.block)
        if _is_inf(self.p):
            code, scale = _q.encode(blocks, u.reshape(-1, self.block),
                                    bits=self.bits)
        else:
            code, scale = _stochastic_quantize(blocks, u.reshape(
                -1, self.block), self.bits, self.p)
        return (code.reshape(n, -1, self.block), scale.reshape(n, -1, 1))

    def _decode_agents(self, code, scale, shape, dtype):
        """scale * 2^(1-b) * code (K2), back to the agents' `shape`."""
        rows = _q.decode(code.reshape(-1, self.block), scale.reshape(-1, 1),
                         bits=self.bits)
        return _agents_from_rows(rows, shape, dtype)

    def compress_agents(self, X: torch.Tensor, u: torch.Tensor):
        """Each agent's encode then decode: one K4 and one K2 pass for all
        agents (p=inf).  X: (n, ...), u: (n, nb, block) U[0, 1)."""
        code, scale = self._encode_agents(X, u)
        mark("encode")
        out = self._decode_agents(code, scale, X.shape, X.dtype)
        mark("decode")
        return out

    def compress(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One agent's xhat; u: (nb, block) U[0, 1) (draw_shape)."""
        return self.compress_agents(x[None], u[None])[0]

    def encode(self, x: torch.Tensor, u: torch.Tensor):
        """({"code": (nb, block) int8, "scale": (nb, 1) f32}, spec)."""
        code, scale = self._encode_agents(x[None], u[None])
        spec = {"n": x.numel(), "shape": tuple(x.shape), "dtype": x.dtype}
        return {"code": code[0], "scale": scale[0]}, spec

    def decode(self, payload: dict, spec: dict) -> torch.Tensor:
        return self._decode_agents(payload["code"], payload["scale"],
                                   (1,) + spec["shape"], spec["dtype"])[0]

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int, u: torch.Tensor):
        """buf: (n, nb, block) f32, zero-padded past dim; u: (n, dim) f32
        uniforms for the logical elements (zero-padded here: a padded
        element is zero, so its code is 0 whatever its dither).  p=inf
        encodes with K4; any other p with the plain formula."""
        n, nb, block = buf.shape
        if block != self.block:
            raise ValueError(f"buffer block {block} != quantizer block "
                             f"{self.block}")
        ub = _rows_to_flat(u, nb, block)
        if _is_inf(self.p):
            code, scale = _q.encode(buf.reshape(n * nb, block),
                                    ub.reshape(n * nb, block),
                                    bits=self.bits)
            code, scale = code.reshape(n, nb, block), scale.reshape(n, nb, 1)
        else:
            code, scale = _stochastic_quantize(buf, ub, self.bits, self.p)
        # the payload: (b+1)-bit codes for the dim logical elements + one
        # f32 scale per logical block (the padded tail rows never travel)
        bits = _bits(dim * (self.bits + 1)
                     + _nb_logical(dim, block) * 32, buf.device)
        return {"code": code, "scale": scale}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        """scale * 2^(1-b) * code, the receiver's decode (K2)."""
        code = payload["code"]
        rows = _q.decode(code.reshape(-1, code.shape[-1]),
                         payload["scale"].reshape(-1, 1), bits=self.bits)
        return rows.reshape(code.shape)

    def variance_constant(self, d_block: Optional[int] = None) -> float:
        """Upper bound on C in  E||x - Q(x)||^2 <= C ||x||^2  (Remark 7).

        For p=inf and blockwise application, ||x||_inf <= ||x||_2 per block so
        C <= d_block * 2^{-2(b-1)} / 4.
        """
        d = d_block if d_block is not None else self.block
        return d * (2.0 ** (-2 * (self.bits - 1))) / 4.0


@dataclasses.dataclass(frozen=True)
class TopK:
    """Biased top-k sparsifier (used in the Fig. 6 compression-error study).

    ratio: fraction of entries kept.  Index transmission costs log2(d) bits
    per kept entry (no shared-seed trick possible).

    Exactly k entries are kept, as ``jax.lax.top_k`` keeps them: every
    entry above the k-th largest magnitude, and of the entries equal to it
    the lowest-index ones, up to k in all (a threshold `|x| >= kth` alone
    would keep every tied entry, sending more than the k values wire_bits
    charges).  The same on the CPU and the card.

    approx_threshold=True switches to a sampled-quantile threshold: each
    agent samples m = sample_per_block * ceil(d/block) of its magnitudes
    (at the given indices) and keeps everything at or above the sample's
    ratio-quantile.  The kept count is then only approximately k, so the
    payload bits are counted from the actual mask.
    """
    ratio: float = 0.1
    approx_threshold: bool = False
    sample_per_block: int = 8

    def _k(self, d: int) -> int:
        return max(1, int(d * self.ratio))

    def wire_bits(self, n_elements: int) -> float:
        k = self._k(n_elements)
        return k * (32 + math.log2(max(n_elements, 2)))

    def sample_size(self, d: int) -> int:
        """m, the magnitudes each agent samples in approximate mode."""
        return min(self.sample_per_block * _nb_logical(d, DEFAULT_BLOCK), d)

    @staticmethod
    def indices_from_uniform(u: torch.Tensor, d: int) -> torch.Tensor:
        """Sample indices in [0, d) from U[0, 1) draws of any shape."""
        return (u * d).to(torch.int64).clamp_(max=d - 1)

    def _mask_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(n, d) -> boolean keep-mask with exactly k True per row, ties
        broken toward the lower index: the k-th largest magnitude t is the
        threshold, every |x| > t is kept, and of the |x| == t the first
        k - #(|x| > t) by a running count."""
        k = self._k(rows.shape[1])
        a = torch.abs(rows)
        t = torch.topk(a, k, dim=1, sorted=False).values.amin(
            dim=1, keepdim=True)
        above = a > t
        tie = a == t
        room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
        return above | _first_true(tie, room)

    def _approx_mask_rows(self, rows: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
        """(n, d) -> keep-mask from a sampled-quantile threshold: the
        (k*m/d)-th largest of each agent's m sampled magnitudes is its
        threshold, and |x| >= threshold is kept."""
        n, d = rows.shape
        m = idx.shape[1]
        rank = min(max(1, round(self._k(d) * m / d)), m)
        sample = torch.abs(torch.gather(rows, 1, idx))
        thr = torch.topk(sample, rank, dim=1).values[:, -1:]
        a = torch.abs(rows)
        # strict-positive guard: an all-zero sample row must not keep the
        # whole (zero) vector and charge d entries of wire traffic for it
        return (a >= thr) & (a > 0.0)

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int,
                      idx: Optional[torch.Tensor] = None):
        """Threshold+mask over the logical rows; the mask is applied by the
        K6 pass and the payload is the masked values in block layout (kept
        values + indices on the wire; the dense zeros are layout, not
        traffic).  Exact mode (default) takes no random input; approximate
        mode takes the (n, m) sample indices `idx`."""
        n, nb, block = buf.shape
        rows = _flat_to_rows(buf, dim)
        if self.approx_threshold:
            if idx is None:
                raise ValueError("approx_threshold=True needs the sample "
                                 "indices idx=")
            maskr = self._approx_mask_rows(rows, idx)
            bits = torch.mean(torch.sum(maskr.to(torch.float32), dim=1)) \
                * (32.0 + math.log2(max(dim, 2)))
        else:
            if idx is not None:
                raise ValueError("exact TopK takes no sample indices")
            maskr = self._mask_rows(rows)
            bits = _bits(self.wire_bits(dim), buf.device)
        mask = _rows_to_flat(maskr, nb, block)
        mark("topk_mask")
        vals = mask_apply(buf.reshape(n * nb, block),
                          mask.reshape(n * nb, block))
        return {"values": vals.reshape(n, nb, block)}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    # -- tree path ---------------------------------------------------------
    def compress_agents(self, X: torch.Tensor) -> torch.Tensor:
        """Each agent's exact top-k of its whole flattened array: the
        tie-stable mask, applied by one K6 pass for all agents."""
        mask = _agent_rows(self._mask_rows(X.reshape(X.shape[0], -1)),
                           DEFAULT_BLOCK)
        mark("topk_mask")
        vals = mask_apply(_agent_rows(X, DEFAULT_BLOCK), mask)
        mark("encode")
        return _agents_from_rows(vals, X.shape, X.dtype)

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        return self.compress_agents(x[None])[0]

    def encode(self, x: torch.Tensor):
        return {"dense": self.compress(x)}, {}

    def decode(self, payload: dict, spec: dict) -> torch.Tensor:
        return payload["dense"]

    def variance_constant(self, d_block=None):
        return None  # biased: Assumption 2 does not hold


@dataclasses.dataclass(frozen=True)
class RandK:
    """Unbiased random-k sparsifier: keep a random fraction, rescale by 1/ratio.

    With a shared PRNG seed, indices need not be transmitted (paper App. C.2).
    """
    ratio: float = 0.1
    rescale: bool = True

    def wire_bits(self, n_elements: int) -> float:
        return n_elements * self.ratio * 32

    # -- tree path ---------------------------------------------------------
    def draw_shape(self, shape) -> tuple:
        """One uniform per element: the reference's bernoulli(key, ratio,
        x.shape) is uniform(key, x.shape) < ratio."""
        return tuple(shape)

    def compress_agents(self, X: torch.Tensor, u: torch.Tensor):
        """x * (1/ratio if rescale) where u < ratio, else 0: one K5 pass
        for all agents (u padded with 1.0, never kept)."""
        vals = randk_encode(_agent_rows(X, DEFAULT_BLOCK),
                            _agent_rows(u, DEFAULT_BLOCK, value=1.0),
                            ratio=self.ratio, rescale=self.rescale)
        mark("encode")
        return _agents_from_rows(vals, X.shape, X.dtype)

    def compress(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.compress_agents(x[None], u[None])[0]

    def encode(self, x: torch.Tensor, u: torch.Tensor):
        return {"dense": self.compress(x, u)}, {}

    def decode(self, payload: dict, spec: dict) -> torch.Tensor:
        return payload["dense"]

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int, u: torch.Tensor):
        """Shared-seed mask: the keep-mask u < ratio is reproducible from
        the shared seed on both sides of the wire, so the payload is
        values-only (no indices travel - paper App. C.2).  The mask and the
        rescale are the K5 pass.  u: (n, dim) uniforms for the logical
        elements, padded here with 1.0 (>= ratio: the layout tail is never
        kept).  Bits are data-dependent: 32 per kept entry, averaged over
        agents."""
        n, nb, block = buf.shape
        ub = _rows_to_flat(u, nb, block, value=1.0)
        vals = randk_encode(buf.reshape(n * nb, block),
                            ub.reshape(n * nb, block), ratio=self.ratio,
                            rescale=self.rescale)
        bits = torch.mean(torch.sum((u < self.ratio).to(torch.float32),
                                    dim=1)) * 32.0
        return {"values": vals.reshape(n, nb, block)}, bits

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    def variance_constant(self, d_block=None):
        # E||x - Q(x)||^2 = (1/ratio - 1)||x||^2 for the rescaled variant.
        return 1.0 / self.ratio - 1.0


@dataclasses.dataclass(frozen=True)
class Identity:
    """No compression (C = 0); LEAD reduces to NIDS with gamma=1."""

    def wire_bits(self, n_elements: int) -> float:
        return n_elements * 32

    # -- tree path ---------------------------------------------------------
    def compress_agents(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def encode(self, x: torch.Tensor):
        return {"dense": x}, {}

    def decode(self, payload: dict, spec: dict) -> torch.Tensor:
        return payload["dense"]

    # -- flat-layout wire path -------------------------------------------
    def encode_blocks(self, buf: torch.Tensor, dim: int):
        return {"values": buf}, _bits(dim * 32, buf.device)

    def decode_blocks(self, payload: dict) -> torch.Tensor:
        return payload["values"]

    def variance_constant(self, d_block=None):
        return 0.0


# -- the tree path's draws and its pytree lifting ------------------------------

def agent_draws(comp, X: torch.Tensor, seed: int) -> dict:
    """The random input of ``comp.compress_agents(X, ...)``: for a
    compressor with a ``draw_shape`` (the quantizers, RandK), ``u``, U[0, 1)
    of shape (n, *draw_shape(agent array shape)) from the counter hash
    seeded `seed`, on X's device; nothing for TopK and Identity.  The one
    place the tree path draws: the parity tests replace it to hand the
    port the reference's draws."""
    draw_shape = getattr(comp, "draw_shape", None)
    if draw_shape is None:
        return {}
    shape = (X.shape[0],) + tuple(draw_shape(X.shape[1:]))
    u = fast_uniform(shape, seed, device=X.device)
    mark("dither")
    return {"u": u}


def compress_each(comp, seed: int, X: torch.Tensor) -> torch.Tensor:
    """Per-agent compression: row i of X (n, ...) is agent i's array.  The
    reference's vmapped compress, one pass per kernel for all agents, with
    the draws of ``agent_draws`` for `seed`."""
    return comp.compress_agents(X, **agent_draws(comp, X, seed))


def compress_pytree(compressor, seed: int, tree):
    """Apply a compressor leaf-wise to a pytree, leaf j seeded with
    sub_seed(seed, j)."""
    leaves, treedef = tree_flatten(tree)
    out = [compress_each(compressor, sub_seed(seed, j), leaf[None])[0]
           for j, leaf in enumerate(leaves)]
    return tree_unflatten(treedef, out)


def estimate_C(compressor, seed: int = 0, d: int = 4096, trials: int = 64,
               device: DeviceLike = None) -> float:
    """Monte-Carlo estimate of the contraction constant C (Assumption 2):
    the largest ||x - Q(x)||^2 / ||x||^2 over `trials` standard normal
    vectors of dimension d, drawn from a torch.Generator seeded `seed`, all
    compressed in one compress_each."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    X = torch.randn((trials, d), generator=gen, dtype=torch.float32,
                    device=dev)
    Xh = compress_each(compressor, sub_seed(seed, 1), X)
    vals = torch.sum((X - Xh) ** 2, dim=1) / torch.sum(X ** 2, dim=1)
    return float(torch.max(vals))
