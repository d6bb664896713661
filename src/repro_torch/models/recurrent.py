"""Recurrent sequence mixers, training (full-sequence) forms: mLSTM and
sLSTM (xLSTM, arXiv:2405.04517) and RG-LRU (RecurrentGemma / Griffin,
arXiv:2402.19427) - the port of ``src/repro/models/recurrent.py``.

* mLSTM - chunkwise-parallel: within a chunk a quadratic attention with
  exponential-gate weights and a local stabiliser, across chunks a linear
  recurrence on the (hd x hd) matrix memory, here a Python loop over the
  chunks (the reference's ``lax.scan``), with the reference's log-space
  stabiliser ``m`` (starting at -1e30) and its ``max(|l|, exp(-m))``
  denominator.
* sLSTM - a strictly sequential exponential-gated scalar recurrence with
  the m-stabiliser: a loop over time.
* RG-LRU - the diagonal linear recurrence h_t = a_t h_{t-1} + x_t, here a
  log-depth Hillis-Steele scan (torch has no ``associative_scan``).  It
  multiplies and adds in another order than XLA's scan, so the two agree
  to a few f32 roundings per level (log2 S levels), not bit for bit.

Every ``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation.  Where
the reference leans on JAX's type promotion (a bf16 activation against an
f32 recurrent state), the operands are promoted explicitly.

Each mixer also has its decode form for serving: one step from a carried
state (``mlstm_decode``, ``slstm_decode``, ``rglru_decode``), the state
tuples (``MLSTMState``, ``SLSTMState``, ``RGLRUState``) and their empty
states (``*_init_state``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.initializers import dense, normal, ones, uniform

M0 = -1e30                       # the stabiliser's start


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """torch.einsum with the operands promoted to one dtype, as JAX
    promotes a bf16 operand against an f32 one."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _rms(x, g, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


# -- mLSTM -----------------------------------------------------------------------

def mlstm_init(gen, d_model: int, n_heads: int, device, proj_factor: int = 2):
    di = proj_factor * d_model
    hd = di // n_heads
    return {
        "w_up": dense(gen, d_model, di, device),
        "w_gate": dense(gen, d_model, di, device),
        # block-diagonal (per-head) projections, as in xLSTM
        "w_q": (hd ** -0.5) * normal(gen, (n_heads, hd, hd), device),
        "w_k": (hd ** -0.5) * normal(gen, (n_heads, hd, hd), device),
        "w_v": (hd ** -0.5) * normal(gen, (n_heads, hd, hd), device),
        "w_if": dense(gen, di, 2 * n_heads, device, scale=0.01),
        "b_if": torch.cat([torch.zeros((n_heads,), device=device),
                           3.0 * torch.ones((n_heads,), device=device)]),
        "w_down": dense(gen, di, d_model, device),
        "out_ln": ones(di, device),
    }


def _mlstm_heads(p, x, n_heads):
    """x: (B, S, d) -> xi, q, k, v: (B, S, nh, hd); i_pre, f_pre: (B, S, nh)
    f32."""
    B, S, _ = x.shape
    xi = _mm(x, p["w_up"])
    di = xi.shape[-1]
    hd = di // n_heads
    xh = xi.reshape(B, S, n_heads, hd)
    q = torch.einsum("bsnh,nhk->bsnk", xh, p["w_q"].to(x.dtype))
    k = torch.einsum("bsnh,nhk->bsnk", xh, p["w_k"].to(x.dtype)) \
        * (hd ** -0.5)
    v = torch.einsum("bsnh,nhk->bsnk", xh, p["w_v"].to(x.dtype))
    gates = _mm(xi, p["w_if"]) + p["b_if"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)
    return xi, q, k, v, i_pre.to(torch.float32), f_pre.to(torch.float32)


def mlstm_forward(p, x, n_heads: int, chunk: int = 128):
    """Chunkwise-parallel mLSTM over a full sequence x: (B, S, d).  The
    chunk G is the largest divisor of S up to `chunk`."""
    B, S, d = x.shape
    G = min(chunk, S)
    while S % G:
        G -= 1
    _, q, k, v, i_pre, f_pre = _mlstm_heads(p, x, n_heads)
    hd = q.shape[-1]
    nC = S // G

    def resh(a):
        return a.reshape(B, nC, G, *a.shape[2:])

    qc, kc, vc, ic, fc = map(resh, (q, k, v, i_pre, f_pre))
    logf = F.logsigmoid(fc)                                  # (B, nC, G, nh)
    cum = torch.cumsum(logf, dim=2)                          # inclusive
    total = cum[:, :, -1]                                    # (B, nC, nh)
    dev = x.device
    mask = torch.tril(torch.ones((G, G), dtype=torch.bool, device=dev))
    Cm = torch.zeros((B, n_heads, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((B, n_heads, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, n_heads), M0, dtype=torch.float32, device=dev)
    hs = []
    for c in range(nC):
        qb, kb, vb, ib = qc[:, c], kc[:, c], vc[:, c], ic[:, c]
        cumb, totb = cum[:, c], total[:, c]
        # intra-chunk weights A[t, s] = exp(cum_t - cum_s + i_s - m_t), s <= t
        a_q = cumb                                           # (B, G, nh)
        a_k = ib - cumb                                      # i_s - cum_s
        m_intra = torch.amax(a_k, dim=1, keepdim=True)       # (B, 1, nh)
        m_t = torch.maximum(a_q + m_intra, a_q + m[:, None])  # (B, G, nh)
        s = torch.einsum("btnh,bsnh->bnts", qb, kb)          # (B, nh, G, G)
        w = torch.exp(a_q[:, :, None] + a_k[:, None, :]
                      - m_t[:, :, None]).permute(0, 3, 1, 2)
        sw = s * torch.where(mask[None, None], w, 0.0)
        o_intra = _ein("bnts,bsnh->btnh", sw, vb)
        l_intra = sw.sum(-1).transpose(1, 2)                 # (B, G, nh)
        # inter-chunk: the carried memory's contribution (stabilised by m)
        decay_q = torch.exp(a_q + m[:, None] - m_t)          # (B, G, nh)
        o_inter = _ein("btnh,bnhj->btnj", qb, Cm) * decay_q[..., None]
        l_inter = _ein("btnh,bnh->btn", qb, n) * decay_q
        denom = torch.maximum(torch.abs(l_intra + l_inter),
                              torch.exp(-m_t))
        hs.append((o_intra + o_inter) / denom[..., None])
        # carry: C' = f_total C + sum_s exp(tot - cum_s + i_s - m') k v^T
        m_next = torch.maximum(totb + m, totb + torch.amax(a_k, dim=1))
        kw = torch.exp(totb[:, None] + a_k - m_next[:, None])  # (B, G, nh)
        f_tot = torch.exp(totb + m - m_next)
        Cm = Cm * f_tot[..., None, None] \
            + _ein("bsnh,bsnj->bnhj", kb * kw[..., None], vb)
        n = n * f_tot[..., None] + _ein("bsnh,bsn->bnh", kb, kw)
        m = m_next
    h = torch.stack(hs, dim=1).reshape(B, S, n_heads * hd)
    out = _rms(h, p["out_ln"]) * F.silu(_mm(x, p["w_gate"]))
    return _mm(out, p["w_down"]).to(x.dtype)


class MLSTMState(NamedTuple):
    C: torch.Tensor    # (B, nh, hd, hd) matrix memory
    n: torch.Tensor    # (B, nh, hd)     normaliser
    m: torch.Tensor    # (B, nh)         log-space stabiliser


def mlstm_decode(p, x, state: MLSTMState, n_heads: int):
    """x: (B, 1, d); one recurrent step -> (out (B, 1, d), new state)."""
    B = x.shape[0]
    _, q, k, v, i_pre, f_pre = _mlstm_heads(p, x, n_heads)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                      # (B, nh, hd)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                  # (B, nh)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state.m, i_pre)
    fg = torch.exp(logf + state.m - m_new)
    ig = torch.exp(i_pre - m_new)
    C = state.C * fg[..., None, None] \
        + _ein("bnh,bnj->bnhj", k * ig[..., None], v)
    n = state.n * fg[..., None] + k * ig[..., None]
    num = _ein("bnh,bnhj->bnj", q, C)
    den = torch.maximum(torch.abs(_ein("bnh,bnh->bn", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, -1)
    out = _rms(h, p["out_ln"]) * F.silu(_mm(x, p["w_gate"]))
    return _mm(out, p["w_down"]).to(x.dtype), MLSTMState(C=C, n=n, m=m_new)


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     proj_factor: int = 2, device=None) -> MLSTMState:
    hd = proj_factor * d_model // n_heads
    return MLSTMState(
        C=torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                      device=device),
        n=torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                      device=device),
        m=torch.full((batch, n_heads), M0, dtype=torch.float32,
                     device=device))


# -- sLSTM -----------------------------------------------------------------------

def slstm_init(gen, d_model: int, n_heads: int, device):
    hd = d_model // n_heads
    b = torch.zeros((4 * d_model,), dtype=torch.float32, device=device)
    b[d_model:2 * d_model] = 3.0
    return {
        "w_in": dense(gen, d_model, 4 * d_model, device),    # i, f, z, o
        "r": 0.1 * normal(gen, (n_heads, hd, 4 * hd), device),  # block-diag
        "b": b,
        "w_ffn_up": dense(gen, d_model, 4 * d_model // 3, device),
        "w_ffn_dn": dense(gen, 4 * d_model // 3, d_model, device),
        "ffn_ln": ones(d_model, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, d)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def _slstm_cell(p, xt, state, n_heads: int) -> SLSTMState:
    """xt: (B, d); state (c, n, h, m), each (B, d) f32.  The
    exponential-gated sLSTM cell with the m-stabiliser."""
    c, n, hprev, m = state
    B, d = xt.shape
    hd = d // n_heads
    rec = _ein("bnh,nhk->bnk", hprev.reshape(B, n_heads, hd), p["r"])
    # per-head (4, hd) gate groups -> gate-major (i, f, z, o) of width d
    rec = rec.reshape(B, n_heads, 4, hd).transpose(1, 2).reshape(B, 4 * d)
    pre = _mm(xt, p["w_in"]) + p["b"] + rec
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre.to(torch.float32), 4,
                                             dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    ig = torch.exp(i_pre - m_new)
    fg = torch.exp(logf + m - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = fg * c + ig * z
    n = fg * n + ig
    h = o * c / torch.clamp_min(torch.abs(n), 1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def slstm_forward(p, x, n_heads: int):
    """A loop over time; x: (B, S, d)."""
    B, S, d = x.shape
    state = slstm_init_state(B, d, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, x[:, t], state, n_heads)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    # post-FFN (factor 4/3, as in the xLSTM sLSTM block)
    y = _rms(h, p["ffn_ln"])
    return _mm(_gelu(_mm(y, p["w_ffn_up"])), p["w_ffn_dn"]).to(x.dtype)


def slstm_decode(p, x, state: SLSTMState, n_heads: int):
    """x: (B, 1, d); one step -> (out (B, 1, d), new state)."""
    new = _slstm_cell(p, x[:, 0], state, n_heads)
    y = _rms(new.h.to(x.dtype), p["ffn_ln"])
    out = _mm(_gelu(_mm(y, p["w_ffn_up"])), p["w_ffn_dn"])[:, None]
    return out.to(x.dtype), new


def slstm_init_state(batch: int, d_model: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z,
                      m=torch.full((batch, d_model), M0,
                                   dtype=torch.float32, device=device))


# -- RG-LRU ----------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, d_rnn)
    conv_buf: torch.Tensor   # (B, conv_width - 1, d) trailing conv inputs


def rglru_init(gen, d_model: int, device, conv_width: int = 4):
    d = d_model
    # Lambda so that a lies in [0.9, 0.999] (Griffin appendix): softplus^-1
    u = uniform(gen, (d,), 0.9, 0.999, device)
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    return {
        "w_x": dense(gen, d, d, device),
        "w_gate": dense(gen, d, d, device),
        "conv": 0.1 * normal(gen, (conv_width, d), device),
        "lam": lam,
        "w_r": dense(gen, d, d, device, scale=0.01),
        "w_i": dense(gen, d, d, device, scale=0.01),
        "w_out": dense(gen, d, d, device),
    }


def _rglru_gates(p, u):
    """u: (B, S, d) post-conv branch input -> (a, gated x), both f32."""
    r = torch.sigmoid(_mm(u, p["w_r"]))
    i = torch.sigmoid(_mm(u, p["w_i"]))
    # jax.nn.softplus is log(1 + e^x) everywhere (no linear cut-off)
    log_a = -8.0 * r * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * u)
    return a.to(torch.float32), gated.to(torch.float32)


def _causal_conv(p, x):
    w = p["conv"]                                            # (cw, d)
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by log2(S)
    Hillis-Steele doublings of the associative pair (a, b) -> (a1 a2,
    b1 a2 + b2)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], b[:, shift:] + a[:, shift:]
                       * b[:, :-shift]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rglru_forward(p, x):
    """The Griffin recurrent block: conv -> RG-LRU -> gate."""
    branch = _causal_conv(p, _mm(x, p["w_x"]))
    a, gx = _rglru_gates(p, branch)
    h = linear_scan(a, gx)
    h = h.to(x.dtype) * _gelu(_mm(x, p["w_gate"]))
    return _mm(h, p["w_out"])


def rglru_decode(p, x, state: RGLRUState):
    """x: (B, 1, d); one step -> (out (B, 1, d), new state)."""
    bp = _mm(x, p["w_x"])                                    # (B, 1, d)
    hist = torch.cat([state.conv_buf.to(bp.dtype), bp], dim=1)  # (B, cw, d)
    conv_out = _ein("bkd,kd->bd", hist, p["conv"])[:, None]
    a, gx = _rglru_gates(p, conv_out)
    h = a[:, 0] * state.h + gx[:, 0]
    out = _mm(h[:, None].to(x.dtype) * _gelu(_mm(x, p["w_gate"])),
              p["w_out"])
    return out, RGLRUState(h=h, conv_buf=hist[:, 1:].to(state.conv_buf.dtype))


def rglru_init_state(batch: int, d_model: int, conv_width: int = 4,
                     device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        conv_buf=torch.zeros((batch, conv_width - 1, d_model),
                             dtype=torch.float32, device=device))
