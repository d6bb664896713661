"""The block-stack language model, training path (the port of
``src/repro/models/transformer.py``), for every family of the reference.

A model is a stack of blocks driven by ``cfg.block_pattern``:

    attn / global   causal full attention (chunked online softmax) + MLP
                    or MoE (``n_experts``: models/moe.py)
    local           sliding-window attention + MLP or MoE
    mlstm, slstm    xLSTM recurrent blocks (models/recurrent.py)
    rglru           RG-LRU recurrent block + MLP

plus, orthogonally, gated cross-attention blocks every
``cfg.cross_attn_every`` layers to a fixed memory (vlm), an encoder stack
with a cross-attention after every decoder layer (audio), and a chunked
cross-entropy that never forms the (B, S, vocab) logits at once.  This
covers all ten registry archs: granite-3-2b, qwen2-7b (QKV bias),
gemma3-12b (local and global layers), deepseek-67b, granite-moe-1b-a400m
and kimi-k2 (MoE), xlstm-1.3b (mLSTM and sLSTM), recurrentgemma-2b (RG-LRU
and local attention), llama-3.2-vision-11b (gated cross-attention to the
vision stub) and whisper-tiny (audio encoder and decoder cross-attention).

The parameters are a plain pytree of tensors with the reference's dict keys
and leaf shapes: when ``n_layers`` is a multiple of the pattern's period and
larger than it, the layers are stacked into one group per pattern position
(``params["layers"]`` a tuple of dicts whose leaves carry a leading layer
axis), else they stay a tuple of per-layer dicts; ``cross_layers`` (vlm)
is then one stacked dict, ``dec_cross`` (audio) stacked by period.  The
functions take and return such pytrees, as the reference's do: the
decentralized trainer (dist/trainer.py) stacks every leaf on an agent axis
and blocks it on its own, which an ``nn.Module`` would only hide.  Weights
come from an explicit ``torch.Generator`` (the reference's threefry keys
cannot be reproduced; ``core/convert.params_from_numpy`` carries the
reference's weights over).

Entry points:
    init_params(cfg, generator=None, device=None)
    forward(params, cfg, tokens, memory=None) -> final hidden (B, S, d)
    encode_audio(params, cfg, frames)
    logits_fn(params, cfg, hidden)
    loss_fn(params, cfg, batch, chunk=512) -> (loss, metrics)
    init_cache(cfg, batch, cache_len, dtype, device)
    prefill(params, cfg, tokens, memory=None, cache_len, moe_groups=None)
        -> (logits, cache)
    decode_step(params, cfg, token, cache, moe_groups=None)
        -> (logits, cache)
    prefill_chunk(params, cfg, tokens, cache, slot, start, valid_len)
        -> (last-valid-token logits, cache)   [paged serving path]

The serving caches are updated in place (a step owns its cache).  MoE
across ranks (models/moe_ep.py): ``moe_groups`` (a ``MoEGroups``, None in
one process) names the process groups an MoE layer runs over.  With
``cfg.moe_ep_axis`` set, the full-sequence paths (``forward``,
``prefill``) take the expert-parallel all-to-all dispatch over its ep and
tp groups, as the reference's block does; decode and ``prefill_chunk``
keep the plain MoE, as the reference's do.  The plain MoE routes the
whole batch when its rows are split over the ``rows`` group.  The trainer
does not take the expert-parallel dispatch (``check_supported``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_ep
from repro_torch.models import recurrent as rec
from repro_torch.models.initializers import dense, normal, ones, zeros
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]

_ATTN_BLOCKS = ("attn", "local", "global")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError where the trainer would need what the
    port does not model yet: the expert-parallel MoE dispatch
    (``moe_ep_axis``; models/moe_ep.py), which the reference documents as
    its serving path and the port runs in ``forward`` and ``prefill``, but
    not in the decentralized trainer."""
    if cfg.moe_ep_axis:
        raise NotImplementedError(
            f"{cfg.name}: the expert-parallel MoE (moe_ep_axis="
            f"{cfg.moe_ep_axis!r}, models/moe_ep.py's all-to-all) serves; "
            "the trainer does not take it yet (see ROADMAP.md, queue 1)")


# -- init ------------------------------------------------------------------------

def _attn_init(cfg: ModelConfig, gen, device, cross: bool = False) -> Params:
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.kv_heads
    p = {
        "wq": dense(gen, d, nq * hd, device),
        "wk": dense(gen, d, nkv * hd, device),
        "wv": dense(gen, d, nkv * hd, device),
        "wo": dense(gen, nq * hd, d, device,
                    scale=(nq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            p[name] = zeros((width,), device)
    if cross:
        p["gate"] = zeros((), device)        # tanh-gated cross-attention
        p["ln_mem"] = ones(d, device)
    return p


def _mlp_init(cfg: ModelConfig, gen, d_ff: int, device) -> Params:
    d = cfg.d_model
    down = d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp_type == "swiglu":
        return {"w_gate": dense(gen, d, d_ff, device),
                "w_up": dense(gen, d, d_ff, device),
                "w_down": dense(gen, d_ff, d, device, scale=down)}
    return {"w_up": dense(gen, d, d_ff, device),
            "w_down": dense(gen, d_ff, d, device, scale=down)}


def _block_init(cfg: ModelConfig, gen, block_type: str, device) -> Params:
    d = cfg.d_model
    if block_type in _ATTN_BLOCKS:
        p = {"ln1": ones(d, device), "attn": _attn_init(cfg, gen, device),
             "ln2": ones(d, device)}
        if cfg.n_experts:
            p["moe"] = moe_mod.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                        device)
        else:
            p["mlp"] = _mlp_init(cfg, gen, cfg.d_ff, device)
        return p
    if block_type == "mlstm":
        return {"ln1": ones(d, device),
                "mlstm": rec.mlstm_init(gen, d, cfg.n_heads, device)}
    if block_type == "slstm":
        return {"ln1": ones(d, device),
                "slstm": rec.slstm_init(gen, d, cfg.n_heads, device)}
    if block_type == "rglru":
        return {"ln1": ones(d, device),
                "rglru": rec.rglru_init(gen, d, device),
                "ln2": ones(d, device),
                "mlp": _mlp_init(cfg, gen, cfg.d_ff, device)}
    raise ValueError(block_type)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _by_period(cfg: ModelConfig, per_layer: list):
    """Per-layer trees stacked into one group per pattern position when
    the layers are (n_layers a multiple of the period, larger than it),
    else the tuple of per-layer trees.  Each layer's entry of `per_layer`
    is dropped once its group is stacked, so that the stacking holds one
    group's copy at a time (gemma3-12b whole is 50.5 GB of f32)."""
    period = cfg.scan_period()
    if period and cfg.n_layers > period:
        n_per = cfg.n_layers // period
        groups = []
        for j in range(period):
            rows = [per_layer[i * period + j] for i in range(n_per)]
            for i in range(n_per):
                per_layer[i * period + j] = None
            groups.append(_stack(rows))
            del rows
        return tuple(groups)
    return tuple(per_layer)


def _xattn_init(cfg: ModelConfig, gen, device) -> Params:
    return {"ln": ones(cfg.d_model, device),
            "xattn": _attn_init(cfg, gen, device, cross=True)}


def init_params(cfg: ModelConfig, generator: torch.Generator = None,
                device: DeviceLike = None) -> Params:
    """Random weights of `cfg` on `device` ("cuda" when None; "meta" gives
    shapes only) drawn from `generator` (a torch.Generator on that device;
    None takes torch's default).  The reference's init scales: embedding
    0.02 N(0, 1), dense d_in^-1/2 N(0, 1), the output projections further
    over sqrt(2 n_layers), norms one, biases and cross-attention gates
    zero; the experts', mLSTM's, sLSTM's and RG-LRU's as in
    models/moe.py and models/recurrent.py."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    d = cfg.d_model
    params: Params = {"embed": 0.02 * normal(generator, (cfg.vocab, d), dev),
                      "final_ln": ones(d, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(generator, d, cfg.vocab, dev)
    params["layers"] = _by_period(
        cfg, [_block_init(cfg, generator, t, dev) for t in cfg.layer_types()])

    if cfg.cross_attn_every:
        cross = [_xattn_init(cfg, generator, dev)
                 for _ in range(cfg.n_layers // cfg.cross_attn_every)]
        stacked = cfg.scan_period() and cfg.n_layers > cfg.scan_period()
        params["cross_layers"] = _stack(cross) if stacked else tuple(cross)

    if cfg.encoder_layers:
        params["encoder"] = tuple(
            {"ln1": ones(d, dev), "attn": _attn_init(cfg, generator, dev),
             "ln2": ones(d, dev),
             "mlp": _mlp_init(cfg, generator, cfg.d_ff, dev)}
            for _ in range(cfg.encoder_layers))
        params["encoder_ln"] = ones(d, dev)
        # one cross-attention per decoder layer
        params["dec_cross"] = _by_period(
            cfg, [_xattn_init(cfg, generator, dev)
                  for _ in range(cfg.n_layers)])

    dtype = getattr(torch, cfg.param_dtype)
    return tree_map(lambda x: x.to(dtype), params)


# -- block application (training / full-sequence mode) --------------------------

def _rms(x, g, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g.to(torch.float32)).to(x.dtype)


def _mlp_apply(cfg, p, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_up"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


def _qkv(cfg, p, x):
    B, S, _ = x.shape
    nq, nkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(B, S, nq, hd), k.reshape(B, S, nkv, hd),
            v.reshape(B, S, nkv, hd))


def _self_attn_full(cfg, p, x, positions, block_type):
    ap = p["attn"]
    q, k, v = _qkv(cfg, ap, x)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    if block_type == "local":
        o = attn.windowed_attention(q, k, v, window=cfg.window)
    else:
        o = attn.chunked_causal_attention(q, k, v)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ ap["wo"].to(x.dtype), (k, v)


def _moe(cfg, p, h2, groups, capacity_factor, seq_chunk=0,
         expert_parallel=False):
    """The MoE layer's output on h2 (B, S, d); its aux loss is discarded,
    as in the reference's block.  expert_parallel: the all-to-all dispatch
    over groups.ep and groups.tp; else the plain dispatch, of the whole
    batch when its rows are split over groups.rows."""
    groups = groups or moe_ep.MoEGroups()
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor,
              seq_chunk=seq_chunk)
    if expert_parallel:
        mo, _ = moe_ep.moe_apply_ep(p, h2, ep_group=groups.ep,
                                    tp_group=groups.tp, **kw)
    elif groups.rows is not None:
        mo, _ = moe_ep.moe_apply_rows(p, h2, groups.rows, **kw)
    else:
        mo, _ = moe_mod.moe_apply(p, h2, **kw)
    return mo


def _block_apply(cfg, p, x, positions, block_type, collect_cache=False,
                 moe_groups=None):
    """Full-sequence application of one block -> (x, cache entry): the
    attention block's (k, v) or a recurrent block's final state when
    `collect_cache` (prefill), else None."""
    entry = None
    if block_type in _ATTN_BLOCKS:
        o, kv = _self_attn_full(cfg, p, _rms(x, p["ln1"]), positions,
                                block_type)
        x = x + o
        h2 = _rms(x, p["ln2"])
        if cfg.n_experts:
            mo = _moe(cfg, p["moe"], h2, moe_groups, cfg.capacity_factor,
                      cfg.moe_seq_chunk, expert_parallel=bool(cfg.moe_ep_axis))
        else:
            mo = _mlp_apply(cfg, p["mlp"], h2)
        return x + mo, (kv if collect_cache else None)
    h = _rms(x, p["ln1"])
    if block_type == "mlstm":
        x = x + rec.mlstm_forward(p["mlstm"], h, cfg.n_heads)
        if collect_cache:
            entry = _mlstm_final_state(cfg, p, h)
        return x, entry
    if block_type == "slstm":
        x = x + rec.slstm_forward(p["slstm"], h, cfg.n_heads)
        if collect_cache:
            entry = _slstm_final_state(cfg, p, h)
        return x, entry
    if block_type == "rglru":
        x = x + rec.rglru_forward(p["rglru"], h)
        x = x + _mlp_apply(cfg, p["mlp"], _rms(x, p["ln2"]))
        if collect_cache:
            entry = _rglru_final_state(cfg, p, h)
        return x, entry
    raise ValueError(block_type)


# recurrent final states for prefill: the recurrence run again in its decode
# form (one extra pass, on the prefill path only)

def _mlstm_final_state(cfg, p, h):
    st = rec.mlstm_init_state(h.shape[0], cfg.d_model, cfg.n_heads,
                              device=h.device)
    for t in range(h.shape[1]):
        _, st = rec.mlstm_decode(p["mlstm"], h[:, t:t + 1], st, cfg.n_heads)
    return st


def _slstm_final_state(cfg, p, h):
    st = rec.slstm_init_state(h.shape[0], cfg.d_model, device=h.device)
    for t in range(h.shape[1]):
        st = rec._slstm_cell(p["slstm"], h[:, t], st, cfg.n_heads)
    return st


def _rglru_final_state(cfg, p, h):
    bp = rec._mm(h, p["rglru"]["w_x"])
    a, gx = rec._rglru_gates(p["rglru"], rec._causal_conv(p["rglru"], bp))
    hf = rec.linear_scan(a, gx)
    cw = p["rglru"]["conv"].shape[0]
    pad = F.pad(bp, (0, 0, cw - 1, 0))
    return rec.RGLRUState(h=hf[:, -1],
                          conv_buf=pad[:, -(cw - 1):].to(torch.float32))


def _cross_attn_apply(cfg, p, x, mem_kv):
    """tanh(gate) times the attention of x's queries to the memory's
    (k, v)."""
    B, S, _ = x.shape
    q = (x @ p["xattn"]["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads,
                                                   cfg.head_dim)
    mk, mv = mem_kv
    o = attn.cross_attention(q, mk, mv).reshape(B, S, -1)
    o = o @ p["xattn"]["wo"].to(x.dtype)
    return torch.tanh(p["xattn"]["gate"]).to(x.dtype) * o


def _mem_kv(cfg, p, memory):
    """Project a (B, M, d) memory into cross-attention K/V once."""
    B, M, _ = memory.shape
    m = _rms(memory, p["xattn"]["ln_mem"])
    mk = (m @ p["xattn"]["wk"].to(m.dtype)).reshape(B, M, cfg.kv_heads,
                                                    cfg.head_dim)
    mv = (m @ p["xattn"]["wv"].to(m.dtype)).reshape(B, M, cfg.kv_heads,
                                                    cfg.head_dim)
    return mk, mv


# -- full-sequence forward + loss ------------------------------------------------

def _iter_layers(cfg: ModelConfig, params: Params):
    """Yields (layer_index, block_type, layer_params) in order, unstacking
    the stacked groups."""
    types = cfg.layer_types()
    period = cfg.scan_period()
    if period and cfg.n_layers > period:
        for i in range(cfg.n_layers // period):
            for j in range(period):
                lp = tree_map(lambda x: x[i], params["layers"][j])
                yield i * period + j, types[i * period + j], lp
    else:
        for i, t in enumerate(types):
            yield i, t, params["layers"][i]


def _cross_param(cfg, params, cross_idx):
    cl = params["cross_layers"]
    if isinstance(cl, tuple):
        return cl[cross_idx]
    return tree_map(lambda x: x[cross_idx], cl)


def _dec_cross_param(cfg, params, layer_idx):
    dc = params["dec_cross"]
    if isinstance(dc, tuple) and len(dc) == cfg.n_layers:
        return dc[layer_idx]
    # stacked by period groups
    i, j = divmod(layer_idx, cfg.scan_period())
    return tree_map(lambda x: x[i], dc[j])


def encode_audio(params, cfg, frames):
    """Whisper-style encoder over stub frame embeddings (B, F, d):
    bidirectional attention (RoPE on q and k) and the MLP per layer, then
    the encoder's final norm."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for p in params["encoder"]:
        h = _rms(x, p["ln1"])
        q, k, v = _qkv(cfg, p["attn"], h)
        q = attn.apply_rope(q, positions, cfg.rope_theta)
        k = attn.apply_rope(k, positions, cfg.rope_theta)
        o = attn.cross_attention(q, k, v)            # bidirectional, full
        x = x + o.reshape(x.shape) @ p["attn"]["wo"].to(x.dtype)
        x = x + _mlp_apply(cfg, p["mlp"], _rms(x, p["ln2"]))
    return _rms(x, params["encoder_ln"])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory=None) -> torch.Tensor:
    """tokens: (B, S) integer -> final hidden (B, S, d).

    memory: (B, M, d) stub embeddings, vision patches (vlm) or audio
    frames (audio); see data/synthetic.stub_memory.  The layers run in
    order (the reference scans the stacked groups of the families without
    cross-attention; the sums are the same).  An audio model encodes the
    frames first and cross-attends to them after every decoder layer; a
    vlm cross-attends to the memory after every cross_attn_every-th."""
    S = tokens.shape[1]
    # the embedding rows of the tokens (F.embedding: its backward on the
    # card needs no host read for a few thousand tokens)
    x = F.embedding(tokens, params["embed"].to(getattr(torch,
                                                       cfg.param_dtype)))
    positions = torch.arange(S, device=tokens.device)[None]
    enc_out = None
    if cfg.encoder_layers:
        if memory is None:
            raise ValueError(f"{cfg.name}: the audio model needs frame "
                             "embeddings (memory=)")
        enc_out = encode_audio(params, cfg, memory)
    if cfg.cross_attn_every and memory is None:
        raise ValueError(f"{cfg.name}: the vlm needs vision embeddings "
                         "(memory=)")
    cross_idx = 0
    for i, t, lp in _iter_layers(cfg, params):
        x, _ = _block_apply(cfg, lp, x, positions, t)
        if cfg.encoder_layers:
            xp = _dec_cross_param(cfg, params, i)
            x = x + _cross_attn_apply(cfg, xp, _rms(x, xp["ln"]),
                                      _mem_kv(cfg, xp, enc_out))
        if cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            cp = _cross_param(cfg, params, cross_idx)
            x = x + _cross_attn_apply(cfg, cp, _rms(x, cp["ln"]),
                                      _mem_kv(cfg, cp, memory))
            cross_idx += 1
    return _rms(x, params["final_ln"])


def _head(params, cfg, dtype):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    head = head.to(dtype)
    return head.T if cfg.tie_embeddings else head


def logits_fn(params, cfg, hidden):
    return hidden @ _head(params, cfg, hidden.dtype)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            chunk: int = 512) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked next-token cross-entropy.  batch: tokens (B, S), labels
    (B, S) [, memory (B, M, d)].  The logits are formed one sequence chunk
    at a time (the reference's chunk: the largest divisor of S up to
    `chunk`) and summed in the reference's order, chunk by chunk."""
    hidden = forward(params, cfg, batch["tokens"], memory=batch.get("memory"))
    labels = batch["labels"]
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    head = _head(params, cfg, hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        h = hidden[:, i * c:(i + 1) * c]
        l = labels[:, i * c:(i + 1) * c]
        logp = torch.log_softmax((h @ head).to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, l[..., None].to(torch.int64))[..., 0]
        total = total + torch.sum(nll)
    loss = total / (B * S)
    return loss, {"loss": loss}


# -- serving: prefill + decode ---------------------------------------------------

def _layer_cache_template(cfg: ModelConfig, t: str, batch: int,
                          cache_len: int, dtype, device):
    if t in ("attn", "global"):
        return attn.init_cache(batch, cache_len, cfg.kv_heads, cfg.head_dim,
                               dtype, device=device)
    if t == "local":
        return attn.init_cache(batch, min(cfg.window, cache_len),
                               cfg.kv_heads, cfg.head_dim, dtype,
                               rolling=True, device=device)
    if t == "mlstm":
        return rec.mlstm_init_state(batch, cfg.d_model, cfg.n_heads,
                                    device=device)
    if t == "slstm":
        return rec.slstm_init_state(batch, cfg.d_model, device=device)
    if t == "rglru":
        return rec.rglru_init_state(batch, cfg.d_model, device=device)
    raise ValueError(t)


def _mem_slots(batch, M, cfg, dtype, device, n):
    return tuple(
        tuple(torch.zeros((batch, M, cfg.kv_heads, cfg.head_dim),
                          dtype=dtype, device=device) for _ in range(2))
        for _ in range(n))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None):
    """The contiguous serving cache: {"layers": one entry per layer (a
    KVCache, or a recurrent block's state), "pos": 0-d int64} plus the
    vlm's "cross_mem" and the audio model's "enc_mem" (k, v) slots, on
    `device` ("cuda" when None)."""
    dev = resolve_device(device)
    out = {"layers": tuple(_layer_cache_template(cfg, t, batch, cache_len,
                                                 dtype, dev)
                           for t in cfg.layer_types()),
           "pos": torch.zeros((), dtype=torch.int64, device=dev)}
    if cfg.cross_attn_every:
        out["cross_mem"] = _mem_slots(batch, cfg.vis_tokens, cfg, dtype, dev,
                                      cfg.n_layers // cfg.cross_attn_every)
    if cfg.encoder_layers:
        out["enc_mem"] = _mem_slots(batch, cfg.n_audio_frames, cfg, dtype,
                                    dev, cfg.n_layers)
    return out


def _embed(params, cfg, tokens):
    return F.embedding(tokens, params["embed"].to(getattr(torch,
                                                          cfg.param_dtype)))


def prefill(params, cfg: ModelConfig, tokens, memory=None, cache_len=None,
            cache_dtype=torch.bfloat16, moe_groups=None):
    """Process a prompt (B, S) -> (last-token logits (B, 1, V), the
    populated contiguous cache at cache_len (default S), on the tokens'
    device).  The reference's ``prefill_scan`` branch computes the same
    numbers as its layer loop; here one loop serves both.  moe_groups:
    the MoE layers' process groups (module docstring)."""
    B, S = tokens.shape
    cache_len = cache_len or S
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None]
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode_audio(params, cfg, memory)
    cache = init_cache(cfg, B, cache_len, cache_dtype, tokens.device)
    layers, cross_mems, enc_mems = [], [], []
    cross_idx = 0
    for i, t, lp in _iter_layers(cfg, params):
        x, entry = _block_apply(cfg, lp, x, positions, t, collect_cache=True,
                                moe_groups=moe_groups)
        layers.append(_fill_cache(t, cache["layers"][i], entry, S))
        if cfg.encoder_layers:
            xp = _dec_cross_param(cfg, params, i)
            mem = _mem_kv(cfg, xp, enc_out)
            enc_mems.append(tuple(m.to(cache_dtype) for m in mem))
            x = x + _cross_attn_apply(cfg, xp, _rms(x, xp["ln"]), mem)
        if cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            cp = _cross_param(cfg, params, cross_idx)
            mem = _mem_kv(cfg, cp, memory)
            cross_mems.append(tuple(m.to(cache_dtype) for m in mem))
            x = x + _cross_attn_apply(cfg, cp, _rms(x, cp["ln"]), mem)
            cross_idx += 1
    cache["layers"] = tuple(layers)
    cache["pos"] = torch.full((), S, dtype=torch.int64, device=tokens.device)
    if cross_mems:
        cache["cross_mem"] = tuple(cross_mems)
    if enc_mems:
        cache["enc_mem"] = tuple(enc_mems)
    h = _rms(x[:, -1:], params["final_ln"])
    return logits_fn(params, cfg, h), cache


def _fill_cache(t, template, entry, S):
    if t in ("attn", "global"):
        k, v = entry
        L = template.k.shape[1]
        template.k[:, :min(S, L)] = k[:, :L]
        template.v[:, :min(S, L)] = v[:, :L]
        return template
    if t == "local":
        k, v = entry
        w = template.k.shape[1]
        if S >= w:
            # ring order: position p lives at slot p % w
            slots = torch.remainder(torch.arange(S - w, S, device=k.device), w)
            template.k[:, slots] = k[:, S - w:S].to(template.k.dtype)
            template.v[:, slots] = v[:, S - w:S].to(template.v.dtype)
        else:
            template.k[:, :S] = k
            template.v[:, :S] = v
        return template
    return entry                     # recurrent states pass through


def _ffn(cfg, lp, x, moe_groups=None):
    """The attention block's MLP or MoE on the residual x.  Serving routes
    MoE tokens at capacity factor 4 through the plain dispatch, as the
    reference's serving does."""
    h2 = _rms(x, lp["ln2"])
    if cfg.n_experts:
        return _moe(cfg, lp["moe"], h2, moe_groups, 4.0)
    return _mlp_apply(cfg, lp["mlp"], h2)


def prefill_chunk(params, cfg: ModelConfig, tokens, cache, slot: int,
                  start: int, valid_len: int):
    """Chunked prefill into a paged cache (serve/paged_cache.py): one
    (1, C) chunk of one sequence's prompt attends to the slot's cached pages
    and to itself (causal), and its k/v go in through the page table.  C is
    the cache's page size, so a full chunk flushes as one page and only the
    last, partial chunk (valid_len < C; its pad positions are masked by
    position) lands in the exact tail.  slot, start and valid_len are host
    ints from the scheduler.  Returns (logits of the last valid token
    (1, 1, V), the cache, updated in place)."""
    C = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(start, start + C, device=tokens.device)[None]
    for i, t, lp in _iter_layers(cfg, params):
        if t not in _ATTN_BLOCKS:
            raise ValueError(f"prefill_chunk serves attention stacks only, "
                             f"got {t!r}")
        c = cache["layers"][i]
        q, k, v = _qkv(cfg, lp["attn"], _rms(x, lp["ln1"]))
        q = attn.apply_rope(q, positions, cfg.rope_theta)
        k = attn.apply_rope(k, positions, cfg.rope_theta)
        k_past, v_past, past_pos, past_valid = c.prefill_view(slot, start)
        o = attn.chunk_attention(
            q, k, v, k_past, v_past, past_pos, past_valid, start,
            window=cfg.window if t == "local" else None)
        x = x + o.reshape(1, C, -1) @ lp["attn"]["wo"].to(x.dtype)
        x = x + _ffn(cfg, lp, x)
        c.insert_chunk(k, v, slot, start, valid_len)
    h = _rms(x[:, valid_len - 1:valid_len], params["final_ln"])
    return logits_fn(params, cfg, h), cache


def decode_step(params, cfg: ModelConfig, token, cache, memory=None,
                moe_groups=None):
    """token: (B, 1) integer; cache from init_cache / prefill (contiguous,
    a 0-d ``pos``) or serve/paged_cache.init_paged_cache (paged, ``pos``
    one position per sequence (B,): continuous batching; other keys such
    as ``active`` ride through).  Returns (logits (B, 1, V), the cache):
    the layers' caches are updated in place, the returned dict holds the
    new states of the recurrent layers and ``pos`` + 1.  moe_groups: the
    MoE layers' process groups (module docstring)."""
    B = token.shape[0]
    pos = cache["pos"]
    x = _embed(params, cfg, token)
    positions = pos[:, None] if pos.ndim == 1 else pos.expand(B, 1)
    new_layers = []
    cross_idx = 0
    for i, t, lp in _iter_layers(cfg, params):
        c = cache["layers"][i]
        h = _rms(x, lp["ln1"])
        if t in _ATTN_BLOCKS:
            q, k, v = _qkv(cfg, lp["attn"], h)
            q = attn.apply_rope(q, positions, cfg.rope_theta)
            k = attn.apply_rope(k, positions, cfg.rope_theta)
            c = attn.update_cache(c, k, v, pos)
            o = attn.decode_attention(q, c, pos)
            x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"].to(x.dtype)
            x = x + _ffn(cfg, lp, x, moe_groups)
        elif t == "mlstm":
            o, c = rec.mlstm_decode(lp["mlstm"], h, c, cfg.n_heads)
            x = x + o
        elif t == "slstm":
            o, c = rec.slstm_decode(lp["slstm"], h, c, cfg.n_heads)
            x = x + o
        elif t == "rglru":
            o, c = rec.rglru_decode(lp["rglru"], h, c)
            x = x + o
            x = x + _mlp_apply(cfg, lp["mlp"], _rms(x, lp["ln2"]))
        else:
            raise ValueError(t)
        new_layers.append(c)
        if cfg.encoder_layers:
            xp = _dec_cross_param(cfg, params, i)
            mk, mv = cache["enc_mem"][i]
            x = x + _cross_attn_apply(cfg, xp, _rms(x, xp["ln"]),
                                      (mk.to(x.dtype), mv.to(x.dtype)))
        if cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            cp = _cross_param(cfg, params, cross_idx)
            mk, mv = cache["cross_mem"][cross_idx]
            x = x + _cross_attn_apply(cfg, cp, _rms(x, cp["ln"]),
                                      (mk.to(x.dtype), mv.to(x.dtype)))
            cross_idx += 1
    new_cache = dict(cache)
    new_cache["layers"] = tuple(new_layers)
    new_cache["pos"] = pos + 1
    return logits_fn(params, cfg, _rms(x, params["final_ln"])), new_cache


__all__ = ["check_supported", "decode_step", "encode_audio", "forward",
           "init_cache", "init_params", "logits_fn", "loss_fn", "prefill",
           "prefill_chunk"]
