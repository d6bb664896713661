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

Not ported yet, each raising NotImplementedError (ROADMAP.md lists them in
order): the expert-parallel MoE (``moe_ep_axis``: models/moe_ep.py's
all-to-all, with the multi-card trainer) and the serving entry points
``prefill``, ``prefill_chunk``, ``decode_step`` and ``init_cache`` (with
the recurrent blocks' decode forms).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.initializers import dense, normal, ones, zeros
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]

_ATTN_BLOCKS = ("attn", "local", "global")
_ROADMAP = "see ROADMAP.md, queue 1"


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({_ROADMAP})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError where `cfg` needs what the port does not
    model yet: the expert-parallel MoE dispatch (``moe_ep_axis``)."""
    if cfg.moe_ep_axis:
        raise NotImplementedError(
            f"{cfg.name}: the expert-parallel MoE (moe_ep_axis="
            f"{cfg.moe_ep_axis!r}, models/moe_ep.py's all-to-all) comes with "
            "the multi-card trainer (see ROADMAP.md, queue 1)")


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


def _by_period(cfg: ModelConfig, per_layer):
    """Per-layer trees stacked into one group per pattern position when
    the layers are (n_layers a multiple of the period, larger than it),
    else the tuple of per-layer trees."""
    period = cfg.scan_period()
    if period and cfg.n_layers > period:
        n_per = cfg.n_layers // period
        return tuple(_stack([per_layer[i * period + j] for i in range(n_per)])
                     for j in range(period))
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
    return o.reshape(B, S, -1) @ ap["wo"].to(x.dtype)


def _block_apply(cfg, p, x, positions, block_type):
    """Full-sequence application of one block."""
    if block_type in _ATTN_BLOCKS:
        x = x + _self_attn_full(cfg, p, _rms(x, p["ln1"]), positions,
                                block_type)
        h2 = _rms(x, p["ln2"])
        if cfg.n_experts:
            # the aux loss is discarded, as in the reference's block
            mo, _aux = moe_mod.moe_apply(p["moe"], h2, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor,
                                         seq_chunk=cfg.moe_seq_chunk)
        else:
            mo = _mlp_apply(cfg, p["mlp"], h2)
        return x + mo
    if block_type == "mlstm":
        return x + rec.mlstm_forward(p["mlstm"], _rms(x, p["ln1"]),
                                     cfg.n_heads)
    if block_type == "slstm":
        return x + rec.slstm_forward(p["slstm"], _rms(x, p["ln1"]),
                                     cfg.n_heads)
    if block_type == "rglru":
        x = x + rec.rglru_forward(p["rglru"], _rms(x, p["ln1"]))
        return x + _mlp_apply(cfg, p["mlp"], _rms(x, p["ln2"]))
    raise ValueError(block_type)


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
    check_supported(cfg)
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
        x = _block_apply(cfg, lp, x, positions, t)
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


def _serving(name):
    def entry(*args, **kwargs):
        raise _unported(f"the serving entry point {name}")
    entry.__name__ = name
    entry.__doc__ = f"Serving's {name}: not ported yet ({_ROADMAP})."
    return entry


prefill = _serving("prefill")
prefill_chunk = _serving("prefill_chunk")
decode_step = _serving("decode_step")
init_cache = _serving("init_cache")

__all__ = ["check_supported", "decode_step", "encode_audio", "forward",
           "init_cache", "init_params", "logits_fn", "loss_fn", "prefill",
           "prefill_chunk"]
