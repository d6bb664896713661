"""The block-stack language model, training path, for the dense attention
families (the port of ``src/repro/models/transformer.py``).

A model is a stack of blocks driven by ``cfg.block_pattern``:

    attn / global   causal full attention (chunked online softmax) + MLP
    local           sliding-window attention + MLP

with a chunked cross-entropy that never forms the (B, S, vocab) logits at
once.  This covers granite-3-2b, qwen2-7b (QKV bias), gemma3-12b (local and
global layers) and deepseek-67b.

The parameters are a plain pytree of tensors with the reference's dict keys
and leaf shapes: when ``n_layers`` is a multiple of the pattern's period and
larger than it, the layers are stacked into one group per pattern position
(``params["layers"]`` a tuple of dicts whose leaves carry a leading layer
axis), else they stay a tuple of per-layer dicts.  The functions take and
return such pytrees, as the reference's do: the decentralized trainer
(dist/trainer.py) stacks every leaf on an agent axis and blocks it on its
own, which an ``nn.Module`` would only hide.  Weights come from an explicit
``torch.Generator`` (the reference's threefry keys cannot be reproduced;
``core/convert.params_from_numpy`` carries the reference's weights over).

Entry points:
    init_params(cfg, generator=None, device=None)
    forward(params, cfg, tokens) -> final hidden states (B, S, d)
    logits_fn(params, cfg, hidden)
    loss_fn(params, cfg, batch, chunk=512) -> (loss, metrics)

Not ported yet, each raising NotImplementedError (ROADMAP.md lists them in
order): the MoE blocks (``n_experts``), the recurrent blocks (mlstm, slstm,
rglru), gated cross-attention (vlm), the audio encoder, and the serving
entry points ``prefill``, ``prefill_chunk``, ``decode_step`` and
``init_cache``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]

_ATTN_BLOCKS = ("attn", "local", "global")
_ROADMAP = "see ROADMAP.md, queue 1"


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"({_ROADMAP})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless every block of `cfg` is one the port
    models: dense attention blocks, no experts, no cross-attention, no
    audio encoder."""
    if cfg.n_experts:
        raise _unported(f"{cfg.name}: the MoE block ({cfg.family})")
    other = sorted(set(cfg.block_pattern) - set(_ATTN_BLOCKS))
    if other:
        raise _unported(f"{cfg.name}: the recurrent blocks {other}")
    if cfg.cross_attn_every:
        raise _unported(f"{cfg.name}: gated cross-attention (vlm)")
    if cfg.encoder_layers:
        raise _unported(f"{cfg.name}: the audio encoder")


# -- init ------------------------------------------------------------------------

def _normal(gen, shape, device) -> torch.Tensor:
    """N(0, 1) f32 of `shape`; on the meta device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=gen)


def _dense(gen, d_in, d_out, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return scale * _normal(gen, (d_in, d_out), device)


def _ones(n, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def _attn_init(cfg: ModelConfig, gen, device) -> Params:
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.kv_heads
    p = {
        "wq": _dense(gen, d, nq * hd, device),
        "wk": _dense(gen, d, nkv * hd, device),
        "wv": _dense(gen, d, nkv * hd, device),
        "wo": _dense(gen, nq * hd, d, device,
                     scale=(nq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            p[name] = torch.zeros((width,), dtype=torch.float32,
                                  device=device)
    return p


def _mlp_init(cfg: ModelConfig, gen, d_ff: int, device) -> Params:
    d = cfg.d_model
    down = d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.mlp_type == "swiglu":
        return {"w_gate": _dense(gen, d, d_ff, device),
                "w_up": _dense(gen, d, d_ff, device),
                "w_down": _dense(gen, d_ff, d, device, scale=down)}
    return {"w_up": _dense(gen, d, d_ff, device),
            "w_down": _dense(gen, d_ff, d, device, scale=down)}


def _block_init(cfg: ModelConfig, gen, block_type: str, device) -> Params:
    if block_type not in _ATTN_BLOCKS:
        raise _unported(f"the {block_type!r} block")
    d = cfg.d_model
    return {"ln1": _ones(d, device), "attn": _attn_init(cfg, gen, device),
            "ln2": _ones(d, device),
            "mlp": _mlp_init(cfg, gen, cfg.d_ff, device)}


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(cfg: ModelConfig, generator: torch.Generator = None,
                device: DeviceLike = None) -> Params:
    """Random weights of `cfg` on `device` ("cuda" when None; "meta" gives
    shapes only) drawn from `generator` (a torch.Generator on that device;
    None takes torch's default).  The reference's init scales: embedding
    0.02 N(0, 1), dense d_in^-1/2 N(0, 1), the output projections further
    over sqrt(2 n_layers), norms one, biases zero."""
    check_supported(cfg)
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    d = cfg.d_model
    params: Params = {"embed": 0.02 * _normal(generator, (cfg.vocab, d), dev),
                      "final_ln": _ones(d, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(generator, d, cfg.vocab, dev)
    layers = [_block_init(cfg, generator, t, dev) for t in cfg.layer_types()]
    period = cfg.scan_period()
    if period and cfg.n_layers > period:
        n_per = cfg.n_layers // period
        params["layers"] = tuple(
            _stack([layers[i * period + j] for i in range(n_per)])
            for j in range(period))
    else:
        params["layers"] = tuple(layers)
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


def _block_apply(cfg, p, x, positions, block_type):
    """Full-sequence application of one attention block: (x, (k, v))."""
    if block_type not in _ATTN_BLOCKS:
        raise _unported(f"the {block_type!r} block")
    h = _rms(x, p["ln1"])
    o, kv = _self_attn_full(cfg, p, h, positions, block_type)
    x = x + o
    x = x + _mlp_apply(cfg, p["mlp"], _rms(x, p["ln2"]))
    return x, kv


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


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory=None) -> torch.Tensor:
    """tokens: (B, S) integer -> final hidden (B, S, d).  The layers run in
    order (the reference scans the stacked groups; the sums are the same)."""
    check_supported(cfg)
    if memory is not None:
        raise _unported("a modality memory (vlm, audio)")
    S = tokens.shape[1]
    # the embedding rows of the tokens (F.embedding: its backward on the
    # card needs no host read for a few thousand tokens)
    x = F.embedding(tokens, params["embed"].to(getattr(torch,
                                                       cfg.param_dtype)))
    positions = torch.arange(S, device=tokens.device)[None]
    for _, t, lp in _iter_layers(cfg, params):
        x, _ = _block_apply(cfg, lp, x, positions, t)
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
    (B, S).  The logits are formed one sequence chunk at a time (the
    reference's chunk: the largest divisor of S up to `chunk`) and summed
    in the reference's order, chunk by chunk."""
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

__all__ = ["check_supported", "decode_step", "forward", "init_cache",
           "init_params", "logits_fn", "loss_fn", "prefill", "prefill_chunk"]
