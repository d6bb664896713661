"""Model / run configuration schema (the port's copy of
``src/repro/configs/base.py``).

Every assigned architecture is a ModelConfig instance in its own file under
repro_torch/configs/, registered in repro_torch/configs/registry.py.  The
block_pattern field drives the block stack of repro_torch/models: the
pattern cycles over the layers (e.g. gemma3's 5 local : 1 global, recurrentgemma's
RG-LRU/RG-LRU/local-attn 1:2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""                 # citation for the config
    head_dim: Optional[int] = None   # default d_model // n_heads

    # block stack: cycles over layers.  Types:
    #   attn          full (causal) attention + MLP
    #   local         sliding-window attention + MLP
    #   global        full attention + MLP (used in local:global cycles)
    #   mlstm, slstm  xLSTM blocks (no separate MLP when d_ff == 0)
    #   rglru         RG-LRU recurrent block + MLP
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096               # sliding-window width for "local" blocks

    qkv_bias: bool = False           # qwen2
    mlp_type: str = "swiglu"         # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # process long sequences through the MoE in chunks of this many tokens
    # (0 = whole sequence at once).  Bounds the (E, C, d) dispatch buffer and
    # its collectives — see EXPERIMENTS.md §Perf (kimi prefill iteration).
    moe_seq_chunk: int = 0
    # manual all-to-all expert-parallel dispatch over this mesh axis
    # (serving path; see models/moe_ep.py and §Perf kimi log)
    moe_ep_axis: Optional[str] = None
    # scan the layer stack in prefill (uniform-attention archs only):
    # bounds per-layer transient buffers (e.g. EP weight gathers) to a
    # single instance — the §Perf kimi iteration 4 fix
    prefill_scan: bool = False

    # VLM: insert a gated cross-attention block after every k-th layer
    cross_attn_every: int = 0
    vis_tokens: int = 0              # stub vision-memory length

    # audio (enc-dec): encoder depth + stub frame-embedding count
    encoder_layers: int = 0
    n_audio_frames: int = 0

    # long-context: window used when a shape demands sub-quadratic attention
    # on an otherwise full-attention architecture (beyond-paper variant).
    long_context_window: int = 4096
    native_subquadratic: bool = False

    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    # scan layers in pattern-period groups (small HLO).  False = unrolled —
    # used by the dry-run cost pass: XLA cost_analysis counts a scan body
    # once, so an unrolled lowering is needed for true FLOP/byte totals.
    scan_layers: bool = True
    # sequence-parallel activations (beyond-paper perf): shard the residual
    # stream's sequence dim over this mesh axis between blocks (Megatron-SP
    # style) — cuts the replicated-activation footprint by the TP degree.
    seq_shard_axis: Optional[str] = None
    # general residual-stream constraint: PartitionSpec parts for (B, S, d),
    # applied between blocks (overrides seq_shard_axis when set).  Used by
    # serving to pin the batch dim to the data axis (see §Perf kimi log).
    act_spec: Optional[Tuple] = None
    # sharding profile: "default" (agents over pod x data, TP over model) or
    # "xxl" (agents over pod only; experts EP-sharded over data).
    sharding_profile: str = "default"
    # with "xxl": additionally FSDP-shard dense weights over (data, model)
    dense_fsdp: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.kv_heads, 1) == 0, "GQA group must divide"

    @property
    def is_recurrent(self) -> bool:
        return any(b in ("mlstm", "slstm", "rglru") for b in self.block_pattern)

    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block type, the pattern cycled over n_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def scan_period(self) -> int:
        """Layers are scanned in groups of one pattern period when possible
        (keeps HLO size ~n_layers/period smaller); 0 => unrolled."""
        if not self.scan_layers:
            return 0
        p = len(self.block_pattern)
        return p if self.n_layers % p == 0 else 0

    def reduced(self, n_layers: int = 2, d_model: int = 256, n_experts: int = 4,
                vocab: int = 512) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(heads, self.kv_heads if self.kv_heads < self.n_heads else heads))
        while heads % kv:
            kv -= 1
        pattern = self.block_pattern[: max(1, min(len(self.block_pattern), n_layers))]
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=d_model, n_heads=heads, kv_heads=kv,
            d_ff=0 if self.d_ff == 0 else max(4 * d_model // 3, 128),
            vocab=vocab, head_dim=d_model // heads,
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            block_pattern=pattern, window=min(self.window, 128),
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            vis_tokens=min(self.vis_tokens, 16) if self.vis_tokens else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            n_audio_frames=min(self.n_audio_frames, 32) if self.n_audio_frames else 0,
            long_context_window=128,
        )

    # -- parameter counting (for roofline MODEL_FLOPS = 6 N D) --------------
    def param_count(self) -> int:
        """Exact: the port's own init_params on the ``meta`` device (shapes
        only, no allocation)."""
        from repro_torch.models import transformer as _tfm
        from repro_torch.utils.tree import tree_leaves
        params = _tfm.init_params(self, device="meta")
        return sum(int(l.numel()) for l in tree_leaves(params))

    def active_param_count(self) -> int:
        """MoE: only top_k of n_experts active per token."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        expert_p = 3 * self.d_model * self.d_ff
        moe_layers = sum(1 for t in self.layer_types() if t in ("attn", "local", "global"))
        inactive = moe_layers * (self.n_experts - self.top_k) * expert_p
        return full - inactive

    def _attn_params(self, cross: bool = False) -> int:
        d, hd, nq, nkv = self.d_model, self.head_dim, self.n_heads, self.kv_heads
        p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias and not cross:
            p += (nq + 2 * nkv) * hd
        return p + 2 * d  # norms

    def _mlp_params(self, d_ff: int) -> int:
        if d_ff == 0:
            return 0
        mult = 3 if self.mlp_type == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _block_params(self, t: str) -> int:
        d = self.d_model
        if t in ("attn", "local", "global"):
            if self.n_experts:
                moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
                return self._attn_params() + moe + 2 * d
            return self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
        if t == "mlstm":
            # up-proj x2, qkv in inner dim, gates, down-proj (xLSTM mLSTM block)
            di = 2 * d
            return 2 * d * di + 3 * di * di // max(self.n_heads, 1) + 4 * di + di * d + 2 * d
        if t == "slstm":
            # 4 gates x (input + recurrent) per head-diag + ffn 4/3
            return 8 * d * d // max(self.n_heads, 1) * self.n_heads // self.n_heads + 8 * d * d + self._mlp_params(4 * d // 3) + 2 * d
        if t == "rglru":
            d_rnn = d  # lru width = d_model
            return 2 * d * d_rnn + 2 * d_rnn + d_rnn * d + self._mlp_params(self.d_ff) + 2 * d
        raise ValueError(t)


def with_long_context(cfg: ModelConfig) -> ModelConfig:
    """Beyond-paper variant for long_500k on full-attention archs: every
    full-attention block becomes sliding-window (long_context_window).
    Native sub-quadratic archs are returned unchanged (DESIGN.md §4)."""
    if cfg.native_subquadratic:
        return cfg
    pattern = tuple("local" if t in ("attn", "global") else t
                    for t in cfg.block_pattern)
    return dataclasses.replace(cfg, name=cfg.name + "-swa",
                               block_pattern=pattern,
                               window=cfg.long_context_window)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
