"""Deterministic synthetic language-model stream (the port of
``src/repro/data/synthetic.py``).

Decentralized training needs per-agent data with a heterogeneity knob (the
paper's homogeneous and heterogeneous settings).  Each agent draws tokens
from a mixture: with probability 0.8 a token of its own preferred block of
``block_size`` ids, else a uniform token - so in the heterogeneous setting
the local gradients disagree at the optimum, the regime where DGD-type
methods break and LEAD's gradient correction matters.

Everything is seeded and stateless: ``lm_batch(cfg, step)`` is a pure
function of (seed, step, agent), made on the device from the counter hash
of ``core/compression.py`` (``counter_bits``: 24-bit integers, the same on
the CPU and the card).  The reference draws from threefry, which torch
cannot reproduce, so the two streams agree in distribution only; the
parity tests hand both packages the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.compression import (counter_bits, fast_normal,
                                          sub_seed)
from repro_torch.device import DeviceLike, resolve_device

_PREF = 0.8                      # share of tokens from the preferred block


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab: int
    seq_len: int
    batch_per_agent: int
    n_agents: int
    heterogeneous: bool = True
    seed: int = 0
    block_size: int = 64          # preferred-token block per agent (het mode)


def _below(shape, seed: int, n: int, device) -> torch.Tensor:
    """Integers in [0, n) from 24 counter-hash bits (multiply-shift)."""
    return (counter_bits(shape, seed, device) * n) >> 24


def lm_batch(cfg: LMStreamConfig, step: int, agent: Optional[int] = None,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Batch for `agent` at `step` (or all agents stacked when agent=None),
    on `device` ("cuda" when None).

    Returns {tokens: (.., B, S), labels: (.., B, S)} int64 with labels the
    next token.  Agent a's preferred block starts at
    ``(a * block_size) % max(vocab - block_size, 1)``, as in the reference."""
    dev = resolve_device(device)

    def one(a):
        s = sub_seed(sub_seed(cfg.seed, step), a)
        shape = (cfg.batch_per_agent, cfg.seq_len + 1)
        toks = _below(shape, sub_seed(s, 0), cfg.vocab, dev)
        if cfg.heterogeneous:
            lo = (a * cfg.block_size) % max(cfg.vocab - cfg.block_size, 1)
            pref = lo + _below(shape, sub_seed(s, 1), cfg.block_size, dev)
            use_pref = counter_bits(shape, sub_seed(s, 2), dev) \
                < int(_PREF * (1 << 24))
            toks = torch.where(use_pref, pref, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    if agent is not None:
        return one(agent)
    batches = [one(a) for a in range(cfg.n_agents)]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def stub_memory(family: str, batch_shape, cfg, seed: int = 0,
                device: DeviceLike = None):
    """Pre-computed modality embeddings (the one allowed stub): vision patch
    embeddings for a vlm (M = cfg.vis_tokens), frame embeddings for audio
    (M = cfg.n_audio_frames), 0.02 N(0, 1) f32 of shape (*batch_shape, M,
    d_model) on `device` ("cuda" when None); None for the other families.

    The reference draws from threefry, which torch cannot reproduce: the
    normals here come from the counter hash (``fast_normal`` seeded with
    `seed`), so the two stubs agree in distribution only; the parity tests
    hand both packages the reference's memory."""
    if family == "vlm":
        M = cfg.vis_tokens
    elif family == "audio":
        M = cfg.n_audio_frames
    else:
        return None
    shape = (*batch_shape, M, cfg.d_model)
    return 0.02 * fast_normal(shape, seed, resolve_device(device))
