"""Mixture-of-Experts layer: token-choice top-k routing with a capacity
(the port of ``src/repro/models/moe.py``).

The dispatch never forms the (T, E, C) one-hot tensor:

  1. router logits in f32, softmax, the top-k experts of each token and
     their gates, renormalised by their sum;
  2. each (token, expert) pair's slot within its expert from a cumulative
     sum over tokens of the (T, E) multi-hot assignment matrix;
  3. the tokens scattered (``index_add``) into a dense (E, C, d) buffer,
     pairs beyond the capacity C dropped;
  4. the batched expert SwiGLU on the buffer, (E, C, d) x (E, d, f) as
     ``torch.bmm`` (plain products: the reference has no Pallas kernel
     here either);
  5. the expert outputs gathered back and combined with the kept gate
     weights (``combine``: a fold over each token's k choices in order).

The Switch load-balancing loss is returned beside the output; the
transformer block discards it, as the reference's does.

Routing order: the top-k is a stable descending sort, so equal
probabilities keep the lower expert index first, as ``jax.lax.top_k``
does.  Probabilities that differ by an ulp between the two packages can
still swap experts at a near-tie (ROADMAP.md, queue 3).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.initializers import normal


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, device):
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": s_in * normal(gen, (d_model, n_experts), device),
        "w_gate": s_in * normal(gen, (n_experts, d_model, d_ff), device),
        "w_up": s_in * normal(gen, (n_experts, d_model, d_ff), device),
        "w_down": s_ff * normal(gen, (n_experts, d_ff, d_model), device),
    }


def combine(weighted: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """(T * k, d) weighted expert outputs, token-major -> (T, d): each
    token's k rows added in choice order.  That is the order of a
    sequential scatter-add over the tokens (the reference's, and
    ``index_add`` on the CPU, bit for bit up to the sign of a zero), and,
    unlike ``index_add``'s atomics on the card, the same order on every
    run.  ``unbind`` keeps the backward to one stack of the k gradients."""
    first, *rest = weighted.reshape(T, k, -1).unbind(1)
    out = first
    for row in rest:
        out = out + row
    return out


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: max(1, int(capacity_factor * T * top_k / E))."""
    return max(1, int(capacity_factor * n_tokens * top_k / n_experts))


def slots(expert_ids: torch.Tensor, n_experts: int, C: int):
    """Each (token, choice) pair's slot within its expert, in token order:
    (slot ids (T * k,) int64, keep (T * k,) bool, slot < C).  The top-k
    experts are distinct per token, so a cumulative sum over tokens of the
    (T, E) multi-hot assignment matrix gives each pair its slot."""
    T, k = expert_ids.shape
    multi_hot = F.one_hot(expert_ids, n_experts).sum(1)           # (T, E)
    slot_te = torch.cumsum(multi_hot, dim=0) - 1
    slot_id = torch.gather(slot_te, 1, expert_ids).reshape(T * k)
    return slot_id, slot_id < C


def top_k_of(probs: torch.Tensor, k: int):
    """The k largest probabilities of each row and their experts, as
    ``jax.lax.top_k``: a stable descending sort, so ties keep the lower
    index first."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def route(p, xt: torch.Tensor, top_k: int, capacity_factor: float):
    """Routing of xt (T, d): (probs (T, E) f32, gates (T, k) f32, expert ids
    (T, k) int64, slot ids (T * k,) int64, keep (T * k,) bool, C)."""
    T = xt.shape[0]
    E = p["router"].shape[1]
    C = capacity(T, top_k, E, capacity_factor)
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_of(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    slot_id, keep = slots(expert_ids, E, C)
    return probs, gate_vals, expert_ids, slot_id, keep, C


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              seq_chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d f32).

    seq_chunk > 0 routes the sequence in chunks of that many positions
    (when it divides S and is smaller): capacity is per chunk, and the aux
    loss is the chunks' mean."""
    B, S, d = x.shape
    if seq_chunk and S > seq_chunk and S % seq_chunk == 0:
        nc = S // seq_chunk
        xc = x.reshape(B, nc, seq_chunk, d)
        aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for c in range(nc):
            out, aux = moe_apply(p, xc[:, c], top_k=top_k,
                                 capacity_factor=capacity_factor)
            aux_tot = aux_tot + aux
            outs.append(out)
        return torch.stack(outs, dim=1).reshape(B, S, d), aux_tot / nc
    E = p["router"].shape[1]
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, expert_ids, slot_id, keep, C = route(
        p, xt, top_k, capacity_factor)
    eid = expert_ids.reshape(T * top_k)
    slot = torch.clamp(slot_id, 0, C - 1)
    flat_slot = eid * C + slot          # the pair's row of (E * C, d)

    # scatter into (E, C, d): a dropped pair adds zeros to its expert's
    # last slot, as in the reference
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)
    src = torch.where(keep[:, None], xt[tok_idx], 0.0)
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device) \
        .index_add(0, flat_slot, src).reshape(E, C, d)

    # batched expert SwiGLU: (E, C, d) x (E, d, f)
    g = torch.bmm(buf, p["w_gate"].to(x.dtype))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    out_buf = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(E * C, d)

    # gather-combine
    gathered = out_buf[flat_slot]                                  # (T*k, d)
    w = (gate_vals.reshape(T * top_k) * keep).to(x.dtype)
    combined = combine(gathered * w[:, None], T, top_k)

    # Switch-style load-balance aux loss
    frac_tokens = torch.mean(
        F.one_hot(expert_ids[:, 0], E).to(torch.float32), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return combined.reshape(B, S, d), aux
