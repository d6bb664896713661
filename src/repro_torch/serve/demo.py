"""Tiny deterministic LM for serving demos and tests (the port of
``src/repro/serve/demo.py``).

Quantized-KV token identity is only a meaningful claim for a model whose
greedy argmax has real margins: a random-init model's logits are noise
(top-1/top-2 gaps ~0.2) and flip under any perturbation, harmless ones
included.  ``fit_counting_lm`` trains a reduced config with Adam on
modular counting (next token = (t + 1) mod vocab), which grows the margins.
The draws come from an explicit ``torch.Generator``; the optimizer is the
port's Adam (optim/optimizers.py).
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.optim.optimizers import Adam
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def counting_batch(cfg, generator: torch.Generator, batch: int = 8,
                   seqlen: int = 48):
    """(tokens, labels) for next = (t + 1) mod vocab from random starts,
    drawn from `generator` on its device."""
    start = torch.randint(0, cfg.vocab, (batch, 1), generator=generator,
                          device=generator.device)
    seq = (start + torch.arange(seqlen + 1, device=start.device)[None]) \
        % cfg.vocab
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def counting_prompt(cfg, start: int, n: int):
    """An in-distribution prompt of length n starting at ``start``."""
    return [int((start + i) % cfg.vocab) for i in range(n)]


def fit_counting_lm(cfg, generator: torch.Generator, *, steps: int = 200,
                    batch: int = 8, seqlen: int = 48, lr: float = 5e-3,
                    device: DeviceLike = None):
    """Train ``cfg`` (a .reduced() config) on counting with Adam; returns
    (params, the last step's loss).  The weights and every batch come from
    `generator`, which must live on `device` ("cuda" when None)."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev)
    leaves, treedef = tree_flatten(params)
    opt = Adam()
    state = opt.init(leaves)
    loss = None
    for _ in range(steps):
        xs = [l.detach().requires_grad_() for l in leaves]
        loss, _ = loss_fn(tree_unflatten(treedef, xs), cfg,
                          counting_batch(cfg, generator, batch, seqlen))
        grads = torch.autograd.grad(loss, xs)
        direction, state = opt.update(list(grads), state, leaves)
        leaves = [l - lr * d for l, d in zip(leaves, direction)]
    return tree_unflatten(treedef, leaves), float(loss.detach())
