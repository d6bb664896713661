#!/usr/bin/env python3
"""Why chip_smoke.py's recurrent_at_scale trains xLSTM with Adam at eta 1e-3
and scales its dual-sum bound by 0.03 / eta, measured on one NVIDIA GPU.

    PYTHONPATH=src python3 scripts/xlstm_stability.py

xlstm-1.3b at its published width cut to one pattern period (6 layers: five
mLSTM blocks and an sLSTM block), 2 agents on ring(2), LEAD on the 2-bit
p=inf wire, the heterogeneous stream at batch 2 x seq 128, seed 0 - the
phase's setting - for 11 steps under each optimizer and eta below, and
granite-moe-1b-a400m at 4 layers (moe_at_scale's model, 4 agents) under
SGD at eta 1e-3.  One JSON line per run: the mean loss over agents on
batch 0 before and after each step, grad_norm, whether the state is
finite, max |x| and the dual sum max |sum_agents d| with the leaf that
holds it.  A run stops at its first non-finite loss.

What it shows: at SGD eta 0.03 and 0.01 the xLSTM loss turns NaN within a
few steps while max |x| stays near its start (the reference's chunkwise
mLSTM divides 0 by 0 once the gate weights have grown, which
tests/test_torch_recurrent.py pins in both packages); at 1e-3 it stays
finite but hardly moves; Adam at 1e-3 lowers it.  LEAD's dual sum is 0 up
to rounding times gamma / (2 eta), so it grows as eta falls, on either
model.
"""
import dataclasses
import json
import subprocess
import sys

import torch

RUNS = (("xlstm-1.3b", 6, 2, "sgd", 0.03), ("xlstm-1.3b", 6, 2, "sgd", 0.01),
        ("xlstm-1.3b", 6, 2, "sgd", 1e-3), ("xlstm-1.3b", 6, 2, "adam", 1e-3),
        ("granite-moe-1b-a400m", 4, 4, "sgd", 1e-3))
STEPS = 11


def run(dev, arch, n_layers, agents, optimizer, eta):
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.dist.trainer import (DistConfig, agent_losses,
                                          init_train_state, make_train_step)
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=128, batch_per_agent=2,
                        n_agents=agents, seed=0)
    dc = DistConfig(algorithm="lead", hyper={"eta": eta},
                    optimizer=make_optimizer(optimizer))
    state = init_train_state(cfg, agents, dc,
                             torch.Generator(dev).manual_seed(0), dev)
    step = make_train_step(cfg, agents, dc, dev)
    b0 = lm_batch(ds, 0, device=dev)
    losses = [float(agent_losses(cfg, state.params, b0).mean())]
    norms, finite = [], True
    for i in range(STEPS):
        state, m = step(state, lm_batch(ds, i, device=dev), 0, step=i)
        norms.append(float(m["grad_norm"]))
        losses.append(float(agent_losses(cfg, state.params, b0).mean()))
        finite = all(bool(torch.isfinite(l).all())
                     for l in tree_leaves(state.params))
        if not (finite and losses[-1] == losses[-1]):
            break
    duals = [float(l.sum(0).abs().max()) for l in tree_leaves(state.algo["d"])]
    j = max(range(len(duals)), key=duals.__getitem__)
    out = {"arch": arch, "n_layers": n_layers, "agents": agents,
           "optimizer": optimizer, "eta": eta, "steps": len(norms),
           "loss_batch0": losses, "grad_norm": norms, "finite": finite,
           "max_abs_x": max(float(l.abs().max())
                            for l in tree_leaves(state.params)),
           "dual_sum_max": duals[j], "dual_sum_leaf": j}
    del state, step
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        print("xlstm_stability: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for spec in RUNS:
        print(json.dumps(run(dev, *spec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
