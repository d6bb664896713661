"""End-to-end decentralized training driver, all agents on one device (the
port of ``src/repro/launch/train.py``).

Examples:
    # 4 agents of the reduced granite on the CPU, 50 steps:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --mesh-shape 4,1 --device cpu

    # any registry arch: MoE, xLSTM, RG-LRU, vlm and audio too (the vlm
    # and audio batches carry data/synthetic.stub_memory's embeddings):
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --reduced --mesh-shape 4,1 --device cpu

    # the same on the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --mesh-shape 4,1

``--mesh-shape`` keeps the reference's (data, model) or (pod, data, model)
form: the agents are the product of the axes other than ``model``, and
live on the one device as the leading tensor axis.  A model axis above 1
(tensor parallelism), ``--production``, ``--multi-pod`` and
``--ckpt-dir`` belong to later slices and raise NotImplementedError
(ROADMAP.md).  ``--device`` is the port's addition.
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import topology
from repro_torch.core.engines import ENGINES, describe
from repro_torch.data.synthetic import (LMStreamConfig, lm_batch,
                                        stub_memory)
from repro_torch.device import resolve_device
from repro_torch.dist.trainer import (DistConfig, agent_losses, engine_of,
                                      init_train_state, make_train_step)
from repro_torch.optim.optimizers import make_optimizer

_LATER = "is not ported to repro_torch yet (see ROADMAP.md, queue 1)"


def mesh_of(spec: str):
    """The reference's mesh shape string -> ({axis: size}, agents)."""
    shape = tuple(int(x) for x in spec.split(","))
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = dict(zip(axes, shape))
    if mesh.get("model", 1) > 1:
        raise NotImplementedError(f"a model axis above 1 (tensor "
                                  f"parallelism) {_LATER}")
    agents = 1
    for a, n in mesh.items():
        if a != "model":
            agents *= n
    return mesh, agents


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--mesh-shape", default="4,1",
                    help="e.g. 4,1 (data,model) or 2,2,1 (pod,data,model); "
                         "the agents all live on --device")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-agent", type=int, default=2)
    ap.add_argument("--algorithm", default="lead",
                    choices=sorted(set(ENGINES)) + ["allreduce"],
                    help="any core/engines registry algorithm, or the "
                         "centralized allreduce reference")
    ap.add_argument("--topology", default="ring",
                    choices=sorted(topology.TOPOLOGIES),
                    help="communication graph over the agents; the gossip "
                         "rounds come from its permute_rounds()")
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--eta", type=float, default=0.03)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--heterogeneous", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.production or args.multi_pod:
        raise NotImplementedError(f"the production pod mesh {_LATER}")
    if args.ckpt_dir:
        raise NotImplementedError(f"checkpointing {_LATER}")
    mesh, A = mesh_of(args.mesh_shape)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # eta from the CLI; every other hyper falls through to the resolved
    # engine's paper defaults
    dc = DistConfig(algorithm=args.algorithm, bits=args.bits,
                    topology=args.topology, hyper={"eta": args.eta},
                    optimizer=make_optimizer(args.optimizer))
    print(f"mesh {mesh} | {A} agents | {cfg.name} | "
          f"{cfg.param_count()/1e6:.1f}M params per agent | "
          f"algorithm={args.algorithm}")
    eng = engine_of(dc, A, dev)
    if eng is None:
        print("registry: algorithm=allreduce (centralized SGD reference, "
              "mean over agents - not a decentralized engine)")
    else:
        print(f"registry: {describe(eng)} (gathers along the agent axis "
              f"on {dev})")

    state = init_train_state(cfg, A, dc,
                             torch.Generator(device=dev).manual_seed(0), dev)
    step_fn = make_train_step(cfg, A, dc, dev)
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                        batch_per_agent=args.batch_per_agent, n_agents=A,
                        heterogeneous=args.heterogeneous)

    # the modality stub is the same every step (seed 0), as the reference's
    memory = stub_memory(cfg.family, (A, args.batch_per_agent), cfg,
                         device=dev)

    t0 = time.time()
    for i in range(args.steps):
        batch = lm_batch(ds, i, device=dev)
        if memory is not None:
            batch["memory"] = memory
        state, metrics = step_fn(state, batch, 0, step=i)
        if (i + 1) % args.log_every == 0 or i == 0:
            loss = float(agent_losses(cfg, state.params, batch).mean())
            print(f"step {i+1:5d} | loss {loss:.4f} | "
                  f"grad_norm {float(metrics['grad_norm']):.3f} | "
                  f"{(time.time()-t0)/(i+1):.2f}s/step", flush=True)
    print("done.")


if __name__ == "__main__":
    main()
