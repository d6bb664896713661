"""End-to-end decentralized training driver (the port of
``src/repro/launch/train.py``): one process holding every agent, or one
process per rank of the mesh under ``torchrun``.

Examples:
    # 4 agents of the reduced granite on the CPU in one process, 50 steps:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --mesh-shape 4,1 --device cpu

    # the same with one agent per rank: 4 processes under gloo
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --mesh-shape 4,1 --device cpu

    # 4 agents x 2 replicas on 8 cards under NCCL, checkpointed (a second
    # run resumes from the directory's LATEST step):
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --reduced --mesh-shape 4,2 --ckpt-dir /path/to/ckpt

    # any registry arch: MoE, xLSTM, RG-LRU, vlm and audio too (the vlm
    # and audio batches carry data/synthetic.stub_memory's embeddings):
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --reduced --mesh-shape 4,1 --device cpu

``--mesh-shape`` is the reference's (data, model) or (pod, data, model)
grid: the agents are the product of the axes other than ``model``, and
ranks along ``model`` are replicas of their agents (the reference
replicates the weights over it).  The world size (torchrun's
``WORLD_SIZE``) must equal the product of the shape, one rank per cell,
or be 1: one process holds every agent.  Ranks run on ``cuda:LOCAL_RANK``
under NCCL, or with ``--device cpu`` under gloo; nothing switches backend
on its own.  ``--production`` / ``--multi-pod`` build the 256 / 512-rank
grid and raise unless the world matches.  ``--ckpt-dir`` saves every 100
steps and at the end and resumes from the directory's LATEST step, as the
reference's.  Rank 0 alone prints.  ``--device`` is the port's addition.
"""
import argparse
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.core import topology
from repro_torch.core.engines import ENGINES, describe
from repro_torch.data.synthetic import (LMStreamConfig, lm_batch,
                                        stub_memory)
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import train_batch_rows
from repro_torch.dist.trainer import (DistConfig, agent_losses, engine_of,
                                      init_train_state, layout_of,
                                      make_train_step)
from repro_torch.launch.mesh import AXES, make_mesh, make_production_mesh
from repro_torch.optim.optimizers import make_optimizer

CKPT_EVERY = 100


def mesh_of(spec: str):
    """The reference's mesh shape string -> ({axis: size}, agents)."""
    shape = tuple(int(x) for x in spec.split(","))
    mesh = dict(zip(AXES[len(shape)], shape))
    agents = math.prod(n for a, n in mesh.items() if a != "model")
    return mesh, agents


def start_ranks(device_arg):
    """(world, rank, device) from torchrun's environment: a world above 1
    joins the default process group, NCCL on ``cuda:LOCAL_RANK`` or gloo
    with ``--device cpu``; anything else raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world == 1:
        return 1, 0, resolve_device(device_arg)
    want = torch.device("cuda" if device_arg is None else device_arg)
    if want.type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    elif want.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        raise ValueError(f"ranks run on cuda or cpu, not {want}")
    dist.init_process_group(backend=backend)
    return world, rank, dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--mesh-shape", default="4,1",
                    help="e.g. 4,1 (data,model) or 2,2,1 (pod,data,model)")
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

    world, rank, dev = start_ranks(args.device)
    try:
        run(args, world, rank, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args, world, rank, dev):
    say = print if rank == 0 else (lambda *a, **k: None)
    if args.production or args.multi_pod:
        # make_mesh raises unless the world is the grid's 256 / 512 ranks
        rm = make_production_mesh(multi_pod=args.multi_pod)
        shape = dict(zip(rm.axis_names, rm.shape))
        A = math.prod(n for a, n in shape.items() if a != "model")
    else:
        shape, A = mesh_of(args.mesh_shape)
        rm = None
        if world > 1:
            rm = make_mesh(tuple(shape.values()), tuple(shape))
        elif shape.get("model", 1) > 1:
            # one process holds every agent once: its replicas are itself
            shape = {**shape, "model": 1}

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # eta from the CLI; every other hyper falls through to the resolved
    # engine's paper defaults
    dc = DistConfig(algorithm=args.algorithm, bits=args.bits,
                    topology=args.topology, hyper={"eta": args.eta},
                    optimizer=make_optimizer(args.optimizer))
    lay = layout_of(cfg, rm, A)
    say(f"mesh {shape} | {A} agents | {world} rank(s), {lay.local} agent(s) "
        f"each | {cfg.name} | {cfg.param_count()/1e6:.1f}M params per agent "
        f"| algorithm={args.algorithm}")
    eng = engine_of(dc, A, dev)
    if eng is None:
        say("registry: algorithm=allreduce (centralized SGD reference, "
            "mean over agents - not a decentralized engine)")
    else:
        where = (f"batch_isend_irecv rounds over {world} ranks"
                 if world > 1 else f"gathers along the agent axis on {dev}")
        say(f"registry: {describe(eng)} ({where})")

    state = init_train_state(cfg, A, dc,
                             torch.Generator(device=dev).manual_seed(0), dev,
                             mesh=rm)
    start = 0
    if args.ckpt_dir:
        restored, at = ckpt.restore(args.ckpt_dir, state, layout=lay)
        if restored is not None:
            state, start = restored, at
            say(f"restored step {start}")
    step_fn = make_train_step(cfg, A, dc, dev, mesh=rm)
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                        batch_per_agent=args.batch_per_agent, n_agents=A,
                        heterogeneous=args.heterogeneous)

    # the modality stub is the same every step (seed 0), as the reference's
    memory = stub_memory(cfg.family, (A, args.batch_per_agent), cfg,
                         device=dev)

    t0 = time.time()
    for i in range(start, start + args.steps):
        batch = lm_batch(ds, i, device=dev)
        if memory is not None:
            batch["memory"] = memory
        batch = train_batch_rows(lay, batch)
        state, metrics = step_fn(state, batch, 0, step=i)
        if (i + 1) % args.log_every == 0 or i == start:
            # the mean loss over every agent: each rank's sum, all-reduced
            loss = lay.all_sum(
                agent_losses(cfg, state.params, batch).sum().reshape(1))
            say(f"step {i+1:5d} | loss {float(loss[0]) / A:.4f} | "
                f"grad_norm {float(metrics['grad_norm']):.3f} | "
                f"{(time.time()-t0)/(i-start+1):.2f}s/step", flush=True)
        if args.ckpt_dir and (i + 1) % CKPT_EVERY == 0:
            ckpt.save(args.ckpt_dir, i + 1, state, layout=lay)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, start + args.steps, state, layout=lay)
    say("done.")


if __name__ == "__main__":
    main()
