"""End-to-end example: decentralized LEAD training of a language model on
8 ranks (4 agents x 2 replicas along ``model``), heterogeneous token
streams, with a checkpoint save/restore cycle (the port of
``examples/train_lm.py``).

Launches ``launch/train.py`` twice under torchrun on a (4, 2) mesh: the
first run trains ``--steps`` steps and saves, the second restores that
checkpoint ("restored step N") and trains ``--resume-steps`` more.
Default is the reduced model; ``--full`` is granite-3-2b at its published
size (same code path, meant for 8 cards).

    # 8 processes on the CPU under gloo:
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu

    # one rank per card under NCCL, on a machine with 8:
    PYTHONPATH=src python -m repro_torch.launch.train_lm
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def commands(args):
    """The two torchrun command lines: train and save, then resume."""
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "8", "-m", "repro_torch.launch.train",
            "--mesh-shape", "4,2", "--arch", "granite-3-2b",
            "--algorithm", "lead", "--bits", "2",
            "--ckpt-dir", args.ckpt_dir, "--log-every", str(args.log_every)]
    if not args.full:
        base.append("--reduced")
    if args.device:
        base += ["--device", args.device]
    return [base + ["--steps", str(args.steps)],
            base + ["--steps", str(args.resume_steps)]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="granite-3-2b at its published size (8 cards)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--resume-steps", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "reports", "ckpt_demo"))
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    for cmd in commands(args):
        print("+", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, env=env)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
