"""The port's checkpoints (src/repro_torch/checkpoint) on the CPU: the
reference's file format in both directions, the loud failures, a faulted
run across 2 ranks resumed bit for bit, and launch/train.py's
``--ckpt-dir`` under torchrun and in one process.  Across the 2 ranks, no
save or restore creates a tensor with more than the rank's rows of a leaf
(rank 0 stages the whole tree in host arrays only), a file written through
the layout equals the one-process file of the same tree, and bf16 leaves
(stored as f32) come back bit for bit.

Setting: granite-3-2b ``.reduced()``, 4 agents, batch 2 x seq 32 (as
tests/test_torch_trainer.py).  The rank processes (this file run as a
script: one gloo group on a ``FileStore`` under tmp_path, one torch thread
each) and the torchrun launch start when the module does and run beside
its in-process tests.

    PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint.py
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_trainer import A, BATCH, SEQ

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300
RESUME_STEPS, KILLED_AT = 8, 4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


# -- what save and restore stage -------------------------------------------

class RowSpy:
    """The largest leading dimension of any tensor made inside the with
    block: every op's outputs (a TorchDispatchMode) and torch.from_numpy's.
    Meta tensors (shapes only, no data) are not counted."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        spy, self.most = self, 0

        def seen(t):
            if isinstance(t, torch.Tensor) and t.ndim and not t.is_meta:
                spy.most = max(spy.most, int(t.shape[0]))
            elif isinstance(t, (tuple, list)):
                for x in t:
                    seen(x)
            return t

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return seen(func(*args, **(kwargs or {})))

        self._from_numpy = torch.from_numpy
        torch.from_numpy = lambda a: seen(self._from_numpy(a))
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        torch.from_numpy = self._from_numpy


def _bf16_state(seed=3):
    """A whole train state with every algo leaf in bf16, one leaf holding
    +-0, +-inf, the smallest subnormal and the largest finite bf16."""
    from repro_torch.utils.tree import tree_map

    state = _randomized(_port_state(0), seed)
    algo = tree_map(lambda l: l.to(torch.bfloat16), state.algo)
    first = algo["h"]["embed"].reshape(-1)
    first[:6] = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                              2.0 ** -133, 3.3895e38]).to(torch.bfloat16)
    return state._replace(algo=algo)


def _bits(tree):
    """Every leaf's bytes, bf16 leaves reinterpreted as int16."""
    from repro_torch.utils.tree import tree_leaves
    return [(l.view(torch.int16) if l.dtype == torch.bfloat16 else l)
            .contiguous().numpy().tobytes() for l in tree_leaves(tree)]


# -- the rank side: a faulted run, uninterrupted and resumed ------------------------

def _digest(state):
    import hashlib

    from repro_torch.utils.tree import tree_leaves
    h = hashlib.sha256()
    for l in tree_leaves((state.params, state.algo, state.opt, state.step)):
        h.update(l.contiguous().numpy().tobytes())
    return h.hexdigest()


def resume_main(out_dir, rank):
    """LEAD 2-bit under 15% link drops (the reference's
    faulted_checkpoint_resume) on 4 agents over 2 ranks: RESUME_STEPS steps
    straight, then the same run killed after KILLED_AT (saved, the state
    dropped, a fresh state of another seed restored from the file) and
    finished; both runs' final states saved for the test."""
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.core.faults import FaultModel
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.dist.sharding import train_batch_rows
    from repro_torch.dist.trainer import (DistConfig, init_train_state,
                                          layout_of, make_train_step)
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "resume.store"),
                                     2), rank=rank, world_size=2)
    try:
        mesh = make_mesh((2, 1))
        cfg = get_config("granite-3-2b").reduced()
        dc = DistConfig(algorithm="lead",
                        faults=FaultModel(seed=11, link_drop=0.15))
        lay = layout_of(cfg, mesh, A)
        step = make_train_step(cfg, A, dc, "cpu", mesh=mesh)
        ds = LMStreamConfig(vocab=cfg.vocab, seq_len=SEQ,
                            batch_per_agent=BATCH, n_agents=A)

        def run(state, lo, hi):
            dropped = 0.0
            for i in range(lo, hi):
                b = train_batch_rows(lay, lm_batch(ds, i, device="cpu"))
                state, m = step(state, b, 0, step=i)
                dropped += float(m["dropped_links"])
            return state, dropped

        def fresh(seed):
            return init_train_state(cfg, A, dc,
                                    torch.Generator().manual_seed(seed),
                                    "cpu", mesh=mesh)

        staged = []

        def save(name, at, state):
            with RowSpy() as spy:
                ckpt.save(os.path.join(out_dir, name), at, state, layout=lay)
            staged.append(spy.most)

        def restore(name, like):
            with RowSpy() as spy:
                out = ckpt.restore(os.path.join(out_dir, name), like,
                                   layout=lay)
            staged.append(spy.most)
            return out

        straight, dropped = run(fresh(0), 0, RESUME_STEPS)
        save("straight", RESUME_STEPS, straight)
        killed, _ = run(fresh(0), 0, KILLED_AT)
        save("killed", KILLED_AT, killed)
        del killed
        other = fresh(1)
        resumed, at = restore("killed", other)
        restored_fresh = _digest(resumed) != _digest(other)
        resumed, _ = run(resumed, at, RESUME_STEPS)
        save("resumed", RESUME_STEPS, resumed)
        # bf16 leaves through the layout: the rank's rows of one whole state
        mine = lay.rows(_bf16_state())
        save("bf16", 7, mine)
        back, _ = restore("bf16", _randomized(mine, 5))
        res = {"at": at, "dropped": dropped,
               "restored_fresh": restored_fresh,
               "same": _digest(straight) == _digest(resumed),
               "bf16_same": _bits(back) == _bits(mine),
               "staged_rows": staged,
               "first": lay.first, "local": lay.local}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"resume.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the test side ---------------------------------------------------------------

def _finish(procs, what):
    deadline = time.time() + TIMEOUT
    errs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.time(), 1))
            if p.returncode != 0:
                errs.append(out[-2000:] + err[-4000:])
            p.output = out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, f"{what}: " + "\n".join(errs)
    return [p.output for p in procs]


CLI = ["--arch", "granite-3-2b", "--reduced", "--mesh-shape", "2,1",
       "--seq-len", str(SEQ), "--batch-per-agent", str(BATCH),
       "--log-every", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The 2-rank resume world and a 2-rank torchrun of the CLI, started
    together when the module starts; each test that reads one waits."""
    out = tmp_path_factory.mktemp("ckpt_ranks")
    procs = {"resume": [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(r)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]}
    procs["torchrun"] = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--steps", "2", "--ckpt-dir", str(out / "cli")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    done = {}

    def wait(what):
        if what not in done:
            done[what] = _finish(procs.pop(what), what)
        return out, done[what]

    yield wait
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(background):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_state(seed=0, optimizer="sgd"):
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.trainer import DistConfig, init_train_state
    from repro_torch.optim.optimizers import make_optimizer

    cfg = get_config("granite-3-2b").reduced()
    dc = DistConfig(algorithm="lead", optimizer=make_optimizer(optimizer))
    return init_train_state(cfg, A, dc, torch.Generator().manual_seed(seed),
                            "cpu")


def _randomized(state, seed):
    """`state` with every floating leaf drawn anew (so no two leaves of a
    field agree) and the step set to 7."""
    from repro_torch.utils.tree import tree_map
    g = torch.Generator().manual_seed(seed)

    def draw(l):
        if not l.is_floating_point():
            return l
        return torch.randn(l.shape, generator=g, dtype=torch.float32).to(
            l.dtype)

    return state._replace(params=tree_map(draw, state.params),
                          algo=tree_map(draw, state.algo),
                          opt=tree_map(draw, state.opt),
                          step=torch.tensor(7, dtype=torch.int64))


def _numpy_tree(tree):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda l: l.numpy(), tree)


def _reference_state(port, opt_cls=None):
    """The reference's TrainState (numpy leaves; its step an int32) holding
    the port state's values."""
    from repro.dist.trainer import TrainState
    opt = port.opt
    if opt_cls is not None:
        opt = opt_cls(*_numpy_tree(tuple(opt)))
    return TrainState(params=_numpy_tree(port.params),
                      algo=_numpy_tree(port.algo),
                      opt=() if opt_cls is None else opt,
                      step=np.int32(int(port.step)))


def _equal_trees(a, b):
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) and
        np.asarray(x).dtype == np.asarray(y).dtype for x, y in zip(la, lb))


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_reference_file_restores_into_the_port(tmp_path, optimizer):
    """A file that the reference's repro.checkpoint.save writes (numpy
    leaves, in-process) restores into the port equal, leaf for leaf and
    dtype for dtype, to core/convert.train_state_from_numpy of the same
    state; LATEST names the step."""
    from repro import checkpoint as ref_ckpt
    from repro.optim.optimizers import MomentumState as RefMomentum

    from repro_torch import checkpoint as ckpt
    from repro_torch.core.convert import train_state_from_numpy

    like = _port_state(0, optimizer)
    ref_state = _reference_state(_randomized(like, 1),
                                 RefMomentum if optimizer == "momentum"
                                 else None)
    ref_ckpt.save(str(tmp_path), 7, ref_state)
    got, at = ckpt.restore(str(tmp_path), like)
    want = train_state_from_numpy(ref_state, device="cpu")
    assert at == 7 and got.step.dtype == torch.int64
    assert _equal_trees(got, want)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_port_file_restores_through_the_reference(tmp_path, optimizer):
    """A file that the port writes restores through the reference's
    load_pytree into the reference's structure, every leaf equal (the
    step cast to the reference's int32)."""
    from repro.checkpoint import load_pytree
    from repro.optim.optimizers import MomentumState as RefMomentum

    from repro_torch import checkpoint as ckpt

    state = _randomized(_port_state(0, optimizer), 2)
    path = ckpt.save(str(tmp_path), 7, state)
    like = _reference_state(_port_state(0, optimizer),
                            RefMomentum if optimizer == "momentum" else None)
    got = load_pytree(path, like)
    want = _reference_state(state, RefMomentum if optimizer == "momentum"
                            else None)
    assert np.asarray(got.step).dtype == np.int32 and int(got.step) == 7
    assert _equal_trees(got, want)


def test_bad_files_raise(tmp_path):
    """Truncated and corrupt files, a leaf-count mismatch, a target path
    the file lacks and a shape mismatch each raise ValueError naming the
    file; a missing directory restores nothing."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.utils.tree import tree_map

    state = _port_state()
    assert ckpt.restore(str(tmp_path / "none"), state) == (None, -1)
    path = ckpt.save(str(tmp_path), 3, state)
    blob = open(path, "rb").read()
    cases = {"truncated": blob[:len(blob) // 2],
             "corrupt": b"\0" * 64 + blob[64:]}
    for name, data in cases.items():
        bad = str(tmp_path / f"{name}.npz")
        with open(bad, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match="corrupt or truncated"):
            ckpt.load_pytree(bad, state)
    more = state._replace(algo={**state.algo, "extra": state.params})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_pytree(path, more)
    renamed = state._replace(algo={("z" + k): v
                                   for k, v in state.algo.items()})
    with pytest.raises(ValueError, match="absent"):
        ckpt.load_pytree(path, renamed)
    wider = state._replace(params=tree_map(
        lambda l: torch.zeros((A + 1,) + tuple(l.shape[1:]), dtype=l.dtype),
        state.params))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(path, wider)


@pytest.mark.parametrize("ranks", [1, 2])
def test_bf16_round_trip_is_bit_exact(tmp_path, background, ranks):
    """A state with bf16 leaves (stored as f32; +-0, +-inf, a subnormal and
    the largest bf16 among them) restores bit for bit: in one process, and
    through the 2-rank layout (each rank its rows); the layout's file
    equals the one-process file of the same state, leaf for leaf, dtype
    for dtype and in its path keys."""
    from repro_torch import checkpoint as ckpt

    state = _bf16_state()
    path = ckpt.save(str(tmp_path), 7, state)
    if ranks == 1:
        like = _randomized(state, 5)
        back, at = ckpt.restore(str(tmp_path), like)
        assert at == 7 and _bits(back) == _bits(state)
        with np.load(path) as z:
            assert {z[k].dtype for k in z.files if k != "__meta__"} == {
                np.dtype(np.float32), np.dtype(np.int64)}
        return
    out, _ = background("resume")
    res = [json.load(open(out / f"resume.{r}.json")) for r in range(2)]
    assert all(r["bf16_same"] for r in res), res
    with np.load(path) as one, np.load(out / "bf16" / "step_00000007.npz") \
            as two:
        assert sorted(one.files) == sorted(two.files)
        assert json.loads(one["__meta__"].item()) == \
            json.loads(two["__meta__"].item())
        for k in one.files:
            assert one[k].dtype == two[k].dtype, k
            assert np.array_equal(one[k], two[k]), k


def test_rank_checkpoint_stages_only_the_ranks_rows(background):
    """Across 2 ranks (2 agents each), no save and no restore creates a
    tensor with more than the rank's 2 rows of a leaf, on either rank: rank
    0 gathers each peer's rows into host arrays one leaf at a time, and a
    restore cuts the rank's rows on the host before they become tensors."""
    out, _ = background("resume")
    res = [json.load(open(out / f"resume.{r}.json")) for r in range(2)]
    for r in res:
        assert len(r["staged_rows"]) == 6
        assert max(r["staged_rows"]) == r["local"] == 2, r["staged_rows"]


def test_cli_checkpoint_resumes(background, capsys):
    """launch/train.py --ckpt-dir: a 2-rank torchrun run (gloo, one agent
    per rank) saves at its end, rank 0 alone printing; a one-process run of
    the same mesh restores that file ("restored step 2") and saves step 3."""
    from repro_torch.launch import train

    out, (stdout,) = background("torchrun")
    cli = out / "cli"
    assert open(cli / "LATEST").read() == "2"
    assert stdout.count("done.") == 1
    train.main([*CLI, "--steps", "1", "--ckpt-dir", str(cli)])
    printed = capsys.readouterr().out
    assert "restored step 2" in printed and "step     3" in printed
    assert open(cli / "LATEST").read() == "3"


def test_faulted_run_resumes_bit_for_bit(background):
    """The port's faulted_checkpoint_resume at world 2 (tests/dist_worker.py:
    454-503): a LEAD run under 15% link drops killed after 4 steps, saved
    (rank 0 gathers), restored into a fresh state of another seed and
    finished equals the straight 8-step run bit for bit on both ranks, and
    the two final files are equal leaf for leaf."""
    from repro_torch import checkpoint as ckpt

    out, _ = background("resume")
    res = [json.load(open(out / f"resume.{r}.json")) for r in range(2)]
    for r in res:
        assert r["at"] == KILLED_AT and r["restored_fresh"]
        assert r["dropped"] > 0 and r["same"], r
    assert [r["first"] for r in res] == [0, 2]
    like = _port_state()
    a, _ = ckpt.restore(str(out / "straight"), like)
    b, _ = ckpt.restore(str(out / "resumed"), like)
    assert int(a.step) == RESUME_STEPS and _equal_trees(a, b)


if __name__ == "__main__":
    resume_main(sys.argv[1], int(sys.argv[2]))
