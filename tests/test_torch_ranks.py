"""The port's trainer across processes (torch.distributed, gloo, on the CPU)
against its one-process step, and one case against the JAX reference.

Each world is one group of rank processes (this file run as a script, one
``FileStore`` under the test's tmp_path, one torch thread each) that runs
all of its cases and writes what it measured as json; the tests read it.
The worlds, all on granite-3-2b ``.reduced()``, 4 agents, batch 2 x seq
32, 3 steps (tests/test_torch_trainer.py's setting):

    w2           the (4, 1) mesh's 4 agents over 2 ranks, 2 agents each
    w4           one agent per rank, the reference's layout; also the case
                 against the reference trainer
    w4_replicas  a (2, 2) rank grid: 2 agent ranks of 2 agents, each
                 replicated along ``model``

Bounds: the exact algorithms (NIDS, allreduce) run 3 free steps within
1e-6 of the state's scale (its largest |x|); the compressed ones take
step 1's codes and scales bit for bit, and after every step fewer than
1e-5 of the elements deviate by more than 1e-4 of the scale
(tests/test_torch_trainer.py's per-step bound, held here on the free run
from the same start, which is stricter than restarting each step from
the one-process state: the rank path sums in the one-process step's
order, so it comes out bit-identical); bits and dropped links exactly;
grad_norm within 1e-6; replicas bit-identical.

    PYTHONPATH=src python -m pytest -q tests/test_torch_ranks.py
"""
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_trainer import (A, BATCH, DEVIATE_FRAC, DEVIATE_TOL, SEQ,
                                STEPS, dist_fields, model_config)

HERE = os.path.dirname(os.path.abspath(__file__))
EXACT_GAP = 1e-6
NORM_RTOL = 1e-6
TIMEOUT = 300

CASES = {
    "lead_2bit": {"algorithm": "lead"},
    "choco_2bit": {"algorithm": "choco",
                   "hyper": {"eta": 0.03, "gamma": 0.3}},
    "nids": {"algorithm": "nids"},
    "allreduce": {"algorithm": "allreduce"},
    "lead_onepeer": {"algorithm": "lead", "topology": "onepeer"},
    "lead_interval2": {"algorithm": "lead", "topology": "interval2"},
    "lead_hier": {"algorithm": "lead", "topology": "hier"},
    "lead_drops": {"algorithm": "lead", "faults": 0.1},
    "lead_wire_pack": {"algorithm": "lead", "wire_pack": True},
}
EXACT = ("nids", "allreduce")
WORLDS = {
    "w2": {"shape": [2, 1],
           "cases": ["lead_2bit", "nids", "allreduce", "lead_onepeer",
                     "lead_hier", "lead_drops"]},
    "w4": {"shape": [4, 1], "cases": list(CASES)},
    "w4_replicas": {"shape": [2, 2],
                    "cases": ["lead_2bit", "allreduce", "lead_drops"]},
}
RANK_CASES = [(w, c) for w, spec in WORLDS.items() for c in spec["cases"]]


# -- the rank side: this file run as a script ---------------------------------------

class Spy:
    """Records, on this rank, the payload of every QuantizePNorm encode and
    what every batch_isend_irecv hands to isend (dtype, numel, bytes)."""

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.core.compression import QuantizePNorm

        self.codes, self.calls = [], []
        self._cls, self._dist = QuantizePNorm, dist
        self._encode, self._batch = QuantizePNorm.encode_blocks, \
            dist.batch_isend_irecv
        spy = self

        def encode_blocks(comp, buf, dim, u):
            payload, bits = spy._encode(comp, buf, dim, u)
            spy.codes.append((payload["code"].clone(),
                              payload["scale"].clone()))
            return payload, bits

        def batch_isend_irecv(ops):
            spy.calls.append([(str(op.tensor.dtype), op.tensor.numel(),
                               op.tensor.numel() * op.tensor.element_size())
                              for op in ops if op.op is dist.isend])
            return spy._batch(ops)

        QuantizePNorm.encode_blocks = encode_blocks
        dist.batch_isend_irecv = batch_isend_irecv
        return self

    def __exit__(self, *exc):
        self._cls.encode_blocks = self._encode
        self._dist.batch_isend_irecv = self._batch

    def take(self):
        out = (self.codes, self.calls)
        self.codes, self.calls = [], []
        return out


def _setup(spec):
    from repro_torch.configs import registry
    from repro_torch.core import compression, faults, topology
    from repro_torch.dist.trainer import DistConfig

    cfg = model_config(registry, spec)
    return cfg, DistConfig(**dist_fields(spec, topology, compression,
                                         faults))


def _fields(state):
    from repro_torch.utils.tree import tree_leaves
    out = list(tree_leaves(state.params))
    for f in sorted(state.algo):
        out += tree_leaves(state.algo[f])
    return out


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gather_rows(tree, lay, root):
    """Every block's rows of every stacked leaf of `tree`, gathered to rank
    `root` of this rank's agent group (None elsewhere)."""
    import torch.distributed as dist

    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    out = []
    for l in leaves:
        if l.ndim == 0:
            out.append(l)
            continue
        parts = ([torch.empty_like(l) for _ in lay.peers]
                 if lay.mesh.rank == root else None)
        dist.gather(l.contiguous(), parts, dst=root, group=lay.group)
        out.append(None if parts is None else torch.cat(parts))
    return tree_unflatten(treedef, out) if lay.mesh.rank == root else None


def _compare(got, want, scale=None):
    """(max |got - want| over the scale, deviating elements, total,
    identical): a state against the one-process state `want`, whose
    largest |x| is the scale unless given."""
    from repro_torch.utils.tree import tree_leaves

    if scale is None:
        scale = max(float(l.abs().max()) for l in tree_leaves(want.params))
    gap, bad, total, same = 0.0, 0, 0, True
    for g, w in zip(_fields(got), _fields(want)):
        d = (g.double() - w.double()).abs()
        gap = max(gap, float(d.max()) / scale)
        bad += int((d > DEVIATE_TOL * scale).sum())
        total += d.numel()
        same = same and torch.equal(g, w)
    return gap, bad, total, same


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _batches(cfg):
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch

    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=SEQ, batch_per_agent=BATCH,
                        n_agents=A)
    return [lm_batch(ds, i, device="cpu") for i in range(STEPS)]


def one_process_run(name):
    """The case's one-process run (no mesh): [(state, metrics)] after each
    step and step 1's payloads."""
    from repro_torch.dist.trainer import init_train_state, make_train_step

    cfg, dc = _setup(CASES[name])
    step = make_train_step(cfg, A, dc, "cpu")
    state = init_train_state(cfg, A, dc, torch.Generator().manual_seed(0),
                             "cpu")
    runs, codes0 = [], None
    with Spy() as spy:
        for i, b in enumerate(_batches(cfg)):
            state, m = step(state, b, 0, step=i)
            runs.append((state, _metrics(m)))
            if i == 0:
                codes0 = spy.take()[0]
    return runs, codes0


def _comparer(name, lay):
    """The rank of this agent group that holds case `name` against the
    one-process run: the cases take turns, so those runs spread."""
    return lay.peers[list(CASES).index(name) % len(lay.peers)]


def run_case(name, mesh, one=None):
    """One case on this rank: the rank path for STEPS steps, free; the
    case's comparer (``_comparer``) gathers its agent group's states and
    step 1's codes and holds them against `one`, the one-process run of
    the same seed, which it made beforehand.  What the tests read, as
    json."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import train_batch_rows
    from repro_torch.dist.trainer import (init_train_state, layout_of,
                                          make_train_step)

    cfg, dc = _setup(CASES[name])
    lay = layout_of(cfg, mesh, A)
    root = _comparer(name, lay)
    ranked = make_train_step(cfg, A, dc, "cpu", mesh=mesh)
    state = init_train_state(cfg, A, dc, torch.Generator().manual_seed(0),
                             "cpu", mesh=mesh)
    out = {"first": lay.first, "metrics": [], "calls": []}
    recs = []
    with Spy() as spy:
        for i, b in enumerate(_batches(cfg)):
            state, m = ranked(state, train_batch_rows(lay, b), 0, step=i)
            codes, calls = spy.take()
            out["metrics"].append(_metrics(m))
            out["calls"].append(calls)
            whole = _gather_rows(state, lay, root)
            if i == 0:
                # step 1's payload of every block, by digest
                every = [None] * len(lay.peers)
                dist.all_gather_object(every, [_digest(p) for p in codes],
                                       group=lay.group)
            if whole is None:
                continue
            s_one, m_one = one[0][i]
            gap, bad, total, same = _compare(whole, s_one)
            rec = {"gap": gap, "bad": bad, "total": total, "identical": same,
                   "metrics": m_one}
            if i == 0:
                L = lay.local
                rec["codes_identical"] = bool(one[1]) and all(
                    [_digest((c[b * L:(b + 1) * L], sc[b * L:(b + 1) * L]))
                     for c, sc in one[1]] == every[b]
                    for b in range(len(lay.peers)))
            recs.append(rec)
    out["digest"] = _digest(_fields(state))
    if recs:
        out["one"] = recs
    return out


def run_reference_case(ref_path, mesh):
    """LEAD 2-bit on ring(4), one agent per rank, each step from the
    reference trainer's state with the reference's draws injected (the
    rank's rows of each draw plane)."""
    from test_torch_trainer import CASES as REF_CASES
    from test_torch_trainer import port_batch, port_setup, port_state

    from repro_torch.dist import trainer
    from repro_torch.dist.sharding import train_batch_rows

    spec = REF_CASES["lead_2bit"]
    cfg, dc, treedef = port_setup(spec)
    lay = trainer.layout_of(cfg, mesh, A)
    out = {"steps": []}
    with np.load(ref_path) as ref:
        def draws(comp, seed, step, leaf, wire, n, dim, device, first=0):
            u = ref[f"s{step}/u/{leaf}/{0 if wire is None else wire}"]
            return {"u": torch.tensor(u[first:first + n], device=device)}

        real, trainer.leaf_draws = trainer.leaf_draws, draws
        try:
            step = trainer.make_train_step(cfg, A, dc, "cpu", mesh=mesh)
            for i in range(STEPS):
                prev = "init" if i == 0 else f"s{i - 1}"
                state = lay.rows(port_state(ref, prev, treedef))
                batch = train_batch_rows(lay, port_batch(ref, i))
                new, metrics = step(state, batch, 0, step=i)
                want = port_state(ref, f"s{i}", treedef)
                scale = max(float(l.abs().max())
                            for l in trainer.tree_leaves(want.params))
                _, bad, total, _ = _compare(new, lay.rows(want), scale)
                out["steps"].append({
                    "bad": bad, "total": total,
                    "bits": [float(ref[f"s{i}/metric/bits_per_agent"]),
                             float(metrics["bits_per_agent"])],
                    "grad_norm": [float(ref[f"s{i}/metric/grad_norm"]),
                                  float(metrics["grad_norm"])]})
        finally:
            trainer.leaf_draws = real
    return out


def rank_main(out_dir, world_name, rank, ref_path):
    import torch.distributed as dist

    from repro_torch.dist.trainer import layout_of
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    spec = WORLDS[world_name]
    world = int(np.prod(spec["shape"]))
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, f"{world_name}"
                                                  ".store"), world),
        rank=rank, world_size=world)
    try:
        mesh = make_mesh(spec["shape"])
        cfg, _ = _setup(CASES["lead_2bit"])
        lay = layout_of(cfg, mesh, A)
        # this rank's share of the one-process runs first, with no
        # collective in flight, then the cases' rank paths together
        ones = {n: one_process_run(n) for n in spec["cases"]
                if _comparer(n, lay) == rank}
        res = {n: run_case(n, mesh, ones.pop(n, None))
               for n in spec["cases"]}
        if ref_path:
            # the export runs beside the cases; the test marks it written
            deadline = time.time() + TIMEOUT
            while not os.path.exists(ref_path + ".ready"):
                if time.time() > deadline:
                    raise TimeoutError(f"no {ref_path}")
                time.sleep(0.2)
            res["reference"] = run_reference_case(ref_path, mesh)
        res["coords"] = mesh.coords()
        res["rank"] = rank
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{world_name}.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the test side ---------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def start_world(out_dir, name, ref_path=""):
    world = int(np.prod(WORLDS[name]["shape"]))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out_dir), name,
         str(r), ref_path], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def finish(procs, what, timeout=TIMEOUT):
    deadline = time.time() + timeout
    errs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.time(), 1))
            if p.returncode != 0:
                errs.append(out[-2000:] + err[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, f"{what}: " + "\n".join(errs)


def start_reference(out_dir):
    """The reference trainer's lead_2bit case on 4 placeholder devices,
    exported by tests/test_torch_trainer.py's subprocess into out_dir."""
    from test_torch_trainer import CASES as REF_CASES

    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "test_torch_trainer.py"),
         str(out_dir), json.dumps({"lead_2bit": REF_CASES["lead_2bit"]})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [each rank's json]}: the reference export and the worlds
    start together; w4 reads the export once it is written."""
    out = tmp_path_factory.mktemp("ranks")
    ref_path = out / "lead_2bit.npz"
    ref = start_reference(out)
    procs = {w: start_world(out, w, str(ref_path) if w == "w4" else "")
             for w in WORLDS}
    try:
        finish([ref], "reference export")
    finally:
        # the w4 ranks wait for this mark (or time out) once their cases
        # are done
        open(str(ref_path) + ".ready", "w").close()
    for w, ps in procs.items():
        finish(ps, w)
    os.remove(out / "lead_2bit.npz")
    res = {}
    for w, spec in WORLDS.items():
        n = int(np.prod(spec["shape"]))
        res[w] = [json.load(open(out / f"{w}.{r}.json")) for r in range(n)]
    return res


@pytest.mark.parametrize("world,name", RANK_CASES,
                         ids=[f"{w}-{c}" for w, c in RANK_CASES])
def test_rank_path_matches_one_process(worlds, world, name):
    """Each agent group's states after every step (gathered at one of its
    ranks) against the one-process run; every rank's metrics (the whole
    run's) against the one-process run's."""
    ranks = worlds[world]
    roots = [r for r in ranks if "one" in r[name]]
    assert len(roots) == len(ranks) // len({r[name]["first"] for r in ranks})
    for root in roots:
        one = root[name]["one"]
        for i, rec in enumerate(one):
            if name in EXACT:
                assert rec["gap"] < EXACT_GAP, (root["coords"], i, rec["gap"])
            else:
                assert rec["bad"] < DEVIATE_FRAC * rec["total"], (i, rec)
        if name not in EXACT:
            assert one[0]["codes_identical"]
        for r in ranks:
            for i, m in enumerate(r[name]["metrics"]):
                want = one[i]["metrics"]
                assert set(m) == set(want)
                for k in ("bits_per_agent", "dropped_links"):
                    if k in m:
                        assert m[k] == want[k], (k, i, m[k], want[k])
                g = want["grad_norm"]
                assert abs(m["grad_norm"] - g) <= NORM_RTOL * g, (i, m)


def test_faulted_runs_drop_links(worlds):
    """10% link drops over 3 steps realize some drop on every world, the
    same count on every rank."""
    for world in ("w2", "w4", "w4_replicas"):
        counts = {tuple(m["dropped_links"] for m in r["lead_drops"]["metrics"])
                  for r in worlds[world]}
        assert len(counts) == 1 and sum(next(iter(counts))) > 0, counts


@pytest.mark.parametrize("name", WORLDS["w4_replicas"]["cases"])
def test_replicas_are_bit_identical(worlds, name):
    """On the (2, 2) grid, the two ranks of each agent block (model index 0
    and 1) end with the same state, bit for bit."""
    by_block = {}
    for r in worlds["w4_replicas"]:
        by_block.setdefault(r[name]["first"], set()).add(r[name]["digest"])
    assert len(by_block) == 2
    assert all(len(d) == 1 for d in by_block.values()), by_block


def _payload_bytes(leaves_dims, packed):
    """What one agent's payload of each leaf takes on the wire: its int8
    codes (or 2-bit codes in uint32 words, 10 to a word) for every padded
    512-block, and one f32 scale a block."""
    out = []
    for d in leaves_dims:
        nb = -(-d // 512)
        codes = (-(-nb * 512 // 10)) * 4 if packed else nb * 512
        out.append(codes + nb * 4)
    return out


@pytest.mark.parametrize("name", ["lead_2bit", "choco_2bit",
                                  "lead_wire_pack"])
def test_wire_carries_only_the_payload(worlds, name):
    """One agent per rank on ring(4): each step, each rank posts one
    batch_isend_irecv per leaf and round (2 rounds), handing isend exactly
    one agent's payload - int8 codes (uint32 words as int32 when packed)
    and f32 scales, one per 512-block.  No f32 tensor as long as a row of
    the leaf crosses ranks."""
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_leaves

    cfg, _ = _setup(CASES[name])
    dims = [l.numel() for l in tree_leaves(tfm.init_params(cfg,
                                                         device="meta"))]
    want = _payload_bytes(dims, packed=name == "lead_wire_pack")
    for rank in worlds["w4"]:
        for calls in rank[name]["calls"]:
            assert len(calls) == 2 * len(dims)
            for c, call in enumerate(calls):
                leaf = c // 2
                assert sum(b for _, _, b in call) == want[leaf], (c, call)
                nb = -(-dims[leaf] // 512)
                for dtype, numel, _ in call:
                    assert dtype in ("torch.int8", "torch.int32") \
                        or (dtype == "torch.float32" and numel == nb), call


def test_interval_skipped_step_posts_no_op(worlds):
    """ring(4).with_interval(2) at one agent per rank: step 1 is local on
    every rank - no batch_isend_irecv at all - and ships 0 bits; steps 0
    and 2 exchange."""
    for world in ("w4",):
        for r in worlds[world]:
            case = r["lead_interval2"]
            assert case["calls"][1] == []
            assert case["metrics"][1]["bits_per_agent"] == 0.0
            assert case["calls"][0] and case["calls"][2]


def test_hier_node_across_ranks(worlds):
    """hierarchical(ring(2), 2): on w4 each node's two agents sit on two
    ranks (the node mean an all_reduce), on w2 inside one; both halve the
    ring's bits."""
    for world in ("w2", "w4"):
        for r in worlds[world]:
            hb = r["lead_hier"]["metrics"][0]["bits_per_agent"]
            rb = r["lead_2bit"]["metrics"][0]["bits_per_agent"]
            assert hb * 2 == rb


def test_rank_path_matches_reference(worlds):
    """LEAD 2-bit on ring(4), one agent per rank, against the reference
    trainer on 4 devices (its draws injected), each step from its state:
    fewer than 1e-5 of the elements deviate by more than 1e-4 of the
    scale; the bits exactly, grad_norm within 1e-5."""
    ranks = worlds["w4"]
    bad = sum(s["bad"] for r in ranks for s in r["reference"]["steps"])
    total = sum(s["total"] for r in ranks for s in r["reference"]["steps"])
    assert bad < DEVIATE_FRAC * total, (bad, total)
    for r in ranks:
        for s in r["reference"]["steps"]:
            assert s["bits"][0] == s["bits"][1]
            assert abs(s["grad_norm"][0] - s["grad_norm"][1]) \
                <= 1e-5 * s["grad_norm"][0]


def test_rank_mesh_layout():
    """RankMesh coordinates are row-major; an agent group is a model
    index's ranks in agent order; AgentLayout blocks are contiguous."""
    from repro_torch.dist.sharding import agent_index, make_profile
    from repro_torch.launch.mesh import RankMesh

    m = RankMesh((2, 4, 2), ("pod", "data", "model"), rank=11)
    assert m.coords() == {"pod": 1, "data": 1, "model": 1}
    assert m.rank_of({"pod": 1, "data": 1, "model": 1}) == 11
    prof = make_profile(None, m.axis_names)
    assert prof.agent_axes == ("pod", "data") and prof.tp_axis == "model"
    assert agent_index(m, prof) == 5
    assert m.ranks_along(prof.agent_axes) == (1, 3, 5, 7, 9, 11, 13, 15)
    assert m.ranks_along(("model",)) == (10, 11)
    assert len(m.partition(prof.agent_axes)) == 2


def test_seq_parallel_on_a_model_axis_raises():
    """seq_parallel with a model axis above 1 is a later slice: it raises
    naming ROADMAP.md before any process group is touched."""
    from repro_torch.dist.trainer import DistConfig, make_train_step
    from repro_torch.launch.mesh import RankMesh

    cfg, _ = _setup(CASES["lead_2bit"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(cfg, A, DistConfig(seq_parallel=True), "cpu",
                        mesh=RankMesh((4, 2), ("data", "model")))


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
