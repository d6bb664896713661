"""Parity of the port's decentralized trainer (src/repro_torch/dist/trainer.py)
with the JAX reference trainer, on the CPU; plus the helpers that
tests/test_torch_trainer_graphs.py shares.

The reference's ``make_train_step`` runs in one module-scoped subprocess on
a (4, 1) mesh of 4 placeholder CPU devices (XLA_FLAGS must be set before
jax starts, as tests/test_dist.py does), on granite-3-2b ``.reduced()``
(2 layers, d_model 256, d_ff 341, so the padded-leaf path runs), 4 agents,
batch 2 x seq 32, 3 steps.  It exports as numpy its initial state, its
batches, its state and metrics after every step, and the draws its
compressor made (per step, leaf and wire: the rows of
``split(leaf_key, A)``'s uniforms, ``fold_in`` per wire).  The port starts
from the same state (``core/convert.train_state_from_numpy``), takes the
same batches, and - for the compressed algorithms - gets the reference's
draws through its one source of randomness, ``trainer.leaf_draws``, which
the tests replace.

Bounds: the exact algorithms within 1e-5 relative over 3 free steps (max
|port - ref| over the state's scale, its largest |x|, for every leaf and
field); the compressed ones, where a gradient rounding difference can flip
a knife-edge code, each step from the reference's state before it, by the
share of elements that deviate by more than 1e-4 of the state's scale,
below 1e-5, the bound the reference holds its own trainer to
(tests/dist_worker.py:328).  Bits
exactly; grad_norm within 1e-5; LEAD's dual sum below 1e-3.

    PYTHONPATH=src python -m pytest -q tests/test_torch_trainer.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

STEPS = 3
A = 4
SEQ, BATCH = 32, 2
EXACT_RTOL = 1e-5
DEVIATE_TOL = 1e-4           # an element deviates beyond 1e-4 x the scale
DEVIATE_FRAC = 1e-5          # ... in fewer than 1e-5 of the elements
DUAL_SUM = 1e-3

# case -> DistConfig fields, in a form both packages read; "topology" names
# a graph of topology_spec, "compressor" one of compressor_spec, "faults"
# a link-drop rate, "mesh" the reference's mesh shape, "arch" and "reduced"
# the model (granite-3-2b ``.reduced()`` when absent; see model_config)
CASES = {
    "nids": {"algorithm": "nids"},
    "allreduce": {"algorithm": "allreduce"},
    "lead_2bit": {"algorithm": "lead"},
    "choco_2bit": {"algorithm": "choco",
                   "hyper": {"eta": 0.03, "gamma": 0.3}},
}


def topology_spec(mod, name):
    """The named graph of 4 agents, from core/topology module `mod` (the
    reference's or the port's)."""
    return {"onepeer": lambda: mod.exponential_onepeer(A),
            "interval2": lambda: mod.ring(A).with_interval(2),
            "hier": lambda: mod.hierarchical(mod.ring(2), 2)}[name]()


def compressor_spec(mod, name):
    return {"randk": lambda: mod.RandK(ratio=0.5),
            "identity": lambda: mod.Identity()}[name]()


def model_config(registry, spec):
    """The case's model config from `registry` (the reference's or the
    port's configs.registry): spec["arch"] at ``.reduced(**spec["reduced"])``,
    granite-3-2b ``.reduced()`` by default."""
    return registry.get_config(spec.get("arch", "granite-3-2b")).reduced(
        **spec.get("reduced", {}))


def dist_fields(spec, topo_mod, comp_mod, faults_mod):
    """DistConfig keyword arguments of a case for one package."""
    kw = {"algorithm": spec["algorithm"]}
    if "hyper" in spec:
        kw["hyper"] = dict(spec["hyper"])
    if spec.get("topology"):
        kw["topology"] = topology_spec(topo_mod, spec["topology"])
    if spec.get("compressor"):
        kw["compressor"] = compressor_spec(comp_mod, spec["compressor"])
    if spec.get("faults"):
        kw["faults"] = faults_mod.FaultModel(seed=0,
                                             link_drop=spec["faults"])
    if spec.get("wire_pack"):
        kw["wire_pack"] = True
    for f in ("microbatches", "compute_dtype", "state_dtype"):
        if f in spec:
            kw[f] = spec[f]
    return kw


def _exported(leaf):
    """A reference leaf as numpy; bfloat16 as f32 (exact), which np.savez
    can store."""
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# -- the reference side, run in a subprocess ------------------------------------

def _reference_main(outdir, names, cases):
    """Run each case on the reference trainer and save it as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.compat import AxisType, make_mesh, set_mesh
    from repro.configs import registry
    from repro.core import compression, faults, topology
    from repro.data.synthetic import LMStreamConfig, lm_batch, stub_memory
    from repro.dist import sharding as shr
    from repro.dist.trainer import (DistConfig, engine_of, init_train_state,
                                    make_train_step, state_shardings)

    for name in names:
        spec = cases[name]
        shape = tuple(spec.get("mesh", (A, 1)))
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        cfg = model_config(registry, spec)
        prof = shr.make_profile(cfg, mesh.axis_names)
        shr.set_mesh_for_rules(mesh)
        dc = DistConfig(**dist_fields(spec, topology, compression, faults))
        key = jax.random.PRNGKey(0)
        sds = jax.eval_shape(
            lambda k: init_train_state(cfg, mesh, prof, dc, k), key)
        shardings = state_shardings(cfg, mesh, prof, sds)
        eng = engine_of(dc, A)
        comp = None if eng is None else eng.compressor
        n_wires = 1 if eng is None else eng.n_wires
        ds = LMStreamConfig(vocab=cfg.vocab, seq_len=SEQ,
                            batch_per_agent=BATCH, n_agents=A)
        out = {}
        # the vlm's and audio model's stub memory, the same every step (the
        # reference CLI's get_batch)
        memory = stub_memory(cfg.family, (A, BATCH), cfg)
        if memory is not None:
            out["memory"] = np.asarray(memory)

        def put(prefix, state):
            for j, l in enumerate(jax.tree_util.tree_leaves(state.params)):
                out[f"{prefix}/x/{j}"] = _exported(l)
            for f, tree in state.algo.items():
                for j, l in enumerate(jax.tree_util.tree_leaves(tree)):
                    out[f"{prefix}/{f}/{j}"] = _exported(l)

        with set_mesh(mesh):
            state = jax.jit(lambda k: init_train_state(cfg, mesh, prof, dc, k),
                            out_shardings=shardings)(key)
            step = jax.jit(make_train_step(cfg, mesh, prof, dc))
            put("init", state)
            out["algo_fields"] = np.asarray(sorted(state.algo), dtype=str)
            for i in range(STEPS):
                b = lm_batch(ds, i)
                out[f"s{i}/tokens"] = np.asarray(b["tokens"])
                out[f"s{i}/labels"] = np.asarray(b["labels"])
                if memory is not None:
                    b["memory"] = memory
                b = jax.device_put(b, NamedSharding(
                    mesh, shr.train_batch_spec(prof)))
                kk = jax.random.fold_in(key, i)
                state, metrics = step(state, b, kk)
                put(f"s{i}", state)
                for m, v in metrics.items():
                    out[f"s{i}/metric/{m}"] = np.asarray(v)
                drawn = comp is not None and (hasattr(comp, "bits")
                                              or hasattr(comp, "rescale"))
                if not drawn:                  # exact wire, TopK: no draws
                    continue
                leaves = jax.tree_util.tree_leaves(state.params)
                keys = jax.random.split(kk, len(leaves))
                for j, (l, lk) in enumerate(zip(leaves, keys)):
                    dim = int(np.prod(l.shape[1:]))
                    for w in range(n_wires):
                        wk = lk if n_wires == 1 else jax.random.fold_in(lk, w)
                        ks = jax.random.split(wk, A)
                        if hasattr(comp, "rescale"):            # RandK
                            u = jax.vmap(lambda q: jax.random.uniform(
                                q, (dim,), jnp.float32))(ks)
                        else:                                   # quantizer
                            nbl = -(-dim // comp.block)
                            u = jax.vmap(lambda q: jax.random.uniform(
                                q, (nbl, comp.block), jnp.float32))(ks)
                            u = u.reshape(A, -1)[:, :dim]
                        out[f"s{i}/u/{j}/{w}"] = np.asarray(u)
        np.savez(os.path.join(outdir, f"{name}.npz"), **out)


def run_reference(tmp_dir, cases, per_process=2, timeout=600):
    """Run the reference trainer on `cases` with 4 placeholder devices, in
    subprocesses of `per_process` cases each, started together (each
    case's time is mostly its XLA compile, on one core); {case: npz
    dict}, the files removed once loaded."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here, env.get("PYTHONPATH", "")])
    names = list(cases)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_dir),
         json.dumps({n: cases[n] for n in names[i:i + per_process]})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(0, len(names), per_process)]
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, out[-3000:] + err[-3000:]
    refs = {}
    for n in cases:
        # a case is several hundred MB: load it, then keep no copy on disk
        path = os.path.join(tmp_dir, f"{n}.npz")
        with np.load(path) as z:
            refs[n] = dict(z)
        os.remove(path)
    return refs


# -- the port side ---------------------------------------------------------------

def port_setup(spec):
    """(cfg, DistConfig, treedef) of a case in the port."""
    from repro_torch.configs import registry
    from repro_torch.core import compression, faults, topology
    from repro_torch.dist.trainer import DistConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten

    cfg = model_config(registry, spec)
    dc = DistConfig(**dist_fields(spec, topology, compression, faults))
    _, treedef = tree_flatten(tfm.init_params(cfg, device="meta"))
    return cfg, dc, treedef


def _tree(ref, prefix, treedef):
    from repro_torch.utils.tree import tree_unflatten
    n = len([k for k in ref if k.startswith(f"{prefix}/")])
    return tree_unflatten(treedef, [ref[f"{prefix}/{j}"] for j in range(n)])


def port_state(ref, prefix, treedef, device="cpu", dtype=torch.float32):
    """The port's TrainState from the reference's exported state, its
    floating leaves in `dtype` (the run's state_dtype)."""
    from repro_torch.core.convert import train_state_from_numpy

    fields = [str(f) for f in ref["algo_fields"]]
    step = 0 if prefix == "init" else int(prefix[1:]) + 1
    st = train_state_from_numpy(
        {"params": _tree(ref, f"{prefix}/x", treedef),
         "algo": {f: _tree(ref, f"{prefix}/{f}", treedef) for f in fields},
         "opt": (), "step": step}, device=device)
    if dtype == torch.float32:
        return st
    return st._replace(params=_cast(st.params, dtype),
                       algo={f: _cast(t, dtype) for f, t in st.algo.items()})


def port_batch(ref, i, device="cpu"):
    """Step i's batch of the reference: tokens, labels and, for vlm and
    audio, the stub memory."""
    b = {k: torch.tensor(ref[f"s{i}/{k}"], dtype=torch.int64,
                         device=device) for k in ("tokens", "labels")}
    if "memory" in ref:
        b["memory"] = torch.tensor(ref["memory"], device=device)
    return b


def inject_draws(monkeypatch, ref):
    """Hand the port's trainer the reference's draws, per (step, leaf,
    wire)."""
    from repro_torch.dist import trainer

    def draws(comp, seed, step, leaf, wire, n, dim, device):
        u = ref[f"s{step}/u/{leaf}/{0 if wire is None else wire}"]
        assert u.shape == (n, dim)
        return {"u": torch.tensor(u, device=device)}

    monkeypatch.setattr(trainer, "leaf_draws", draws)


def run_port(ref, spec, steps=STEPS, device="cpu", restart=False):
    """The port's run from the reference's initial state on its batches:
    [(state, metrics) after each step].  With `restart`, every step starts
    from the reference's state after the step before (so a code that one
    step flips at a knife edge does not seed the next step's flips)."""
    from repro_torch.dist.trainer import make_train_step

    cfg, dc, treedef = port_setup(spec)
    sd = getattr(torch, dc.state_dtype)
    state = port_state(ref, "init", treedef, device, sd)
    step = make_train_step(cfg, A, dc, device)
    out = []
    for i in range(steps):
        if restart and i:
            state = port_state(ref, f"s{i - 1}", treedef, device, sd)
        state, metrics = step(state, port_batch(ref, i, device), 0, step=i)
        out.append((state, metrics))
    return out


def _fields(state):
    from repro_torch.utils.tree import tree_leaves
    yield "x", tree_leaves(state.params)
    for f, tree in state.algo.items():
        yield f, tree_leaves(tree)


def _scale(ref, i):
    """The reference state's scale after step i: its largest |x|."""
    return max(np.abs(ref[k]).max() for k in ref if k.startswith(f"s{i}/x/"))


def exact_gap(ref, runs):
    """max over steps, fields and leaves of |port - ref|, over the step's
    scale (its largest |x|; tests/dist_worker.py scales its bounds so).
    The dual of an exact algorithm is a difference of near-equal iterates
    over eta (NIDS: gamma / (2 eta) (y - W y)), so against its own size it
    carries the iterates' rounding times 1 / eta; against the state's
    scale it does not."""
    worst = 0.0
    for i, (state, _) in enumerate(runs):
        scale = _scale(ref, i)
        for f, leaves in _fields(state):
            for j, l in enumerate(leaves):
                want = ref[f"s{i}/{f}/{j}"].astype(np.float64)
                got = l.detach().cpu().double().numpy()
                worst = max(worst, np.abs(got - want).max() / scale)
    return worst


def deviating_share(ref, runs):
    """(deviating, total): elements of every state field after every step
    off the reference's by more than DEVIATE_TOL x the step's largest |x|,
    as tests/dist_worker.py counts them."""
    bad = total = 0
    for i, (state, _) in enumerate(runs):
        scale = _scale(ref, i)
        for f, leaves in _fields(state):
            for j, l in enumerate(leaves):
                dev = np.abs(l.detach().cpu().double().numpy()
                             - ref[f"s{i}/{f}/{j}"].astype(np.float64))
                bad += int((dev > DEVIATE_TOL * scale).sum())
                total += dev.size
    return bad, total


def check_metrics(ref, runs):
    """bits_per_agent (and dropped_links) exactly, grad_norm within 1e-5."""
    for i, (_, metrics) in enumerate(runs):
        for m in ("bits_per_agent", "dropped_links"):
            key = f"s{i}/metric/{m}"
            assert (key in ref) == (m in metrics), (m, i)
            if key in ref:
                assert float(metrics[m]) == float(ref[key]), (m, i)
        gn = float(ref[f"s{i}/metric/grad_norm"])
        assert abs(float(metrics["grad_norm"]) - gn) <= 1e-5 * gn, i


def dual_sum(state):
    """max over leaves of max |sum_agents d|."""
    from repro_torch.utils.tree import tree_leaves
    return max(float(l.sum(0).abs().max())
               for l in tree_leaves(state.algo["d"]))


# -- tests -----------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (several pytest
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("trainer_ref"), CASES)


@pytest.mark.parametrize("name", ["nids", "allreduce"])
def test_exact_algorithms_match_reference(reference, name):
    """NIDS (raw 32-bit wire over the ring's two gather rounds) and the
    allreduce reference: 3 steps from the reference's state within 1e-5
    relative, bits and grad_norm as the reference's."""
    ref = reference[name]
    runs = run_port(ref, CASES[name])
    assert exact_gap(ref, runs) < EXACT_RTOL
    check_metrics(ref, runs)


@pytest.mark.parametrize("name", ["lead_2bit", "choco_2bit"])
def test_compressed_algorithms_match_reference(reference, name,
                                               monkeypatch):
    """LEAD and CHOCO on the 2-bit p=inf wire (K4, K2 and, for LEAD, K3
    on the card) with the reference's draws injected, each of 3 steps from
    the reference's state before it: fewer than 1e-5 of the state's
    elements deviate, the bits are the reference's exactly (3 bits an
    element and 32 a 512-block), and LEAD's dual sum stays below 1e-3.
    (Run free, a code flipped at a knife edge moves one weight, which
    moves every gradient of the next step a little and flips more codes:
    ~20 deviating elements after one step, ~1200 of 6.3e7 after three.)"""
    ref = reference[name]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES[name], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
    if name == "lead_2bit":
        assert dual_sum(runs[-1][0]) < DUAL_SUM


def test_dither_comes_from_leaf_draws(reference, monkeypatch):
    """Without the swap, the trainer draws every leaf's dither through
    trainer.leaf_draws, once per leaf and step, as fast_uniform of (A,
    d_leaf) seeded sub_seed(sub_seed(seed, step), leaf) - the one function
    the parity tests replace, and the one the card path calls."""
    from repro_torch.core.compression import fast_uniform, sub_seed
    from repro_torch.dist import trainer
    from repro_torch.utils.tree import tree_leaves

    ref = reference["lead_2bit"]
    calls = []
    real = trainer.leaf_draws

    def spy(comp, seed, step, leaf, wire, n, dim, device):
        out = real(comp, seed, step, leaf, wire, n, dim, device)
        calls.append((step, leaf, wire))
        want = fast_uniform((n, dim), sub_seed(sub_seed(seed, step), leaf),
                            device)
        assert torch.equal(out["u"], want)
        return out

    monkeypatch.setattr(trainer, "leaf_draws", spy)
    runs = run_port(ref, CASES["lead_2bit"], steps=2)
    n_leaves = len(tree_leaves(runs[0][0].params))
    assert calls == [(i, j, None) for i in range(2) for j in range(n_leaves)]
    for i, (_, metrics) in enumerate(runs):           # the bits take no draw
        assert float(metrics["bits_per_agent"]) \
            == float(ref[f"s{i}/metric/bits_per_agent"])


def test_train_state_and_engine_resolution():
    """init_train_state: a consensus start (every agent the same replica,
    LEAD's h and hw copies of x, d zeros, step 0) with the reference's
    leaf shapes; engine_of resolves the reference's hyper contract
    (tests/test_dist.py::test_distconfig_hyper_contract)."""
    from repro_torch.core.lead import LEADHyper
    from repro_torch.dist.trainer import (DistConfig, engine_of,
                                          init_train_state)
    from repro_torch.utils.tree import tree_leaves

    cfg, dc, _ = port_setup(CASES["lead_2bit"])
    gen = torch.Generator().manual_seed(0)
    st = init_train_state(cfg, A, dc, gen, "cpu")
    assert sorted(st.algo) == ["d", "h", "hw"] and int(st.step) == 0
    for x, h, d in zip(tree_leaves(st.params), tree_leaves(st.algo["h"]),
                       tree_leaves(st.algo["d"])):
        assert x.shape[0] == A and torch.equal(x, h)
        assert torch.equal(x, x[:1].expand_as(x)) and not d.any()
    assert sum(l[0].numel() for l in tree_leaves(st.params)) \
        == cfg.param_count()

    eng = engine_of(DistConfig(algorithm="deepsqueeze"), 4, "cpu")
    assert eng.eta == 0.03 and eng.gamma == 0.2
    with pytest.raises(ValueError):
        engine_of(DistConfig(algorithm="nids",
                             hyper={"eta": 0.05, "gamma": 0.5}), 4, "cpu")
    eng = engine_of(DistConfig(algorithm="lead", hyper=LEADHyper(eta=0.01)),
                    4, "cpu")
    assert (eng.eta, eng.gamma, eng.alpha) == (0.01, 1.0, 0.5)
    with pytest.raises(ValueError):
        engine_of(DistConfig(algorithm="choco", hyper=LEADHyper(eta=0.01)),
                  4, "cpu")
    assert engine_of(DistConfig(algorithm="allreduce"), 4, "cpu") is None
    with pytest.raises(ValueError):
        engine_of(DistConfig(algorithm="allreduce",
                             hyper={"eta": 0.1, "gamma": 1.0}), 4, "cpu")


def test_microbatches_dtypes_and_multiwire(reference):
    """The knobs the reference's perf_variants case covers, in the port:
    two microbatches give the one-batch step's gradient (the loss is a
    mean over equal chunks); bfloat16 state keeps its leaves bfloat16 and
    trains finite; C-GT, the two-wire engine, ships exactly twice the
    single-wire bits through the trainer."""
    from repro_torch.dist.trainer import (DistConfig, init_train_state,
                                          make_train_step)
    from repro_torch.utils.tree import tree_leaves

    ref = reference["lead_2bit"]
    cfg, _, treedef = port_setup(CASES["lead_2bit"])
    state = port_state(ref, "init", treedef)
    batch = port_batch(ref, 0)
    out = {}
    for name, dc in {
            "one": DistConfig(algorithm="nids"),
            "two": DistConfig(algorithm="nids", microbatches=2),
            "bf16": DistConfig(algorithm="nids", state_dtype="bfloat16",
                               compute_dtype="bfloat16"),
            "cedas": DistConfig(algorithm="cedas"),
            "cgt": DistConfig(algorithm="cgt")}.items():
        st = state
        if name == "bf16":
            st = st._replace(params=_cast(st.params, torch.bfloat16),
                             algo={f: _cast(t, torch.bfloat16)
                                   for f, t in st.algo.items()})
        if name in ("cedas", "cgt"):
            st = init_train_state(cfg, A, dc,
                                  torch.Generator().manual_seed(0), "cpu")
        out[name] = make_train_step(cfg, A, dc, "cpu")(st, batch, 0, step=0)
    g1 = float(out["one"][1]["grad_norm"])
    assert abs(float(out["two"][1]["grad_norm"]) - g1) <= 1e-5 * g1
    for a, b in zip(tree_leaves(out["one"][0].params),
                    tree_leaves(out["two"][0].params)):
        assert (a - b).abs().max() <= 1e-6 * max(a.abs().max(), 1.0)
    bf = tree_leaves(out["bf16"][0].params)
    assert all(l.dtype == torch.bfloat16 and torch.isfinite(l.float()).all()
               for l in bf)
    assert float(out["cgt"][1]["bits_per_agent"]) \
        == 2 * float(out["cedas"][1]["bits_per_agent"])


def _cast(tree, dtype):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda l: l.to(dtype), tree)


if __name__ == "__main__":
    _reference_main(sys.argv[1], list(json.loads(sys.argv[2])),
                    json.loads(sys.argv[2]))
