"""Parity of the port's CEDAS (src/repro_torch/core/engines/cedas.py and the
tree CEDAS of core/baselines.py) with the JAX reference, on the CPU, and
the helpers the multi-wire tests of tests/test_torch_cgt.py share.

Both packages get the same numbers: inputs are made with numpy from a seed
and states are carried across with repro_torch.core.convert.  The flat
engines run the reference's ``dither="fast"`` counter hash, whose step-k
plane is seeded ``key_data(key)[-1] ^ k`` (``PRNGKey(s)`` has last word
s).  A multi-wire engine draws wire j under ``fold_in(key, j)`` in the
reference and under ``compression.wire_seed(seed, j)`` in the port; the
tests replace that one function with the reference's per-wire seeds
(``key_data(fold_in(PRNGKey(seed), j))[-1]``), and hand RandK's threefry
draws to the engine's ``_draws`` per wire seed.  The tree path's draws go
through ``compression.agent_draws`` (tests/test_torch_tree.py's method).
Codes and scales are compared exactly, float state within 1e-5.

The mirrored reference tests are tests/test_cedas.py (flat against tree,
the exact-diffusion reduction, static equals a period-1 bank, the hat
invariant on a multi-round bank, convergence on a matching bank and the
registry) and the instability over one-peer banks that
src/repro/core/engines/cedas.py documents, reproduced here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import topology as jax_topology
from repro.core.compression import Identity as JaxIdentity
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.compression import RandK as JaxRandK
from repro.core.compression import TopK as JaxTopK
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import run as jax_run
from repro_torch.core import baselines, compression, topology
from repro_torch.core.baselines import CEDAS, DiffusionState
from repro_torch.core.compression import Identity, QuantizePNorm, RandK, TopK
from repro_torch.core.convert import fault_state_from_numpy, state_from_numpy
from repro_torch.core.engines import describe, engine_for, flat_twin, is_exact
from repro_torch.core.engines.cedas import FlatCEDASEngine
from repro_torch.core.simulator import run
from test_torch_baselines import _agent_uniforms
from test_torch_tree import _reference_draws
from test_torch_faults import _Quadratic, _quadratics

CPU = "cpu"
N, DIM = 8, 1300             # 3 logical blocks per agent, the last ragged
STEPS = 3
ATOL = 1e-5                  # the reference's flat-engine contract
NB_ATOL = 3e-5               # neighbor gather: float summation order only
ERR_RTOL = 1e-6
HYPER = dict(eta=0.02, gamma=0.5, alpha=0.5)
WIRES = {
    "pinf": (lambda: QuantizePNorm(bits=2), lambda: JaxQuantizePNorm(bits=2)),
    "randk": (lambda: RandK(ratio=0.5), lambda: JaxRandK(ratio=0.5)),
    "topk": (lambda: TopK(ratio=0.1), lambda: JaxTopK(ratio=0.1)),
    "identity": (lambda: None, lambda: None),
}
TOPOS = {
    "ring": lambda m: m.ring(N),
    "onepeer": lambda m: m.exponential_onepeer(N),       # period 3
    "matching": lambda m: m.random_matching(N, seed=0),  # period 8
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (many small ops;
    several pytest workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- shared helpers (tests/test_torch_cgt.py imports them) -----------------------

def ref_wire_seed(seed, j):
    """The reference's seed of wire j for a step keyed PRNGKey(seed): the
    last word of fold_in(PRNGKey(seed), j), which its dither="fast" plane
    reads."""
    return int(np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                             j)).ravel()[-1])


def wire_keys(n_wires, seed):
    """{port seed of the wire: the reference's key of the wire} for a step
    keyed PRNGKey(seed), once ref_wire_seed stands in for wire_seed."""
    key = jax.random.PRNGKey(seed)
    if n_wires == 1:
        return {seed: key}
    return {ref_wire_seed(seed, j): jax.random.fold_in(key, j)
            for j in range(n_wires)}


def inject_flat_draws(eng, seed):
    """The engine's _draws take the reference's draws for each wire's key
    (RandK: per-agent uniforms over the logical elements, one key per row
    by split); the p=inf wire shares the counter hash and exact TopK draws
    nothing."""
    keys = wire_keys(eng.n_wires, seed)

    def draws(comp, wseed, k, rows):
        if isinstance(comp, RandK):
            return {"u": torch.from_numpy(
                _agent_uniforms(keys[wseed], rows, (eng.dim,)))}
        return {}
    object.__setattr__(eng, "_draws", draws)


def pair(name, wire, topo, gossip="dense", faults=None, **hyper):
    """(port engine, reference engine on dither="fast") for `name`."""
    make_t, make_j = WIRES[wire]
    topo_t, topo_j = (TOPOS[topo](m) if isinstance(topo, str) else topo(m)
                      for m in (topology, jax_topology))
    hyper = {**HYPER, **hyper}
    eng = engine_for(topo_t, make_t(), DIM, algorithm=name, gossip=gossip,
                     faults=None if faults is None else faults[0],
                     device=CPU, **hyper)
    ref = jax_engine_for(topo_j, make_j(), DIM, algorithm=name, gossip=gossip,
                         dither="fast",
                         faults=None if faults is None else faults[1],
                         **hyper)
    return eng, ref


def state_close(got, want, what, atol=ATOL):
    """Every float field within atol of its scale (at least 1), k exact."""
    assert got._fields == want._fields, what
    for f in want._fields:
        if f == "k":
            assert int(got.k) == int(want.k), what
            continue
        w = np.asarray(getattr(want, f))
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=0,
                                   atol=atol * scale, err_msg=f"{what}: {f}")


def payloads_equal(got, want, what):
    """The encoded payloads of every wire: codes and scales exactly, RandK's
    and TopK's values exactly, the raw values of the exact wire exactly."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for j, (pt, pj) in enumerate(zip(got, want)):
        for f in pj:
            np.testing.assert_array_equal(
                pt[f].numpy(), np.asarray(pj[f]),
                err_msg=f"{what}: wire {j} payload {f}")


def flat_step_parity(monkeypatch, eng, ref, steps=STEPS, seed0=0,
                     atol=ATOL, faulted=False):
    """From a common state (the reference's, carried across before every
    step), one step each with the same gradient and the same per-wire
    seeds: every wire's payload exactly, float state within atol, wire bits
    equal, comp_err within ERR_RTOL (and, faulted, the ages exactly)."""
    monkeypatch.setattr(compression, "wire_seed", ref_wire_seed)
    rng = np.random.default_rng(seed0)
    x0, g0 = (rng.standard_normal((N, DIM)).astype(np.float32)
              for _ in range(2))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    cls = type(eng.init(torch.from_numpy(x0), torch.from_numpy(g0)))
    fs_j = ref.init_fault_state(st_j) if faulted else None
    for i in range(steps):
        g = rng.standard_normal((N, DIM)).astype(np.float32)
        seed = int(rng.integers(0, 2 ** 31))
        key = jax.random.PRNGKey(seed)
        st_t = state_from_numpy(cls, st_j, device=CPU)
        inject_flat_draws(eng, seed)
        what = f"{describe(eng)} step {i}"
        with jax.disable_jit():
            if (ref.comm_interval == 1
                    or int(st_j.k) % ref.comm_interval == 0):
                gb_t, gb_j = eng.blockify(torch.from_numpy(g)), \
                    ref.blockify(jnp.asarray(g))
                pl_t = eng.encode_stage(st_t, gb_t, seed,
                                        eng.hypers_at(st_t.k))[0]
                pl_j = ref.encode_stage(st_j, gb_j, key,
                                        ref.hypers_at(st_j.k))[0]
                payloads_equal(pl_t, pl_j, what)
            if faulted:
                fs_t = fault_state_from_numpy(fs_j, device=CPU)
                new_j, fs_j, err_j, bits_j = ref.step_with_wire_faulted(
                    st_j, fs_j, jnp.asarray(g), key)
                new_t, fs_t, err_t, bits_t = eng.step_with_wire_faulted(
                    st_t, fs_t, torch.from_numpy(g), seed)
                np.testing.assert_array_equal(fs_t.age.numpy(),
                                              np.asarray(fs_j.age))
            else:
                new_j, err_j, bits_j = ref.step_with_wire(
                    st_j, jnp.asarray(g), key)
                new_t, err_t, bits_t = eng.step_with_wire(
                    st_t, torch.from_numpy(g), seed)
        state_close(new_t, new_j, what, atol)
        assert float(bits_t) == float(bits_j), what
        np.testing.assert_allclose(float(err_t), float(err_j),
                                   rtol=ERR_RTOL, atol=1e-7, err_msg=what)
        st_j = new_j


def tree_pair(cls_name, wire, topo, **hyper):
    """(port tree algorithm, reference tree algorithm)."""
    make_t, make_j = WIRES[wire]
    comp_t = make_t() or Identity()
    comp_j = make_j() or JaxIdentity()
    hyper = {**HYPER, **hyper}
    algo = getattr(baselines, cls_name)(
        topology=TOPOS[topo](topology), compressor=comp_t, device=CPU,
        **hyper)
    ref = getattr(jax_baselines, cls_name)(
        topology=TOPOS[topo](jax_topology), compressor=comp_j, **hyper)
    return algo, ref


def tree_step_parity(monkeypatch, algo, ref, n_wires, steps=STEPS, seed0=0):
    """From a common state, one tree step each with the reference's
    per-agent draws of every wire injected (wire j's keys: the per-agent
    split of fold_in(key, j), or of key for a single wire): float state and
    comp_err within 1e-5 relative."""
    rng = np.random.default_rng(seed0)
    x0, g0 = (rng.standard_normal((N, DIM)).astype(np.float32)
              for _ in range(2))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    st0 = algo.init(torch.from_numpy(x0), torch.from_numpy(g0))
    state_close(st0, st_j, f"{type(algo).__name__} init")
    for i in range(steps):
        g = rng.standard_normal((N, DIM)).astype(np.float32)
        key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 31)))
        keys = ([key] if n_wires == 1 else
                [jax.random.fold_in(key, j) for j in range(n_wires)])
        draws = iter([_reference_draws(ref.compressor,
                                       jax.random.split(kj, N), (DIM,))
                      for kj in keys])
        monkeypatch.setattr(compression, "agent_draws",
                            lambda comp, X, seed: next(draws))
        st_t = state_from_numpy(type(st0), st_j, device=CPU)
        new_j, err_j = ref.step_with_metrics(st_j, jnp.asarray(g), key)
        new_t, err_t = algo.step_with_metrics(st_t, torch.from_numpy(g), 0)
        what = f"{type(algo).__name__} {ref.compressor!r} step {i}"
        state_close(new_t, new_j, what)
        np.testing.assert_allclose(float(err_t), float(err_j), rtol=ATOL,
                                   atol=1e-7, err_msg=what)
        st_j = new_j


def flat_equals_tree(monkeypatch, algo, steps=STEPS, seed0=0,
                     gossip="dense", atol=ATOL):
    """Within the port: from each common state along the tree's own
    trajectory, one flat_twin step equals one tree step, the tree handed
    the flat engine's dither planes (its logical blocks) as its draws."""
    eng = flat_twin(algo, DIM, gossip=gossip)
    rng = np.random.default_rng(seed0)
    x0 = torch.from_numpy(rng.standard_normal((N, DIM)).astype(np.float32))
    st = algo.init(x0, torch.zeros_like(x0))
    for i in range(steps):
        g = torch.from_numpy(rng.standard_normal((N, DIM)).astype(
            np.float32))
        seed = int(rng.integers(0, 2 ** 31))
        k = st.k
        monkeypatch.setattr(
            compression, "agent_draws",
            lambda comp, X, s: ({"u": eng._dither_plane(s, k)[
                :, :eng.nb_logical]} if isinstance(comp, QuantizePNorm)
                else {}))
        st_f = type(st)(*(eng.blockify(v) if v.ndim == 2 else v
                          for v in st))
        new_f, err_f, _ = eng.step_with_wire(st_f, g, seed)
        new_t, err_t = algo.step_with_metrics(st, g, seed)
        for f in st._fields:
            if f == "k":
                assert int(new_f.k) == int(new_t.k)
                continue
            want = getattr(new_t, f).numpy()
            scale = max(1.0, float(np.max(np.abs(want))))
            np.testing.assert_allclose(
                eng.unblockify(getattr(new_f, f)).numpy(), want, rtol=0,
                atol=atol * scale, err_msg=f"flat vs tree step {i}: {f}")
        np.testing.assert_allclose(float(err_f), float(err_t), rtol=ATOL,
                                   atol=1e-7)
        st = new_t


# -- flat CEDAS against the reference's --------------------------------------------

@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_cedas_step_parity(monkeypatch, wire, gossip):
    eng, ref = pair("cedas", wire, "ring", gossip)
    flat_step_parity(monkeypatch, eng, ref, seed0=len(wire + gossip),
                     atol=ATOL if gossip == "dense" else NB_ATOL)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("bank", ["onepeer", "matching"])
def test_cedas_bank_step_parity(monkeypatch, bank, gossip):
    """On a bank: the round of step k and hw recomputed from it."""
    eng, ref = pair("cedas", "pinf", bank, gossip)
    flat_step_parity(monkeypatch, eng, ref, steps=4, seed0=len(bank),
                     atol=ATOL if gossip == "dense" else NB_ATOL)


def test_cedas_hier_and_interval_step_parity(monkeypatch):
    for topo, gossip in ((lambda m: m.hierarchical(m.ring(4), 2), "hier"),
                         (lambda m: m.ring(N).with_interval(2), "dense")):
        eng, ref = pair("cedas", "pinf", topo, gossip)
        flat_step_parity(monkeypatch, eng, ref, steps=4, seed0=3,
                         atol=NB_ATOL)


# -- tree CEDAS against the reference's, and flat against tree ----------------------

@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("wire", ["pinf", "randk", "identity"])
def test_tree_cedas_step_parity(monkeypatch, wire, topo):
    algo, ref = tree_pair("CEDAS", wire, topo)
    tree_step_parity(monkeypatch, algo, ref, 1, seed0=len(wire + topo))


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("topo", ["ring", "onepeer"])
def test_cedas_flat_step_equals_tree(monkeypatch, topo, gossip):
    algo, _ = tree_pair("CEDAS", "pinf", topo)
    flat_equals_tree(monkeypatch, algo, steps=4, seed0=len(topo),
                     gossip=gossip,
                     atol=ATOL if gossip == "dense" else NB_ATOL)


# -- the pins of tests/test_cedas.py --------------------------------------------------

def test_cedas_identity_is_exact_diffusion_d2():
    """alpha = gamma = 1, no compression: the tree CEDAS follows D2's
    eq. (15) recursion x+ = (I+W)/2 (2x - x_prev - eta g + eta g_prev),
    seeded from its own first iterate x1 = Wtilde (x0 - eta g0); the flat
    twin takes the same steps."""
    prob, _ = _quadratics(256)
    eta = 0.02
    ring = topology.ring(N)
    tree = CEDAS(topology=ring, compressor=Identity(), eta=eta, gamma=1.0,
                 alpha=1.0, device=CPU)
    eng = flat_twin(tree, 256)
    Wt = torch.from_numpy((0.5 * (np.eye(N) + ring.W)).astype(np.float32))
    x0 = torch.zeros((N, 256))
    g0 = prob.full_grad(x0)
    st, st_f = tree.init(x0, g0), eng.init(x0, g0)
    st = tree.step(st, g0, 0)
    st_f = eng.step(st_f, g0, 0)
    torch.testing.assert_close(st.x, Wt @ (x0 - eta * g0), rtol=0, atol=1e-4)
    x_prev, x_ref, g_prev = x0, st.x, g0
    for k in range(1, 12):
        g = prob.full_grad(x_ref)
        st = tree.step(st, g, k)
        st_f = eng.step(st_f, g, k)
        inner = 2.0 * x_ref - x_prev - eta * g + eta * g_prev
        x_prev, x_ref, g_prev = x_ref, Wt @ inner, g
        tol = 1e-4 * (1.0 + float(x_ref.abs().max()))
        assert float((st.x - x_ref).abs().max()) <= tol, k
        assert float((eng.x_of(st_f) - st.x).abs().max()) <= tol, k


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_cedas_static_equals_period1_bank(gossip):
    """A one-round TopologyBank is the static graph: from each common state
    one bank step matches one static step within 1e-5 (the bank branch
    recomputes W_k h where the static one accumulates it), bits equal."""
    q4 = QuantizePNorm(bits=4)
    ring = topology.ring(N)
    mk = lambda t: engine_for(t, q4, DIM, algorithm="cedas", gossip=gossip,
                              device=CPU, **HYPER)
    eng_s, eng_b = mk(ring), mk(topology.bank([ring]))
    prob, _ = _quadratics(DIM)
    x0 = torch.zeros((N, DIM))
    st = eng_s.init(x0, prob.full_grad(x0))
    for f in st._fields:
        assert torch.equal(getattr(st, f),
                           getattr(eng_b.init(x0, prob.full_grad(x0)), f))
    for k in range(6):
        g = prob.full_grad(eng_s.x_of(st))
        new_s, _, bits_s = eng_s.step_with_wire(st, g, 11 + k)
        new_b, _, bits_b = eng_b.step_with_wire(st, g, 11 + k)
        for f in st._fields:
            a, b = getattr(new_b, f), getattr(new_s, f)
            scale = max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL * scale)
        assert float(bits_s) == float(bits_b)
        st = new_s


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_cedas_hw_invariant_on_multiround_bank(gossip):
    """hw == W_{k mod P} h after every step of the period-3 one-peer bank
    (the incremental form drifts from step P+1 on)."""
    bk = topology.exponential_onepeer(N)
    eng = engine_for(bk, QuantizePNorm(bits=4), DIM, algorithm="cedas",
                     gossip=gossip, device=CPU, eta=0.02)
    prob, _ = _quadratics(DIM)
    x0 = torch.zeros((N, DIM))
    st = eng.init(x0, prob.full_grad(x0))
    for k in range(9):
        st, _, _ = eng.step_with_wire(st, prob.full_grad(eng.x_of(st)), k,
                                      step=k)
        W_k = torch.from_numpy(bk.Ws[k % bk.period].astype(np.float32))
        want = W_k @ eng.unblockify(st.h)
        tol = NB_ATOL * (1.0 + float(want.abs().max()))
        assert float((eng.unblockify(st.hw) - want).abs().max()) <= tol, k


def test_cedas_converges_on_matching_bank():
    """4-bit CEDAS over a random-matching bank at n = 32 reaches the
    consensual optimum (the reference's test_cedas_converges_on_matching_
    bank, on the quadratic): dist and consensus fall by 1e-6 in 600
    steps."""
    n, d = 32, 512
    T = (10.0 * np.random.default_rng(1).standard_normal((n, d))).astype(
        np.float32)
    prob = _Quadratic(T, torch)
    eng = engine_for(topology.random_matching(n, rounds=8),
                     QuantizePNorm(bits=4), d, algorithm="cedas", eta=0.5,
                     gamma=0.25, alpha=1.0, device=CPU)
    tr = run(eng, prob, prob.x_star, iters=600)
    assert tr.dist[-1] < 1e-6 * tr.dist[0], (tr.dist[0], tr.dist[-1])
    assert tr.consensus[-1] < 1e-6 * tr.consensus[0]


def test_cedas_onepeer_instability_reproduced():
    """The reference's caveat (engines/cedas.py): over directed one-peer
    rounds the diffusion momentum phi = 2x - psi_prev is unstable past
    n ~ 16, even uncompressed, where symmetric matching rounds converge.
    The port reproduces it: at n = 32, eta 0.02, gamma 0.25, alpha 1,
    uncompressed CEDAS on exponential_onepeer(32) grows by more than 1e6
    in 300 steps, in step with the reference's trace, while the same run
    on random_matching(32) falls by more than 1e4."""
    n, d = 32, 256
    T = (10.0 * np.random.default_rng(2).standard_normal((n, d))).astype(
        np.float32)
    prob_t, prob_j = _Quadratic(T, torch), _Quadratic(T, jnp)
    hy = dict(eta=0.02, gamma=0.25, alpha=1.0)
    got = run(engine_for(topology.exponential_onepeer(n), None, d,
                         algorithm="cedas", device=CPU, **hy),
              prob_t, prob_t.x_star, iters=300)
    want = jax_run(jax_engine_for(jax_topology.exponential_onepeer(n), None,
                                  d, algorithm="cedas", **hy),
                   prob_j, prob_j.x_star, iters=300)
    assert want.consensus[-1] > 1e6 * want.consensus[0]
    assert got.consensus[-1] > 1e6 * got.consensus[0]
    np.testing.assert_allclose(np.log(got.consensus), np.log(want.consensus),
                               rtol=0, atol=1e-3)
    stable = run(engine_for(topology.random_matching(n, rounds=8), None, d,
                            algorithm="cedas", device=CPU, **hy),
                 prob_t, prob_t.x_star, iters=300)
    assert stable.consensus[-1] < 1e-4 * stable.consensus[0]


def test_cedas_registry_and_flat_twin():
    """'cedas' dispatches, is compressed, and flat_twin mirrors a tree
    instance's hypers and its bank (the reference's
    test_cedas_registry_dispatch)."""
    assert not is_exact("cedas")
    bk = topology.exponential_onepeer(8)
    tree = CEDAS(topology=bk, compressor=RandK(ratio=0.5), eta=0.03,
                 gamma=0.7, alpha=0.9, device=CPU)
    eng = flat_twin(tree, DIM)
    assert isinstance(eng, FlatCEDASEngine)
    assert (eng.eta, eng.gamma, eng.alpha) == (0.03, 0.7, 0.9)
    assert isinstance(eng.topology, topology.TopologyBank)
    assert eng.topology.period == bk.period and eng.device == tree.device
    assert eng.state_cls is DiffusionState
    ring = topology.ring(8)
    with pytest.raises(ValueError, match="periodless"):
        CEDAS(topology=ring.with_schedule(lambda k: ring),
              compressor=Identity(), device=CPU)
    # a periodic schedule materializes into the bank of its rounds
    sched = bk.rounds[0].with_schedule(lambda k: bk.rounds[k % 3], period=3)
    assert CEDAS(topology=sched, compressor=Identity(),
                 device=CPU).topology.period == 3
