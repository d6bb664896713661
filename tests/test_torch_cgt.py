"""Parity of the port's C-GT (src/repro_torch/core/engines/cgt.py, the tree
CGT of core/baselines.py) and of the multi-wire substrate of
core/engines/base.py with the JAX reference, on the CPU.

The method is tests/test_torch_cedas.py's (its helpers are shared): the
reference on ``dither="fast"``, its per-wire seeds ``key_data(fold_in(
PRNGKey(seed), j))[-1]`` handed to the port in place of
``compression.wire_seed``, every wire's payload compared exactly and float
state within 1e-5.  The mirrored reference tests are tests/test_cgt.py
(flat against tree, the lazy gradient-tracking reduction, static equals a
period-1 bank, the local step, the two-wire bits, convergence on the
degree-1 banks, hier and interval, the registry and the stale policy)
and tests/test_invariant_tripwires.py::
test_cgt_tracker_sum_invariant_under_drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core import topology as jax_topology
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import run as jax_run
from repro_torch.core import compression, faults, topology
from repro_torch.core.baselines import CGT, TrackingState
from repro_torch.core.compression import Identity, QuantizePNorm, RandK
from repro_torch.core.engines import engine_for, flat_twin, is_exact
from repro_torch.core.engines.cgt import FlatCGTEngine
from repro_torch.core.simulator import run
from test_torch_cedas import (ATOL, DIM, N, NB_ATOL, TOPOS, WIRES,
                              flat_equals_tree, flat_step_parity, pair,
                              state_close, tree_pair, tree_step_parity)
from test_torch_faults import _Quadratic, _quadratics

CPU = "cpu"
FM = dict(seed=7, link_drop=0.1, policy="renormalize")
STEPS = 12                   # the tripwire's steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (many small ops;
    several pytest workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the per-wire seeds --------------------------------------------------------------

def test_wire_seeds_are_distinct_host_ints():
    """wire_seed is a host derivation: ints in, a uint32 int out, the two
    wires of a step always apart, no two of 4,096 steps' wires alike, and
    the two dither planes of one step uncorrelated."""
    seeds = [compression.wire_seed(s, j) for s in range(2048)
             for j in (0, 1)]
    assert all(isinstance(v, int) and 0 <= v < 2 ** 32 for v in seeds)
    assert len(set(seeds)) == len(seeds)
    assert compression.wire_seed(2 ** 32 + 5, 1) == compression.wire_seed(5, 1)
    eng = engine_for(topology.ring(N), QuantizePNorm(bits=2), DIM,
                     algorithm="cgt", device=CPU)
    k = torch.zeros((), dtype=torch.int64)
    u0, u1 = (eng._dither_plane(compression.wire_seed(123, j), k).flatten()
              for j in (0, 1))
    assert not torch.equal(u0, u1)
    corr = float(torch.corrcoef(torch.stack([u0, u1]))[0, 1])
    assert abs(corr) < 0.02, corr


# -- flat C-GT against the reference's --------------------------------------------

@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_cgt_step_parity(monkeypatch, wire, gossip):
    eng, ref = pair("cgt", wire, "ring", gossip)
    flat_step_parity(monkeypatch, eng, ref, seed0=len(wire + gossip),
                     atol=ATOL if gossip == "dense" else NB_ATOL)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("bank", ["onepeer", "matching"])
def test_cgt_bank_step_parity(monkeypatch, bank, gossip):
    """On a bank: the round of step k, both hw pairs recomputed from it."""
    eng, ref = pair("cgt", "pinf", bank, gossip)
    flat_step_parity(monkeypatch, eng, ref, steps=4, seed0=len(bank),
                     atol=ATOL if gossip == "dense" else NB_ATOL)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("wire", ["pinf", "randk"])
def test_cgt_faulted_step_parity(monkeypatch, wire, gossip):
    """Under renormalized link drops and outages: both wires through one
    masked exchange, the ages exactly."""
    model = dict(seed=5, link_drop=0.3, agent_drop=0.3, dropout_window=2)
    eng, ref = pair("cgt", wire, "ring", gossip,
                    faults=(faults.FaultModel(**model),
                            jax_faults.FaultModel(**model)))
    flat_step_parity(monkeypatch, eng, ref, steps=4, seed0=len(wire),
                     atol=ATOL if gossip == "dense" else NB_ATOL,
                     faulted=True)


def test_cgt_hier_and_interval_follow_the_reference(monkeypatch):
    """hier C-GT (one encode per node on each wire) and C-GT on a tau = 2
    interval (its local steps included) step as the reference's, and their
    run() bits are the reference's: 2 wires / node_size, 2 wires / tau."""
    prob_t, prob_j = _quadratics(DIM)
    for topo, gossip in ((lambda m: m.hierarchical(m.ring(4), 2), "hier"),
                         (lambda m: m.ring(N).with_interval(2), "dense")):
        eng, ref = pair("cgt", "pinf", topo, gossip)
        flat_step_parity(monkeypatch, eng, ref, steps=4, seed0=5,
                         atol=NB_ATOL)
        got = run(eng, prob_t, prob_t.x_star, iters=6)
        want = jax_run(ref, prob_j, prob_j.x_star, iters=6)
        np.testing.assert_array_equal(got.bits_per_agent,
                                      want.bits_per_agent)
        assert got.bits_per_agent[-1] == 6 * 2 * QuantizePNorm(
            bits=2).wire_bits(DIM) / 2


# -- tree C-GT against the reference's, and flat against tree ----------------------

@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("wire", ["pinf", "randk", "identity"])
def test_tree_cgt_step_parity(monkeypatch, wire, topo):
    """Wire j of the tree step takes the reference's per-agent draws of
    fold_in(key, j)."""
    algo, ref = tree_pair("CGT", wire, topo)
    tree_step_parity(monkeypatch, algo, ref, 2, seed0=len(wire + topo))


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("topo", ["ring", "onepeer"])
def test_cgt_flat_step_equals_tree(monkeypatch, topo, gossip):
    algo, _ = tree_pair("CGT", "pinf", topo)
    flat_equals_tree(monkeypatch, algo, steps=4, seed0=len(topo),
                     gossip=gossip,
                     atol=ATOL if gossip == "dense" else NB_ATOL)


# -- the pins of tests/test_cgt.py ---------------------------------------------------

@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_cgt_identity_is_exact_gradient_tracking(gamma):
    """Identity wire, any alpha: x+ = M x - eta y, s+ = M y, y = s + g -
    g_prev with M = (1-gamma) I + gamma W (DIGing at gamma = 1), step by
    step against the recursion in float64, on the flat and the tree C-GT."""
    prob, _ = _quadratics(256)
    eta = 0.05
    W = topology.ring(N).W
    M = (1 - gamma) * np.eye(N) + gamma * W
    eng = engine_for(topology.ring(N), None, 256, algorithm="cgt", eta=eta,
                     gamma=gamma, alpha=0.7, device=CPU)
    tree = CGT(topology=topology.ring(N), compressor=Identity(), eta=eta,
               gamma=gamma, alpha=0.7, device=CPU)
    x, s, gp = (np.zeros((N, 256)) for _ in range(3))
    x0 = torch.zeros((N, 256))
    st, st_t = eng.init(x0, prob.full_grad(x0)), tree.init(x0, x0)
    for k in range(12):
        g = prob.full_grad(torch.from_numpy(x.astype(np.float32))).double()
        st, _, _ = eng.step_with_wire(st, prob.full_grad(eng.x_of(st)), k)
        st_t = tree.step(st_t, prob.full_grad(st_t.x), k)
        y = s + g.numpy() - gp
        x, s, gp = M @ x - eta * y, M @ y, g.numpy()
        for f, ref in (("x", x), ("s", s), ("g_prev", gp)):
            tol = 1e-5 * (1.0 + float(np.max(np.abs(ref))))
            for got in (eng.unblockify(getattr(st, f)), getattr(st_t, f)):
                dev = float(np.max(np.abs(got.double().numpy() - ref)))
                assert dev <= tol, f"step {k}, {f}: {dev}"


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_cgt_static_equals_period1_bank(gossip):
    q4 = QuantizePNorm(bits=4)
    ring = topology.ring(N)
    mk = lambda t: engine_for(t, q4, DIM, algorithm="cgt", gossip=gossip,
                              device=CPU, eta=0.02)
    eng_s, eng_b = mk(ring), mk(topology.bank([ring]))
    prob, _ = _quadratics(DIM)
    x0 = torch.zeros((N, DIM))
    st = eng_s.init(x0, prob.full_grad(x0))
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


def test_cgt_local_step_freezes_both_wires():
    """tau = 2: the communicating step (k = 0) ships both wires; the local
    step (k = 1) ships 0 bits, refreshes the tracker (s, g_prev move) and
    descends (x), while both reference pairs freeze; it equals the
    reference's local_stage."""
    eng, ref = pair("cgt", "pinf", lambda m: m.ring(N).with_interval(2),
                    "neighbor")
    rng = np.random.default_rng(4)
    x0, g0, g = (rng.standard_normal((N, DIM)).astype(np.float32)
                 for _ in range(3))
    s1 = eng.init(torch.from_numpy(x0), torch.from_numpy(g0))
    s1, _, bits1 = eng.step_with_wire(s1, torch.from_numpy(g), 9)
    s2, err2, bits2 = eng.step_with_wire(s1, torch.from_numpy(g), 9)
    assert float(bits1) == 2 * QuantizePNorm(bits=2).wire_bits(DIM)
    assert float(bits2) == 0.0 and float(err2) == 0.0
    assert not torch.equal(s2.x, s1.x) and not torch.equal(s2.s, s1.s)
    for f in ("h_x", "hw_x", "h_s", "hw_s"):
        assert torch.equal(getattr(s2, f), getattr(s1, f)), f
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    st_j = st_j._replace(**{f: jnp.asarray(getattr(s1, f).numpy())
                            for f in s1._fields})
    new_j, _ = ref.local_stage(st_j, ref.blockify(jnp.asarray(g)),
                               ref.hypers_at(st_j.k))
    state_close(s2, new_j, "local_stage")


def test_cgt_bits_are_twice_single_wire():
    """Two payloads per exchange: run()'s bits are exactly 2x the
    quantizer's single-wire bits (and 2 d * 32 on the exact wire), the
    reference's, and twice a single-wire engine's on the same graph."""
    prob_t, prob_j = _quadratics(DIM)
    q2 = QuantizePNorm(bits=2)
    eng = engine_for(topology.ring(N), q2, DIM, algorithm="cgt",
                     gossip="neighbor", device=CPU, eta=0.02)
    assert eng.n_wires == 2 and eng.wire_fields == ("x", "s")
    tr = run(eng, prob_t, prob_t.x_star, iters=5)
    np.testing.assert_array_equal(tr.bits_per_agent,
                                  (np.arange(5) + 1) * 2 * q2.wire_bits(DIM))
    single = run(engine_for(topology.ring(N), q2, DIM, algorithm="choco",
                            gossip="neighbor", device=CPU),
                 prob_t, prob_t.x_star, iters=5)
    np.testing.assert_array_equal(tr.bits_per_agent,
                                  2 * single.bits_per_agent)
    want = jax_run(jax_engine_for(jax_topology.ring(N),
                                  JaxQuantizePNorm(bits=2), DIM,
                                  algorithm="cgt", gossip="neighbor",
                                  dither="fast", eta=0.02),
                   prob_j, prob_j.x_star, iters=5)
    np.testing.assert_array_equal(tr.bits_per_agent, want.bits_per_agent)
    exact = run(engine_for(topology.ring(N), None, DIM, algorithm="cgt",
                           device=CPU, eta=0.02),
                prob_t, prob_t.x_star, iters=5)
    np.testing.assert_array_equal(exact.bits_per_agent,
                                  (np.arange(5) + 1) * 2 * DIM * 32)


# -- the tracker invariant -----------------------------------------------------------

def _tracker_gap(eng, st):
    s = eng.unblockify(st.s).double()
    gp = eng.unblockify(st.g_prev).double()
    return (float((s.sum(0) - gp.sum(0)).abs().max()),
            1.0 + float(gp.abs().max()))


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_cgt_tracker_sum_invariant_clean(topo):
    """sum_i s_i == sum_i g_prev_i after every clean step, on the ring and
    on both degree-1 banks (every round doubly stochastic)."""
    prob, _ = _quadratics(256)
    eng = engine_for(TOPOS[topo](topology), QuantizePNorm(bits=4, block=256),
                     256, algorithm="cgt", gossip="neighbor", device=CPU,
                     eta=0.01)
    x0 = torch.zeros((N, 256))
    st = eng.init(x0, prob.full_grad(x0))
    for k in range(STEPS):
        st, _, _ = eng.step_with_wire(st, prob.full_grad(eng.x_of(st)),
                                      3 + k, step=k)
        dev, scale = _tracker_gap(eng, st)
        assert dev < 1e-4 * scale, f"step {k}: {dev}"


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_cgt_tracker_sum_invariant_under_drops(gossip):
    """The reference's tripwire: 10% renormalized link drops on the ring
    (symmetric masks keep the realized mixing column-stochastic), the
    invariant after every one of 12 faulted steps, with drops realized."""
    fm = faults.FaultModel(**FM)
    masks = [fm.dense_mask(torch.tensor(k), N) for k in range(STEPS)]
    assert any(bool((~m).any()) for m in masks)
    prob, _ = _quadratics(256)
    eng = engine_for(topology.ring(N), QuantizePNorm(bits=4, block=256), 256,
                     algorithm="cgt", gossip=gossip, eta=0.01, gamma=0.5,
                     alpha=0.5, faults=fm, device=CPU)
    x0 = torch.zeros((N, 256))
    st = eng.init(x0, prob.full_grad(x0))
    fs = eng.init_fault_state(st)
    for k in range(STEPS):
        st, fs, _, _ = eng.step_with_wire_faulted(
            st, fs, eng.blockify(prob.full_grad(eng.x_of(st))), 3 + k, step=k)
        dev, scale = _tracker_gap(eng, st)
        assert dev < 1e-4 * scale, f"step {k}: {dev}"


# -- convergence, the registry, the stale policy -------------------------------------

@pytest.mark.parametrize("bank", ["onepeer", "matching"])
def test_cgt_converges_on_n32_banks(bank):
    """4-bit C-GT reaches the consensual optimum on both n = 32 degree-1
    banks, the directed one-peer bank included (where LEAD and CEDAS do
    not): dist and consensus fall by more than 1e6 in 600 steps."""
    n, d = 32, 256
    T = (10.0 * np.random.default_rng(1).standard_normal((n, d))).astype(
        np.float32)
    prob = _Quadratic(T, torch)
    topo = (topology.exponential_onepeer(n) if bank == "onepeer"
            else topology.random_matching(n, rounds=8))
    eng = engine_for(topo, QuantizePNorm(bits=4, block=256), d,
                     algorithm="cgt", eta=0.2, gamma=0.5, alpha=0.5,
                     device=CPU)
    tr = run(eng, prob, prob.x_star, iters=600)
    assert tr.dist[-1] < 1e-6 * tr.dist[0], (tr.dist[0], tr.dist[-1])
    assert tr.consensus[-1] < 1e-6 * tr.consensus[0]


def test_cgt_registry_and_stale_policy():
    """'cgt' and 'c-gt' dispatch to the multi-wire engine; flat_twin
    mirrors a tree instance's hypers and bank; a multi-wire engine takes
    only the renormalize policy (ValueError for stale, the port's form of
    the reference's assertion)."""
    assert not is_exact("cgt") and not is_exact("c-gt")
    bk = topology.exponential_onepeer(8)
    tree = CGT(topology=bk, compressor=RandK(ratio=0.5), eta=0.03,
               gamma=0.7, alpha=0.9, device=CPU)
    eng = flat_twin(tree, DIM)
    assert isinstance(eng, FlatCGTEngine)
    assert (eng.eta, eng.gamma, eng.alpha) == (0.03, 0.7, 0.9)
    assert isinstance(eng.topology, topology.TopologyBank)
    assert isinstance(engine_for(topology.ring(4), QuantizePNorm(), DIM,
                                 algorithm="c-gt", device=CPU),
                      FlatCGTEngine)
    assert isinstance(tree.init(torch.zeros(8, DIM), torch.zeros(8, DIM)),
                      TrackingState)
    fm_ok = faults.FaultModel(seed=1, link_drop=0.2, policy="renormalize")
    assert engine_for(topology.ring(N), QuantizePNorm(), DIM,
                      algorithm="cgt", faults=fm_ok,
                      device=CPU).faults is fm_ok
    stale = faults.FaultModel(seed=1, link_drop=0.2, policy="stale")
    with pytest.raises(ValueError, match="multi-wire"):
        engine_for(topology.ring(N), QuantizePNorm(), DIM, algorithm="cgt",
                   faults=stale, device=CPU)
    with pytest.raises(AssertionError, match="multi-wire"):
        jax_engine_for(jax_topology.ring(N), JaxQuantizePNorm(), DIM,
                       algorithm="cgt",
                       faults=jax_faults.FaultModel(seed=1, link_drop=0.2,
                                                    policy="stale"))
    # a single-wire engine keeps the stale policy
    engine_for(topology.ring(N), QuantizePNorm(), DIM, algorithm="cedas",
               faults=stale, device=CPU)


def test_multiwire_message_must_match_wire_fields():
    """A message that is not one buffer per declared wire raises."""
    eng = engine_for(topology.ring(N), None, 64, algorithm="cgt", device=CPU)
    st = eng.init(torch.zeros(N, 64), torch.zeros(N, 64))
    object.__setattr__(eng, "message", lambda s, gb, hy: ((s.x,), None))
    with pytest.raises(ValueError, match="one buffer per wire"):
        eng.step_with_wire(st, torch.zeros(N, 64), 0)
