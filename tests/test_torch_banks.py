"""Parity of the port's time-varying gossip (core/topology.TopologyBank and
its graph families, the bank backends of core/gossip.py, the engines' bank
branches, the fault metrics on a bank's round graph) with the JAX
reference, on the CPU.

Topology arrays, bank tables, random_matching's rounds, bits and fault
fields are compared exactly (the realized gap within 1e-6, as
tests/test_torch_faults.py); engine steps with the per-step parity of
tests/test_torch_baselines.py (state re-synced to the reference's before
every step, the reference on ``dither="fast"``); whole run() traces with
``_trace_close`` on uncompressed, convergent runs.  The mirrored reference
tests are tests/test_topology.py (schedules, one-peer rounds, matchings,
banks, materialize) and tests/test_cedas.py (static equals a period-1
bank, the hat invariant, CHOCO against a hand reference, LEAD on degree-1
banks and its instability on exponential_onepeer(32)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core import gossip as jax_gossip
from repro.core import topology as jax_topology
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.engines import engine_for as jax_engine_for
from repro.core.lead import LEADHyper as JaxLEADHyper
from repro.core.simulator import run as jax_run
from repro_torch.core import faults, topology
from repro_torch.core.compression import QuantizePNorm
from repro_torch.core.convert import problem_from_numpy
from repro_torch.core.engines import engine_for
from repro_torch.core.gossip import DenseGossip, EncodedNeighborGossip
from repro_torch.core.lead import LEADHyper
from repro_torch.core.simulator import LEADSim, run, with_topology
from test_torch_baselines import _step_parity
from test_torch_engine import _trace_close
from test_torch_faults import _Quadratic, _quadratics

CPU = "cpu"
N = 8
BANKS = {"onepeer": lambda m: m.exponential_onepeer(N),     # period 3
         "matching": lambda m: m.random_matching(N, seed=0)}  # period 8
ENGINES = ["lead", "choco", "deepsqueeze", "qdgd", "dcd",
           "dgd", "nids", "extra", "d2"]
EXACT = {"dgd", "nids", "extra", "d2"}
HYPER = (LEADHyper(eta=0.1, gamma=1.0, alpha=0.5),
         JaxLEADHyper(eta=0.1, gamma=1.0, alpha=0.5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (many small ops;
    several pytest workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def near_consensus(d, seed=0, n=N):
    """(port, reference) quadratics f_i = 0.5 ||x - t_i||^2 with
    t_i = c + N(0, 1), c ~ 100 N(0, 1) shared: CHOCO, which has no
    gradient correction, contracts here to within 1e-4 of its start in
    120 steps, where t_i ~ 100 N(0, 1) leaves it at its heterogeneity
    floor (a stationary, not a convergent, trace)."""
    rng = np.random.default_rng(seed)
    T = (100.0 * rng.standard_normal((1, d))
         + rng.standard_normal((n, d))).astype(np.float32)
    return _Quadratic(T, torch), _Quadratic(T, jnp)


def run_problem(algorithm, d, seed=0):
    """The quadratics the run() parity tests use: LEAD, which converges
    exactly, on t_i ~ 100 N(0, 1) (the fault tests' objective); CHOCO on
    near_consensus targets.  On near-consensus targets LEAD's consensus
    falls to 1e-8 of its start, where the jitted reference parts from its
    own eager trace by ~15% (the reference caveat on XLA's contracted
    multiply-add), so that run can be held only against the eager
    reference."""
    if algorithm == "lead":
        return _quadratics(d, seed)
    return near_consensus(d, seed)


def _bank_equal(got, want):
    assert got.period == want.period and got.n == want.n
    assert got.deg_max == want.deg_max
    for f in ("Ws", "neighbors", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert [r.name for r in got.rounds] == [r.name for r in want.rounds]


# -- topology: schedules, banks and their graph families ----------------

def test_schedule_hook():
    """A Topology is a callable of the iteration counter: a static graph
    returns itself, with_schedule resolves through the hook."""
    ring8 = topology.ring(8)
    assert ring8(0) is ring8 and ring8(17) is ring8
    sched = ring8.with_schedule(
        lambda k: ring8 if k % 2 == 0 else topology.torus_2d(2, 4))
    assert [sched(k).name for k in range(3)] == ["ring", "torus_2x4", "ring"]
    assert sched.schedule is not None and ring8.schedule is None
    with pytest.raises(ValueError):
        ring8.with_schedule(lambda k: ring8, period=0)
    assert topology.ring(8).uniform_weights == \
        jax_topology.ring(8).uniform_weights
    er = topology.erdos_renyi(8, p=0.3, seed=2)
    assert er.uniform_weights is None
    assert jax_topology.erdos_renyi(8, p=0.3, seed=2).uniform_weights is None


@pytest.mark.parametrize("n", [1, 2, 3, 8, 12, 16, 32, 48])
def test_onepeer_bank_equals_reference(n):
    """exponential_onepeer: the reference's bank exactly (stacked W,
    tables, names, period, spectral quantities); every round doubly
    stochastic with degree 1 and period ceil(log2 n)."""
    got = topology.exponential_onepeer(n)
    want = jax_topology.exponential_onepeer(n)
    _bank_equal(got, want)
    assert got.period == max(1, int(np.ceil(np.log2(n))))
    assert repr(got) == repr(want)
    assert got.spectral_gap == want.spectral_gap
    assert got.beta == want.beta and got.kappa_g == want.kappa_g
    np.testing.assert_array_equal(got.period_W, want.period_W)
    np.testing.assert_array_equal(got.edge_masks, want.edge_masks)
    for r in got.rounds:
        W = np.asarray(r)
        assert np.allclose(W.sum(0), 1.0) and np.allclose(W.sum(1), 1.0)
        off = (W > 1e-12) & ~np.eye(n, dtype=bool)
        assert off.sum(1).max(initial=0) <= 1
    got.validate()


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_onepeer_period_product_is_uniform_at_pow2(m):
    """At n = 2^m the P-round product is exactly uniform averaging."""
    bk = topology.exponential_onepeer(2 ** m)
    assert bk.period == m
    assert np.allclose(bk.period_W, np.full((2 ** m,) * 2, 1.0 / 2 ** m),
                       atol=1e-12)
    assert bk.spectral_gap > 1.0 - 1e-9
    nonpow2 = topology.exponential_onepeer(12)
    assert not np.allclose(nonpow2.period_W, np.full((12, 12), 1 / 12))
    assert 0.0 < nonpow2.spectral_gap <= 1.0


@pytest.mark.parametrize("n,seed,rounds", [(7, 3, 8), (8, 0, 8), (16, 7, 8),
                                           (32, 0, 8), (5, 11, 3)])
def test_random_matching_equals_reference(n, seed, rounds):
    """random_matching draws through the port's counter hash: the
    reference's rounds exactly; each round a symmetric matching (degree
    <= 1), one agent left alone at odd n."""
    got = topology.random_matching(n, seed=seed, rounds=rounds)
    _bank_equal(got, jax_topology.random_matching(n, seed=seed,
                                                  rounds=rounds))
    for r in got.rounds:
        W = np.asarray(r)
        assert np.array_equal(W, W.T) and np.allclose(W.sum(1), 1.0)
        off = (W > 1e-12) & ~np.eye(n, dtype=bool)
        assert off.sum(1).max() <= 1
        if n % 2:
            assert int((np.diag(W) == 1.0).sum()) == 1
    got.validate()


def test_random_matching_replay_prefix_and_checks():
    """Replayable bit for bit, seed-sensitive, rounds r1 < r2 a prefix;
    n and rounds below 1 raise."""
    a = topology.random_matching(16, seed=7, rounds=8)
    assert np.array_equal(a.Ws, topology.random_matching(16, 7, 8).Ws)
    assert not np.array_equal(a.Ws, topology.random_matching(16, seed=8).Ws)
    assert np.array_equal(topology.random_matching(16, 7, 3).Ws, a.Ws[:3])
    for bad in (dict(n=0), dict(n=4, rounds=0)):
        with pytest.raises(ValueError):
            topology.random_matching(**bad)
    with pytest.raises(ValueError):
        topology.exponential_onepeer(0)


def test_bank_validation_names_offending_round():
    """Mismatched n and mixed weight styles raise naming the round."""
    with pytest.raises(ValueError, match="round 1.*n=6.*n=4"):
        topology.bank([topology.ring(4), topology.ring(6)])
    with pytest.raises(ValueError, match="round 1"):
        topology.bank([topology.ring(8), topology.erdos_renyi(8, 0.3, 2)])
    with pytest.raises(ValueError, match="at least one round"):
        topology.bank([])
    bad = topology.bank([topology.ring(4)])
    bad.weights[0, 0, 0] = 0.5
    with pytest.raises(ValueError, match="round 0"):
        bad.validate()
    with pytest.raises(ValueError, match="columns"):
        topology.bank([np.array([[1.0, 0.0], [1.0, 0.0]])]).validate()


def test_bank_shared_layout_and_round_access():
    """Rounds of different degrees re-pad to the bank-wide max_deg (the
    reference's tables exactly), bank(k) wraps mod P, W is round 0."""
    got = topology.bank([topology.ring(8), topology.make_mixing("full", 8)])
    _bank_equal(got, jax_topology.bank([jax_topology.ring(8),
                                        jax_topology.make_mixing("full", 8)]))
    assert got.neighbors.shape == (2, 8, got.deg_max)
    assert got(0).name == "ring" and got(3).name == "full"
    np.testing.assert_array_equal(got.W, got.Ws[0])
    assert got.with_interval(3).comm_interval == 3
    got.validate()
    raw = topology.bank([topology.ring(4).W], name="raw")
    assert raw.rounds[0].name == "raw[0]"


def test_materialize_forms():
    """A bank passes through, a list stacks, a periodic schedule expands
    to its P rounds (keeping its interval), a periodless one raises."""
    bk = topology.exponential_onepeer(8)
    assert topology.materialize(bk) is bk
    assert topology.materialize([topology.ring(4)] * 2).period == 2
    ring4 = topology.ring(4)
    sched = ring4.with_schedule(
        lambda k: ring4 if k % 2 == 0 else topology.make_mixing("full", 4),
        period=2)
    got = topology.materialize(sched)
    jring4 = jax_topology.ring(4)
    want = jax_topology.materialize(jring4.with_schedule(
        lambda k: jring4 if k % 2 == 0
        else jax_topology.make_mixing("full", 4), period=2))
    _bank_equal(got, want)
    assert got.name == want.name == "ring@P2"
    assert topology.materialize(sched.with_interval(3)).comm_interval == 3
    with pytest.raises(ValueError, match="periodless"):
        topology.materialize(ring4.with_schedule(lambda k: ring4))
    assert topology.materialize(ring4) is ring4


@pytest.mark.parametrize("name", sorted(jax_topology.TOPOLOGIES))
def test_make_mixing_equals_reference(name):
    """Every family of the registry: the reference's graph or bank."""
    assert set(topology.TOPOLOGIES) == set(jax_topology.TOPOLOGIES)
    got = topology.make_mixing(name, 8)
    want = jax_topology.make_mixing(name, 8)
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, topology.TopologyBank):
        _bank_equal(got, want)
    else:
        for f in ("W", "neighbors", "weights"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.name == want.name
    assert topology._near_square(12) == jax_topology._near_square(12)
    with pytest.raises(KeyError):
        topology.make_mixing("hypercube", 8)


# -- gossip: the step's round ------------------------------------------

@pytest.mark.parametrize("bank", sorted(BANKS))
def test_for_round_equals_reference(bank):
    """DenseGossip and EncodedNeighborGossip built from a bank mix step k
    with round k % P, as the reference's for_round: the same mix within
    1e-6; a static backend is its own every round."""
    bt, bj = BANKS[bank](topology), BANKS[bank](jax_topology)
    x = np.random.default_rng(0).standard_normal((N, 3, 40)).astype(
        np.float32)
    dense = DenseGossip.from_topology(bt, CPU)
    nbr = EncodedNeighborGossip.from_topology(bt, CPU)
    assert dense.W.shape == (bt.period, N, N) and dense.n == N
    for k in range(2 * bt.period + 1):
        want = np.asarray(jax_gossip.DenseGossip.for_round(bj, k).mix(
            jnp.asarray(x)))
        want_n = np.asarray(jax_gossip.EncodedNeighborGossip.for_round(
            bj, k).mix(jnp.asarray(x)))
        got = dense.for_round(k).mix(torch.from_numpy(x)).numpy()
        got_n = nbr.for_round(k).mix(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_n, want_n, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_n, got, rtol=0, atol=1e-6)
    static = DenseGossip.from_topology(topology.ring(N), CPU)
    assert static.for_round(5) is static


# -- engines: per-step parity on a bank --------------------------------

@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("bank", sorted(BANKS))
@pytest.mark.parametrize("name", ENGINES)
def test_bank_step_parity(name, bank, gossip):
    """Every flat engine on a bank, 2-bit p=inf wire (the exact engines
    on 32-bit values): from the reference's state before every step, the
    step's round picked from state.k, the state within 1e-5, bits equal,
    comp_err within 1e-6 relative.  Steps cover rounds 0-3 of the bank
    (every round of the period-3 one-peer bank)."""
    comp = (None, None) if name in EXACT else (QuantizePNorm(bits=2),
                                              JaxQuantizePNorm(bits=2))
    eng = engine_for(BANKS[bank](topology), comp[0], 1300, algorithm=name,
                     gossip=gossip, device=CPU)
    ref = jax_engine_for(BANKS[bank](jax_topology), comp[1], 1300,
                         algorithm=name, gossip=gossip, dither="fast")
    with jax.disable_jit():
        _step_parity(eng, ref, steps=4, seed0=len(name + bank),
                     lead_hyper=HYPER if name == "lead" else None)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("algo", ["lead", "choco", "dcd"])
def test_static_equals_period1_bank(algo, gossip):
    """A one-round bank is the static graph: from each common state along
    the static run, one bank step matches one static step within 1e-5 of
    the field's scale, with the same bits (the bank branch recomputes
    W h where the static branch accumulates)."""
    prob, _ = _quadratics(700, seed=1)
    q4 = QuantizePNorm(bits=4)
    mk = lambda topo: engine_for(topo, q4, 700, algorithm=algo,
                                 gossip=gossip, eta=0.02, device=CPU)
    eng_s, eng_b = mk(topology.ring(N)), mk(topology.bank([topology.ring(N)]))
    x0 = torch.zeros(N, 700)
    st = eng_s.init(x0, prob.full_grad(x0))
    st_b = eng_b.init(x0, prob.full_grad(x0))
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(st_b, f)), f
    for k in range(12):
        g = prob.full_grad(eng_s.x_of(st))
        st_s, _, bits_s = eng_s.step_with_wire(st, g, k, step=k)
        st_b, _, bits_b = eng_b.step_with_wire(st, g, k, step=k)
        for f in st._fields:
            ref = getattr(st_s, f).double()
            dev = float((getattr(st_b, f).double() - ref).abs().max())
            assert dev <= 1e-5 * (1.0 + float(ref.abs().max())), (k, f, dev)
        assert float(bits_s) == float(bits_b)
        st = st_s


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("algo", ["choco", "dcd"])
def test_hat_invariant_on_multiround_bank(algo, gossip):
    """On the period-3 one-peer bank xhat_w == W_k xhat after every step,
    with the step's round graph (the incremental form drifts from step
    P + 1 on)."""
    prob, _ = _quadratics(768, seed=2)
    bk = topology.exponential_onepeer(N)
    eng = engine_for(bk, QuantizePNorm(bits=4), 768, algorithm=algo,
                     gossip=gossip, eta=0.02, device=CPU)
    x0 = torch.zeros(N, 768)
    st = eng.init(x0, prob.full_grad(x0))
    for k in range(12):
        st, _, _ = eng.step_with_wire(st, prob.full_grad(eng.x_of(st)), k,
                                      step=k)
        ref = bk.Ws[k % bk.period] @ eng.unblockify(st.xhat).double().numpy()
        dev = float(np.max(np.abs(eng.unblockify(st.xhat_w).double().numpy()
                                  - ref)))
        assert dev <= 3e-5 * (1.0 + float(np.max(np.abs(ref)))), (k, dev)


def test_choco_bank_matches_hand_reference():
    """Uncompressed CHOCO over the period-3 one-peer bank against a dense
    float64 reference that mixes with W_{k mod P} and recomputes
    xhat_w+ = W_k (xhat + q)."""
    prob, _ = _quadratics(768, seed=3)
    bk = topology.exponential_onepeer(N)
    eta, gamma = 0.02, 0.8
    eng = engine_for(bk, None, 768, algorithm="choco", eta=eta, gamma=gamma,
                     device=CPU)
    T = prob.T.double().numpy()
    x0 = torch.zeros(N, 768)
    st = eng.init(x0, prob.full_grad(x0))
    x = np.zeros((N, 768))
    xhat = np.zeros((N, 768))
    for k in range(12):
        st, _, _ = eng.step_with_wire(st, prob.full_grad(eng.x_of(st)), k,
                                      step=k)
        x_half = x - eta * (x - T)
        xhat = x_half                         # xhat + (x_half - xhat)
        xhat_w = bk.Ws[k % bk.period] @ xhat
        x = x_half + gamma * (xhat_w - xhat)
        for f, ref in (("x", x), ("xhat", xhat), ("xhat_w", xhat_w)):
            got = eng.unblockify(getattr(st, f)).double().numpy()
            dev = float(np.max(np.abs(got - ref)))
            assert dev <= 1e-4 * (1.0 + float(np.max(np.abs(ref)))), (k, f)


def test_lead_consensus_on_deg1_banks():
    """LEAD over degree-1 banks at the reference's stable settings:
    directed one-peer at n = 16 (gamma 1) and matchings at n = 32
    (gamma 0.25) reach consensus under 4-bit compression, on the
    reference's problems carried across."""
    key = jax.random.PRNGKey(2)
    q4 = QuantizePNorm(bits=4)
    for bk, n, gamma, iters in [
            (topology.exponential_onepeer(16), 16, 1.0, 600),
            (topology.random_matching(32, rounds=8), 32, 0.25, 1200)]:
        jprob = JaxLinearRegression.generate(key, n_agents=n, m=64, d=768)
        prob = problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                                  jprob.lam, device=CPU)
        eng = engine_for(bk, q4, 768, eta=1.0 / prob.mu_L[1], gamma=gamma,
                         device=CPU)
        tr = run(eng, prob, torch.tensor(np.asarray(jprob.x_star)),
                 iters=iters)
        assert tr.consensus[-1] < 1e-5, (bk.name, tr.consensus[-1])
        assert tr.dist[-1] < 1e-2, (bk.name, tr.dist[-1])


def _lead_monodromy(bk):
    """The homogeneous LEAD recursion's period monodromy (gamma = 1):
    x+ = M_k y, u+ = u + y - M_k y, M_k = I/2 + W_k/2, over the rounds."""
    I = np.eye(bk.n)
    Phi = np.eye(2 * bk.n)
    for W in bk.Ws:
        M = 0.5 * I + 0.5 * W
        Phi = np.block([[2 * M - I, -I], [I - M, I]]) @ Phi
    return np.sort(np.abs(np.linalg.eigvals(Phi)))[::-1]


def test_lead_onepeer32_instability_reproduced():
    """The reference's measured boundary, reproduced and not repaired: on
    the port's exponential_onepeer(32) the LEAD recursion's period
    monodromy has radius above 1.1 (the reference measures 1.218), while
    at n = 16 it is stable.  Uncompressed LEAD at eta = 0.02 (where the
    consensus part dominates the gradient's contraction) reaches consensus
    on the 16-agent bank in 300 steps and moves away from it on the
    32-agent bank, in the port as in the reference."""
    assert _lead_monodromy(topology.exponential_onepeer(32))[0] > 1.1
    mods = _lead_monodromy(topology.exponential_onepeer(16))
    assert mods[0] <= 1.0 + 1e-9 and mods[2] < 1.0
    for n in (16, 32):
        T = np.random.default_rng(n).standard_normal((n, 64)).astype(
            np.float32)
        cons = []
        for prob, make, mod in ((_Quadratic(T, torch), engine_for, topology),
                                (_Quadratic(T, jnp), jax_engine_for,
                                 jax_topology)):
            kw = dict(device=CPU) if mod is topology else {}
            eng = make(mod.exponential_onepeer(n), None, 64, eta=0.02,
                       gamma=1.0, **kw)
            tr = (run if mod is topology else jax_run)(
                eng, prob, prob.x_star, iters=300)
            cons.append((float(tr.consensus[0]), float(tr.consensus[-1])))
        for first, last in cons:
            if n == 16:
                assert last < 1e-4 * first, (n, cons)
            else:
                assert last > 1e3 * first, (n, cons)


# -- run(): traces, bits and fault fields against the reference ---------------

@pytest.mark.parametrize("bank", sorted(BANKS))
@pytest.mark.parametrize("algorithm", ["lead", "choco"])
def test_bank_run_matches_reference(algorithm, bank):
    """run() over a bank, 120 steps of the uncompressed engine on a ring-8
    quadratic (run_problem): dist, consensus and loss within
    _trace_close's bound of the reference's (a convergent run), bits
    exactly; the 2-bit run's bits exactly."""
    prob_t, prob_j = run_problem(algorithm, 1024, seed=5)
    hy = dict(eta=0.5) if algorithm == "lead" else dict(eta=0.5, gamma=0.8)
    got = run(engine_for(BANKS[bank](topology), None, 1024,
                         algorithm=algorithm, device=CPU, **hy),
              prob_t, prob_t.x_star, iters=120)
    want = jax_run(jax_engine_for(BANKS[bank](jax_topology), None, 1024,
                                  algorithm=algorithm, **hy),
                   prob_j, prob_j.x_star, iters=120)
    assert want.dist[-1] < 1e-3 * want.dist[0]
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f"{bank} {f}")
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)
    q2 = run(engine_for(BANKS[bank](topology), QuantizePNorm(bits=2), 1024,
                        algorithm=algorithm, device=CPU, **hy),
             prob_t, prob_t.x_star, iters=10)
    want_q2 = jax_run(jax_engine_for(BANKS[bank](jax_topology),
                                     JaxQuantizePNorm(bits=2), 1024,
                                     algorithm=algorithm, dither="fast",
                                     **hy),
                      prob_j, prob_j.x_star, iters=10)
    np.testing.assert_array_equal(q2.bits_per_agent, want_q2.bits_per_agent)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_faulted_bank_run_matches_reference(gossip):
    """run() of uncompressed LEAD over random_matching(8) under 10% link
    drops and agent outages: the four fault fields the reference's (the
    realized gap within 1e-6) and held to step_metrics on the step's round
    graph, the traces within _trace_close's bound."""
    prob_t, prob_j = _quadratics(1024, seed=6)
    model = dict(seed=0, link_drop=0.1, agent_drop=0.1, dropout_window=3)
    got = run(LEADSim(topology=topology.random_matching(N), eta=0.5,
                      engine="flat", engine_gossip=gossip,
                      faults=faults.FaultModel(**model)),
              prob_t, prob_t.x_star, iters=80)
    want = jax_run(jax_engine_for(jax_topology.random_matching(N), None,
                                  1024, gossip=gossip, eta=0.5,
                                  faults=jax_faults.FaultModel(**model)),
                   prob_j, prob_j.x_star, iters=80)
    assert want.dist[-1] < 1e-2 * want.dist[0]
    for f in ("dropped_links", "staleness_mean", "staleness_max"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.realized_gap, want.realized_gap, rtol=0,
                               atol=1e-6)
    assert got.dropped_links.sum() > 0
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)


def test_bank_entry_points_and_rejections():
    """LEADSim(engine='flat') and with_topology take a bank, a list of
    rounds and a periodic schedule; the tree engine and tree baselines
    refuse a bank; gossip='ring' and an interval on a bank raise, as the
    reference asserts."""
    prob, _ = _quadratics(256, seed=7)
    bk = topology.exponential_onepeer(N)
    lead = LEADSim(topology=topology.ring(N), eta=0.5, engine="flat")
    rebound = with_topology(lead, bk)
    assert rebound._topology is bk
    a = run(lead, prob, prob.x_star, iters=20, topology=bk)
    ring = topology.ring(N)
    sched = ring.with_schedule(lambda k: bk(k), period=bk.period)
    b = run(lead, prob, prob.x_star, iters=20, topology=sched)
    c = run(lead, prob, prob.x_star, iters=20, topology=list(bk.rounds))
    for f in ("dist", "consensus", "bits_per_agent"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(a, f), getattr(c, f))
    with pytest.raises(ValueError, match="engine='flat'"):
        LEADSim(topology=bk, compressor=QuantizePNorm(), engine="tree",
                device=CPU)._gossip
    from repro_torch.core.baselines import DGD
    with pytest.raises(TypeError, match="TopologyBank"):
        with_topology(DGD(gossip=DenseGossip.from_topology(ring, CPU)), bk)
    with pytest.raises(ValueError, match="TopologyBank"):
        engine_for(bk, None, 64, gossip="ring", device=CPU)
    with pytest.raises(ValueError, match="comm_interval"):
        engine_for(bk.with_interval(2), None, 64, device=CPU)
    with pytest.raises(ValueError, match="periodless"):
        engine_for(ring.with_schedule(lambda k: ring), None, 64, device=CPU)
    for call in (lambda: jax_engine_for(jax_topology.exponential_onepeer(N),
                                        None, 64, gossip="ring"),
                 lambda: jax_engine_for(
                     jax_topology.exponential_onepeer(N).with_interval(2),
                     None, 64)):
        with pytest.raises(AssertionError):
            call()
