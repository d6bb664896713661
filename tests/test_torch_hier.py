"""Parity of the port's two-level gossip (core/topology.hierarchical,
core/gossip.HierarchicalGossip, the engines' ``gossip="hier"`` wire and
run()'s fault metrics on the inter graph) with the JAX reference, on the
CPU; the mirror of the reference's tests/test_hierarchical.py for the
hier half (tests/test_torch_interval.py mirrors the interval half).

Topology arrays, bits and fault fields are compared exactly (the realized
gap within 1e-6); engine steps with the per-step parity of
tests/test_torch_baselines.py; run() traces with ``_trace_close`` on
uncompressed, convergent runs.
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
from repro.core.compression import RandK as JaxRandK
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import run as jax_run
from repro_torch.core import faults, topology
from repro_torch.core.compression import QuantizePNorm, RandK
from repro_torch.core.convert import problem_from_numpy
from repro_torch.core.engines import engine_for
from repro_torch.core.gossip import DenseGossip, HierarchicalGossip
from repro_torch.core.simulator import LEADSim, run
from repro_torch.kernels import lead_update
from test_torch_baselines import _agent_uniforms, _step_parity
from test_torch_banks import (ENGINES, EXACT, HYPER, near_consensus,
                              run_problem)
from test_torch_engine import _trace_close

CPU = "cpu"
N, D = 8, 768
HIER = {"ring4x2": lambda m: m.hierarchical(m.ring(4), 2),
        "ring2x4": lambda m: m.hierarchical(m.ring(2), 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (many small ops;
    several pytest workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the graph and the backend ------------------------------------------

@pytest.mark.parametrize("name", sorted(HIER))
def test_hierarchical_graph_equals_reference(name):
    """The composite W = kron(W_inter, J_s / s) and its table exactly the
    reference's; it validates; its spectrum is the inter graph's plus
    zeros, so the gap never falls."""
    got, want = HIER[name](topology), HIER[name](jax_topology)
    assert (got.n, got.node_size, got.name) == (want.n, want.node_size,
                                                want.name)
    for f in ("W", "neighbors", "weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.spectral_gap == want.spectral_gap
    got.validate()
    s, inter = got.node_size, got.inter
    np.testing.assert_allclose(got.W, np.kron(inter.W, np.full((s, s),
                                                               1.0 / s)),
                               atol=1e-12)
    eigs = np.sort(np.linalg.eigvalsh(got.W))
    expect = np.sort(np.concatenate([np.linalg.eigvalsh(inter.W),
                                     np.zeros(got.n - inter.n)]))
    np.testing.assert_allclose(eigs, expect, atol=1e-10)
    assert got.spectral_gap >= inter.spectral_gap - 1e-12
    assert isinstance(got, topology.Topology)
    assert topology.hierarchical(topology.ring(4).with_interval(3),
                                 2).comm_interval == 3


def test_hierarchical_node_size_one_and_rejections():
    """node_size 1 is the inter graph's W and table; a bank, a scheduled
    inter graph and node_size 0 raise ValueError, as in the reference."""
    inter = topology.ring(N)
    hier = topology.hierarchical(inter, 1)
    for f in ("W", "neighbors", "weights"):
        np.testing.assert_array_equal(getattr(hier, f), getattr(inter, f))
    for call in (lambda: topology.hierarchical(
                     topology.exponential_onepeer(4), 2),
                 lambda: topology.hierarchical(topology.ring(4).with_schedule(
                     lambda k: topology.ring(4), period=2), 2),
                 lambda: topology.hierarchical(topology.ring(4), 0)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("name", sorted(HIER))
def test_hier_gossip_equals_reference(name):
    """HierarchicalGossip: m, intra_mean, node_view, broadcast and mix
    equal the reference's (within 1e-6), and mix is the dense composite
    W @ x."""
    topo_t, topo_j = HIER[name](topology), HIER[name](jax_topology)
    hg = HierarchicalGossip.from_topology(topo_t, CPU)
    hj = jax_gossip.HierarchicalGossip.from_topology(topo_j)
    assert hg.m == hj.m and hg.node_size == hj.node_size
    x = np.random.default_rng(1).standard_normal((N, 2, 384)).astype(
        np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for got, want in ((hg.intra_mean(xt), hj.intra_mean(xj)),
                      (hg.node_view(xt), hj.node_view(xj)),
                      (hg.broadcast(hg.intra_mean(xt)),
                       hj.broadcast(hj.intra_mean(xj))),
                      (hg.mix(xt), hj.mix(xj))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    dense = DenseGossip.from_topology(topo_t, CPU).mix(xt)
    np.testing.assert_allclose(hg.mix(xt).numpy(), dense.numpy(), atol=1e-5)


# -- engines: per-step parity on the hier wire -------------------------

def _inject_node_draws(eng, comp_j, key):
    """RandK on the hier wire: the reference splits the key over the m
    node rows it encodes; hand the port engine those uniforms."""
    if isinstance(comp_j, JaxRandK):
        m = eng.n // eng.node_size
        draws = {"u": torch.from_numpy(_agent_uniforms(key, m, (eng.dim,)))}
        object.__setattr__(eng, "_draws", lambda comp, seed, k, rows: draws)


@pytest.mark.parametrize("name", ENGINES)
def test_hier_step_parity(name):
    """Every flat engine on hierarchical(ring(4), 2) with gossip="hier"
    (the 2-bit p=inf wire; the exact engines on 32-bit values): from the
    reference's state before every step, the state within 1e-5, the bits
    (node payload over node_size) equal, comp_err within 1e-6."""
    comp = (None, None) if name in EXACT else (QuantizePNorm(bits=2),
                                              JaxQuantizePNorm(bits=2))
    eng = engine_for(HIER["ring4x2"](topology), comp[0], 1300,
                     algorithm=name, gossip="hier", device=CPU)
    ref = jax_engine_for(HIER["ring4x2"](jax_topology), comp[1], 1300,
                         algorithm=name, gossip="hier", dither="fast")
    with jax.disable_jit():
        _step_parity(eng, ref, seed0=len(name),
                     lead_hyper=HYPER if name == "lead" else None)


@pytest.mark.parametrize("name", ["lead", "choco"])
def test_hier_randk_step_parity(name, monkeypatch):
    """RandK on the hier wire, with the reference's node-row draws."""
    eng = engine_for(HIER["ring2x4"](topology), RandK(ratio=0.25), 1300,
                     algorithm=name, gossip="hier", device=CPU)
    ref = jax_engine_for(HIER["ring2x4"](jax_topology), JaxRandK(ratio=0.25),
                         1300, algorithm=name, gossip="hier", dither="fast")
    import test_torch_baselines
    monkeypatch.setattr(test_torch_baselines, "_inject_reference_draws",
                        _inject_node_draws)
    with jax.disable_jit():
        _step_parity(eng, ref, seed0=3,
                     lead_hyper=HYPER if name == "lead" else None)


def test_hier_lead_takes_the_base_encode(monkeypatch):
    """On the hier wire LEAD encodes the node mean of its difference
    through the base's path: K1 (lead_diff_encode) is never called, where
    the flat ring step calls it once."""
    calls = []
    plain = lead_update.lead_diff_encode
    monkeypatch.setattr(lead_update, "lead_diff_encode",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    x = torch.randn(N, 600, generator=torch.Generator().manual_seed(0))
    for topo, gossip, want in ((topology.ring(N), "neighbor", 1),
                               (HIER["ring4x2"](topology), "hier", 0)):
        eng = engine_for(topo, QuantizePNorm(bits=2), 600, gossip=gossip,
                         device=CPU)
        calls.clear()
        eng.step_with_wire(eng.init(x, x), x, 1, step=0)
        assert len(calls) == want, gossip


# -- bits, neutral settings, runs --------------------------------------

@pytest.mark.parametrize("algo", ["lead", "choco"])
def test_hier_bits_are_flat_bits_over_node_size(algo):
    """hier bits are exactly the flat ring-8 bits over node_size (one
    encode per node), and the reference's."""
    prob_t, prob_j = near_consensus(D, seed=2)
    q4, j4 = QuantizePNorm(bits=4), JaxQuantizePNorm(bits=4)
    flat = run(engine_for(topology.ring(N), q4, D, algorithm=algo,
                          gossip="neighbor", eta=0.02, device=CPU),
               prob_t, prob_t.x_star, iters=6)
    hier = run(engine_for(HIER["ring2x4"](topology), q4, D, algorithm=algo,
                          gossip="hier", eta=0.02, device=CPU),
               prob_t, prob_t.x_star, iters=6)
    want = jax_run(jax_engine_for(HIER["ring2x4"](jax_topology), j4, D,
                                  algorithm=algo, gossip="hier", eta=0.02,
                                  dither="fast"),
                   prob_j, prob_j.x_star, iters=6)
    assert hier.bits_per_agent[-1] == flat.bits_per_agent[-1] / 4
    np.testing.assert_array_equal(hier.bits_per_agent, want.bits_per_agent)


@pytest.mark.parametrize("algo", ["lead", "choco"])
def test_node_size_one_is_bit_identical(algo):
    """hierarchical(ring(8), 1) under gossip="hier" reproduces the flat
    neighbor run on the ring bit for bit (every Trace field)."""
    prob, _ = near_consensus(D, seed=3)
    q4 = QuantizePNorm(bits=4)
    a = run(engine_for(topology.ring(N), q4, D, algorithm=algo,
                       gossip="neighbor", eta=0.02, device=CPU),
            prob, prob.x_star, iters=10)
    b = run(engine_for(topology.hierarchical(topology.ring(N), 1), q4, D,
                       algorithm=algo, gossip="hier", eta=0.02, device=CPU),
            prob, prob.x_star, iters=10)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("algorithm", ["lead", "choco"])
def test_hier_run_matches_reference(algorithm):
    """run() on hierarchical(ring(4), 2) with gossip="hier", 120 steps
    uncompressed: dist, consensus and loss within _trace_close's bound of
    the reference's (a convergent run), bits exactly."""
    prob_t, prob_j = run_problem(algorithm, 1024, seed=4)
    hy = dict(eta=0.5) if algorithm == "lead" else dict(eta=0.5, gamma=0.8)
    got = run(engine_for(HIER["ring4x2"](topology), None, 1024,
                         algorithm=algorithm, gossip="hier", device=CPU,
                         **hy), prob_t, prob_t.x_star, iters=120)
    want = jax_run(jax_engine_for(HIER["ring4x2"](jax_topology), None, 1024,
                                  algorithm=algorithm, gossip="hier", **hy),
                   prob_j, prob_j.x_star, iters=120)
    assert want.dist[-1] < 1e-3 * want.dist[0]
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)


def test_hier_faulted_run_matches_reference():
    """Uncompressed LEAD on the hier wire under renormalized link drops
    and agent outages (the fault tests' model and objective, 100 steps):
    the fault fields are the reference's, counted on the inter graph (the
    realized gap within 1e-6), the traces within _trace_close's bound;
    the stale policy raises, as the reference asserts."""
    prob_t, prob_j = run_problem("lead", 1024, seed=5)
    model = dict(seed=0, link_drop=0.1, agent_drop=0.1, dropout_window=3)
    got = run(LEADSim(topology=HIER["ring4x2"](topology), eta=0.5,
                      engine="flat", engine_gossip="hier",
                      faults=faults.FaultModel(**model)),
              prob_t, prob_t.x_star, iters=100)
    want = jax_run(jax_engine_for(HIER["ring4x2"](jax_topology), None, 1024,
                                  gossip="hier", eta=0.5,
                                  faults=jax_faults.FaultModel(**model)),
                   prob_j, prob_j.x_star, iters=100)
    assert want.dist[-1] < want.dist[0]          # not a divergent run
    for f in ("dropped_links", "staleness_mean", "staleness_max"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.realized_gap, want.realized_gap, rtol=0,
                               atol=1e-6)
    assert got.dropped_links.max() <= 2 * 4      # the inter ring's 8 links
    assert got.dropped_links.sum() > 0 and got.staleness_max.max() >= 1
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
    stale = faults.FaultModel(seed=1, link_drop=0.3, policy="stale")
    with pytest.raises(ValueError, match="renormalize"):
        engine_for(HIER["ring4x2"](topology), None, 64, gossip="hier",
                   faults=stale, device=CPU)
    with pytest.raises(AssertionError):
        jax_engine_for(HIER["ring4x2"](jax_topology), None, 64,
                       gossip="hier",
                       faults=jax_faults.FaultModel(seed=1, link_drop=0.3,
                                                    policy="stale"))
    # node_size 1 is the flat wire: the stale policy is accepted there
    engine_for(topology.hierarchical(topology.ring(N), 1), None, 64,
               gossip="hier", faults=stale, device=CPU)


def test_lead_converges_hier():
    """4-bit LEAD on hierarchical(ring(2), 4), the reference's
    well-posed problem carried across (8 agents x 64 rows > 256 dims),
    eta = 1/L, 400 steps: dist below 1e-3 and consensus below 1e-6, as the
    reference's test_lead_converges_hier_and_interval asks."""
    jprob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=N,
                                         m=64, d=256)
    prob = problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                              jprob.lam, device=CPU)
    eng = engine_for(HIER["ring2x4"](topology), QuantizePNorm(bits=4), 256,
                     gossip="hier", eta=1.0 / prob.mu_L[1], gamma=1.0,
                     device=CPU)
    tr = run(eng, prob, torch.tensor(np.asarray(jprob.x_star)), iters=400)
    assert tr.dist[-1] < 1e-3, tr.dist[-1]
    assert tr.consensus[-1] < 1e-6, tr.consensus[-1]
