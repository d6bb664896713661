"""Parity of the PyTorch port's main path (src/repro_torch/core) with the JAX
reference (src/repro/core): topology, problem, compressor accounting, the
flat LEAD and DGD engines, and the simulator, all on the CPU.

Both packages get the same numbers: inputs are made with numpy from a seed,
problems and states are carried across with repro_torch.core.convert, and a
quantized step gets the same dither seed on both sides (the reference's
``dither="fast"`` seeds step k with ``key_data(key)[-1] ^ k``, and
``PRNGKey(s)`` has last word s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jax_topology
from repro.core.compression import Identity as JaxIdentity
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.engines import describe as jax_describe
from repro.core.engines import engine_for as jax_engine_for
from repro.core.lead import LEADHyper as JaxLEADHyper
from repro.core.lead import _at as jax_at
from repro.core.lead import diminishing_schedules as jax_diminishing
from repro.core.lead import theorem1_ranges as jax_theorem1_ranges
from repro.core.simulator import LEADSim as JaxLEADSim
from repro.core.simulator import run as jax_run
from repro_torch.core import topology
from repro_torch.core.compression import Identity, QuantizePNorm, rel_err
from repro_torch.core.convert import problem_from_numpy, state_from_numpy
from repro_torch.core.convex import LinearRegression
from repro_torch.core.engines import (FlatLEADState,
                                      algorithm_name, describe, engine_for,
                                      is_exact)
from repro_torch.core.gossip import DenseGossip, EncodedNeighborGossip
from repro_torch.core.lead import (LEADHyper, _at, diminishing_schedules,
                                   theorem1_ranges)
from repro_torch.core.simulator import LEADSim, run
from repro_torch.core.stage_timer import StageTimer, mark
from repro_torch.kernels import cuda_lib

CPU = "cpu"
TOPOLOGIES = {
    "ring8": lambda m: m.ring(8),
    "torus_2x4": lambda m: m.torus_2d(2, 4),
    "er8": lambda m: m.erdos_renyi(8),
    "chain6": lambda m: m.chain(6),
    "star5": lambda m: m.star(5),
    "full4": lambda m: m.fully_connected(4),
}
TRACE_RTOL = 1e-5           # tests/test_engine.py's trajectory tolerance
TRACE_FLOOR = 1e-2          # see _trace_close
HYPER_FIELDS = ("eta", "gamma", "alpha")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs: its torch work is
    many small ops, and the tier-1 run puts several pytest workers on the
    same cores, where torch's spinning thread pool slows each small op by
    orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trace_close(got, want, what):
    """dist, consensus and loss traces (each >= 0) agree with the
    reference's at every step.

    Pointwise within 1e-5 relative wherever the reference is at least 1e-2
    of its first value.  Below that a squared distance nears the f32
    rounding of the iterates: LEAD's dist falls ~9 decades in 100 steps, to
    where iterates a few ulp apart move it by tens of percent.
    So every step is also held in norm space, |sqrt(got) - sqrt(want)|
    within 1e-5 of sqrt(want[0]): the iterates stay within 1e-5 of their
    starting distance from the optimum."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = want >= TRACE_FLOOR * want[0]
    np.testing.assert_allclose(got[keep], want[keep], rtol=TRACE_RTOL,
                               atol=0, err_msg=what)
    np.testing.assert_allclose(np.sqrt(got), np.sqrt(want), rtol=0,
                               atol=TRACE_RTOL * np.sqrt(want[0]),
                               err_msg=what)


@pytest.fixture(scope="module")
def readme_problem():
    """The README quickstart's problem (ring-8, m = d = 64), from the
    reference, with its eta = 1/L."""
    prob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=8,
                                        m=64, d=64)
    mu, L = prob.mu_L
    return prob, 1.0 / L


@pytest.fixture(scope="module")
def readme_runs(readme_problem):
    """The reference's headline: LEAD 2-bit (dither="fast") and DGD, 300
    iterations each."""
    prob, eta = readme_problem
    topo = jax_topology.ring(8)
    lead = JaxLEADSim(topology=topo, compressor=JaxQuantizePNorm(bits=2),
                      eta=eta, engine="flat", dither="fast")
    dgd = jax_engine_for(topo, None, prob.d, algorithm="dgd", eta=eta)
    return (jax_run(lead, prob, prob.x_star, iters=300),
            jax_run(dgd, prob, prob.x_star, iters=300))


def _port_problem(jprob):
    return (problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                               jprob.lam, device=CPU),
            torch.tensor(np.asarray(jprob.x_star)))


# -- topology, problem, compressor ---------------------------------------------

@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_matches_reference(name):
    """W, the neighbor table, the point-to-point rounds and the spectral
    quantities are equal to the reference's."""
    got = TOPOLOGIES[name](topology)
    want = TOPOLOGIES[name](jax_topology)
    assert got.name == want.name and repr(got) == repr(want)
    np.testing.assert_array_equal(got.W, want.W)
    np.testing.assert_array_equal(got.neighbors, want.neighbors)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert len(got.permute_rounds()) == len(want.permute_rounds())
    for (p1, w1), (p2, w2) in zip(got.permute_rounds(), want.permute_rounds()):
        assert p1 == p2
        np.testing.assert_array_equal(w1, w2)
    for attr in ("beta", "kappa_g", "lambda_min_plus", "spectral_gap"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(np.asarray(got), want.W)
    got.validate()
    metro = topology.metropolis(got.W > 0)
    np.testing.assert_array_equal(metro.W, jax_topology.metropolis(want.W > 0).W)


def test_topology_unported_forms_raise():
    ring = topology.ring(8)
    for call in (lambda: ring.with_interval(2),
                 lambda: ring.with_schedule(lambda k: ring, period=2),
                 lambda: topology.hierarchical(ring, 2),
                 lambda: topology.materialize([ring, ring])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError):
        topology.from_matrix(np.array([[0.9, 0.1], [0.3, 0.7]]))
    assert topology.as_topology(ring.W).W.tolist() == ring.W.tolist()


def test_linear_regression_matches_reference(readme_problem):
    """full_grad, loss, x_star and mu_L of the reference's A, b within 1e-5
    relative."""
    jprob, _ = readme_problem
    prob, _ = _port_problem(jprob)
    assert (prob.n, prob.d, prob.lam) == (jprob.n, jprob.d, jprob.lam)
    X = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    np.testing.assert_allclose(prob.full_grad(torch.from_numpy(X)).numpy(),
                               np.asarray(jprob.full_grad(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(prob.loss(torch.from_numpy(X))),
                               float(jprob.loss(jnp.asarray(X))), rtol=1e-5)
    np.testing.assert_allclose(prob.x_star.numpy(), np.asarray(jprob.x_star),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prob.mu_L, jprob.mu_L, rtol=1e-5)
    gen = LinearRegression.generate(torch.Generator().manual_seed(1),
                                    n_agents=4, m=16, d=8, device=CPU)
    assert tuple(gen.A.shape) == (4, 16, 8) and tuple(gen.b.shape) == (4, 16)


@pytest.mark.parametrize("bits", range(1, 8))
def test_wire_bits_match_reference(bits):
    for d in (64, 1000, 4096, 2 ** 25):
        assert QuantizePNorm(bits=bits).wire_bits(d) == \
            JaxQuantizePNorm(bits=bits).wire_bits(d)
        assert Identity().wire_bits(d) == JaxIdentity().wire_bits(d)
    assert QuantizePNorm(bits=bits).variance_constant() == \
        JaxQuantizePNorm(bits=bits).variance_constant()
    assert Identity().variance_constant() == 0.0


def test_hyper_helpers_match_reference():
    """theorem1_ranges and the Theorem-2 schedules, resolved on the device
    at a 0-d k, agree with the reference."""
    args = (0.2, 8.0, 64.0, 1.333, 0.1)
    assert theorem1_ranges(*args) == jax_theorem1_ranges(*args)
    for C in (0.0, 2.0):
        got = diminishing_schedules(0.2, 8.0, C, 1.333, 3.0)
        want = jax_diminishing(0.2, 8.0, C, 1.333, 3.0)
        for k in (0, 1, 7, 100):
            kt = torch.tensor(k, dtype=torch.int64)
            kj = jnp.asarray(k, jnp.int32)
            for f in ("eta", "gamma", "alpha"):
                np.testing.assert_allclose(
                    float(_at(getattr(got, f), kt)),
                    float(jax_at(getattr(want, f), kj)), rtol=1e-6)
    k = torch.zeros((), dtype=torch.int64)
    assert _at(0.5, k).dtype == torch.float32 and float(_at(0.5, k)) == 0.5
    assert float(_at(torch.tensor(0.25), k)) == 0.25


def test_rel_err_and_gossip_backends():
    rng = np.random.default_rng(1)
    q, t, r = (rng.standard_normal((8, 2, 512)).astype(np.float32)
               for _ in range(3))
    want = float(jnp.linalg.norm(jnp.ravel(q - t))
                 / (jnp.linalg.norm(jnp.ravel(r)) + 1e-12))
    got = float(rel_err(*(torch.from_numpy(a) for a in (q, t, r))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    x = torch.from_numpy(q)
    for name in ("ring8", "torus_2x4", "er8"):
        topo = TOPOLOGIES[name](topology)
        dense = DenseGossip.from_topology(topo, CPU).mix(x)
        sparse = EncodedNeighborGossip.from_topology(topo, CPU).mix(x)
        np.testing.assert_allclose(sparse.numpy(), dense.numpy(), atol=1e-5)
        want = np.tensordot(topo.W.astype(np.float32), q, axes=([1], [0]))
        np.testing.assert_allclose(dense.numpy(), want, atol=1e-5)


# -- engines -----------------------------------------------------------------

def test_registry_matches_reference():
    topo_t, topo_j = topology.ring(8), jax_topology.ring(8)
    for comp_t, comp_j in ((QuantizePNorm(bits=2), JaxQuantizePNorm(bits=2)),
                           (None, None)):
        eng = engine_for(topo_t, comp_t, 1000, device=CPU)
        ref = jax_engine_for(topo_j, comp_j, 1000)
        assert describe(eng) == jax_describe(ref)
        assert (eng.nb, eng.nb_logical, eng.tile_b) == \
            (ref.nb, ref.nb_logical, ref.tile_b)
        assert eng.hyper_fields == ref.hyper_fields
    dgd = engine_for(topo_t, Identity(), 64, algorithm="dgd", device=CPU)
    assert dgd.compressor is None and algorithm_name(dgd) == "dgd"
    assert describe(dgd) == jax_describe(jax_engine_for(topo_j, None, 64,
                                                        algorithm="dgd"))
    assert is_exact("dgd") and not is_exact("lead")
    for unported in ("cedas", "cgt"):
        with pytest.raises(KeyError):
            engine_for(topo_t, None, 64, algorithm=unported, device=CPU)
    with pytest.raises(ValueError):
        engine_for(topo_t, QuantizePNorm(), 64, algorithm="dgd", device=CPU)


def test_unported_paths_raise():
    topo = topology.ring(8)
    with pytest.raises(NotImplementedError, match="threefry"):
        engine_for(topo, None, 64, dither="match", device=CPU)
    with pytest.raises(NotImplementedError):
        engine_for(topo, None, 64, gossip="hier", device=CPU)
    with pytest.raises(NotImplementedError):
        engine_for(topo, None, 64, faults=object(), device=CPU)
    # the tree path is ported: it steps (and still needs a compressor)
    tree = LEADSim(topology=topo, compressor=Identity(), engine="tree",
                   device=CPU)
    x = torch.ones(8, 64)
    new, err, bits = tree.step_with_wire(tree.init(x, x), x, 0)
    assert int(new.k) == 1 and bool(torch.isfinite(new.x).all())
    assert float(bits) == Identity().wire_bits(64)
    with pytest.raises(ValueError):
        LEADSim(topology=topo, engine="tree")
    with pytest.raises(NotImplementedError):
        LEADSim(topology=topo, faults=object())
    with pytest.raises(ValueError):
        LEADSim(topology=topo, engine="pytree")
    prob = LinearRegression.generate(torch.Generator().manual_seed(0),
                                     n_agents=8, m=8, d=8, device=CPU)
    with pytest.raises(NotImplementedError):
        run(LEADSim(topology=topo), prob, prob.x_star, iters=2,
            stochastic=True)
    # LEAD with a p=2 quantizer takes the generic wire and steps
    eng = engine_for(topo, QuantizePNorm(bits=2, p=2.0), 64, device=CPU)
    x = torch.ones(8, 64)
    new, err, bits = eng.step_wire(eng.init(x, x), x, 0)
    assert int(new.k) == 1 and bool(torch.isfinite(new.x).all())
    assert float(bits) == QuantizePNorm(bits=2).wire_bits(64)


def test_fast_dither_plane_matches_reference():
    """The engine's dither plane for seed s at step k is the reference's
    for PRNGKey(s) at k, bit for bit."""
    eng = engine_for(topology.ring(8), QuantizePNorm(bits=2), 1000,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(8), JaxQuantizePNorm(bits=2), 1000,
                         dither="fast")
    for s, k in ((0, 0), (7, 3), (2 ** 31 - 1, 12)):
        want = ref._dither_plane(jax.random.PRNGKey(s), jnp.asarray(k, jnp.int32))
        got = eng._dither_plane(s, torch.tensor(k, dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["lead", "dgd"])
def test_init_and_state_conversion_match_reference(algorithm):
    """init from the same x0, g0 equals the reference's, and a reference
    state carried across by state_from_numpy is equal field by field."""
    rng = np.random.default_rng(2)
    x0, g0 = (rng.standard_normal((8, 1000)).astype(np.float32)
              for _ in range(2))
    eng = engine_for(topology.ring(8), None, 1000, algorithm=algorithm,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(8), None, 1000, algorithm=algorithm)
    got = eng.init(torch.from_numpy(x0), torch.from_numpy(g0))
    want = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    carried = state_from_numpy(type(got), want, device=CPU)
    assert carried._fields == want._fields
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6)
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert carried.k.dtype == torch.int64
    np.testing.assert_allclose(eng.x_of(got).numpy(),
                               np.asarray(ref.x_of(want)), atol=1e-6)


def test_lead_local_stage_matches_reference():
    """The no-communication step (X advances, H / H_w / D freeze)."""
    rng = np.random.default_rng(4)
    x0, g0, g = (rng.standard_normal((8, 1000)).astype(np.float32)
                 for _ in range(3))
    eng = engine_for(topology.ring(8), None, 1000, device=CPU)
    ref = jax_engine_for(jax_topology.ring(8), None, 1000)
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0))
    st_t = state_from_numpy(FlatLEADState, st_j, device=CPU)
    hy_t = eng.hypers_at(st_t.k)
    hy_j = ref.hypers_at(st_j.k)
    new_t, err_t = eng.local_stage(st_t, eng.blockify(torch.from_numpy(g)),
                                   hy_t)
    new_j, err_j = ref.local_stage(st_j, ref.blockify(jnp.asarray(g)), hy_j)
    assert float(err_t) == float(err_j) == 0.0
    for f in FlatLEADState._fields:
        np.testing.assert_allclose(getattr(new_t, f).numpy(),
                                   np.asarray(getattr(new_j, f)), atol=1e-6)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_lead_step_parity_quantized(gossip):
    """2-bit LEAD, step by step from a common state (re-synced to the
    reference before every step), with the same gradient and dither seed:
    codes equal (the reference's eager encode) and x, d, h, hw within
    1e-4 * max|x| except on a fraction below 1e-5 of elements - the bound
    tests/dist_worker.py uses, for the same reason (a 1-ulp difference can
    flip floor() on an element sitting on a level boundary)."""
    n, dim, steps = 8, 1000, 10
    hyper_t = LEADHyper(eta=0.1, gamma=1.0, alpha=0.5)
    hyper_j = JaxLEADHyper(eta=0.1, gamma=1.0, alpha=0.5)
    eng = engine_for(topology.ring(n), QuantizePNorm(bits=2), dim,
                     gossip=gossip, device=CPU)
    ref = jax_engine_for(jax_topology.ring(n), JaxQuantizePNorm(bits=2), dim,
                         dither="fast", gossip=gossip)
    step_ref = jax.jit(lambda s, g, key: ref.step_wire(s, g, key, hyper_j))
    rng = np.random.default_rng(5)
    x0, g0 = (rng.standard_normal((n, dim)).astype(np.float32)
              for _ in range(2))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), hyper_j)
    total = n_bad = n_code = n_codes = 0
    scale = 1.0
    for _ in range(steps):
        g = rng.standard_normal((n, dim)).astype(np.float32)
        seed = int(rng.integers(0, 2 ** 31))
        key = jax.random.PRNGKey(seed)
        assert int(jax.random.key_data(key)[-1]) == seed
        st_t = state_from_numpy(FlatLEADState, st_j, device=CPU)
        gt = torch.from_numpy(g)

        hy_t = {f: _at(getattr(hyper_t, f), st_t.k) for f in HYPER_FIELDS}
        hy_j = {f: jax_at(getattr(hyper_j, f), st_j.k) for f in HYPER_FIELDS}
        code_t = eng.encode_stage(st_t, eng.blockify(gt), seed, hy_t)[0]["code"]
        code_j = ref.encode_stage(st_j, ref.blockify(jnp.asarray(g)), key,
                                  hy_j)[0]["code"]
        n_code += int((code_t.numpy() != np.asarray(code_j)).sum())
        n_codes += code_t.numel()

        new_j, cerr_j, bits_j = step_ref(st_j, jnp.asarray(g), key)
        new_t, cerr_t, bits_t = eng.step_wire(st_t, gt, seed, hyper_t)
        assert float(bits_t) == float(bits_j)
        assert int(new_t.k) == int(new_j.k)
        np.testing.assert_allclose(float(cerr_t), float(cerr_j), rtol=1e-3)
        scale = max(scale, float(np.max(np.abs(np.asarray(new_j.x)))))
        for f in ("x", "d", "h", "hw"):
            dev = np.abs(getattr(new_t, f).numpy().astype(np.float64)
                         - np.asarray(getattr(new_j, f), np.float64))
            total += dev.size
            n_bad += int((dev > 1e-4 * scale).sum())
        st_j = new_j
    assert n_code <= 1e-4 * n_codes, (n_code, n_codes)
    assert n_bad < 1e-5 * total, (n_bad, total)


@pytest.mark.parametrize("algorithm", ["lead", "dgd"])
def test_free_run_trace_parity(readme_problem, algorithm):
    """run(), 100 steps from the same problem arrays: LEAD uncompressed and
    DGD give the reference's dist, consensus and loss traces, and exactly
    its bits."""
    jprob, eta = readme_problem
    prob, x_star = _port_problem(jprob)
    if algorithm == "lead":
        algo_t = LEADSim(topology=topology.ring(8), eta=eta)
        algo_j = JaxLEADSim(topology=jax_topology.ring(8), eta=eta,
                            engine="flat")
    else:
        algo_t = engine_for(topology.ring(8), None, prob.d, algorithm="dgd",
                            eta=eta, device=CPU)
        algo_j = jax_engine_for(jax_topology.ring(8), None, prob.d,
                                algorithm="dgd", eta=eta)
    got = run(algo_t, prob, x_star, iters=100)
    want = jax_run(algo_j, jprob, jprob.x_star, iters=100)
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)
    np.testing.assert_allclose(got.comp_err, want.comp_err, atol=1e-5)
    if algorithm == "lead":                 # exact: converges to x*
        assert got.dist[-1] < 1e-6 * got.dist[0]


def test_bits_and_headline_on_reference_data(readme_problem, readme_runs):
    """The README run in the port on the reference's data: bits exactly
    the reference's for LEAD 2-bit and DGD, and LEAD below 1e-3 x DGD's
    distance (the quantized trace matches only in distribution: the port
    seeds each step's dither from its own counter)."""
    jprob, eta = readme_problem
    prob, x_star = _port_problem(jprob)
    ref_lead, ref_dgd = readme_runs
    cuda_lib.reset_launch_counts()
    lead = run(LEADSim(topology=topology.ring(8),
                       compressor=QuantizePNorm(bits=2), eta=eta),
               prob, x_star, iters=300)
    assert sum(cuda_lib.launch_counts().values()) == 0    # CPU: plain only
    dgd = run(engine_for(topology.ring(8), None, prob.d, algorithm="dgd",
                         eta=eta, device=CPU), prob, x_star, iters=300)
    np.testing.assert_array_equal(lead.bits_per_agent, ref_lead.bits_per_agent)
    np.testing.assert_array_equal(dgd.bits_per_agent, ref_dgd.bits_per_agent)
    _trace_close(dgd.dist, ref_dgd.dist, "dgd dist")
    assert lead.dist[-1] < 1e-3 * dgd.dist[-1]
    assert ref_lead.dist[-1] < 1e-3 * ref_dgd.dist[-1]


def test_headline_in_the_port_alone(readme_runs):
    """The README snippet's configuration on the port's own data (drawn
    from a torch.Generator): LEAD 2-bit reaches 1e-3 x DGD's distance, on
    the reference's bit saving."""
    ref_lead, ref_dgd = readme_runs
    prob = LinearRegression.generate(torch.Generator().manual_seed(0),
                                     n_agents=8, m=64, d=64, device=CPU)
    topo = topology.ring(8)
    mu, L = prob.mu_L
    eta = 1.0 / L
    lead = LEADSim(topology=topo, compressor=QuantizePNorm(bits=2), eta=eta)
    tr = run(lead, prob, prob.x_star, iters=300)
    dgd = engine_for(topo, None, prob.d, algorithm="dgd", eta=eta, device=CPU)
    tr_dgd = run(dgd, prob, prob.x_star, iters=300)
    assert np.isfinite(tr.dist).all() and np.isfinite(tr.comp_err).all()
    assert tr.dist[-1] < 1e-3 * tr_dgd.dist[-1]
    saving = tr_dgd.bits_per_agent[-1] / tr.bits_per_agent[-1]
    assert saving == ref_dgd.bits_per_agent[-1] / ref_lead.bits_per_agent[-1]


def test_stage_timer_marks_the_run():
    """A StageTimer times run()'s own stages: every step marks them in the
    LEAD step's order, and timing changes nothing in the trace."""
    prob = LinearRegression.generate(torch.Generator().manual_seed(3),
                                     n_agents=8, m=16, d=40, device=CPU)
    lead = LEADSim(topology=topology.ring(8), compressor=QuantizePNorm(bits=2),
                   eta=0.02)
    plain = run(lead, prob, prob.x_star, iters=3)
    with StageTimer(CPU) as timer:
        timed = run(lead, prob, prob.x_star, iters=3)
    order = ["gradient", "dither", "diff_encode", "decode", "mix", "update",
             "comp_err", "metrics"]
    stages = timer.stages()
    assert [name for name, _ in stages] == order * 3
    assert all(ms >= 0.0 for _, ms in stages)
    for f in plain._fields:
        np.testing.assert_array_equal(getattr(timed, f), getattr(plain, f))
    with StageTimer(CPU) as again:         # the first timer is inactive now
        mark("gradient")
    assert [n for n, _ in again.stages()] == ["gradient"]
    assert len(timer.stages()) == 24


def test_run_options():
    """record_every keeps every recorded row of the full trace; topology=
    rebinds the graph; distinct seeds give distinct quantized traces."""
    prob = LinearRegression.generate(torch.Generator().manual_seed(3),
                                     n_agents=8, m=16, d=40, device=CPU)
    lead = LEADSim(topology=topology.ring(8), compressor=QuantizePNorm(bits=2),
                   eta=0.02)
    full = run(lead, prob, prob.x_star, iters=12)
    sub = run(lead, prob, prob.x_star, iters=12, record_every=5)
    for f in full._fields:
        np.testing.assert_array_equal(getattr(sub, f), getattr(full, f)[::5])
    other = run(lead, prob, prob.x_star, iters=12, seed=1)
    assert not np.array_equal(other.dist, full.dist)
    torus = run(lead, prob, prob.x_star, iters=12,
                topology=topology.torus_2d(2, 4))
    assert not np.array_equal(torus.dist, full.dist)
    bound = dataclasses.replace(lead, dim=40, device=CPU)
    assert bound._flat_engine(40) is bound._flat_engine(40)
