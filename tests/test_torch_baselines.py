"""Parity of the port's baseline family (src/repro_torch/core/engines/
baselines.py, the generic compressed wire, LogisticRegression) with the JAX
reference, on the CPU, and the paper's Fig. 2 ordering in the port alone.

Both packages get the same numbers: inputs are made with numpy from a seed,
states and problems are carried across with repro_torch.core.convert.  The
p=inf quantizer's dither is the counter hash both packages share (the
reference's ``dither="fast"`` seeds step k with ``key_data(key)[-1] ^ k``,
and ``PRNGKey(s)`` has last word s).  RandK's and approximate TopK's draws
come from a threefry key in the reference; the test rebuilds them from the
key with the reference's split and hands them to the port engine in place
of its own stream (``_draws``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jax_topology
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.compression import RandK as JaxRandK
from repro.core.compression import TopK as JaxTopK
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.convex import LogisticRegression as JaxLogisticRegression
from repro.core.engines import ENGINES as JAX_ENGINES
from repro.core.engines import algorithm_name as jax_algorithm_name
from repro.core.engines import describe as jax_describe
from repro.core.engines import engine_for as jax_engine_for
from repro.core.engines import is_exact as jax_is_exact
from repro.core.lead import LEADHyper as JaxLEADHyper
from repro.core.simulator import run as jax_run
from repro_torch.core import topology
from repro_torch.core.compression import QuantizePNorm, RandK, TopK
from repro_torch.core.convert import (logreg_from_numpy, problem_from_numpy,
                                      state_from_numpy)
from repro_torch.core.convex import LinearRegression, LogisticRegression
from repro_torch.core.engines import (ENGINES, algorithm_name, describe,
                                      engine_for, is_exact)
from repro_torch.core.lead import LEADHyper
from repro_torch.core.simulator import LEADSim, run
from repro_torch.kernels import cuda_lib
from test_torch_engine import _trace_close

CPU = "cpu"
N, DIM = 8, 1300             # 3 logical blocks per agent, the last ragged
STEPS = 3
ATOL = 1e-5                  # the reference's flat-baseline contract
ERR_RTOL = 1e-6
COMPRESSED = ["choco", "deepsqueeze", "qdgd", "dcd"]
EXACT = ["dgd", "nids", "extra", "d2"]
# the wires and how the reference's random input reaches the port engine
WIRES = {
    "pinf": (lambda: QuantizePNorm(bits=2), lambda: JaxQuantizePNorm(bits=2)),
    "randk": (lambda: RandK(ratio=0.25), lambda: JaxRandK(ratio=0.25)),
    "topk": (lambda: TopK(ratio=0.1), lambda: JaxTopK(ratio=0.1)),
}
# Fig. 2 (benchmarks/bench_logreg.py's hypers, plus DCD, EXTRA and D2)
FIG2_ETA = 0.1
FIG2 = {"lead": {}, "choco": {"gamma": 0.6}, "deepsqueeze": {"gamma": 0.4},
        "qdgd": {"gamma": 0.4}, "dcd": {}, "dgd": {}, "nids": {},
        "extra": {}, "d2": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs: its torch work is
    many small ops, and the tier-1 run puts several pytest workers on the
    same cores, where torch's spinning thread pool slows each small op by
    orders of magnitude (a seconds-long sweep took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _agent_uniforms(key, n, shape):
    """The reference's draw inside encode_blocks: one key per agent by
    split, then uniform(kk, shape) per agent."""
    keys = jax.random.split(key, n)
    return np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, shape, jnp.float32))(keys))


def _inject_reference_draws(eng, comp_j, key):
    """Make the port engine's encode take the reference's draws for `key`
    (RandK: per-agent uniforms over the logical elements; a p != inf
    quantizer: per-agent uniforms over the logical blocks; approximate
    TopK: the sample indices) instead of its own counter-hash stream."""
    comp = eng.compressor
    if isinstance(comp, RandK):
        u = _agent_uniforms(key, eng.n, (eng.dim,))
        draws = {"u": torch.from_numpy(u)}
    elif isinstance(comp, QuantizePNorm) and comp.p != float("inf"):
        u = _agent_uniforms(key, eng.n, (eng.nb_logical, eng.block))
        draws = {"u": torch.from_numpy(u.reshape(eng.n, -1)[:, :eng.dim])}
    elif isinstance(comp, TopK) and comp.approx_threshold:
        m = comp.sample_size(eng.dim)
        idx = np.array(jax.random.randint(key, (eng.n, m), 0, eng.dim))
        draws = {"idx": torch.from_numpy(idx).to(torch.int64)}
    else:
        return                 # p=inf: the shared hash; exact TopK: none
    object.__setattr__(eng, "_draws", lambda comp, seed, k, rows: draws)


def _state_close(got, want, what):
    assert got._fields == want._fields
    for f in want._fields:
        if f == "k":
            assert int(got.k) == int(want.k), what
            continue
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ATOL, err_msg=f"{what}: {f}")


def _step_parity(eng, ref, steps=STEPS, seed0=0, lead_hyper=None):
    """From a common state (re-synced to the reference's before every
    step), one step each with the same gradient and seed: float state
    within ATOL, wire bits equal, comp_err within ERR_RTOL."""
    rng = np.random.default_rng(seed0)
    x0, g0 = (rng.standard_normal((eng.n, eng.dim)).astype(np.float32)
              for _ in range(2))
    if lead_hyper is None:
        st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0),
                        jax.random.PRNGKey(0))
    else:
        st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), lead_hyper[1])
    cls = type(eng.init(torch.from_numpy(x0), torch.from_numpy(g0)))
    for i in range(steps):
        g = rng.standard_normal((eng.n, eng.dim)).astype(np.float32)
        seed = int(rng.integers(0, 2 ** 31))
        key = jax.random.PRNGKey(seed)
        st_t = state_from_numpy(cls, st_j, device=CPU)
        _inject_reference_draws(eng, ref.compressor, key)
        if lead_hyper is None:
            new_j, err_j, bits_j = ref.step_with_wire(st_j, jnp.asarray(g),
                                                      key)
            new_t, err_t, bits_t = eng.step_with_wire(
                st_t, torch.from_numpy(g), seed)
        else:
            new_j, err_j, bits_j = ref.step_wire(st_j, jnp.asarray(g), key,
                                                 lead_hyper[1])
            new_t, err_t, bits_t = eng.step_wire(st_t, torch.from_numpy(g),
                                                 seed, lead_hyper[0])
        what = f"{describe(eng)} step {i}"
        _state_close(new_t, new_j, what)
        assert float(bits_t) == float(bits_j), what
        np.testing.assert_allclose(float(err_t), float(err_j),
                                   rtol=ERR_RTOL, atol=0, err_msg=what)
        st_j = new_j


# -- registry --------------------------------------------------------------------

def test_registry_covers_the_reference():
    """Every name and alias of the reference's registry is registered,
    CEDAS and C-GT included; exact and canonical names agree."""
    assert set(ENGINES) == set(JAX_ENGINES)
    for name in ENGINES:
        assert is_exact(name) == jax_is_exact(name), name
        assert ENGINES[name].__name__ == JAX_ENGINES[name].__name__, name
    for name in ("cedas", "cgt", "c-gt"):
        eng = engine_for(topology.ring(8), None, 64, algorithm=name,
                         device=CPU)
        assert algorithm_name(eng) == jax_algorithm_name(
            jax_engine_for(jax_topology.ring(8), None, 64, algorithm=name))


@pytest.mark.parametrize("name", sorted(JAX_ENGINES))
@pytest.mark.parametrize("dim", [1000, 7840])
def test_registry_entry_matches_reference(name, dim):
    """describe, the block layout (nb, nb_logical, tile_b), hyper_fields,
    the state fields and consensus_init agree for every name and alias,
    with each compressor the name takes."""
    comps = ([(None, None)] if jax_is_exact(name) else
             [(f(), g()) for f, g in WIRES.values()])
    for comp_t, comp_j in comps:
        for gossip in ("dense", "neighbor"):
            eng = engine_for(topology.ring(8), comp_t, dim, algorithm=name,
                             gossip=gossip, device=CPU)
            ref = jax_engine_for(jax_topology.ring(8), comp_j, dim,
                                 algorithm=name, gossip=gossip)
            assert describe(eng) == jax_describe(ref)
            assert algorithm_name(eng) == jax_algorithm_name(ref)
            assert (eng.nb, eng.nb_logical, eng.tile_b) == \
                (ref.nb, ref.nb_logical, ref.tile_b)
            assert eng.hyper_fields == ref.hyper_fields
    if name != "lead":
        assert eng.state_cls._fields == ref.state_cls._fields
        assert eng.consensus_init == ref.consensus_init


def test_registry_rejects_what_it_cannot_run():
    topo = topology.ring(8)
    with pytest.raises(ValueError):
        engine_for(topo, RandK(), 64, algorithm="nids", device=CPU)
    with pytest.raises(NotImplementedError):
        engine_for(topo, object(), 64, algorithm="choco", device=CPU)
    # CHOCO's local_stage is ported: the reference's frozen-hat step
    eng = engine_for(topo, QuantizePNorm(), 64, algorithm="choco", device=CPU)
    ref = jax_engine_for(jax_topology.ring(8), JaxQuantizePNorm(), 64,
                         algorithm="choco")
    rng = np.random.default_rng(11)
    x, xhat, g = (rng.standard_normal((8, 64)).astype(np.float32)
                  for _ in range(3))
    st_j = ref.init(jnp.asarray(x), jnp.asarray(g), jax.random.PRNGKey(0))
    st_j = st_j._replace(xhat=ref.blockify(jnp.asarray(xhat)),
                         xhat_w=ref._mix(ref.blockify(jnp.asarray(xhat))))
    st_t = state_from_numpy(type(eng.init(torch.from_numpy(x),
                                          torch.from_numpy(g))), st_j,
                            device=CPU)
    new_t, err_t = eng.local_stage(st_t, eng.blockify(torch.from_numpy(g)),
                                   eng.hypers_at(st_t.k))
    new_j, err_j = ref.local_stage(st_j, ref.blockify(jnp.asarray(g)),
                                   ref.hypers_at(st_j.k))
    assert float(err_t) == float(err_j) == 0.0
    _state_close(new_t, new_j, "choco local_stage")
    assert torch.equal(new_t.xhat, st_t.xhat)
    assert torch.equal(new_t.xhat_w, st_t.xhat_w)


@pytest.mark.parametrize("name", COMPRESSED + EXACT)
def test_init_and_state_conversion_match_reference(name):
    """init from the same x0, g0 equals the reference's, and a reference
    state carried across by state_from_numpy is equal field by field."""
    rng = np.random.default_rng(3)
    x0, g0 = (rng.standard_normal((N, DIM)).astype(np.float32)
              for _ in range(2))
    comp_t, comp_j = ((None, None) if name in EXACT else
                      (QuantizePNorm(bits=2), JaxQuantizePNorm(bits=2)))
    eng = engine_for(topology.ring(N), comp_t, DIM, algorithm=name,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(N), comp_j, DIM, algorithm=name)
    got = eng.init(torch.from_numpy(x0), torch.from_numpy(g0))
    want = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    _state_close(got, want, name)
    carried = state_from_numpy(type(got), want, device=CPU)
    assert carried.k.dtype == torch.int64
    for f in got._fields:
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(getattr(want, f)))


# -- exact baselines: free-run traces -------------------------------------------

@pytest.fixture(scope="module")
def readme_problem():
    """The README quickstart's problem (ring-8, m = d = 64), from the
    reference, with its eta = 1/L."""
    prob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=8,
                                        m=64, d=64)
    mu, L = prob.mu_L
    return prob, 1.0 / L


@pytest.mark.parametrize("name", EXACT)
def test_exact_free_run_trace_parity(readme_problem, name):
    """run(), 100 steps on the reference's arrays: dist, consensus and loss
    within _trace_close's bound, bits exactly, comp_err exactly 0."""
    jprob, eta = readme_problem
    prob = problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                              jprob.lam, device=CPU)
    x_star = torch.tensor(np.asarray(jprob.x_star))
    eng = engine_for(topology.ring(8), None, prob.d, algorithm=name, eta=eta,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(8), None, prob.d, algorithm=name,
                         eta=eta)
    got = run(eng, prob, x_star, iters=100)
    want = jax_run(ref, jprob, jprob.x_star, iters=100)
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f"{name} {f}")
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)
    assert not got.comp_err.any()


# -- compressed baselines and LEAD's generic wire: per-step parity ------------

@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("name", COMPRESSED)
def test_compressed_step_parity(name, wire, gossip):
    make_t, make_j = WIRES[wire]
    eng = engine_for(topology.ring(N), make_t(), DIM, algorithm=name,
                     gossip=gossip, device=CPU)
    ref = jax_engine_for(jax_topology.ring(N), make_j(), DIM, algorithm=name,
                         gossip=gossip, dither="fast")
    with jax.disable_jit():
        _step_parity(eng, ref, seed0=len(name))


LEAD_WIRES = {
    "randk": (lambda: RandK(ratio=0.25), lambda: JaxRandK(ratio=0.25)),
    "topk": (lambda: TopK(ratio=0.1), lambda: JaxTopK(ratio=0.1)),
    "topk_approx": (lambda: TopK(ratio=0.1, approx_threshold=True),
                    lambda: JaxTopK(ratio=0.1, approx_threshold=True)),
    "p2": (lambda: QuantizePNorm(bits=4, p=2.0),
           lambda: JaxQuantizePNorm(bits=4, p=2.0)),
}


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("wire", sorted(LEAD_WIRES))
def test_lead_generic_wire_step_parity(wire, gossip):
    """LEAD with a compressor other than the fused p=inf quantizer goes
    through the base's generic wire: the same per-step parity."""
    make_t, make_j = LEAD_WIRES[wire]
    hyper = (LEADHyper(eta=0.1, gamma=1.0, alpha=0.5),
             JaxLEADHyper(eta=0.1, gamma=1.0, alpha=0.5))
    eng = engine_for(topology.ring(N), make_t(), DIM, gossip=gossip,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(N), make_j(), DIM, gossip=gossip,
                         dither="fast")
    with jax.disable_jit():
        _step_parity(eng, ref, seed0=7, lead_hyper=hyper)


# -- gossip="ring": the uniform-ring alias of the neighbor gather ------------

@pytest.mark.parametrize("name", ["lead", "choco", "dcd"])
def test_ring_gossip_alias_matches_reference(name):
    """gossip="ring" is accepted, as in the reference (its tests drive LEAD
    and CHOCO through it: tests/test_engine.py, tests/test_flat_baselines.
    py): the same registry path and per-step parity with the reference's
    ring engine on the 2-bit p=inf wire."""
    hyper = (LEADHyper(eta=0.1, gamma=1.0, alpha=0.5),
             JaxLEADHyper(eta=0.1, gamma=1.0, alpha=0.5))
    eng = engine_for(topology.ring(N), QuantizePNorm(bits=2), DIM,
                     algorithm=name, gossip="ring", device=CPU)
    ref = jax_engine_for(jax_topology.ring(N), JaxQuantizePNorm(bits=2), DIM,
                         algorithm=name, gossip="ring", dither="fast")
    assert describe(eng) == jax_describe(ref)
    with jax.disable_jit():
        _step_parity(eng, ref, seed0=3,
                     lead_hyper=hyper if name == "lead" else None)


def test_ring_gossip_alias_runs_and_rejects_other_graphs():
    """CHOCO on the ring alias through run() with a schedule: bits are the
    static estimate per step and the run falls, as the reference's
    test_baseline_schedule_runs_through_simulator pins; uncompressed LEAD
    on the alias steps exactly as on dense gossip up to summation order.
    A graph other than the uniform ring raises ValueError."""
    prob = LinearRegression.generate(torch.Generator().manual_seed(0),
                                     n_agents=8, m=40, d=30, noise=0.05,
                                     device=CPU)
    q4 = QuantizePNorm(bits=4)
    algo = engine_for(topology.ring(8), q4, 30, algorithm="choco",
                      gossip="ring", eta=lambda k: 0.05 / (1.0 + 0.02 * k),
                      gamma=0.8, device=CPU)
    tr = run(algo, prob, prob.x_star, iters=150)
    assert np.isfinite(tr.dist[-1]) and tr.dist[-1] < tr.dist[0]
    np.testing.assert_allclose(
        tr.bits_per_agent, (np.arange(150) + 1) * q4.wire_bits(30))
    dense, ring = (run(LEADSim(topology=topology.ring(8), eta=0.02,
                               engine="flat", engine_gossip=g), prob,
                       prob.x_star, iters=50)
                   for g in ("dense", "ring"))
    _trace_close(ring.dist, dense.dist, "ring vs dense LEAD")
    for topo in (topology.torus_2d(2, 4), topology.fully_connected(4)):
        with pytest.raises(ValueError, match="uniform ring"):
            engine_for(topo, QuantizePNorm(bits=2), 64, gossip="ring",
                       device=CPU)


def test_generic_wire_marks_its_stages():
    """The generic wire marks its own stages for core/stage_timer.py."""
    from repro_torch.core.stage_timer import StageTimer
    x = torch.ones(N, DIM)
    orders = {
        QuantizePNorm(bits=2): ["message", "dither", "encode", "decode",
                                "mix", "update", "comp_err"],
        RandK(ratio=0.25): ["message", "dither", "encode", "decode", "mix",
                            "update", "comp_err"],
        TopK(ratio=0.1): ["message", "topk_mask", "encode", "decode", "mix",
                          "update", "comp_err"],
        TopK(ratio=0.1, approx_threshold=True): [
            "message", "dither", "topk_mask", "encode", "decode", "mix",
            "update", "comp_err"],
    }
    for comp, order in orders.items():
        eng = engine_for(topology.ring(N), comp, DIM, algorithm="choco",
                         device=CPU)
        st = eng.init(x, x)
        with StageTimer(CPU) as timer:
            eng.step_with_wire(st, x, 3)
        assert [n for n, _ in timer.stages()] == order, comp


# -- LogisticRegression ---------------------------------------------------------

@pytest.fixture(scope="module")
def logreg():
    """The Fig. 2 problem from the reference (8 agents x 256 samples, 784
    features, 10 classes, heterogeneous), and the port's copy."""
    jprob = JaxLogisticRegression.generate(jax.random.PRNGKey(1), n_agents=8,
                                           m_per_agent=256, d=784,
                                           n_classes=10, heterogeneous=True)
    prob = logreg_from_numpy(np.asarray(jprob.feats),
                             np.asarray(jprob.labels), jprob.n_classes,
                             jprob.lam, device=CPU)
    return jprob, prob


def test_logreg_matches_reference(logreg):
    """full_grad and loss on the reference's arrays within rtol 1e-5 (the
    gradient with an atol of 1e-5 x its largest entry: the analytic form
    sums in another order than autodiff, which moves entries near zero),
    and x* = solve_x_star(800) within 1e-4."""
    jprob, prob = logreg
    assert (prob.n, prob.d) == (jprob.n, jprob.d) == (8, 7840)
    rng = np.random.default_rng(0)
    for scale in (0.0, 0.1, 1.0):
        X = (scale * rng.standard_normal((8, 7840))).astype(np.float32)
        got = prob.full_grad(torch.from_numpy(X)).numpy()
        want = np.asarray(jprob.full_grad(jnp.asarray(X)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(float(prob.loss(torch.from_numpy(X))),
                                   float(jprob.loss(jnp.asarray(X))),
                                   rtol=1e-5)
    got = prob.solve_x_star(iters=800).numpy()
    want = np.asarray(jprob.solve_x_star(iters=800))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_logreg_generate_recipe():
    """The port draws its own instance: the reference's shapes and label
    sort, class-balanced in expectation, features of the right scale."""
    gen = torch.Generator().manual_seed(1)
    prob = LogisticRegression.generate(gen, device=CPU)
    assert tuple(prob.feats.shape) == (8, 256, 784)
    assert prob.labels.dtype == torch.int64 and prob.d == 7840
    flat = prob.labels.reshape(-1)
    assert bool((flat[1:] >= flat[:-1]).all())        # sorted: heterogeneous
    assert prob.labels[0].max() < prob.labels[-1].min()
    counts = torch.bincount(flat, minlength=10)
    assert int(counts.min()) > 150
    homo = LogisticRegression.generate(torch.Generator().manual_seed(1),
                                       heterogeneous=False, device=CPU)
    assert len(set(homo.labels[0].tolist())) == 10
    norms = prob.feats.norm(dim=-1)
    assert 2.0 < float(norms.mean()) < 4.5             # sqrt(1 + sep^2)
    assert LogisticRegression.from_arrays(
        prob.feats, prob.labels, 10, 1e-4, device=CPU).d == 7840


# -- the paper's Fig. 2 in the port ---------------------------------------------

def test_fig2_ordering_in_the_port():
    """The Fig. 2 sweep (chip_smoke.py's fig2 phase) at full size on the
    port's own problem, 200 iterations: LEAD within 1.01 x NIDS's final
    distance and below every compressed baseline's and DGD's, with a
    consensus error at least 10x below each compressed baseline's, on the
    analytic bit ratio against the exact wire; no kernel launches on the
    CPU."""
    prob = LogisticRegression.generate(torch.Generator().manual_seed(1),
                                       device=CPU)
    x_star = prob.solve_x_star(iters=800)
    topo, q2 = topology.ring(8), QuantizePNorm(bits=2)
    cuda_lib.reset_launch_counts()
    tr = {}
    for name, hy in FIG2.items():
        if name == "lead":
            algo = LEADSim(topology=topo, compressor=q2, eta=FIG2_ETA,
                           engine="flat")
        else:
            algo = engine_for(topo, None if is_exact(name) else q2, prob.d,
                              algorithm=name, eta=FIG2_ETA, device=CPU, **hy)
        tr[name] = run(algo, prob, x_star, iters=200)
        assert all(np.isfinite(a).all() for a in tr[name]), name
    assert sum(cuda_lib.launch_counts().values()) == 0
    lead = tr["lead"]
    assert lead.dist[-1] <= 1.01 * tr["nids"].dist[-1]
    for name in COMPRESSED + ["dgd"]:
        assert lead.dist[-1] < tr[name].dist[-1], name
    for name in COMPRESSED:
        assert lead.consensus[-1] * 10 <= tr[name].consensus[-1], name
        assert tr[name].bits_per_agent[-1] == lead.bits_per_agent[-1]
    d = prob.d
    ratio = (32 * d) / (3 * d + 32 * -(-d // 512))
    assert tr["dgd"].bits_per_agent[-1] / lead.bits_per_agent[-1] == \
        pytest.approx(ratio, rel=1e-6)
