"""Parity of the port's communication interval (``topo.with_interval(tau)``:
the engines' local_stage, the host-gated wire of ``_step_core`` and
``step_with_wire_faulted``, run()'s fault metrics gated to 0 on skipped
steps) with the JAX reference, on the CPU; the mirror of the reference's
tests/test_hierarchical.py for the interval half.

Bits and fault fields are compared exactly (the realized gap within
1e-6); local stages and steps with the per-step parity of
tests/test_torch_baselines.py; run() traces with ``_trace_close`` on
uncompressed, convergent runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro.core import topology as jax_topology
from repro.core.compression import QuantizePNorm as JaxQuantizePNorm
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import run as jax_run
from repro_torch.core import faults, topology
from repro_torch.core.compression import QuantizePNorm
from repro_torch.core.convert import problem_from_numpy, state_from_numpy
from repro_torch.core.engines import engine_for
from repro_torch.core.simulator import LEADSim, run
from test_torch_baselines import _state_close, _step_parity
from test_torch_banks import ENGINES, EXACT, HYPER, run_problem
from test_torch_engine import _trace_close

CPU = "cpu"
N, D = 8, 768


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs (many small ops;
    several pytest workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _comps(name, bits=2):
    if name in EXACT:
        return None, None
    return QuantizePNorm(bits=bits), JaxQuantizePNorm(bits=bits)


def test_with_interval_validates_and_threads_through_materialize():
    """tau >= 1; a periodic schedule materializes into a bank that keeps
    tau; a hierarchical graph takes its inter graph's tau."""
    with pytest.raises(ValueError):
        topology.ring(N).with_interval(0)
    assert topology.ring(N).with_interval(3).comm_interval == 3
    sched = topology.ring(N).with_schedule(
        lambda k: topology.ring(N), period=2).with_interval(3)
    bank = topology.materialize(sched)
    assert isinstance(bank, topology.TopologyBank)
    assert bank.comm_interval == 3
    eng = engine_for(topology.ring(N).with_interval(4), None, 64,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(N).with_interval(4), None, 64)
    assert eng.comm_interval == ref.comm_interval == 4


@pytest.mark.parametrize("name", ENGINES)
def test_local_stage_matches_reference(name):
    """Every flat engine's no-communication step from a common state: the
    reference's state (within 1e-5), comp_err exactly 0; LEAD, CHOCO and
    DCD freeze their tracking fields, the others take the self-delivery
    step."""
    comp_t, comp_j = _comps(name)
    eng = engine_for(topology.ring(N), comp_t, 1300, algorithm=name,
                     device=CPU)
    ref = jax_engine_for(jax_topology.ring(N), comp_j, 1300, algorithm=name)
    rng = np.random.default_rng(len(name))
    x0, g0, g = (rng.standard_normal((N, 1300)).astype(np.float32)
                 for _ in range(3))
    if name == "lead":
        st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), HYPER[1])
    else:
        st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0),
                        jax.random.PRNGKey(0))
    cls = type(eng.init(torch.from_numpy(x0), torch.from_numpy(g0)))
    st_t = state_from_numpy(cls, st_j, device=CPU)
    new_t, err_t = eng.local_stage(st_t, eng.blockify(torch.from_numpy(g)),
                                   eng.hypers_at(st_t.k))
    new_j, err_j = ref.local_stage(st_j, ref.blockify(jnp.asarray(g)),
                                   ref.hypers_at(st_j.k))
    assert float(err_t) == float(err_j) == 0.0
    _state_close(new_t, new_j, f"{name} local_stage")
    if name in ("lead", "choco", "dcd"):
        for f in eng.consensus_init:
            assert torch.equal(getattr(new_t, f), getattr(st_t, f)), f


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("name", ENGINES)
def test_interval_step_parity(name, gossip):
    """Every flat engine on ring(8).with_interval(4): five steps from the
    reference's state (k = 0 and 4 communicate, 1-3 are local, the gate
    read off state.k), the state within 1e-5, bits equal (0 on local
    steps), comp_err within 1e-6."""
    comp_t, comp_j = _comps(name)
    eng = engine_for(topology.ring(N).with_interval(4), comp_t, 1300,
                     algorithm=name, gossip=gossip, device=CPU)
    ref = jax_engine_for(jax_topology.ring(N).with_interval(4), comp_j, 1300,
                         algorithm=name, gossip=gossip, dither="fast")
    with jax.disable_jit():
        _step_parity(eng, ref, steps=5, seed0=len(name + gossip),
                     lead_hyper=HYPER if name == "lead" else None)


@pytest.mark.parametrize("algo", ["lead", "choco", "dcd", "dgd"])
def test_local_step_freezes_communication_state(algo):
    """tau = 2: the communicating step (k = 0) ships bits, the local step
    (k = 1) ships none and moves only x; its fault state is untouched."""
    comp = None if algo == "dgd" else QuantizePNorm(bits=4)
    fm = faults.FaultModel(seed=3, link_drop=0.5)
    eng = engine_for(topology.ring(N).with_interval(2), comp, D,
                     algorithm=algo, gossip="neighbor", eta=0.02,
                     faults=fm, device=CPU)
    gen = torch.Generator().manual_seed(4)
    x0, g0, g = (torch.randn(N, D, generator=gen) for _ in range(3))
    s1 = eng.init(x0, g0)
    s1, _, bits1 = eng.step_with_wire(s1, eng.blockify(g), 1, step=0)
    s2, _, bits2 = eng.step_with_wire(s1, eng.blockify(g), 1, step=1)
    assert float(bits1) > 0.0 and float(bits2) == 0.0
    assert not torch.equal(s2.x, s1.x)
    for f in eng.consensus_init:
        assert torch.equal(getattr(s2, f), getattr(s1, f)), f
    fs = eng.init_fault_state(s1)
    fs = fs._replace(age=fs.age + 3)
    _, fs2, err, bits = eng.step_with_wire_faulted(s1, fs, g, 1, step=1)
    assert fs2 is fs and float(err) == float(bits) == 0.0


@pytest.mark.parametrize("algo", ["lead", "choco"])
def test_interval_bits_are_flat_bits_over_tau(algo):
    """tau = 4 bits are exactly the every-step bits over 4, and the
    reference's."""
    prob_t, prob_j = run_problem(algo, D, seed=2)
    q4 = QuantizePNorm(bits=4)
    flat = run(engine_for(topology.ring(N), q4, D, algorithm=algo,
                          gossip="neighbor", eta=0.02, device=CPU),
               prob_t, prob_t.x_star, iters=8)
    tau4 = run(engine_for(topology.ring(N).with_interval(4), q4, D,
                          algorithm=algo, gossip="neighbor", eta=0.02,
                          device=CPU), prob_t, prob_t.x_star, iters=8)
    want = jax_run(jax_engine_for(jax_topology.ring(N).with_interval(4),
                                  JaxQuantizePNorm(bits=4), D,
                                  algorithm=algo, gossip="neighbor",
                                  eta=0.02, dither="fast"),
                   prob_j, prob_j.x_star, iters=8)
    assert tau4.bits_per_agent[-1] == flat.bits_per_agent[-1] / 4
    np.testing.assert_array_equal(tau4.bits_per_agent, want.bits_per_agent)
    assert (tau4.comp_err[1::4] == 0).all() and (tau4.comp_err[::4] > 0).all()


@pytest.mark.parametrize("algo", ["lead", "choco"])
def test_tau1_is_bit_identical(algo):
    """with_interval(1) reproduces the every-step run bit for bit (every
    Trace field)."""
    prob, _ = run_problem(algo, D, seed=3)
    q4 = QuantizePNorm(bits=4)
    a, b = (run(engine_for(topo, q4, D, algorithm=algo, gossip="neighbor",
                           eta=0.02, device=CPU), prob, prob.x_star,
                iters=10)
            for topo in (topology.ring(N), topology.ring(N).with_interval(1)))
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("algorithm", ["lead", "choco"])
def test_interval_run_matches_reference(algorithm):
    """run() on ring(8).with_interval(4), 160 steps uncompressed (LEAD at
    gamma 0.5): dist, consensus and loss within _trace_close's bound of
    the reference's (a convergent run), bits exactly."""
    prob_t, prob_j = run_problem(algorithm, 1024, seed=6)
    hy = (dict(eta=0.5, gamma=0.5) if algorithm == "lead"
          else dict(eta=0.5, gamma=0.8))
    got = run(engine_for(topology.ring(N).with_interval(4), None, 1024,
                         algorithm=algorithm, gossip="neighbor", device=CPU,
                         **hy), prob_t, prob_t.x_star, iters=160)
    want = jax_run(jax_engine_for(jax_topology.ring(N).with_interval(4),
                                  None, 1024, algorithm=algorithm,
                                  gossip="neighbor", **hy),
                   prob_j, prob_j.x_star, iters=160)
    assert want.dist[-1] < 1e-3 * want.dist[0]
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)


@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_fault_metrics_gate_on_skip_steps(gossip):
    """A faulted tau = 2 run: dropped links and realized gap 0 on the
    skipped steps, nonzero drops on communicating steps, staleness frozen
    across a skipped step; the four fault fields the reference's (the gap
    within 1e-6), held every step and every third."""
    prob_t, prob_j = run_problem("lead", 1024, seed=7)
    model = dict(seed=1, link_drop=0.5, agent_drop=0.2, dropout_window=2)
    for every in (1, 3):
        got = run(LEADSim(topology=topology.ring(N).with_interval(2),
                          compressor=QuantizePNorm(bits=2), eta=0.02,
                          engine="flat", engine_gossip=gossip,
                          faults=faults.FaultModel(**model)),
                  prob_t, prob_t.x_star, iters=12, record_every=every)
        want = jax_run(jax_engine_for(
            jax_topology.ring(N).with_interval(2), JaxQuantizePNorm(bits=2),
            1024, gossip=gossip, eta=0.02, dither="fast",
            faults=jax_faults.FaultModel(**model)),
            prob_j, prob_j.x_star, iters=12, record_every=every)
        for f in ("dropped_links", "staleness_mean", "staleness_max",
                  "bits_per_agent"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)), f)
        np.testing.assert_allclose(got.realized_gap, want.realized_gap,
                                   rtol=0, atol=1e-6)
        if every == 1:
            assert not got.dropped_links[1::2].any()
            assert not got.realized_gap[1::2].any()
            assert got.dropped_links[0::2].any()
            np.testing.assert_array_equal(got.staleness_max[1::2],
                                          got.staleness_max[0::2])


def test_hier_interval_run_matches_reference():
    """Both knobs at once: hierarchical(ring(4), 2) with tau = 2 under
    gossip="hier", 2-bit LEAD, 12 steps: bits exactly the flat ring-8
    run's over 4 (node_size 2 times tau 2) and the reference's."""
    prob_t, prob_j = run_problem("lead", 1024, seed=8)
    hier = topology.hierarchical(topology.ring(4), 2).with_interval(2)
    jhier = jax_topology.hierarchical(jax_topology.ring(4), 2)
    jhier = jhier.with_interval(2)
    got = run(engine_for(hier, QuantizePNorm(bits=2), 1024, gossip="hier",
                         eta=0.02, device=CPU), prob_t, prob_t.x_star,
              iters=12)
    want = jax_run(jax_engine_for(jhier, JaxQuantizePNorm(bits=2), 1024,
                                  gossip="hier", eta=0.02, dither="fast"),
                   prob_j, prob_j.x_star, iters=12)
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)
    assert got.bits_per_agent[-1] == 12 * QuantizePNorm(bits=2).wire_bits(
        1024) / 4


def test_lead_converges_interval():
    """4-bit LEAD on ring(8).with_interval(4) at gamma 1/4, the reference's
    well-posed problem carried across, eta = 1/L, 400 steps: dist below
    1e-2, as the reference's test_lead_converges_hier_and_interval asks."""
    jprob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=N,
                                         m=64, d=256)
    prob = problem_from_numpy(np.asarray(jprob.A), np.asarray(jprob.b),
                              jprob.lam, device=CPU)
    eng = engine_for(topology.ring(N).with_interval(4), QuantizePNorm(bits=4),
                     256, gossip="neighbor", eta=1.0 / prob.mu_L[1],
                     gamma=0.25, device=CPU)
    tr = run(eng, prob, torch.tensor(np.asarray(jprob.x_star)), iters=400)
    assert tr.dist[-1] < 1e-2, tr.dist[-1]
