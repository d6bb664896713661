"""Parity of the port's fault layer (src/repro_torch/core/faults.py, the
masked mixes of core/gossip.py, the engines' faulted wire and run()'s
faulted driving) with the JAX reference, on the CPU.

The fault realizations are a counter hash both packages compute, so every
mask, plane and corrupted bit is compared exactly; the degraded mixes and
the realized spectral gap within 1e-6.  Per-step parity carries the
reference's engine and fault states across before every step; RandK's
draws come from the reference's threefry key and reach the port engine
through its ``_draws`` (tests/test_torch_baselines.py).
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
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import LEADSim as JaxLEADSim
from repro.core.simulator import run as jax_run
from repro_torch.core import faults, topology
from repro_torch.core.compression import QuantizePNorm, RandK
from repro_torch.core.convert import fault_state_from_numpy, state_from_numpy
from repro_torch.core.engines import describe, engine_for
from repro_torch.core.gossip import DenseGossip, EncodedNeighborGossip
from repro_torch.core.simulator import LEADSim, run
from repro_torch.core.stage_timer import StageTimer
from test_torch_baselines import _inject_reference_draws
from test_torch_engine import _trace_close

CPU = "cpu"
N, DIM = 8, 1300             # 3 logical blocks per agent, the last ragged
STEPS = 4
ATOL = 1e-5                  # the reference's flat-engine contract
TOPOS = {"ring8": lambda m: m.ring(8),
         "torus_2x4": lambda m: m.torus_2d(2, 4),
         "er8": lambda m: m.erdos_renyi(8, p=0.5, seed=1)}
RATES = (0.0, 0.1, 0.5)
WIRES = {"pinf": (lambda: QuantizePNorm(bits=2),
                  lambda: JaxQuantizePNorm(bits=2)),
         "randk": (lambda: RandK(ratio=0.25), lambda: JaxRandK(ratio=0.25))}
# the fault settings the reference's behaviour was measured at (ring-8
# f_i = 0.5 ||x - t_i||^2, t_i ~ 100 N(0, 1))
LINK_DROP = dict(seed=0, link_drop=0.1)
STALE = dict(seed=6, agent_drop=0.2, dropout_window=5, policy="stale")


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


def _models(rate):
    """(port, reference) FaultModels with every fault at `rate`, one with
    detected and one with undetected corruption."""
    out = []
    for detect in (True, False):
        kw = dict(seed=int(rate * 1000) + detect, link_drop=rate,
                  agent_drop=rate, dropout_window=3, straggler_rate=rate,
                  straggler_tau=2, bitflip_rate=rate,
                  detect_corruption=detect)
        out.append((faults.FaultModel(**kw), jax_faults.FaultModel(**kw)))
    return out


class _Quadratic:
    """f_i(x) = 0.5 ||x - t_i||^2 in either package (`xp` is torch or
    jax.numpy), x* = mean_i t_i."""

    def __init__(self, T, xp):
        self.xp = xp
        self.T = torch.from_numpy(T) if xp is torch else jnp.asarray(T)
        self.n, self.d = T.shape
        self.x_star = self.T.mean(0)

    def full_grad(self, X):
        return X - self.T

    def loss(self, X):
        return 0.5 * self.xp.mean(self.xp.sum((X - self.T) ** 2, -1))


def _quadratics(d, seed=0):
    T = (100.0 * np.random.default_rng(seed).standard_normal((N, d))
         ).astype(np.float32)
    return _Quadratic(T, torch), _Quadratic(T, jnp)


# -- the counter hash and the fault planes ----------------------------------------

def test_counter_hash_matches_reference():
    """counter_hash and counter_u01 bit for bit over uint32 counters up to
    2^32 - 1 (the int64-masked arithmetic wraps as uint32 does)."""
    rng = np.random.default_rng(0)
    k, a, b = (rng.integers(0, 2 ** 32, size=(64, 5), dtype=np.uint64)
               for _ in range(3))
    k[0], a[0], b[0] = 0, 2 ** 32 - 1, 2 ** 31
    for seed in (0, 1, 12345, 2 ** 32 - 1):
        for salt in (0x1001, 0x5005):
            want = np.asarray(jax_faults.counter_hash(
                seed, jnp.asarray(k, jnp.uint32), jnp.asarray(a, jnp.uint32),
                jnp.asarray(b, jnp.uint32), salt))
            got = faults.counter_hash(seed, *(torch.from_numpy(
                v.astype(np.int64)) for v in (k, a, b)), salt)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
            want_u = np.asarray(jax_faults.counter_u01(
                seed, jnp.asarray(k, jnp.uint32), jnp.asarray(a, jnp.uint32),
                jnp.asarray(b, jnp.uint32), salt))
            got_u = faults.counter_u01(seed, *(torch.from_numpy(
                v.astype(np.int64)) for v in (k, a, b)), salt)
            assert got_u.dtype == torch.float32
            np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert int(faults.counter_hash(3, 5, 7, 9, 0x2002, device=CPU)) == \
        int(jax_faults.counter_hash(3, 5, 7, 9, 0x2002))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_fault_planes_and_masks_match_reference(topo, rate):
    """agent_down, straggler, corrupted, broadcast_ok, link_ok, table_mask
    and dense_mask bit for bit over 64 steps (a batched k: both packages
    broadcast it), with detected and undetected corruption; a scalar k
    gives the batch's row."""
    t_topo, j_topo = TOPOS[topo](topology), TOPOS[topo](jax_topology)
    nbr = torch.as_tensor(t_topo.neighbors, dtype=torch.int64)
    ids_t, ids_j = torch.arange(N), jnp.arange(N)
    kt, kj = torch.arange(64), jnp.arange(64)
    for fm, jm in _models(rate):
        assert fm.is_active == jm.is_active
        for plane in ("agent_down", "straggler", "corrupted"):
            got = getattr(fm, plane)(kt[:, None], ids_t)
            want = jnp.broadcast_to(getattr(jm, plane)(kj[:, None], ids_j),
                                    (64, N))
            np.testing.assert_array_equal(got.expand(64, N).numpy(),
                                          np.asarray(want), err_msg=plane)
        got = fm.broadcast_ok(kt[:, None], N)
        np.testing.assert_array_equal(
            got.expand(64, N).numpy(),
            np.asarray(jnp.broadcast_to(jm.broadcast_ok(kj[:, None], N),
                                        (64, N))))
        k3t, k3j = kt.reshape(-1, 1, 1), kj.reshape(-1, 1, 1)
        np.testing.assert_array_equal(
            fm.link_ok(k3t, ids_t[None, :], ids_t[:, None]).numpy(),
            np.asarray(jnp.broadcast_to(
                jm.link_ok(k3j, ids_j[None, :], ids_j[:, None]), (64, N, N))))
        np.testing.assert_array_equal(
            fm.table_mask(k3t, nbr).numpy(),
            np.asarray(jnp.broadcast_to(
                jm.table_mask(k3j, j_topo.neighbors),
                (64,) + j_topo.neighbors.shape)))
        dense = fm.dense_mask(k3t, N)
        np.testing.assert_array_equal(
            dense.numpy(), np.asarray(jnp.broadcast_to(
                jm.dense_mask(k3j, N), (64, N, N))))
        for k in (0, 17, 63):
            np.testing.assert_array_equal(fm.dense_mask(k, N, device=CPU),
                                          dense[k])
            np.testing.assert_array_equal(
                fm.dense_mask(k, N, device=CPU).numpy(),
                np.asarray(jm.dense_mask(k, N)))
            np.testing.assert_array_equal(
                fm.broadcast_ok(torch.tensor(k), N).numpy(),
                np.asarray(jm.broadcast_ok(k, N)))


def test_corrupt_values_matches_reference():
    """Undetected corruption flips the reference's bits, the sign bit
    among them; detected corruption, or rate 0, is the identity."""
    x = np.random.default_rng(1).standard_normal((N, 3, 64)).astype(np.float32)
    kw = dict(seed=3, bitflip_rate=0.7, bitflip_frac=0.5,
              detect_corruption=False)
    fm, jm = faults.FaultModel(**kw), jax_faults.FaultModel(**kw)
    sign_flips = 0
    for k in range(12):
        got = fm.corrupt_values(torch.from_numpy(x), torch.tensor(k)).numpy()
        want = np.asarray(jm.corrupt_values(jnp.asarray(x), k))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        sign_flips += int(((got.view(np.uint32) ^ x.view(np.uint32))
                           == 0x80000000).sum())
    assert sign_flips > 0
    for off in (dict(kw, detect_corruption=True), dict(kw, bitflip_rate=0.0)):
        t = torch.from_numpy(x)
        assert faults.FaultModel(**off).corrupt_values(t, 3) is t


# -- the realized graph ------------------------------------------------------------

@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_renormalize_matches_reference(topo):
    """renormalize_dense and renormalize_table within 1e-6 of the
    reference's under realized masks; rows stay stochastic and an isolated
    agent gets self-weight 1."""
    t_topo, j_topo = TOPOS[topo](topology), TOPOS[topo](jax_topology)
    W = torch.as_tensor(t_topo.W, dtype=torch.float32)
    w = torch.as_tensor(t_topo.weights, dtype=torch.float32)
    nbr = torch.as_tensor(t_topo.neighbors, dtype=torch.int64)
    fm, jm = _models(0.5)[0]
    for k in range(20):
        dm = fm.dense_mask(k, N, device=CPU)
        got = faults.renormalize_dense(W, dm)
        want = jax_faults.renormalize_dense(jnp.asarray(j_topo.W, jnp.float32),
                                            jm.dense_mask(k, N))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)
        tm = fm.table_mask(k, nbr)
        got_t = faults.renormalize_table(w, tm)
        want_t = jax_faults.renormalize_table(
            jnp.asarray(j_topo.weights, jnp.float32),
            jm.table_mask(k, j_topo.neighbors))
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   atol=1e-6)
    alone = torch.ones(N, N, dtype=torch.bool)
    alone[0, 1:] = alone[1:, 0] = False
    R = faults.renormalize_dense(W, alone)
    assert float(R[0, 0]) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("policy", ["renormalize", "stale"])
@pytest.mark.parametrize("backend", ["dense", "neighbor"])
def test_mix_masked_matches_reference(backend, policy):
    """DenseGossip.mix_masked and EncodedNeighborGossip.mix_masked, with a
    separate wire copy, within 1e-6 of the reference's on three graphs."""
    rng = np.random.default_rng(2)
    x, x_tx, cache = (rng.standard_normal((N, 2, 64)).astype(np.float32)
                      for _ in range(3))
    fm, jm = _models(0.5)[0]
    for topo in sorted(TOPOS):
        t_topo, j_topo = TOPOS[topo](topology), TOPOS[topo](jax_topology)
        kw_t = dict(x_tx=torch.from_numpy(x_tx))
        kw_j = dict(x_tx=jnp.asarray(x_tx))
        if policy == "stale":
            kw_t["cache"], kw_j["cache"] = (torch.from_numpy(cache),
                                            jnp.asarray(cache))
        for k in range(6):
            if backend == "dense":
                got = DenseGossip.from_topology(t_topo, CPU).mix_masked(
                    torch.from_numpy(x), fm.dense_mask(k, N, device=CPU),
                    **kw_t)
                want = jax_gossip.DenseGossip(W=j_topo).mix_masked(
                    jnp.asarray(x), jm.dense_mask(k, N), **kw_j)
            else:
                g = EncodedNeighborGossip.from_topology(t_topo, CPU)
                got = g.mix_masked(torch.from_numpy(x),
                                   fm.table_mask(k, g.neighbors), **kw_t)
                want = jax_gossip.EncodedNeighborGossip.from_topology(
                    j_topo).mix_masked(jnp.asarray(x),
                                       jm.table_mask(k, j_topo.neighbors),
                                       **kw_j)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, err_msg=f"{topo} k={k}")


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_step_metrics_match_reference(topo):
    """step_metrics: dropped links and staleness exactly, realized gap
    within 1e-6; link_metrics over a batch of steps gives the same, and a
    fault-free mask gives the topology's spectral gap."""
    t_topo, j_topo = TOPOS[topo](topology), TOPOS[topo](jax_topology)
    rng = np.random.default_rng(3)
    for fm, jm in (_models(0.1)[0], _models(0.5)[0]):
        ks = torch.arange(30)
        dropped, gap = faults.link_metrics(fm, t_topo, ks)
        for k in range(30):
            age = rng.integers(0, 9, size=N).astype(np.int32)
            got = faults.step_metrics(fm, t_topo, k, torch.from_numpy(age))
            want = jax_faults.step_metrics(jm, j_topo, k, jnp.asarray(age))
            assert float(got[0]) == float(want[0]) == float(dropped[k])
            assert abs(float(got[1]) - float(want[1])) <= 1e-6
            assert float(got[1]) == float(gap[k])
            assert float(got[2]) == float(want[2])
            assert float(got[3]) == float(want[3])
    clean = faults.link_metrics(faults.FaultModel(), t_topo, torch.arange(2))
    assert not clean[0].any()
    np.testing.assert_allclose(clean[1].numpy(), t_topo.spectral_gap,
                               atol=1e-6)


def test_fault_model_checks_and_state():
    """The model's argument checks, the fault state's shapes, FaultState
    carried from numpy, the rejection of a non-FaultModel and of faults on
    the tree engine, and step_metrics on a real bank (round k % P of
    random_matching(8)) equal to the reference's."""
    for bad in (dict(policy="drop"), dict(link_drop=1.5),
                dict(agent_drop=-0.1), dict(dropout_window=0)):
        with pytest.raises(ValueError):
            faults.FaultModel(**bad)
    assert not faults.FaultModel(seed=9).is_active
    assert faults.FaultModel(straggler_rate=0.1).is_active
    x = torch.zeros(N, 3, 512)
    st = faults.init_fault_state(faults.FaultModel(policy="stale"), x)
    assert st.cache.shape == x.shape and st.age.dtype == torch.int32
    st = faults.init_fault_state(faults.FaultModel(), x)
    assert st.cache.shape == (0,) and st.age.shape == (N,)
    js = jax_faults.init_fault_state(jax_faults.FaultModel(policy="stale"),
                                     jnp.ones((N, 3, 512)))
    carried = fault_state_from_numpy(js._replace(age=js.age + 2), device=CPU)
    assert carried.age.dtype == torch.int32 and int(carried.age[0]) == 2
    assert carried.cache.shape == (N, 3, 512)
    with pytest.raises(TypeError, match="FaultModel"):
        engine_for(topology.ring(8), None, 64, faults=object(), device=CPU)
    with pytest.raises(ValueError, match="flat"):
        LEADSim(topology=topology.ring(8), compressor=QuantizePNorm(),
                faults=faults.FaultModel(link_drop=0.1))

    fm, jm = (mod.FaultModel(seed=2, link_drop=0.3, agent_drop=0.1)
              for mod in (faults, jax_faults))
    bank, jbank = topology.random_matching(N), jax_topology.random_matching(N)
    age = np.arange(N, dtype=np.int32) % 3
    for k in range(2 * bank.period):
        got = faults.step_metrics(fm, bank, k, torch.from_numpy(age))
        want = jax_faults.step_metrics(jm, jbank, k, jnp.asarray(age))
        assert float(got[0]) == float(want[0]), k
        assert abs(float(got[1]) - float(want[1])) <= 1e-6, k
        assert float(got[2]) == float(want[2])
        assert float(got[3]) == float(want[3])


# -- the engines' faulted wire: per-step parity ------------------------------------

def _close(got, want, what):
    """Within ATOL of the field's scale (at least 1): the stale runs grow
    their state, where a 1e-7 relative rounding exceeds 1e-5 absolute."""
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * scale,
                               err_msg=what)


def _pair(algorithm, wire, gossip, model):
    """(port engine, reference engine) with the FaultModel kwargs `model`
    attached."""
    make_t, make_j = WIRES[wire]
    hy = (dict(eta=0.1, gamma=1.0, alpha=0.5) if algorithm == "lead"
          else dict(eta=0.1, gamma=0.6))
    eng = engine_for(topology.ring(N), make_t(), DIM, algorithm=algorithm,
                     gossip=gossip, faults=faults.FaultModel(**model),
                     device=CPU, **hy)
    ref = jax_engine_for(jax_topology.ring(N), make_j(), DIM,
                         algorithm=algorithm, gossip=gossip, dither="fast",
                         faults=jax_faults.FaultModel(**model), **hy)
    return eng, ref


@pytest.mark.parametrize("policy", ["renormalize", "stale"])
@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
@pytest.mark.parametrize("algorithm,wire", [("lead", "pinf"),
                                            ("choco", "pinf"),
                                            ("choco", "randk")])
def test_faulted_step_parity(algorithm, wire, gossip, policy):
    """From a common engine and fault state (the reference's, carried
    across before every step), one faulted step each with the same
    gradient and seed: float state and the stale cache within 1e-5 of
    each field's scale, the ages exactly, wire bits equal, comp_err within 1e-6."""
    model = dict(seed=5, link_drop=0.3, agent_drop=0.3, dropout_window=2,
                 straggler_rate=0.2, policy=policy)
    eng, ref = _pair(algorithm, wire, gossip, model)
    rng = np.random.default_rng(len(algorithm + wire + gossip + policy))
    x0, g0 = (rng.standard_normal((N, DIM)).astype(np.float32)
              for _ in range(2))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    fs_j = ref.init_fault_state(st_j)
    cls = type(eng.init(torch.from_numpy(x0), torch.from_numpy(g0)))
    fs0 = eng.init_fault_state(state_from_numpy(cls, st_j, device=CPU))
    assert fs0.cache.shape == tuple(fs_j.cache.shape)
    step_j = jax.jit(ref.step_with_wire_faulted)
    for i in range(STEPS):
        g = rng.standard_normal((N, DIM)).astype(np.float32)
        seed = int(rng.integers(0, 2 ** 31))
        key = jax.random.PRNGKey(seed)
        st_t = state_from_numpy(cls, st_j, device=CPU)
        fs_t = fault_state_from_numpy(fs_j, device=CPU)
        _inject_reference_draws(eng, ref.compressor, key)
        new_j, fs_j, err_j, bits_j = step_j(st_j, fs_j, jnp.asarray(g), key)
        new_t, fs_t, err_t, bits_t = eng.step_with_wire_faulted(
            st_t, fs_t, torch.from_numpy(g), seed)
        what = f"{describe(eng)} {policy} step {i}"
        for f in new_j._fields:
            if f == "k":
                assert int(new_t.k) == int(new_j.k), what
                continue
            _close(getattr(new_t, f), getattr(new_j, f), f"{what}: {f}")
        np.testing.assert_array_equal(fs_t.age.numpy(), np.asarray(fs_j.age))
        _close(fs_t.cache, fs_j.cache, f"{what}: cache")
        assert float(bits_t) == float(bits_j), what
        np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-6,
                                   atol=0, err_msg=what)
        st_j = new_j


# -- run(): free runs, the inactive model, the reference's caveats ------------------

@pytest.mark.parametrize("gossip", ["dense", "neighbor"])
def test_faulted_free_run_matches_reference(gossip):
    """run(), 200 steps of uncompressed flat LEAD on the ring-8 quadratic
    with t_i ~ 100 N(0, 1) (d = 2,048) under link drops and an agent outage window,
    recorded every step and every third: the four fault fields exactly
    (the realized gap within 1e-6), dist, consensus and loss within
    _trace_close's bound, bits exactly."""
    prob_t, prob_j = _quadratics(2048)
    model = dict(seed=0, link_drop=0.1, agent_drop=0.1, dropout_window=3)
    for every in (1, 3):
        got = run(LEADSim(topology=topology.ring(N), eta=0.5, engine="flat",
                          engine_gossip=gossip,
                          faults=faults.FaultModel(**model)),
                  prob_t, prob_t.x_star, iters=200, record_every=every)
        want = jax_run(JaxLEADSim(topology=jax_topology.ring(N), eta=0.5,
                                  engine="flat", engine_gossip=gossip,
                                  faults=jax_faults.FaultModel(**model)),
                       prob_j, prob_j.x_star, iters=200, record_every=every)
        assert len(got.dist) == len(want.dist) == -(-200 // every)
        assert want.dist[-1] < want.dist[0]      # not a divergent run
        for f in ("dropped_links", "staleness_mean", "staleness_max"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_allclose(got.realized_gap, want.realized_gap,
                                   rtol=0, atol=1e-6)
        assert got.dropped_links.sum() > 0 and got.staleness_max.max() >= 1
        for f in ("dist", "consensus", "loss"):
            _trace_close(getattr(got, f), getattr(want, f), f"{gossip} {f}")
        np.testing.assert_array_equal(got.bits_per_agent,
                                      want.bits_per_agent)


@pytest.mark.parametrize("algorithm", ["lead", "choco"])
def test_drop_rate_zero_is_the_clean_run(algorithm):
    """An inactive model (every rate 0) takes the clean path: the 2-bit
    trace equals the fault-free one bit for bit, its four fault fields are
    0, and so are a clean run's."""
    prob, _ = _quadratics(700, seed=4)
    q2 = QuantizePNorm(bits=2)

    def algo(fm):
        if algorithm == "lead":
            return LEADSim(topology=topology.ring(N), compressor=q2, eta=0.5,
                           engine="flat", faults=fm)
        return engine_for(topology.ring(N), q2, prob.d, algorithm="choco",
                          eta=0.01, gamma=0.8, faults=fm, device=CPU)

    clean = run(algo(None), prob, prob.x_star, iters=25)
    for fm in (faults.FaultModel(seed=3),
               faults.FaultModel(link_drop=0.0, policy="stale")):
        tr = run(algo(fm), prob, prob.x_star, iters=25)
        for f in clean._fields:
            np.testing.assert_array_equal(getattr(tr, f), getattr(clean, f),
                                          err_msg=f)
    for f in ("dropped_links", "realized_gap", "staleness_mean",
              "staleness_max"):
        assert not getattr(clean, f).any() and len(getattr(clean, f)) == 25


def test_reference_stall_and_stale_growth_reproduced():
    """The reference's behaviour under faults, at its measured settings on
    d = 2,048 (200 steps), reproduced and not repaired: 2-bit LEAD
    under 10% link drops stalls (dist stays above a tenth of its start on
    both packages, the port's within 10% of the reference's) where clean
    LEAD converges, with the same dropped links; CHOCO under stale agent
    outages grows past 1000x its start where clean CHOCO falls."""
    prob_t, prob_j = _quadratics(2048)
    q2_t, q2_j = QuantizePNorm(bits=2), JaxQuantizePNorm(bits=2)

    def lead(pkg, fm):
        if pkg == "port":
            return engine_for(topology.ring(N), q2_t, 2048, eta=0.5,
                              gamma=1.0, alpha=0.5, faults=fm, device=CPU)
        return jax_engine_for(jax_topology.ring(N), q2_j, 2048, eta=0.5,
                              gamma=1.0, alpha=0.5, faults=fm, dither="fast")

    got = run(lead("port", faults.FaultModel(**LINK_DROP)), prob_t,
              prob_t.x_star, iters=200)
    want = jax_run(lead("ref", jax_faults.FaultModel(**LINK_DROP)), prob_j,
                   prob_j.x_star, iters=200)
    clean = run(lead("port", None), prob_t, prob_t.x_star, iters=200)
    for tr in (got, want):
        assert 0.1 * tr.dist[0] < tr.dist[-1] < tr.dist[0]
    assert got.dist[-1] == pytest.approx(want.dist[-1], rel=0.1)
    np.testing.assert_array_equal(got.dropped_links, want.dropped_links)
    assert clean.dist[-1] < 1e-6 * clean.dist[0]

    def choco(fm):
        return engine_for(topology.ring(N), q2_t, 2048, algorithm="choco",
                          gossip="neighbor", eta=0.01, gamma=0.8, faults=fm,
                          device=CPU)

    stale = run(choco(faults.FaultModel(**STALE)), prob_t, prob_t.x_star,
                iters=200)
    ref_stale = jax_run(jax_engine_for(
        jax_topology.ring(N), q2_j, 2048, algorithm="choco",
        gossip="neighbor", eta=0.01, gamma=0.8, dither="fast",
        faults=jax_faults.FaultModel(**STALE)), prob_j, prob_j.x_star,
        iters=200)
    clean = run(choco(None), prob_t, prob_t.x_star, iters=200)
    for tr in (stale, ref_stale):
        assert tr.dist[-1] > 1e3 * tr.dist[0]
    np.testing.assert_array_equal(stale.staleness_max,
                                  np.asarray(ref_stale.staleness_max))
    assert clean.dist[-1] < 0.1 * clean.dist[0]


def test_faulted_run_marks_its_stages():
    """A StageTimer breaks a faulted step down as a clean one: the decode
    and mix marks of the faulted wire keep LEAD's order."""
    prob, _ = _quadratics(600, seed=5)
    lead = LEADSim(topology=topology.ring(N), compressor=QuantizePNorm(bits=2),
                   eta=0.5, engine="flat",
                   faults=faults.FaultModel(**LINK_DROP))
    with StageTimer(CPU) as timer:
        run(lead, prob, prob.x_star, iters=2)
    order = ["gradient", "dither", "diff_encode", "decode", "mix", "update",
             "comp_err", "metrics"]
    assert [name for name, _ in timer.stages()] == order * 2
