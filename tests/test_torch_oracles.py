"""Parity of the port's gradient oracles (src/repro_torch/core/convex.py's
local and minibatch gradients, run()'s stochastic and noisy oracles) and of
utils/finite.py with the JAX reference, on the CPU.

The reference draws batch indices and gradient noise from threefry keys,
which torch cannot reproduce; the port draws them from the counter hash,
through one replaceable function, ``simulator.oracle_draws``.  The tests
rebuild the reference's draws from its key stream (run()'s split and
fold_in) and hand them to the port in its place.  Then a whole stochastic
or noisy run of an exact baseline matches the reference's trace within
_trace_close's bound, and flat LEAD matches it step by step: under these
oracles the reference's own jitted and eager LEAD traces part by ~1e-4
relative within 60 steps (XLA contracts a multiply-add in the update), more
than a whole trace can be held to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import gossip as jax_gossip
from repro.core import topology as jax_topology
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.convex import LogisticRegression as JaxLogisticRegression
from repro.core.engines import engine_for as jax_engine_for
from repro.core.simulator import LEADSim as JaxLEADSim
from repro.core.simulator import run as jax_run
from repro.utils import finite as jax_finite
from repro_torch.core import baselines, simulator, topology
from repro_torch.core.compression import QuantizePNorm, fast_normal
from repro_torch.core.convert import (logreg_from_numpy, problem_from_numpy,
                                      state_from_numpy)
from repro_torch.core.convex import batch_indices
from repro_torch.core.engines import FlatLEADState, engine_for
from repro_torch.core.gossip import DenseGossip
from repro_torch.core.simulator import LEADSim, run
from repro_torch.utils import finite
from test_torch_engine import _trace_close

CPU = "cpu"
N = 8
ITERS = 60
RTOL = 1e-5


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


@pytest.fixture(scope="module")
def linreg():
    """A ring-8 linear regression (m = d = 64) from the reference, its
    port copy, x* and eta = 1/L."""
    prob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=N,
                                        m=64, d=64)
    mu, L = prob.mu_L
    port = problem_from_numpy(np.asarray(prob.A), np.asarray(prob.b),
                              prob.lam, device=CPU)
    return prob, port, torch.tensor(np.asarray(prob.x_star)), 1.0 / L


@pytest.fixture(scope="module")
def logreg():
    """A small heterogeneous logistic regression (8 agents x 32 samples,
    20 features, 10 classes) from the reference, its port copy and x*."""
    prob = JaxLogisticRegression.generate(jax.random.PRNGKey(1), n_agents=N,
                                          m_per_agent=32, d=20)
    port = logreg_from_numpy(np.asarray(prob.feats), np.asarray(prob.labels),
                             prob.n_classes, prob.lam, device=CPU)
    x_star = prob.solve_x_star(iters=200)
    return prob, port, x_star, torch.tensor(np.asarray(x_star))


def _reference_oracle_draws(jprob, iters, *, batch, noise_std, d):
    """The draws of the reference's run() with its default key, in call
    order: the initial gradient's (fold_in(k0, 1)), then each step's
    (fold_in(sub, 1) of the split key stream), in oracle_draws' form."""
    key = jax.random.PRNGKey(0)
    k0, key = jax.random.split(key)
    subs = [k0]
    for _ in range(iters):
        key, sub = jax.random.split(key)
        subs.append(sub)
    m = (jprob.A if hasattr(jprob, "A") else jprob.feats).shape[1]
    out = []
    for sub in subs:
        kk = jax.random.fold_in(sub, 1)
        if noise_std > 0:
            out.append({"noise": torch.from_numpy(np.array(
                jax.random.normal(kk, (N, d))))})
        else:
            out.append({"idx": torch.from_numpy(np.array(
                jax.random.randint(kk, (N, batch), 0, m))).to(torch.int64)})
    return out


def _inject(monkeypatch, draws):
    """Make run()'s oracle take `draws` (one dict per call, in order)."""
    it = iter(draws)
    monkeypatch.setattr(simulator, "oracle_draws",
                        lambda problem, X, seed, **kw: next(it))
    return it


def _close(got, want, what):
    """Within RTOL of the array's scale (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(1.0, float(np.max(np.abs(
                                   want)))), err_msg=what)


def _pair(name, eta, d):
    """(port algorithm, reference algorithm): uncompressed, so that the
    oracle's draws are the run's only random input."""
    if name == "lead":
        return (LEADSim(topology=topology.ring(N), eta=eta, engine="flat"),
                JaxLEADSim(topology=jax_topology.ring(N), eta=eta,
                           engine="flat"))
    if name == "dgd":
        return (engine_for(topology.ring(N), None, d, algorithm="dgd",
                           eta=eta, device=CPU),
                jax_engine_for(jax_topology.ring(N), None, d, algorithm="dgd",
                               eta=eta))
    return (baselines.NIDS(gossip=DenseGossip.from_topology(
        topology.ring(N), CPU), eta=eta),
        jax_baselines.NIDS(gossip=jax_gossip.DenseGossip(
            W=jnp.asarray(jax_topology.ring(N))), eta=eta))


# -- the oracles ---------------------------------------------------------------

def test_local_grad_matches_reference(linreg):
    jprob, prob, _, _ = linreg
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    for i in range(N):
        np.testing.assert_allclose(
            prob.local_grad(i, torch.from_numpy(x)).numpy(),
            np.asarray(jprob.local_grad(i, jnp.asarray(x))), rtol=RTOL,
            atol=RTOL)
    full = prob.full_grad(torch.from_numpy(np.tile(x, (N, 1))))
    np.testing.assert_allclose(prob.local_grad(3, torch.from_numpy(x)).numpy(),
                               full[3].numpy(), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", ["linreg", "logreg"])
def test_minibatch_grad_matches_reference(name, linreg, logreg):
    """minibatch_grad on the reference's indices (its randint on the same
    key, at each problem's default batch: 32 and 64) within 1e-5."""
    jprob, prob = (linreg if name == "linreg" else logreg)[:2]
    batch = 32 if name == "linreg" else 64
    X = np.random.default_rng(1).standard_normal(
        (N, prob.d)).astype(np.float32)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        idx = np.array(jax.random.randint(key, (N, batch), 0, prob.m))
        want = np.asarray(jprob.minibatch_grad(jnp.asarray(X), key))
        got = prob.minibatch_grad(torch.from_numpy(X),
                                  torch.from_numpy(idx).to(torch.int64))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(want)))
    # without indices it draws them from the counter hash for `seed`
    own = prob.minibatch_grad(torch.from_numpy(X), seed=5)
    drawn = batch_indices(N, batch, prob.m, 5, device=CPU)
    assert torch.equal(own, prob.minibatch_grad(torch.from_numpy(X), drawn))


def test_oracle_draws_from_the_counter_hash(linreg):
    """Batch indices are integers in [0, m) from the counter hash, the same
    for the same seed and near uniform; the Gaussian plane is finite with
    unit moments; oracle_draws hands out the one each oracle needs."""
    _, prob, _, _ = linreg
    idx = batch_indices(N, 4096, 200, 7, device=CPU)
    assert idx.dtype == torch.int64 and int(idx.min()) >= 0
    assert int(idx.max()) < 200
    assert torch.equal(idx, batch_indices(N, 4096, 200, 7, device=CPU))
    assert not torch.equal(idx, batch_indices(N, 4096, 200, 8, device=CPU))
    counts = torch.bincount(idx.reshape(-1), minlength=200).double()
    assert float(counts.std() / counts.mean()) < 0.1
    z = fast_normal((N, 50000), 3, device=CPU)
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert torch.equal(z, fast_normal((N, 50000), 3, device=CPU))
    X = torch.zeros(N, prob.d)
    kw = dict(batch=16, noise_std=0.0, stochastic=True)
    assert set(simulator.oracle_draws(prob, X, 1, **kw)) == {"idx"}
    assert simulator.oracle_draws(prob, X, 1, **kw)["idx"].shape == (N, 16)
    kw.update(noise_std=0.5)            # noise wins over stochastic
    assert set(simulator.oracle_draws(prob, X, 1, **kw)) == {"noise"}
    kw.update(noise_std=0.0, stochastic=False)
    assert simulator.oracle_draws(prob, X, 1, **kw) == {}


# -- run() with the oracles ------------------------------------------------------

@pytest.mark.parametrize("oracle", ["stochastic", "noisy", "logreg"])
def test_lead_oracle_steps_match_reference(monkeypatch, linreg, logreg,
                                           oracle):
    """Flat LEAD driven step by step through run()'s oracle
    (simulator.oracle_grad) with the reference's draws injected, from x0 =
    0 and the initial gradient's draw on: each gradient and each new state
    (re-synced to the reference's before every step) within 1e-5 of its
    scale.  Stochastic at batch 16 and noisy at 0.5 on linear regression;
    Fig. 3's oracle (batch 64) on logistic regression."""
    if oracle == "logreg":
        jprob, prob = logreg[:2]
        kw, eta = dict(stochastic=True, batch=64), 0.1
    else:
        jprob, prob, _, eta = linreg
        eta *= 0.5
        kw = (dict(stochastic=True, batch=16) if oracle == "stochastic"
              else dict(noise_std=0.5))
    draws = _reference_oracle_draws(jprob, 10, batch=kw.get("batch", 64),
                                    noise_std=kw.get("noise_std", 0.0),
                                    d=prob.d)
    _inject(monkeypatch, draws)
    # the reference's grad_at (run()'s oracle) on its key stream
    key = jax.random.PRNGKey(0)
    k0, key = jax.random.split(key)

    def grad_j(X, sub):
        kk = jax.random.fold_in(sub, 1)
        if oracle == "noisy":
            return jprob.full_grad(X) + 0.5 * jax.random.normal(kk, X.shape)
        return jprob.minibatch_grad(X, kk, batch=kw["batch"])

    algo = LEADSim(topology=topology.ring(N), eta=eta, engine="flat",
                   dim=prob.d, device=CPU)
    ref = JaxLEADSim(topology=jax_topology.ring(N), eta=eta, engine="flat",
                     dim=prob.d)
    x0 = np.zeros((N, prob.d), np.float32)
    g_t = simulator.oracle_grad(prob, torch.from_numpy(x0), 0, **kw)
    g_j = grad_j(jnp.asarray(x0), k0)
    _close(g_t, g_j, "initial gradient")
    st_j = ref.init(jnp.asarray(x0), g_j, k0)
    _close(algo.x_of(algo.init(torch.from_numpy(x0), g_t)), ref.x_of(st_j),
           "init")
    for i in range(10):
        key, sub = jax.random.split(key)
        st_t = state_from_numpy(FlatLEADState, st_j, device=CPU)
        g_j = grad_j(ref.x_of(st_j), sub)
        g_t = simulator.oracle_grad(prob, algo.x_of(st_t), i, **kw)
        _close(g_t, g_j, f"gradient {i}")
        st_j = ref.step(st_j, g_j, jax.random.fold_in(sub, 2))
        new_t = algo.step(st_t, g_t, i)
        for f in ("x", "d", "h", "hw"):
            _close(getattr(new_t, f), getattr(st_j, f), f"step {i}: {f}")


@pytest.mark.parametrize("name", ["dgd", "nids"])
def test_stochastic_run_matches_reference(monkeypatch, linreg, name):
    """run(stochastic=True, batch=16), 60 steps of the exact baselines, the
    reference's batch indices injected (the initial gradient's included):
    dist, consensus and loss within _trace_close's bound, every draw
    consumed."""
    jprob, prob, x_star, eta = linreg
    algo, ref = _pair(name, 0.5 * eta, prob.d)
    draws = _reference_oracle_draws(jprob, ITERS, batch=16, noise_std=0.0,
                                    d=prob.d)
    it = _inject(monkeypatch, draws)
    got = run(algo, prob, x_star, iters=ITERS, stochastic=True, batch=16)
    assert next(it, None) is None
    want = jax_run(ref, jprob, jprob.x_star, iters=ITERS, stochastic=True,
                   batch=16)
    assert want.dist[-1] < want.dist[0]
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f"{name} {f}")


def test_stochastic_logistic_run_matches_reference(monkeypatch, logreg):
    """Fig. 3's oracle on logistic regression: NIDS through run(stochastic=
    True) at the default batch of 64, the reference's indices injected."""
    jprob, prob, jx_star, x_star = logreg
    algo, ref = _pair("nids", 0.1, prob.d)
    _inject(monkeypatch, _reference_oracle_draws(
        jprob, ITERS, batch=64, noise_std=0.0, d=prob.d))
    got = run(algo, prob, x_star, iters=ITERS, stochastic=True)
    want = jax_run(ref, jprob, jx_star, iters=ITERS, stochastic=True)
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f"logreg {f}")


@pytest.mark.parametrize("name", ["dgd", "nids"])
def test_noisy_run_matches_reference(monkeypatch, linreg, name):
    """run(noise_std=0.5): the full gradient plus the reference's Gaussian
    noise, injected; with stochastic=True as well the noise wins, as in
    the reference."""
    jprob, prob, x_star, eta = linreg
    algo, ref = _pair(name, 0.5 * eta, prob.d)
    draws = _reference_oracle_draws(jprob, ITERS, batch=64, noise_std=0.5,
                                    d=prob.d)
    want = jax_run(ref, jprob, jprob.x_star, iters=ITERS, noise_std=0.5)
    for stochastic in (False, True):
        _inject(monkeypatch, draws)
        got = run(algo, prob, x_star, iters=ITERS, noise_std=0.5,
                  stochastic=stochastic)
        for f in ("dist", "consensus", "loss"):
            _trace_close(getattr(got, f), getattr(want, f), f"{name} {f}")


def test_noisy_lead_falls_in_the_port_alone():
    """oracle_at_scale's run at a small width: 2-bit flat LEAD on the
    quadratic f_i = 0.5 ||x - t_i||^2 (t_i ~ N(0, 1)), eta 0.5, with
    noise_std 0.1 from the port's own draws: finite, and dist falls more
    than 10x in 20 steps; another seed draws another trace."""
    gen = torch.Generator().manual_seed(0)
    T = torch.randn((N, 4096), generator=gen)

    class Quadratic:
        n, d, x_star = N, 4096, T.mean(0)

        def full_grad(self, X):
            return X - T

        def loss(self, X):
            return 0.5 * torch.mean(torch.sum((X - T) ** 2, -1))

    prob = Quadratic()
    lead = LEADSim(topology=topology.ring(N), compressor=QuantizePNorm(bits=2),
                   eta=0.5, engine="flat")
    tr = run(lead, prob, prob.x_star, iters=20, noise_std=0.1)
    assert all(np.isfinite(a).all() for a in tr)
    assert tr.dist[-1] < 0.1 * tr.dist[0]
    other = run(lead, prob, prob.x_star, iters=20, noise_std=0.1, seed=1)
    assert not np.array_equal(other.dist, tr.dist)


# -- utils/finite.py ---------------------------------------------------------------

def test_finite_guard_raises_eagerly(monkeypatch):
    """Off by default; REPRO_ASSERT_FINITE=1 raises FloatingPointError
    naming the bad leaves, as the reference does; integer leaves are
    skipped."""
    tree = {"x": torch.tensor([1.0, float("nan")]), "k": torch.tensor([3]),
            "ok": torch.ones(2)}
    monkeypatch.delenv("REPRO_ASSERT_FINITE", raising=False)
    assert not finite.finite_checks_enabled()
    finite.assert_finite_tree(tree)
    for on, off in (("1", "0"), ("true", "off"), ("yes", "")):
        monkeypatch.setenv("REPRO_ASSERT_FINITE", on)
        assert finite.finite_checks_enabled() == \
            jax_finite.finite_checks_enabled() is True
        with pytest.raises(FloatingPointError) as got:
            finite.assert_finite_tree(tree, where="here")
        with pytest.raises(FloatingPointError) as want:
            jax_finite.assert_finite_tree(
                {k: jnp.asarray(v.numpy()) for k, v in tree.items()},
                where="here")
        assert str(got.value) == str(want.value)
        finite.assert_finite_tree({"ok": torch.ones(3), "k": torch.tensor(1)})
        monkeypatch.setenv("REPRO_ASSERT_FINITE", off)
        assert not finite.finite_checks_enabled()
        finite.assert_finite_tree(tree)


def test_finite_guard_in_run(monkeypatch, linreg):
    """A diverging run (DGD at 50 / L) raises at its first nonfinite
    recorded step under the guard, and runs to the end without it."""
    _, prob, x_star, eta = linreg
    dgd = engine_for(topology.ring(N), None, prob.d, algorithm="dgd",
                     eta=50 * eta, device=CPU)
    monkeypatch.setenv("REPRO_ASSERT_FINITE", "1")
    with pytest.raises(FloatingPointError, match="simulator recorded step"):
        run(dgd, prob, x_star, iters=200)
    monkeypatch.setenv("REPRO_ASSERT_FINITE", "0")
    tr = run(dgd, prob, x_star, iters=200)
    assert not np.isfinite(tr.dist[-1])
