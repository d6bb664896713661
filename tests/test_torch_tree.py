"""Parity of the port's tree path (src/repro_torch: utils/tree.py, the
compressors' per-agent compress, the topology functions, DenseGossip over
pytrees and EncodedRingGossip, tree LEAD, the tree baselines, LEADSim's
tree engine, flat_twin and the simulator's tree driving) with the JAX
reference, on the CPU.

Both packages get the same numbers: inputs are made with numpy from a seed
and carried across as arrays.  The reference's tree compressors draw from
threefry keys (one per agent by split); the test rebuilds those draws from
the key and hands them to the port in place of its own counter-hash stream,
by replacing ``repro_torch.core.compression.agent_draws``, the one function
the port's tree path draws through.  The reference's tree path is not
jitted, so it runs op by op, as the plain versions do: quantizer codes are
compared exactly and float state within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import compression as jax_comp
from repro.core import gossip as jax_gossip
from repro.core import lead as jax_lead
from repro.core import simulator as jax_sim
from repro.core import topology as jax_topology
from repro.core.convex import LinearRegression as JaxLinearRegression
from repro.core.engines import describe as jax_describe
from repro.core.engines import engine_for as jax_engine_for
from repro.core.engines import flat_twin as jax_flat_twin
from repro.utils import tree as jax_tree
from repro_torch.core import baselines, compression, gossip, lead, topology
from repro_torch.core import simulator
from repro_torch.core.compression import Identity, QuantizePNorm, RandK, TopK
from repro_torch.core.convert import problem_from_numpy, state_from_numpy
from repro_torch.core.engines import describe, flat_twin
from repro_torch.core.simulator import LEADSim, run
from repro_torch.kernels import cuda_lib
from repro_torch.utils import tree as port_tree
from test_torch_engine import _trace_close

CPU = "cpu"
N, DIM = 8, 1300            # 3 logical blocks per agent, the last ragged
STEPS = 3
RTOL = 1e-5                 # float state, as the reference's trajectories
TOPOS = {"ring8": lambda m: m.ring(8), "torus_2x4": lambda m: m.torus_2d(2, 4)}
# the wires: the port's compressor and the reference's
WIRES = {
    "pinf2": (lambda: QuantizePNorm(bits=2),
              lambda: jax_comp.QuantizePNorm(bits=2)),
    "pinf4": (lambda: QuantizePNorm(bits=4),
              lambda: jax_comp.QuantizePNorm(bits=4)),
    "randk": (lambda: RandK(ratio=0.25), lambda: jax_comp.RandK(ratio=0.25)),
    "topk": (lambda: TopK(ratio=0.1), lambda: jax_comp.TopK(ratio=0.1)),
    "identity": (Identity, jax_comp.Identity),
}
COMPRESSED = {"choco": "CHOCO_SGD", "deepsqueeze": "DeepSqueeze",
              "qdgd": "QDGD", "dcd": "DCD_SGD"}
EXACT = {"dgd": "DGD", "nids": "NIDS", "extra": "EXTRA", "d2": "D2"}


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


def _uniforms(keys, shape):
    """uniform(k, shape) for each key, stacked (numpy f32)."""
    return np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, shape, jnp.float32))(keys))


def _reference_draws(comp_j, keys, agent_shape):
    """The draws the reference's compress takes for one key per agent: the
    quantizer's dither over each agent's block matrix, RandK's uniforms
    over the agent's array (bernoulli(k, p, shape) is uniform(k, shape) <
    p), nothing for TopK and Identity.  In the port's agent_draws form."""
    if isinstance(comp_j, jax_comp.QuantizePNorm):
        size = int(np.prod(agent_shape))
        shape = (-(-size // comp_j.block), comp_j.block)
    elif isinstance(comp_j, jax_comp.RandK):
        shape = tuple(agent_shape)
    else:
        return {}
    return {"u": torch.from_numpy(_uniforms(keys, shape))}


def _inject(monkeypatch, draws):
    """Make the port's tree path take `draws` (a dict, or a list consumed
    one call at a time) instead of its counter-hash stream."""
    it = iter(draws) if isinstance(draws, list) else None
    monkeypatch.setattr(compression, "agent_draws",
                        lambda comp, X, seed: next(it) if it else draws)


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * max(1.0, float(np.max(np.abs(
                                   np.asarray(want))))), err_msg=what)


def _state_close(got, want, what):
    assert got._fields == want._fields, what
    for f in want._fields:
        if f == "k":
            assert int(got.k) == int(want.k), what
        else:
            _close(getattr(got, f).numpy(), getattr(want, f), f"{what}: {f}")


# -- utils/tree.py --------------------------------------------------------------

def test_tree_utils_match_reference():
    """Leaf order (dict keys sorted, NamedTuple fields in order, None an
    empty subtree), the vector-space helpers and ravel_pytree agree."""
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3,), (2, 5), (4,), (7,))]
    state_t = lead.LEADState(*(torch.from_numpy(a) for a in arrs[:4]),
                             k=torch.tensor(3))
    tree_t = {"z": [torch.from_numpy(arrs[0]), None],
              "a": (torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]))}
    tree_j = {"z": [jnp.asarray(arrs[0]), None],
              "a": (jnp.asarray(arrs[1]), jnp.asarray(arrs[2]))}
    lt, dt = port_tree.tree_flatten(tree_t)
    lj = jax.tree_util.tree_leaves(tree_j)
    assert [tuple(x.shape) for x in lt] == [x.shape for x in lj]
    assert port_tree.tree_unflatten(dt, lt)["z"][1] is None
    assert port_tree.tree_leaves(state_t)[-1] is state_t.k
    other_t = port_tree.tree_map(lambda x: 2.0 * x - 1.0, tree_t)
    other_j = jax.tree_util.tree_map(lambda x: 2.0 * x - 1.0, tree_j)
    for ft, fj in ((port_tree.tree_sub, jax_tree.tree_sub),
                   (port_tree.tree_add, jax_tree.tree_add),
                   (lambda a, b: port_tree.tree_lerp(0.3, a, b),
                    lambda a, b: jax_tree.tree_lerp(0.3, a, b)),
                   (lambda a, b: port_tree.tree_axpy(-0.5, a, b),
                    lambda a, b: jax_tree.tree_axpy(-0.5, a, b))):
        for x, y in zip(port_tree.tree_leaves(ft(tree_t, other_t)),
                        jax.tree_util.tree_leaves(fj(tree_j, other_j))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    _close(port_tree.tree_norm(tree_t), jax_tree.tree_norm(tree_j), "norm",
           rtol=1e-6)
    _close(port_tree.tree_dot(tree_t, other_t),
           jax_tree.tree_dot(tree_j, other_j), "dot", rtol=1e-6)
    assert port_tree.tree_size(tree_t) == jax_tree.tree_size(tree_j)
    assert port_tree.tree_bytes(tree_t) == jax_tree.tree_bytes(tree_j)
    assert not any(x.any() for x in port_tree.tree_leaves(
        port_tree.tree_zeros_like(tree_t)))
    vt, unravel = port_tree.ravel_pytree(tree_t)
    vj, _ = jax_tree.ravel_pytree(tree_j)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    back = unravel(vt)
    assert torch.equal(back["a"][0], tree_t["a"][0]) and back["z"][1] is None
    with pytest.raises(ValueError):
        port_tree.tree_map(torch.add, tree_t, [torch.zeros(1)])


# -- the compressors' tree path -------------------------------------------------

COMPRESSORS = {
    "pinf2_b512": (lambda: QuantizePNorm(bits=2),
                   lambda: jax_comp.QuantizePNorm(bits=2)),
    "pinf4_b16": (lambda: QuantizePNorm(bits=4, block=16),
                  lambda: jax_comp.QuantizePNorm(bits=4, block=16)),
    "pinf7_b64": (lambda: QuantizePNorm(bits=7, block=64),
                  lambda: jax_comp.QuantizePNorm(bits=7, block=64)),
    "randk": (lambda: RandK(ratio=0.25), lambda: jax_comp.RandK(ratio=0.25)),
    "randk_norescale": (lambda: RandK(ratio=0.5, rescale=False),
                        lambda: jax_comp.RandK(ratio=0.5, rescale=False)),
    "topk": (lambda: TopK(ratio=0.1), lambda: jax_comp.TopK(ratio=0.1)),
    "identity": (Identity, jax_comp.Identity),
}


@pytest.mark.parametrize("shape", [(1300,), (7, 30)], ids=str)
@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_compress_matches_reference(monkeypatch, name, shape):
    """Per-agent compress of one array and of a stack of agents (the
    reference's vmap over split keys) with the reference's draws: equal
    bit for bit; the p=inf quantizer's encode payload (codes and scales)
    equal, and its decode."""
    make_t, make_j = COMPRESSORS[name]
    ct, cj = make_t(), make_j()
    rng = np.random.default_rng(len(name))
    X = rng.standard_normal((N,) + shape).astype(np.float32)
    X[2] = 0.0
    if name == "topk":                       # ties among the magnitudes
        X[3] = np.round(X[3])
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, N)
    draws = _reference_draws(cj, keys, shape)
    want = np.asarray(jax_sim.vmap_compress(cj)(key, jnp.asarray(X)))
    _inject(monkeypatch, draws)
    got = compression.compress_each(ct, 0, torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), want)
    one = {k: v[0] for k, v in draws.items()}
    np.testing.assert_array_equal(ct.compress(torch.from_numpy(X[0]),
                                              **one).numpy(), want[0])
    pj, sj = cj.encode(keys[0], jnp.asarray(X[0]))
    pt, st = ct.encode(torch.from_numpy(X[0]), **one)
    assert set(pt) == set(pj)
    for f in pj:
        np.testing.assert_array_equal(pt[f].numpy(), np.asarray(pj[f]),
                                      err_msg=f)
    np.testing.assert_array_equal(ct.decode(pt, st).numpy(), want[0])
    assert ct.wire_bits(X[0].size) == cj.wire_bits(X[0].size)


def test_quantizer_p2_compress_matches_reference(monkeypatch):
    """p = 2 encodes in plain torch as the reference leaves it to XLA: the
    block norm sums in another order, so scales agree within 4 ulp and a
    code may flip by one level at a knife edge (ROADMAP.md)."""
    ct, cj = QuantizePNorm(bits=4, p=2.0), jax_comp.QuantizePNorm(bits=4, p=2.0)
    X = np.random.default_rng(9).standard_normal((1300,)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    draws = _reference_draws(cj, key[None], X.shape)
    pj, _ = cj.encode(key, jnp.asarray(X))
    pt, _ = ct.encode(torch.from_numpy(X), u=draws["u"][0])
    np.testing.assert_allclose(pt["scale"].numpy(), np.asarray(pj["scale"]),
                               rtol=4 * 2.0 ** -23, atol=0)
    flips = np.abs(pt["code"].numpy().astype(int)
                   - np.asarray(pj["code"]).astype(int))
    assert flips.max() <= 1 and flips.sum() <= 2


def test_compress_pytree_matches_reference(monkeypatch):
    """compress_pytree: leaf by leaf, in the reference's leaf order, each
    leaf with its own draws."""
    rng = np.random.default_rng(1)
    shapes = {"b": [(5, 7), (300,)], "a": (13,)}
    tree = {"b": [rng.standard_normal(s).astype(np.float32)
                  for s in shapes["b"]],
            "a": rng.standard_normal(shapes["a"]).astype(np.float32)}
    key = jax.random.PRNGKey(2)
    for ct, cj in ((QuantizePNorm(bits=2, block=64),
                    jax_comp.QuantizePNorm(bits=2, block=64)),
                   (RandK(ratio=0.3), jax_comp.RandK(ratio=0.3))):
        leaves = jax.tree_util.tree_leaves(tree)
        keys = jax.random.split(key, len(leaves))
        _inject(monkeypatch, [_reference_draws(cj, k[None], leaf.shape)
                              for k, leaf in zip(keys, leaves)])
        want = jax_comp.compress_pytree(cj, key, jax.tree_util.tree_map(
            jnp.asarray, tree))
        got = compression.compress_pytree(ct, 0, port_tree.tree_map(
            torch.from_numpy, tree))
        for g, w in zip(port_tree.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_estimate_C_matches_reference_in_distribution():
    """estimate_C draws its vectors and the compressors' draws from its own
    streams: its estimate is the reference's in distribution (within 10%;
    the max of 64 trials), 0 for Identity; nothing launches on the CPU."""
    cuda_lib.reset_launch_counts()
    for ct, cj in ((QuantizePNorm(bits=2), jax_comp.QuantizePNorm(bits=2)),
                   (RandK(ratio=0.25), jax_comp.RandK(ratio=0.25)),
                   (TopK(ratio=0.25), jax_comp.TopK(ratio=0.25))):
        got = compression.estimate_C(ct, seed=3, device=CPU)
        want = jax_comp.estimate_C(cj, jax.random.PRNGKey(3))
        assert got == pytest.approx(want, rel=0.1), type(ct).__name__
    assert compression.estimate_C(Identity(), device=CPU) == 0.0
    assert sum(cuda_lib.launch_counts().values()) == 0


# -- topology functions and gossip ---------------------------------------------

def test_topology_functions_match_reference():
    """spectral_gap, beta, lambda_min_plus, kappa_g on Topologies and raw
    matrices; check_mixing and check_doubly_stochastic accept what the
    reference accepts and raise (ValueError here) on what it rejects."""
    for make in TOPOS.values():
        got, want = make(topology), make(jax_topology)
        for arg_t, arg_j in ((got, want), (got.W, want.W)):
            for f in ("spectral_gap", "beta", "lambda_min_plus", "kappa_g"):
                assert getattr(topology, f)(arg_t) == \
                    getattr(jax_topology, f)(arg_j), f
        topology.check_mixing(got.W)
        topology.check_doubly_stochastic(got.W)
    directed = np.roll(np.eye(4), 1, axis=1)          # a one-peer round
    topology.check_doubly_stochastic(directed)
    jax_topology.check_doubly_stochastic(directed)
    with pytest.raises(ValueError):
        topology.check_mixing(directed)
    for bad in (np.array([[0.9, 0.1], [0.3, 0.7]]),
                np.array([[1.2, -0.2], [-0.2, 1.2]]), np.ones((2, 3))):
        with pytest.raises(AssertionError):
            jax_topology.check_doubly_stochastic(bad)
        with pytest.raises(ValueError):
            topology.check_doubly_stochastic(bad)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_encoded_ring_gossip_matches_reference(n):
    """EncodedRingGossip: weights read off topology.ring(n), mix_encoded
    equal to the reference's and to the dense W @ x (n = 2 has one
    neighbour, n = 1 none), shift rolls the agent axis."""
    W = topology.ring(n).W
    ring_t = gossip.EncodedRingGossip.weights_from(topology.ring(n))
    ring_j = jax_gossip.EncodedRingGossip.weights_from(
        jnp.asarray(jax_topology.ring(n)))
    assert (ring_t.w_self, ring_t.w_neighbor) == pytest.approx(
        (ring_j.w_self, ring_j.w_neighbor), rel=1e-7)
    x = (np.arange(1.0, n + 1.0)[:, None]
         * np.array([1.0, -2.0, 0.5])).astype(np.float32)
    tree_t = {"values": torch.from_numpy(x)}
    got = ring_t.mix_encoded(tree_t, lambda pl: pl["values"])
    want = ring_j.mix_encoded({"values": jnp.asarray(x)},
                              lambda pl: pl["values"])
    _close(got.numpy(), want, "mix_encoded", rtol=1e-6)
    _close(got.numpy(), W @ x, "dense", rtol=1e-6)
    np.testing.assert_array_equal(ring_t.shift(tree_t, 1)["values"].numpy(),
                                  np.roll(x, -1, axis=0))


def test_dense_gossip_mixes_pytrees():
    """DenseGossip.mix and i_minus_w leaf-wise over a pytree, equal to the
    reference's."""
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32)}
    dg_t = gossip.DenseGossip.from_topology(topology.ring(8), CPU)
    dg_j = jax_gossip.DenseGossip(W=jnp.asarray(jax_topology.ring(8)))
    tree_t = port_tree.tree_map(torch.from_numpy, tree)
    tree_j = jax.tree_util.tree_map(jnp.asarray, tree)
    for ft, fj in ((dg_t.mix, dg_j.mix), (dg_t.i_minus_w, dg_j.i_minus_w)):
        for g, w in zip(port_tree.tree_leaves(ft(tree_t)),
                        jax.tree_util.tree_leaves(fj(tree_j))):
            _close(g.numpy(), w, "mix", rtol=1e-6)


# -- tree LEAD and the tree baselines: per-step parity ------------------------------

def _pair(name, wire, topo):
    """(port algorithm, reference algorithm) for a registry-style name on
    `wire` over the TOPOS entry `topo`."""
    dg_t = gossip.DenseGossip.from_topology(TOPOS[topo](topology), CPU)
    dg_j = jax_gossip.DenseGossip(W=jnp.asarray(TOPOS[topo](jax_topology)))
    if name == "lead":
        make_t, make_j = WIRES[wire]
        return (LEADSim(gossip=dg_t, compressor=make_t(), eta=0.1,
                        engine="tree"),
                jax_sim.LEADSim(gossip=dg_j, compressor=make_j(), eta=0.1,
                                engine="tree"))
    cls = COMPRESSED.get(name) or EXACT[name]
    if name in EXACT:
        return (getattr(baselines, cls)(gossip=dg_t, eta=0.1),
                getattr(jax_baselines, cls)(gossip=dg_j, eta=0.1))
    make_t, make_j = WIRES[wire]
    return (getattr(baselines, cls)(gossip=dg_t, compressor=make_t(),
                                    eta=0.1),
            getattr(jax_baselines, cls)(gossip=dg_j, compressor=make_j(),
                                        eta=0.1))


def _tree_step_parity(monkeypatch, algo, ref, seed0):
    """From a common state (the reference's, carried across before every
    step), one step each with the same gradient and the reference's draws:
    init and every state field within RTOL, comp_err within RTOL."""
    rng = np.random.default_rng(seed0)
    x0, g0 = (rng.standard_normal((N, DIM)).astype(np.float32)
              for _ in range(2))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0),
                    jax.random.PRNGKey(0))
    st0 = algo.init(torch.from_numpy(x0), torch.from_numpy(g0))
    _state_close(st0, st_j, f"{type(algo).__name__} init")
    comp_j = getattr(ref, "compressor", None)
    for i in range(STEPS):
        g = rng.standard_normal((N, DIM)).astype(np.float32)
        key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 31)))
        st_t = state_from_numpy(type(st0), st_j, device=CPU)
        what = f"{type(algo).__name__} {comp_j!r} step {i}"
        if comp_j is None:
            new_j = ref.step(st_j, jnp.asarray(g), key)
            new_t = algo.step(st_t, torch.from_numpy(g), 0)
        else:
            keys = jax.random.split(key, N)
            _inject(monkeypatch, _reference_draws(comp_j, keys, (DIM,)))
            new_j, err_j = ref.step_with_metrics(st_j, jnp.asarray(g), key)
            new_t, err_t = algo.step_with_metrics(st_t, torch.from_numpy(g), 0)
            _close(float(err_t), float(err_j), what)
        _state_close(new_t, new_j, what)
        st_j = new_j


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("name", ["lead"] + sorted(COMPRESSED))
def test_compressed_tree_step_parity(monkeypatch, name, wire, topo):
    algo, ref = _pair(name, wire, topo)
    _tree_step_parity(monkeypatch, algo, ref, seed0=len(name + wire))


@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_tree_step_parity(monkeypatch, name, topo):
    algo, ref = _pair(name, None, topo)
    _tree_step_parity(monkeypatch, algo, ref, seed0=len(name))


# -- free runs, the simulator's tree driving, flat_twin ------------------------------

@pytest.fixture(scope="module")
def readme_problem():
    """The README quickstart's problem (ring-8, m = d = 64), from the
    reference, with its eta = 1/L, and the port's copy."""
    prob = JaxLinearRegression.generate(jax.random.PRNGKey(0), n_agents=8,
                                        m=64, d=64)
    mu, L = prob.mu_L
    port = problem_from_numpy(np.asarray(prob.A), np.asarray(prob.b),
                              prob.lam, device=CPU)
    return prob, port, torch.tensor(np.asarray(prob.x_star)), 1.0 / L


@pytest.mark.parametrize("name", ["lead"] + sorted(EXACT))
def test_uncompressed_tree_free_run_trace_parity(readme_problem, name):
    """run(), 100 steps of the uncompressed tree runs (LEADSim on Identity,
    the exact baselines) on the reference's arrays at eta = 1/L, where
    every one converges: dist, consensus and loss within _trace_close's
    bound, bits exactly, comp_err 0."""
    jprob, prob, x_star, eta = readme_problem
    dg_t = gossip.DenseGossip.from_topology(topology.ring(8), CPU)
    dg_j = jax_gossip.DenseGossip(W=jnp.asarray(jax_topology.ring(8)))
    if name == "lead":
        algo = LEADSim(gossip=dg_t, compressor=Identity(), eta=eta,
                       engine="tree")
        ref = jax_sim.LEADSim(gossip=dg_j, compressor=jax_comp.Identity(),
                              eta=eta, engine="tree")
    else:
        algo = getattr(baselines, EXACT[name])(gossip=dg_t, eta=eta)
        ref = getattr(jax_baselines, EXACT[name])(gossip=dg_j, eta=eta)
    got = run(algo, prob, x_star, iters=100)
    want = jax_sim.run(ref, jprob, jprob.x_star, iters=100)
    assert want.dist[-1] < want.dist[0]          # not a divergent run
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f"{name} {f}")
    np.testing.assert_array_equal(got.bits_per_agent, want.bits_per_agent)
    assert not got.comp_err.any()


def test_default_engine_is_the_references(monkeypatch):
    """LEADSim's default engine is the reference's, "tree": the same call,
    LEADSim(gossip=dg, compressor=QuantizePNorm(bits=2), eta=0.1), takes
    one step equal to the reference's default LEADSim (the reference's
    per-agent draws injected through compression.agent_draws); with no
    compressor the default raises ValueError, as the reference asserts."""
    dg_t = gossip.DenseGossip.from_topology(topology.ring(N), CPU)
    dg_j = jax_gossip.DenseGossip(W=jnp.asarray(jax_topology.ring(N)))
    algo = LEADSim(gossip=dg_t, compressor=QuantizePNorm(bits=2), eta=0.1)
    ref = jax_sim.LEADSim(gossip=dg_j,
                          compressor=jax_comp.QuantizePNorm(bits=2), eta=0.1)
    assert algo.engine == ref.engine == "tree"
    rng = np.random.default_rng(17)
    x0, g0, g = (rng.standard_normal((N, DIM)).astype(np.float32)
                 for _ in range(3))
    st_j = ref.init(jnp.asarray(x0), jnp.asarray(g0), jax.random.PRNGKey(0))
    st_t = algo.init(torch.from_numpy(x0), torch.from_numpy(g0))
    _state_close(st_t, st_j, "default LEADSim init")
    key = jax.random.PRNGKey(11)
    _inject(monkeypatch, _reference_draws(ref.compressor,
                                          jax.random.split(key, N), (DIM,)))
    new_j, err_j, bits_j = ref.step_with_wire(st_j, jnp.asarray(g), key)
    new_t, err_t, bits_t = algo.step_with_wire(st_t, torch.from_numpy(g), 0)
    assert type(new_t).__name__ == type(new_j).__name__ == "LEADState"
    _state_close(new_t, new_j, "default LEADSim step")
    _close(float(err_t), float(err_j), "default LEADSim comp_err")
    assert float(bits_t) == float(bits_j)
    with pytest.raises(ValueError):
        LEADSim(topology=topology.ring(8))


def test_tree_lead_construction_and_rebinding(readme_problem):
    """LEADSim(engine="tree"): exactly one of gossip= and topology=, a
    compressor required, a time-varying bank refused; the legacy gossip=
    form and topology= give the same run; run(topology=) rebinds a tree
    baseline's DenseGossip; the tree path launches nothing on the CPU."""
    jprob, prob, x_star, eta = readme_problem
    ring = topology.ring(8)
    dg = gossip.DenseGossip.from_topology(ring, CPU)
    with pytest.raises(ValueError):
        LEADSim(gossip=dg, topology=ring, compressor=Identity(),
                engine="tree")
    with pytest.raises(ValueError):
        LEADSim(compressor=Identity(), engine="tree")
    with pytest.raises(ValueError):
        LEADSim(gossip=dg, engine="tree")
    with pytest.raises(ValueError, match="engine='flat'"):
        LEADSim(topology=[ring, ring], compressor=Identity(), engine="tree",
                device=CPU)._gossip
    q2 = QuantizePNorm(bits=2)
    cuda_lib.reset_launch_counts()
    legacy = run(LEADSim(gossip=dg, compressor=q2, eta=eta, engine="tree"),
                 prob, x_star, iters=30)
    topo = run(LEADSim(topology=ring, compressor=q2, eta=eta, engine="tree"),
               prob, x_star, iters=30)
    for f in legacy._fields:
        np.testing.assert_array_equal(getattr(legacy, f), getattr(topo, f))
    assert legacy.dist[-1] < 1e-3 * legacy.dist[0]
    assert sum(cuda_lib.launch_counts().values()) == 0
    torus = topology.torus_2d(2, 4)
    rebound = run(baselines.DGD(gossip=dg, eta=eta), prob, x_star, iters=10,
                  topology=torus)
    direct = run(baselines.DGD(gossip=gossip.DenseGossip.from_topology(
        torus, CPU), eta=eta), prob, x_star, iters=10)
    np.testing.assert_array_equal(rebound.dist, direct.dist)


def test_compression_error_fallback_matches_reference(monkeypatch,
                                                      readme_problem):
    """_compression_error, the comp_err of an algorithm without step
    metrics, in its three branches: an `e` field (v = x - eta g + e), an
    `xhat` field (x - xhat against x) and a plain state (x); with no
    compressor it is 0."""
    jprob, prob, _, eta = readme_problem
    rng = np.random.default_rng(6)
    x, e, xhat = (rng.standard_normal((8, 64)).astype(np.float32)
                  for _ in range(3))
    cases = [("DeepSqueeze", "ErrorState", {"x": x, "e": e}),
             ("CHOCO_SGD", "HatState", {"x": x, "xhat": xhat, "xhat_w": xhat}),
             ("QDGD", "SimpleState", {"x": x})]
    dg_t = gossip.DenseGossip.from_topology(topology.ring(8), CPU)
    dg_j = jax_gossip.DenseGossip(W=jnp.asarray(jax_topology.ring(8)))
    key = jax.random.PRNGKey(8)
    for cls, state_cls, fields in cases:
        algo = getattr(baselines, cls)(gossip=dg_t, eta=eta,
                                       compressor=QuantizePNorm(bits=2))
        ref = getattr(jax_baselines, cls)(
            gossip=dg_j, eta=eta, compressor=jax_comp.QuantizePNorm(bits=2))
        st_j = getattr(jax_baselines, state_cls)(
            **{f: jnp.asarray(v) for f, v in fields.items()},
            k=jnp.asarray(2, jnp.int32))
        st_t = state_from_numpy(getattr(baselines, state_cls), st_j,
                                device=CPU)
        _inject(monkeypatch, _reference_draws(ref.compressor,
                                              jax.random.split(key, 8), (64,)))
        want = jax_sim._compression_error(ref, st_j, jprob, key)
        got = simulator._compression_error(algo, st_t, prob, 0)
        _close(float(got), float(want), cls)
        assert float(got) > 0
    exact = baselines.DGD(gossip=dg_t, eta=eta)
    assert float(simulator._compression_error(
        exact, baselines.SimpleState(x=torch.ones(8, 64),
                                     k=torch.tensor(0)), prob, 0)) == 0.0


@pytest.mark.parametrize("name", sorted({**COMPRESSED, **EXACT}) + ["lead"])
def test_flat_twin_matches_reference(name):
    """flat_twin of a tree algorithm: the registry path, sizes and hypers of
    the reference's twin (for LEADSim, of the reference's engine_for on the
    same graph)."""
    algo, ref = _pair(name, "pinf2", "ring8")
    twin = flat_twin(algo, DIM)
    if name == "lead":
        want = jax_engine_for(ref.gossip.W, ref.compressor, DIM,
                              dither="fast", eta=ref.eta, gamma=ref.gamma,
                              alpha=ref.alpha)
    else:
        want = jax_flat_twin(ref, DIM)
    assert describe(twin) == jax_describe(want)
    assert (twin.nb, twin.block, twin.hyper_fields) == \
        (want.nb, want.block, want.hyper_fields)
    for f in twin.hyper_fields:
        assert getattr(twin, f) == getattr(want, f), f
    assert twin.device == torch.device(CPU)
    with pytest.raises(KeyError):
        flat_twin(object(), DIM)


def test_tree_and_flat_lead_agree_uncompressed(readme_problem):
    """Uncompressed, LEAD's tree path (plain torch) and its flat twin (the
    fused plain kernels) run the same trajectory to rounding."""
    _, prob, x_star, eta = readme_problem
    tree = LEADSim(topology=topology.ring(8), compressor=Identity(), eta=eta,
                   engine="tree", device=CPU)
    got = run(tree, prob, x_star, iters=60)
    want = run(flat_twin(tree, prob.d), prob, x_star, iters=60)
    for f in ("dist", "consensus", "loss"):
        _trace_close(getattr(got, f), getattr(want, f), f)
