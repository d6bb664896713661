"""The port's MoE layer (src/repro_torch/models/moe.py) against the JAX
reference's (src/repro/models/moe.py), on the CPU.

Weights from the reference's ``moe_init``, inputs numpy from a seed.  The
routing is held integer for integer: the expert ids of every token whose
k-th and (k+1)-th probabilities lie more than NEAR_TIE apart (a 1-ulp
difference in the router logits may swap experts at a near-tie; such
tokens are counted, not avoided by re-seeding), and the slots and keep
mask of the reference's expert ids exactly.  Where no token flips, the
port's own slots and keep are the reference's; outputs agree within 1e-5
relative, every gradient (the four weights and the input) within 1e-4, the
aux loss within 1e-6.  Where a token flips, the tokens and experts it
touches are left out of the comparison and the others held on the same
bounds.  Cases: the default capacity factor, one small enough that pairs
are dropped, and a ``seq_chunk`` run.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.configs.registry import get_config
from repro_torch.models import moe, transformer as tfm

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
AUX_TOL = 1e-6
NEAR_TIE = 1e-6
D, F, E, K = 64, 96, 8, 2
WEIGHTS = ("router", "w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(np.abs(want).max(), 1e-30)


def _setup(seed=0, B=2, S=32):
    p = jax.tree_util.tree_map(
        np.asarray, jax_moe.moe_init(jax.random.PRNGKey(seed), D, F, E))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, D)) \
        .astype(np.float32)
    return p, x


def _reference_routing(p, xt, top_k, capacity_factor):
    """src/repro/models/moe.py:56-72 on (T, d): probs, expert ids, slot
    ids, keep, C."""
    T = xt.shape[0]
    C = max(1, int(capacity_factor * T * top_k / E))
    probs = jax.nn.softmax(jnp.asarray(xt) @ p["router"], axis=-1)
    _, expert_ids = jax.lax.top_k(probs, top_k)
    multi_hot = jax.nn.one_hot(expert_ids, E, dtype=jnp.int32).sum(1)
    slot_te = jnp.cumsum(multi_hot, axis=0) - 1
    slot_id = jnp.take_along_axis(slot_te, expert_ids, axis=1) \
        .reshape(T * top_k)
    return (np.asarray(probs), np.asarray(expert_ids), np.asarray(slot_id),
            np.asarray(slot_id < C), C)


def _near_ties(probs, top_k):
    """Tokens whose k-th and (k+1)-th probabilities lie within NEAR_TIE."""
    s = -np.sort(-probs, axis=-1)
    return np.flatnonzero(s[:, top_k - 1] - s[:, top_k] <= NEAR_TIE)


CASES = {"default": dict(capacity_factor=1.25),
         "dropping": dict(capacity_factor=0.5),
         "seq_chunk": dict(capacity_factor=1.25, seq_chunk=8)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_slots_and_keep_match_reference(case):
    """Expert ids exactly away from near-ties; the slots and keep of the
    reference's ids exactly (integer for integer); and, with no flip, the
    port's own.  The dropping case drops pairs in both packages."""
    kw = CASES[case]
    p, x = _setup()
    chunk = kw.get("seq_chunk", x.shape[1])
    tp = {k: torch.tensor(v) for k, v in p.items()}
    for c in range(x.shape[1] // chunk):
        xt = x[:, c * chunk:(c + 1) * chunk].reshape(-1, D)
        probs, ids, slot, keep, C = _reference_routing(
            p, xt, K, kw["capacity_factor"])
        _, _, tids, tslot, tkeep, tC = moe.route(
            tp, torch.tensor(xt), K, kw["capacity_factor"])
        assert tC == C
        ties = _near_ties(probs, K)
        away = np.setdiff1d(np.arange(xt.shape[0]), ties)
        assert np.array_equal(tids.numpy()[away], ids[away]), ties
        rslot, rkeep = moe.slots(torch.tensor(ids, dtype=torch.int64), E, C)
        assert np.array_equal(rslot.numpy(), slot)
        assert np.array_equal(rkeep.numpy(), keep)
        if np.array_equal(tids.numpy(), ids):
            assert np.array_equal(tslot.numpy(), slot)
            assert np.array_equal(tkeep.numpy(), keep)
        if case == "dropping":
            assert not keep.all()


def _flipped(p, x, kw):
    """(tokens, experts) the near-tie flips touch, per the chunks' routing
    in both packages; empty when every token routes as the reference."""
    chunk = kw.get("seq_chunk", x.shape[1])
    tp = {k: torch.tensor(v) for k, v in p.items()}
    bad_tok, bad_exp = set(), set()
    for c in range(x.shape[1] // chunk):
        xt = x[:, c * chunk:(c + 1) * chunk].reshape(-1, D)
        ids = _reference_routing(p, xt, K, kw["capacity_factor"])[1]
        tids = moe.route(tp, torch.tensor(xt), K,
                         kw["capacity_factor"])[2].numpy()
        for t in np.flatnonzero((ids != tids).any(-1)):
            bad_exp |= set(ids[t]) ^ set(tids[t])
    if bad_exp:
        for c in range(x.shape[1] // chunk):
            xt = x[:, c * chunk:(c + 1) * chunk].reshape(-1, D)
            ids = _reference_routing(p, xt, K, kw["capacity_factor"])[1]
            for t in range(xt.shape[0]):
                if set(ids[t]) & bad_exp:
                    b, s = divmod(t, chunk)
                    bad_tok.add((b, c * chunk + s))
    return bad_tok, bad_exp


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_and_grads_match_reference(case):
    """Output within 1e-5, aux within 1e-6, the gradients of a fixed
    random projection of the output (plus the aux loss) with respect to
    the four weights and the input within 1e-4 - away from the tokens and
    experts a near-tie flip touches (none with these seeds is required:
    the count is reported)."""
    kw = CASES[case]
    p, x = _setup()
    proj = np.random.default_rng(7).standard_normal(x.shape) \
        .astype(np.float32)

    def jloss(pp, xx):
        out, aux = jax_moe.moe_apply(pp, xx, top_k=K, **kw)
        return jnp.sum(out * proj) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_apply(tp, tx, top_k=K, **kw)
    aux_value = aux.detach()
    loss = torch.sum(out * torch.tensor(proj)) + aux
    grads = torch.autograd.grad(loss, [tp[k] for k in WEIGHTS] + [tx])

    bad_tok, bad_exp = _flipped(p, x, kw)
    keep_tok = np.ones(x.shape[:2], bool)
    for b, s in bad_tok:
        keep_tok[b, s] = False
    assert _rel(out.detach().numpy()[keep_tok], np.asarray(jout)[keep_tok]) \
        < OUT_RTOL, len(bad_tok)
    gx, jgx = grads[-1].numpy(), np.asarray(jg[1])
    assert _rel(gx[keep_tok], jgx[keep_tok]) < GRAD_RTOL
    experts = [e for e in range(E) if e not in bad_exp]
    for name, g in zip(WEIGHTS, grads):
        want = np.asarray(jg[0][name])
        if name == "router":
            if bad_exp:
                continue
            assert _rel(g.numpy(), want) < GRAD_RTOL, name
        else:
            assert _rel(g.numpy()[experts], want[experts]) < GRAD_RTOL, name
    if not bad_exp:
        assert abs(aux_value.item() - float(jaux)) < AUX_TOL


def test_moe_block_capacity_is_per_call():
    """The capacity is counted on the call's own tokens: C = max(1,
    int(capacity_factor * T * top_k / E)), per chunk under seq_chunk, as
    the reference's; granite-moe's at the trainer's per-agent batch 2 x
    128 is 80 slots."""
    cfg = get_config("granite-moe-1b-a400m")
    assert moe.capacity(2 * 128, cfg.top_k, cfg.n_experts,
                        cfg.capacity_factor) == 80
    assert moe.capacity(3, 2, 64, 1.25) == 1
    assert moe.capacity(64, 2, 8, 0.5) == 8


def test_expert_parallel_config_raises():
    """A config with moe_ep_axis set (models/moe_ep.py's all-to-all) is a
    serving path: the trainer raises NotImplementedError naming
    ROADMAP.md, and forward runs it.  Its parameters are the plain MoE's.
    In one process forward equals the reference's (its moe_apply_ep on a
    (1, 1) mesh) on the same weights within 1e-5 relative."""
    from repro.compat import AxisType, make_mesh, set_mesh
    from repro.configs.registry import get_config as jax_get_config
    from repro.models import transformer as jax_tfm
    from repro_torch.dist.trainer import DistConfig, make_train_step
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              moe_ep_axis="data")
    assert cfg.param_count() \
        == get_config("granite-moe-1b-a400m").reduced().param_count()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfm.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(cfg, 4, DistConfig(), "cpu")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    with torch.no_grad():
        hidden = tfm.forward(params, cfg, torch.tensor(tokens))
    jcfg = dataclasses.replace(
        jax_get_config("granite-moe-1b-a400m").reduced(), moe_ep_axis="data")
    mesh = make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
    with set_mesh(mesh):
        want = jax.jit(lambda pp, tt: jax_tfm.forward(pp, jcfg, tt))(
            tree_map(lambda x: x.numpy(), params),
            jnp.asarray(tokens, jnp.int32))
    assert hidden.shape == tuple(want.shape)
    assert _rel(hidden.numpy(), want) < OUT_RTOL
