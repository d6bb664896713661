"""The port's dense models, optimizers and synthetic stream against the JAX
reference, on the CPU (mirrors tests/test_models.py for what is ported).

Weights are the reference's ``init_params`` carried over with
``core/convert.params_from_numpy`` (QKV biases and norm gains perturbed
first, so those paths carry non-trivial values); batches are numpy from a
seed.  ``forward`` and ``loss_fn`` agree within 1e-5 relative, every
parameter's gradient within 1e-4 (max |port - ref| over max |ref|, per
leaf).  Archs: granite-3-2b, qwen2-7b (QKV bias), deepseek-67b, gemma3-12b
reduced (two local layers) and gemma3-12b at 6 layers with a window of 8
(five local layers and one global: the windows cut the 32 positions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data import synthetic as jax_synthetic
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro.optim import optimizers as jax_optim
from repro_torch.configs.registry import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.data import synthetic
from repro_torch.models import attention, transformer as tfm
from repro_torch.optim import optimizers
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

CPU = "cpu"
RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name):
    """(reference config, port config) of a test arch."""
    if name == "gemma3-local-global":
        kw = {"n_layers": 6, "d_model": 128}
        j = dataclasses.replace(jax_get_config("gemma3-12b").reduced(**kw),
                                window=8)
        t = dataclasses.replace(get_config("gemma3-12b").reduced(**kw),
                                window=8)
        return j, t
    return jax_get_config(name).reduced(), get_config(name).reduced()


ARCHS = ["granite-3-2b", "qwen2-7b", "deepseek-67b", "gemma3-12b",
         "gemma3-local-global"]


def _carried(jcfg, seed=0):
    """The reference's init_params as numpy, with the zero biases and unit
    norm gains perturbed so their paths carry real values."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray,
                               jax_tfm.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'", "ln")):
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, p)


def _batch(vocab, seed=1, B=2, S=32):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, cfg = _configs(arch)
    pn = _carried(jcfg)
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    hidden = jax_tfm.forward(jp, jcfg, jb["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_tfm.loss_fn(p, jcfg, jb)[0]))(jp)

    params = params_from_numpy(pn, device=CPU)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    leaves, treedef = tree_flatten(params)
    xs = [l.requires_grad_() for l in leaves]
    tloss, metrics = tfm.loss_fn(params, cfg, tb)
    tgrads = torch.autograd.grad(tloss, xs)
    with torch.no_grad():
        thidden = tfm.forward(params, cfg, tb["tokens"])

    assert _rel(thidden.numpy(), hidden) < RTOL
    assert abs(tloss.item() - float(loss)) < RTOL * abs(float(loss))
    assert metrics["loss"] is tloss
    jleaves = jax.tree_util.tree_leaves(grads)
    assert len(jleaves) == len(tgrads)
    for g, jg in zip(tgrads, jleaves):
        assert g.shape == jg.shape
        assert _rel(g.numpy(), jg) < GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The same dict keys, stacked scan groups and leaf shapes as the
    reference's init_params (the trainer blocks every leaf on its own), and
    the reference's init statistics; params_from_numpy keeps the order."""
    jcfg, cfg = _configs(arch)
    jp = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
    tl = tree_leaves(tp)
    assert [tuple(l.shape) for l in tl] == [x.shape for _, x in jl]
    assert type(tp["layers"]) is tuple
    assert len(tp["layers"]) == len(jp["layers"])
    assert sorted(tp) == sorted(jp)
    for (path, x), t in zip(jl, tl):
        x = np.asarray(x)
        if x.size > 1000:                 # same init scale, within 5%
            assert abs(t.std().item() - x.std()) <= 0.05 * x.std(), path
        else:                             # norms one, biases zero
            assert torch.equal(t, torch.tensor(x)), path
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device=CPU)
    for (_, x), t in zip(jl, tree_leaves(carried)):
        assert np.array_equal(t.numpy(), np.asarray(x))


def test_windowed_equals_full_when_window_covers():
    """tests/test_models.py:87 on the port."""
    g = torch.Generator().manual_seed(0)
    B, S, nq, nkv, hd = 2, 64, 4, 2, 16
    q = torch.randn(B, S, nq, hd, generator=g)
    k = torch.randn(B, S, nkv, hd, generator=g)
    v = torch.randn(B, S, nkv, hd, generator=g)
    full = attention.chunked_causal_attention(q, k, v, chunk=16)
    win = attention.windowed_attention(q, k, v, window=S, chunk=16)
    assert (full - win).abs().max() < 2e-5


@pytest.mark.parametrize("fn", ["chunked", "windowed"])
def test_attention_matches_reference(fn):
    """Several query and kv chunks (online softmax across chunks), GQA
    groups of 2, a window of 8 cutting the band: within 1e-5 of the
    reference's function, and RoPE likewise."""
    rng = np.random.default_rng(3)
    B, S, nq, nkv, hd = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (nq, nkv, nkv))
    if fn == "chunked":
        want = jax_attn.chunked_causal_attention(q, k, v, chunk=16)
        got = attention.chunked_causal_attention(
            *map(torch.tensor, (q, k, v)), chunk=16)
    else:
        want = jax_attn.windowed_attention(q, k, v, window=8, chunk=16)
        got = attention.windowed_attention(*map(torch.tensor, (q, k, v)),
                                           window=8, chunk=16)
    assert _rel(got.numpy(), want) < RTOL
    pos = np.arange(S)[None]
    assert _rel(attention.apply_rope(torch.tensor(q), torch.tensor(pos),
                                     1e4).numpy(),
                jax_attn.apply_rope(q, pos, 1e4)) < RTOL


def test_chunked_loss_matches_dense():
    """tests/test_models.py:148 on the port: the chunked cross-entropy
    equals the cross-entropy of the materialized logits."""
    cfg = get_config("granite-3-2b").reduced()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg.vocab).items()}
    with torch.no_grad():
        loss, _ = tfm.loss_fn(params, cfg, batch, chunk=8)
        h = tfm.forward(params, cfg, batch["tokens"])
        logp = torch.log_softmax(tfm.logits_fn(params, cfg, h), -1)
        want = -torch.gather(logp, -1,
                             batch["labels"][..., None].long()).mean()
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))


def test_unported_entry_points_raise():
    """Once raising, the serving entry points now give the reference's
    shapes for reduced granite: init_cache's and prefill's cache leaves,
    decode_step's and prefill_chunk's logits and caches (the paged cache's
    pools carry one spare row).  The MoE init and the vlm memory stub, once
    unported, give the reference's leaf shapes and the stub's shape."""
    from repro.serve import paged_cache as jax_pc
    from repro_torch.serve import paged_cache as pc

    cfg = get_config("granite-3-2b").reduced()
    jcfg = jax_get_config("granite-3-2b").reduced()

    def shapes(tree):
        return [tuple(np.shape(l)) for l in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]

    def port_shapes(cache):
        return [tuple(l.shape) for c in cache["layers"]
                for l in (c.k, c.v)] + [tuple(cache["pos"].shape)]

    jc = jax.eval_shape(lambda: jax_tfm.init_cache(jcfg, 2, 32))
    assert port_shapes(tfm.init_cache(cfg, 2, 32, device=CPU)) == shapes(jc)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    jp = jax.eval_shape(lambda: jax_tfm.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jlg, jc = jax.eval_shape(lambda p: jax_tfm.prefill(
        p, jcfg, jnp.zeros((2, 8), jnp.int32), cache_len=32), jp)
    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, toks, cache_len=32)
        assert tuple(lg.shape) == jlg.shape
        assert port_shapes(cache) == shapes(jc)
        lg, cache = tfm.decode_step(params, cfg, toks[:, :1], cache)
        assert tuple(lg.shape) == jlg.shape and int(cache["pos"]) == 9
        paged = pc.init_paged_cache(cfg, 2, 32, kv_bits=4, device=CPU)
        lg, paged = tfm.prefill_chunk(params, cfg, toks[:1].repeat(1, 2),
                                      paged, 0, 0, 16)
        assert tuple(lg.shape) == (1, 1, cfg.vocab)
    jpaged = jax.eval_shape(lambda: jax_pc.init_paged_cache(jcfg, 2, 32,
                                                            kv_bits=4))
    for mine, ref in zip(paged["layers"], jpaged["layers"]):
        assert tuple(mine.kc.shape) == (ref.kc.shape[0] + 1,
                                        *ref.kc.shape[1:])
        assert tuple(mine.tail_k.shape) == ref.tail_k.shape
        assert tuple(mine.page_table.shape) == ref.page_table.shape
    moe_cfg = get_config("granite-moe-1b-a400m").reduced()
    jp = jax_tfm.init_params(jax_get_config("granite-moe-1b-a400m").reduced(),
                             jax.random.PRNGKey(0))
    tp = tfm.init_params(moe_cfg, device=CPU)
    assert [tuple(l.shape) for l in tree_leaves(tp)] \
        == [l.shape for l in jax.tree_util.tree_leaves(jp)]
    vlm = get_config("llama-3.2-vision-11b").reduced()
    mem = synthetic.stub_memory("vlm", (4, 2), vlm, device=CPU)
    assert tuple(mem.shape) == (4, 2, vlm.vis_tokens, vlm.d_model)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {"beta": 0.8}),
                                     ("adam", {})])
def test_optimizers_match_reference(name, kw):
    """Three updates of SGD, Momentum and Adam on the same gradients: the
    same directions and states within 1e-6."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": ((5,), (2, 2))}
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple) and all(
            isinstance(i, int) for i in s))
    jopt = jax_optim.make_optimizer(name, **kw)
    topt = optimizers.make_optimizer(name, **kw)
    jstate = jopt.init(params)
    tparams = params_from_numpy(params, device=CPU)
    tstate = topt.init(tparams)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        jdir, jstate = jopt.update(g, jstate, params)
        tdir, tstate = topt.update(params_from_numpy(g, device=CPU), tstate,
                                   tparams)
        for a, b in zip(tree_leaves(tdir), jax.tree_util.tree_leaves(jdir)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    if name == "adam":
        assert int(tstate.t) == int(jstate.t) == 3
        assert tstate.t.dtype == torch.int32


def test_lm_batch_shapes_labels_and_mixture():
    """(A, B, S) int64 tokens and labels, labels the next token; each
    agent's tokens fall in its preferred block of 64 about 0.8 + 0.2 *
    64 / vocab of the time, as the reference's do; a pure function of
    (seed, step, agent)."""
    cfg = synthetic.LMStreamConfig(vocab=512, seq_len=64, batch_per_agent=8,
                                   n_agents=4)
    jcfg = jax_synthetic.LMStreamConfig(vocab=512, seq_len=64,
                                        batch_per_agent=8, n_agents=4)
    b = synthetic.lm_batch(cfg, 3, device=CPU)
    jb = jax_synthetic.lm_batch(jcfg, 3)
    assert b["tokens"].shape == b["labels"].shape == (4, 8, 64)
    assert tuple(jb["tokens"].shape) == (4, 8, 64)
    assert b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 512
    want = 0.8 + 0.2 * 64 / 512
    for a in range(4):
        lo = (a * 64) % (512 - 64)
        for toks in (b["tokens"][a].numpy(), np.asarray(jb["tokens"][a])):
            share = float(((toks >= lo) & (toks < lo + 64)).mean())
            assert abs(share - want) < 0.05, (a, share)
    again = synthetic.lm_batch(cfg, 3, agent=2, device=CPU)
    assert torch.equal(again["tokens"], b["tokens"][2])
    assert not torch.equal(synthetic.lm_batch(cfg, 4, device=CPU)["tokens"],
                           b["tokens"])
    homo = synthetic.lm_batch(dataclasses.replace(cfg, heterogeneous=False),
                              3, device=CPU)["tokens"]
    assert float(((homo >= 0) & (homo < 64)).float().mean()) < 0.3
