"""The port's model families beyond the dense ones against the JAX
reference, on the CPU: the MoE (granite-moe-1b-a400m, kimi-k2), xLSTM
(xlstm-1.3b at 6 layers, so the sLSTM block runs), the RG-LRU hybrid
(recurrentgemma-2b at 3 layers, so the local-attention block runs), the
vlm (llama-3.2-vision-11b, gated cross-attention to the vision memory) and
the audio encoder-decoder (whisper-tiny, with its frame memory), each at
``.reduced()`` size.

Weights are the reference's ``init_params`` carried over with
``core/convert.params_from_numpy``, the norm gains perturbed and the
cross-attention gates moved off zero (tanh(0) would switch the
cross-attention off), so those paths carry values; batches are numpy from
a seed, the memory the reference's ``stub_memory`` passed over as numpy.
``forward`` and ``loss_fn`` agree within 1e-5 relative, every parameter's
gradient within 1e-4 (max |port - ref| over max |ref|, per leaf), the
bounds of tests/test_torch_models.py.

    PYTHONPATH=src python -m pytest -q tests/test_torch_families.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data import synthetic as jax_synthetic
from repro.models import transformer as jax_tfm
from repro_torch.configs.registry import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.data import synthetic
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import tree_flatten, tree_leaves

CPU = "cpu"
RTOL = 1e-5
GRAD_RTOL = 1e-4

# arch -> reduced() keywords
ARCHS = {"granite-moe-1b-a400m": {}, "kimi-k2-1t-a32b": {},
         "xlstm-1.3b": {"n_layers": 6}, "recurrentgemma-2b": {"n_layers": 3},
         "llama-3.2-vision-11b": {}, "whisper-tiny": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch):
    """(reference config, port config) of a test arch at reduced size."""
    kw = ARCHS[arch]
    return (jax_get_config(arch).reduced(**kw),
            get_config(arch).reduced(**kw))


def carried(jcfg, seed=0):
    """The reference's init_params as numpy, the unit norm gains perturbed
    by 0.1 N(0, 1) and the zero cross-attention gates set to 0.5 + 0.1
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray,
                               jax_tfm.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['gate']"):
            return (leaf + 0.5 + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        if "ln" in name:
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, p)


def batch_of(jcfg, seed=1, B=2, S=32):
    """tokens, labels and, for vlm and audio, the reference's stub memory,
    as numpy."""
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    mem = jax_synthetic.stub_memory(jcfg.family, (B,), jcfg)
    if mem is not None:
        batch["memory"] = np.asarray(mem)
    return batch


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, cfg = configs(arch)
    pn = carried(jcfg)
    batch = batch_of(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, pn)

    @jax.jit
    def reference(p):
        hidden = jax_tfm.forward(p, jcfg, jb["tokens"],
                                 memory=jb.get("memory"))
        loss, grads = jax.value_and_grad(
            lambda q: jax_tfm.loss_fn(q, jcfg, jb)[0])(p)
        return hidden, loss, grads

    hidden, loss, grads = reference(jp)

    params = params_from_numpy(pn, device=CPU)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    leaves, _ = tree_flatten(params)
    xs = [l.requires_grad_() for l in leaves]
    tloss, _ = tfm.loss_fn(params, cfg, tb)
    tgrads = torch.autograd.grad(tloss, xs)
    with torch.no_grad():
        thidden = tfm.forward(params, cfg, tb["tokens"],
                              memory=tb.get("memory"))

    assert _rel(thidden.numpy(), hidden) < RTOL
    assert abs(tloss.item() - float(loss)) < RTOL * abs(float(loss))
    jpaths = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(jpaths) == len(tgrads)
    for g, (path, jg) in zip(tgrads, jpaths):
        assert g.shape == jg.shape, jax.tree_util.keystr(path)
        assert _rel(g.numpy(), jg) < GRAD_RTOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_matches_reference(arch):
    """The reference's dict keys, stacked groups (``layers``, vlm
    ``cross_layers``, audio ``dec_cross``) and leaf shapes, 0-d gates
    included; norms one, biases and gates zero; params_from_numpy keeps
    the order and every value."""
    jcfg, cfg = configs(arch)
    jp = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree_leaves(tp)
    assert [tuple(l.shape) for l in tl] == [x.shape for _, x in jl]
    assert sorted(tp) == sorted(jp)
    for key in ("cross_layers", "dec_cross", "encoder"):
        if key in jp:
            assert type(tp[key]) is type(jp[key]), key
    for (path, x), t in zip(jl, tl):
        name = jax.tree_util.keystr(path)
        if "ln" in name or name.endswith("['gate']"):
            assert torch.equal(t, torch.tensor(np.asarray(x))), name
    carried_tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device=CPU)
    for (_, x), t in zip(jl, tree_leaves(carried_tree)):
        assert t.shape == x.shape and np.array_equal(t.numpy(),
                                                     np.asarray(x))


@pytest.mark.parametrize("family", ["vlm", "audio", "dense"])
def test_stub_memory_shape_and_scale(family):
    """0.02 N(0, 1) of shape (*batch_shape, M, d_model) - M the vision
    tokens or the audio frames - like the reference's; None for the text
    families.  Drawn from the counter hash, so it is the reference's in
    distribution only, the same for the same seed, another for another."""
    arch = {"vlm": "llama-3.2-vision-11b", "audio": "whisper-tiny",
            "dense": "granite-3-2b"}[family]
    cfg = get_config(arch).reduced()
    got = synthetic.stub_memory(family, (4, 2), cfg, device=CPU)
    want = jax_synthetic.stub_memory(family, (4, 2),
                                     jax_get_config(arch).reduced())
    if want is None:
        assert got is None
        return
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert abs(float(got.std()) - 0.02) < 0.002
    assert abs(float(got.mean())) < 0.002
    assert torch.equal(got, synthetic.stub_memory(family, (4, 2), cfg,
                                                  device=CPU))
    assert not torch.equal(got, synthetic.stub_memory(family, (4, 2), cfg,
                                                      seed=1, device=CPU))


def test_modality_families_need_their_memory():
    """A vlm or audio forward without its memory raises ValueError, as the
    reference asserts."""
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        _, cfg = configs(arch)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
        with pytest.raises(ValueError, match="memory"):
            tfm.forward(params, cfg, torch.zeros((1, 8), dtype=torch.int64))
