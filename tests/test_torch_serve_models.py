"""The port's contiguous serving path (models/transformer.py: init_cache,
prefill, decode_step; the decode forms of attention.py and recurrent.py)
against the JAX reference on the CPU, for every registry family at a narrow
reduced size (prefill_chunk and the paged cache: test_torch_paged_cache.py).

Weights are numpy (the port's init from a seed, perturbed), taken by the
reference as they are and by the port through ``params_from_numpy``; the
reference's caches are carried over with ``cache_from_numpy``, so that
every decode step of both packages starts from the same cache.  Logits agree within 1e-5 of
the largest |logit| with an f32 cache and 1e-3 with a bf16 one (a cache
leaf within one rounding of its dtype at its scale).  The vlm and audio
memories are numpy draws fed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as jax_tfm
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import tree_map

CPU = "cpu"
RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# a cache leaf: one rounding of its dtype at the leaf's scale (a bf16 k
# whose f32 value differs in the last bit can round to the next bf16)
LEAF_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
B, S, CACHE_LEN, STEPS = 2, 20, 32, 3
# narrow reduced sizes, two layers whose pattern reaches every block type of
# the family (xLSTM's mLSTM and sLSTM, recurrentgemma's RG-LRU and local
# attention, gemma3's local and global attention)
PATTERN = {"xlstm-1.3b": ("mlstm", "slstm"),
           "recurrentgemma-2b": ("rglru", "local"),
           "gemma3-12b": ("local", "global")}
RING = "gemma3-ring"            # gemma3 with a 16-token window: the ring
                                # wraps inside the 20-token prompt
ARCHS = sorted(list_archs()) + [RING]
BF16 = ["granite-3-2b", "llama-3.2-vision-11b", "whisper-tiny", RING]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(name):
    """(reference config, port config) of a test arch, narrow."""
    arch = "gemma3-12b" if name == RING else name
    j = jax_get_config(arch).reduced(d_model=64, vocab=128)
    t = get_config(arch).reduced(d_model=64, vocab=128)
    kw = {}
    if arch in PATTERN:
        kw["block_pattern"] = PATTERN[arch]
    if name == RING:
        kw["window"] = 16
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def carried(tcfg, seed=0):
    """Weights for both packages, as numpy: the port's init_params (the
    reference's keys, leaf shapes and scales) from a seeded generator, with
    norm gains, QKV biases and cross-attention gates perturbed so that their
    paths carry real values.  The reference takes the numpy tree as it is;
    the port takes it through params_from_numpy."""
    rng = np.random.default_rng(seed)
    tree = tree_map(lambda x: x.numpy(), tfm.init_params(
        tcfg, torch.Generator().manual_seed(seed), CPU))

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'bq'", "'bk'", "'bv'", "ln", "gate'")):
            return (leaf + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, tree)


def memory_of(cfg, seed=2):
    M = cfg.vis_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    if cfg.family not in ("vlm", "audio"):
        return None
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, M, cfg.d_model))).astype(np.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def gap(port, ref):
    """max |port - ref| over max |ref|."""
    ref = np.asarray(ref, np.float64)
    port = port.detach().double().numpy()
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)),
                                                  1e-30))


def assert_cache_close(tc, jc, rtol):
    """Every leaf of the port's contiguous cache within rtol of the
    reference's, layer by layer."""
    for i, (a, b) in enumerate(zip(tc["layers"], jc["layers"])):
        pairs = ([(a.k, b.k), (a.v, b.v)] if hasattr(b, "rolling")
                 else list(zip(a, b)))
        for x, y in pairs:
            y = np.asarray(y, np.float32)
            if np.all(y == 0):
                assert torch.all(x == 0), f"layer {i}"
            else:
                assert gap(x.float(), y) <= rtol, f"layer {i}"
    assert int(tc["pos"]) == int(jc["pos"])


@pytest.mark.parametrize("name,dtype",
                         [(a, "float32") for a in ARCHS]
                         + [(a, "bfloat16") for a in BF16])
def test_prefill_and_decode_match_reference(name, dtype):
    """prefill's logits and cache, then STEPS decode steps from the
    reference's cache carried over, on the contiguous path."""
    jcfg, tcfg = configs(name)
    jp = carried(tcfg)
    tp = params_from_numpy(jp, device=CPU)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    mem = memory_of(jcfg)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rtol = RTOL[dtype]
    prefill = jax.jit(lambda p, tk, m: jax_tfm.prefill(
        p, jcfg, tk, memory=m, cache_len=CACHE_LEN, cache_dtype=jdt))
    jlg, jc = prefill(jp, jnp.asarray(toks, jnp.int32),
                      None if mem is None else jnp.asarray(mem))
    with torch.no_grad():
        tlg, tc = tfm.prefill(tp, tcfg, t(toks), memory=t(mem),
                              cache_len=CACHE_LEN, cache_dtype=tdt)
    assert tlg.shape == jlg.shape
    assert gap(tlg, jlg) <= rtol
    jc = to_np(jc)
    assert_cache_close(tc, jc, LEAF_RTOL[dtype])
    for key in ("cross_mem", "enc_mem"):
        assert (key in tc) == (key in jc)
    step = jax.jit(lambda p, tk, c: jax_tfm.decode_step(p, jcfg, tk, c))
    tok = np.argmax(np.asarray(jlg)[:, -1], -1)[:, None]
    for i in range(STEPS):
        tc = cache_from_numpy(jc, device=CPU)
        jlg, jc = step(jp, jnp.asarray(tok, jnp.int32), jc)
        with torch.no_grad():
            tlg, tc = tfm.decode_step(tp, tcfg, t(tok), tc)
        assert gap(tlg, jlg) <= rtol, f"decode step {i}"
        jc = to_np(jc)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1)[:, None]
