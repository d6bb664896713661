"""The port's KV-page codec (serve/kv_quant.py) against the JAX reference
on the CPU: the codes and scales of encode_rows exactly equal to the
reference's eager oracle (kernels/ref.py, u = 0.5) and to the reference's
encode_rows on the same arrays; decode_rows exactly, cast to the cache's
dtype; pick_block and the bits/elem meter exactly, and the meter equal to
the wire's QuantizePNorm.wire_bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.serve import kv_quant as jax_kvq
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.compression import QuantizePNorm
from repro_torch.serve import kv_quant as kvq

# the page shapes serving meets: granite-3-2b's hot path (16 x 8 x 64 =
# 8,192 elements, block 512) and reduced configs' (other blocks: the
# strided routine on the card)
PAGE_SHAPES = [(16, 8, 64), (16, 1, 64), (16, 2, 48), (4, 1, 24)]


def _pages(shape, n=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    x[1] = 0.0                                      # an all-zero page
    x[2, 0] *= 1e4                                  # one loud position
    return x


def test_pick_block_matches_reference():
    elems = {16 * c.kv_heads * c.head_dim
             for c in (get_config(a).reduced() for a in list_archs())}
    elems |= {16 * c.kv_heads * c.head_dim
              for c in (get_config(a) for a in list_archs())}
    elems |= {96, 4096, 8192, 30720, 7, 1}
    for e in sorted(elems):
        assert kvq.pick_block(e) == jax_kvq.pick_block(e), e
    assert kvq.pick_block(8192) == 512 and kvq.pick_block(30720) == 512


@pytest.mark.parametrize("bits", range(1, 8))
def test_meter_matches_reference_and_wire(bits):
    for block in (1, 24, 96, 512):
        mine, ref = kvq.KVQuantSpec(bits, block), jax_kvq.KVQuantSpec(bits,
                                                                      block)
        assert mine.bits_per_elem == ref.bits_per_elem
        assert mine.page_bits(4096 // block * block) \
            == ref.page_bits(4096 // block * block)
    q = QuantizePNorm(bits=bits, block=512)
    assert kvq.KVQuantSpec(bits, 512).page_bits(8192) == q.wire_bits(8192)
    assert kvq.KVQuantSpec(4, 512).bits_per_elem == 5.0625
    for bad in (0, 8):
        with pytest.raises(ValueError):
            kvq.KVQuantSpec(bad, 512)


@pytest.mark.parametrize("bits", [2, 4, 7])
@pytest.mark.parametrize("shape", PAGE_SHAPES)
def test_codec_matches_reference_exactly(shape, bits):
    """encode_rows' codes and scales equal the eager oracle's with u = 0.5
    on the same (rows, block) plane, and the reference's encode_rows;
    decode_rows gives the reference's values, cast to bf16 as it casts
    them."""
    x = _pages(shape, seed=bits)
    block = kvq.pick_block(int(np.prod(shape)))
    spec = kvq.KVQuantSpec(bits, block)
    code, scale = kvq.encode_rows(torch.tensor(x), spec)
    plane = x.reshape(-1, block)
    oc, os_ = jax_ref.quantize_encode_ref(plane, np.full_like(plane, 0.5),
                                          bits)
    assert np.array_equal(code.reshape(-1, block).numpy(), np.asarray(oc))
    assert np.array_equal(scale.reshape(-1, 1).numpy(), np.asarray(os_))
    rc, rs = jax_kvq.encode_rows(x, jax_kvq.KVQuantSpec(bits, block))
    assert np.array_equal(code.numpy(), np.asarray(rc))
    assert np.array_equal(scale.numpy(), np.asarray(rs))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        vals = kvq.decode_rows(code, scale, spec, shape, dtype)
        want = np.asarray(jax_kvq.decode_rows(
            rc, rs, jax_kvq.KVQuantSpec(bits, block), shape, jdt))
        assert vals.dtype == dtype and tuple(vals.shape) == (5, *shape)
        assert np.array_equal(vals.float().numpy(), want.astype(np.float32))


def test_half_plane_is_built_once_per_shape():
    """The dither plane of one shape is one tensor, reused by every call
    (no allocation per encode), and holds 0.5 everywhere."""
    spec = kvq.KVQuantSpec(4, 512)
    kvq._half_plane.cache_clear()
    for _ in range(3):
        kvq.encode_rows(torch.zeros((2, 16, 8, 64)), spec)
    info = kvq._half_plane.cache_info()
    assert info.misses == 1 and info.hits == 2
    plane = kvq._half_plane(32, 512, torch.device("cpu"))
    assert plane.shape == (32, 512) and torch.all(plane == 0.5)


def test_encode_rows_rejects_a_partial_block():
    with pytest.raises(ValueError, match="whole number"):
        kvq.encode_rows(torch.zeros((2, 3, 5)), kvq.KVQuantSpec(4, 4))
