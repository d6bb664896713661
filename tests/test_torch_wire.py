"""Parity of the port's compressed wires with the JAX reference, on the CPU:
the quantizer's encode (K4), RandK's keep pass (K5), TopK's mask pass (K6),
the code bit packing, and every compressor's ``encode_blocks``.

CPU tensors take each kernel's plain PyTorch version.  Inputs are made with
numpy from a seed and fed to both packages; where the reference draws its
random input from a threefry key, the test rebuilds the draw from the same
key with the same split and hands it to the port, which takes its random
input explicitly.  tests/test_torch_cuda.py holds the CUDA kernels against
the plain versions on a card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jax_comp
from repro.kernels import ops as jax_ops
from repro.kernels import quantize as jax_q
from repro.kernels import ref as jax_ref
from repro.kernels import sparsify as jax_sp
from repro_torch.core import compression as comp
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels import quantize as q
from repro_torch.kernels import sparsify as sp

ROWS = 1024                 # eager-oracle comparisons
INTERP_ROWS = 512           # interpret-mode comparisons (2 tiles of 256)
N, DIM = 8, 1300            # encode_blocks: 3 logical blocks, the last ragged
# ratios whose f32 rounding lies above (0.1, 0.25) and below (0.7, 0.01)
# the double: the keep test must compare in f32, as the reference does
RATIOS = [0.1, 0.25, 0.7, 0.01]


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


def _x_u(seed, rows, zero_rows=(3,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x, rng.random((rows, 512), dtype=np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _knife_edge_u(u, ratio):
    """u with some entries set exactly to f32(ratio) and its neighbours, where
    a compare in another precision would decide differently."""
    r = np.float32(ratio)
    u = u.copy().reshape(-1)
    u[:3] = [np.nextafter(r, np.float32(0)), r, np.nextafter(r, np.float32(1))]
    return u.reshape(-1, 512)


# -- K4 quantize encode ------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 7])
def test_encode_equals_eager_oracle(bits):
    """K4's plain version: codes and scales identical to the eager
    ref.quantize_encode_ref; the zero row encodes to codes 0, scale 0."""
    x, u = _x_u(bits, ROWS)
    with jax.disable_jit():
        jc, js = jax_ref.quantize_encode_ref(*_j(x, u), bits)
    tc, ts = q.encode(*_t(x, u), bits=bits)
    assert tc.dtype == torch.int8 and tuple(ts.shape) == (ROWS, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3, 0]) == 0.0 and not bool(tc[3].any())
    with pytest.raises(ValueError):
        q.encode(*_t(x, u), bits=8)


@pytest.mark.parametrize("bits", [2, 7])
def test_encode_matches_pallas_interpret(bits):
    """Against the interpreted Pallas kernel (a jitted path): scales within
    1 ulp and codes within one level on at most 1e-3 of the elements (the
    jitted reference is not bit-stable against its eager oracle)."""
    x, u = _x_u(20 + bits, INTERP_ROWS)
    jc, js = jax_q.encode(*_j(x, u), bits=bits, interpret=True)
    tc, ts = q.encode(*_t(x, u), bits=bits)
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    diff = np.abs(tc.numpy().astype(int) - np.asarray(jc).astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("n", [1000, 7777])
def test_quantize_encode_flat_matches_reference(n):
    """ops.quantize_encode on a flat vector of any length, with the
    reference's own dither, against kernels/ops.py (jitted): same blocking
    and padding, scales within 1 ulp, codes within one level."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    key = jax.random.PRNGKey(n)
    tile = jax_ops._pick_tile(n, 512, 256)
    xb, _ = jax_ops._to_blocks(jnp.asarray(x), 512, tile)
    u = np.asarray(jax.random.uniform(key, xb.shape, jnp.float32))
    jc, js = jax_ops.quantize_encode(key, jnp.asarray(x), bits=2)
    tc, ts = ops.quantize_encode(*_t(x), u=_t(u)[0], bits=2)
    assert tuple(tc.shape) == jc.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    diff = np.abs(tc.numpy().astype(int) - np.asarray(jc).astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3
    gen = torch.Generator().manual_seed(0)
    c2, _ = ops.quantize_encode(torch.from_numpy(x), generator=gen)
    assert c2.shape == tc.shape
    with pytest.raises(ValueError):
        ops.quantize_encode(torch.from_numpy(x))


# -- K5 randk encode, K6 mask apply -------------------------------------------

@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("rescale", [True, False])
def test_randk_encode_is_exact(ratio, rescale):
    """K5's plain version equals the eager oracle and the interpreted
    kernel bit for bit, knife-edge dithers included."""
    x, u = _x_u(int(ratio * 1000), INTERP_ROWS)
    u = _knife_edge_u(u, ratio)
    scale = (1.0 / ratio) if rescale else 1.0
    with jax.disable_jit():
        eager = jax_ref.randk_encode_ref(*_j(x, u), ratio, scale)
    interp = jax_sp.randk_encode(*_j(x, u), ratio=ratio, rescale=rescale,
                                 interpret=True)
    got = sp.randk_encode(*_t(x, u), ratio=ratio, rescale=rescale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    np.testing.assert_array_equal(got.numpy(), np.asarray(interp))
    kept = u.reshape(-1)[:3] < np.float32(ratio)
    assert list(kept) == [True, False, False]


def test_mask_apply_is_exact():
    x, u = _x_u(5, INTERP_ROWS)
    mask = (u < 0.3).astype(np.float32)
    with jax.disable_jit():
        eager = jax_ref.mask_apply_ref(*_j(x, mask))
    interp = jax_sp.mask_apply(*_j(x, mask), interpret=True)
    got = sp.mask_apply(*_t(x, mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    np.testing.assert_array_equal(got.numpy(), np.asarray(interp))


@pytest.mark.parametrize("nb", [1, 6, 256, 384, 1000])
def test_fit_tile_matches_reference(nb):
    for tile in (1, 8, 256):
        assert sp._fit_tile(nb, tile) == jax_sp._fit_tile(nb, tile)


def test_wire_kernels_dispatch_by_device():
    """CPU tensors run the plain versions (no launch counted); other
    devices raise instead of falling back."""
    x, u = _x_u(6, 8)
    before = cuda_lib.launch_counts()
    q.encode(*_t(x, u))
    sp.randk_encode(*_t(x, u), ratio=0.5)
    sp.mask_apply(*_t(x, u))
    assert cuda_lib.launch_counts() == before
    meta = torch.empty(8, 512, device="meta")
    for call in (lambda: q.encode(meta, meta),
                 lambda: sp.randk_encode(meta, meta, ratio=0.5),
                 lambda: sp.mask_apply(meta, meta)):
        with pytest.raises(ValueError):
            call()


# -- the library yardsticks that chip_smoke.py times beside K2 and K6 --------

@pytest.mark.parametrize("case", ["decode_b2", "decode_b4", "decode_b7",
                                  "mask_apply"])
def test_library_yardstick_computes_the_kernel_function(case):
    """Each one-call PyTorch yardstick gives its kernel's plain version bit
    for bit: torch.mul(code, scale * 2**(1-b)) is K2's decode (int8 codes
    times an f32 (rows, 1) column; the column's product is exact) and equals
    the reference's eager decode; torch.mul(x, mask) is K6."""
    x, u = _x_u(40 + len(case), ROWS)
    if case == "mask_apply":
        mask = (u < 0.01).astype(np.float32)
        xt, mt = _t(x, mask)
        assert torch.equal(torch.mul(xt, mt), sp.mask_apply_plain(xt, mt))
        return
    bits = int(case[-1])
    code, scale = q.encode_plain(*_t(x, u), bits)
    got = torch.mul(code, scale * 2.0 ** (1 - bits))
    assert got.dtype == torch.float32
    assert torch.equal(got, q.decode_plain(code, scale, bits))
    with jax.disable_jit():
        want = jax_ref.quantize_decode_ref(*_j(code.numpy(), scale.numpy()),
                                           bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- code bit packing ----------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("n", [1, 10, 1000, 4097])
def test_pack_unpack_match_reference(bits, n):
    """pack_codes gives the reference's uint32 words bit for bit, and
    unpack_codes its codes back; the round trip is exact."""
    c = 2 ** (bits - 1)
    codes = np.random.default_rng(bits * n).integers(
        -c, c + 1, size=n).astype(np.int8)
    want = np.asarray(jax_ops.pack_codes(jnp.asarray(codes), bits))
    got = ops.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    back = ops.unpack_codes(got, n, bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_ops.unpack_codes(jnp.asarray(want), n,
                                                      bits)))
    np.testing.assert_array_equal(back.numpy(), codes)


# -- encode_blocks, with the reference's own draws -------------------------------

def _buf(seed, dim=DIM, n=N):
    """An (n, nb, block) f32 buffer zero-padded past dim (nb = 4, the
    engine's tile padding for dim = 1300), one agent all zero."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    rows[2] = 0.0
    buf = np.zeros((n, 4 * 512), np.float32)
    buf[:, :dim] = rows
    return buf.reshape(n, 4, 512)


def _agent_uniforms(key, shape):
    """The reference's per-agent draw inside encode_blocks: split the key
    into one per agent, then uniform(kk, shape) per agent."""
    keys = jax.random.split(key, N)
    return np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, shape, jnp.float32))(keys))


def _assert_payload_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("bits", [2, 4])
def test_quantizer_pinf_encode_blocks_equals_reference(bits):
    """p=inf encode_blocks (K4 here, the plain formula in the reference)
    and decode_blocks (K2), eagerly: payload, decode and bits equal."""
    buf, key = _buf(bits), jax.random.PRNGKey(bits)
    cj, ct = jax_comp.QuantizePNorm(bits=bits), comp.QuantizePNorm(bits=bits)
    with jax.disable_jit():
        pj, bj = cj.encode_blocks(key, jnp.asarray(buf), DIM)
        dj = cj.decode_blocks(pj)
    u = _agent_uniforms(key, (3, 512)).reshape(N, -1)[:, :DIM]
    pt, bt = ct.encode_blocks(torch.from_numpy(buf), DIM,
                              torch.from_numpy(u))
    _assert_payload_equal(pt, pj)
    assert float(bt) == float(bj) == cj.wire_bits(DIM)
    np.testing.assert_array_equal(ct.decode_blocks(pt).numpy(),
                                  np.asarray(dj))


def test_quantizer_p2_encode_blocks_matches_reference():
    """p=2 (plain torch, as the reference leaves it to XLA): the block
    2-norm sums 512 squares in another order than XLA, so scales agree to
    a few ulp and a code may flip one level at a knife edge; bits equal."""
    buf, key = _buf(7), jax.random.PRNGKey(7)
    cj, ct = (jax_comp.QuantizePNorm(bits=2, p=2.0),
              comp.QuantizePNorm(bits=2, p=2.0))
    with jax.disable_jit():
        pj, bj = cj.encode_blocks(key, jnp.asarray(buf), DIM)
    u = _agent_uniforms(key, (3, 512)).reshape(N, -1)[:, :DIM]
    pt, bt = ct.encode_blocks(torch.from_numpy(buf), DIM,
                              torch.from_numpy(u))
    np.testing.assert_array_max_ulp(pt["scale"].numpy(),
                                    np.asarray(pj["scale"]), maxulp=4)
    diff = np.abs(pt["code"].numpy().astype(int)
                  - np.asarray(pj["code"]).astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3
    assert float(bt) == float(bj)


@pytest.mark.parametrize("ratio", [0.1, 0.25, 0.7])
@pytest.mark.parametrize("rescale", [True, False])
def test_randk_encode_blocks_equals_reference(ratio, rescale):
    """RandK: the keep plane (K5), its 1.0 padding past dim and the
    data-dependent bits equal the reference's for its own draw."""
    buf, key = _buf(11), jax.random.PRNGKey(11)
    cj = jax_comp.RandK(ratio=ratio, rescale=rescale)
    ct = comp.RandK(ratio=ratio, rescale=rescale)
    with jax.disable_jit():
        pj, bj = cj.encode_blocks(key, jnp.asarray(buf), DIM)
    u = _agent_uniforms(key, (DIM,))
    pt, bt = ct.encode_blocks(torch.from_numpy(buf), DIM,
                              torch.from_numpy(u))
    _assert_payload_equal(pt, pj)
    assert float(bt) == float(bj)
    assert not bool(pt["values"].reshape(N, -1)[:, DIM:].any())
    assert ct.variance_constant() == cj.variance_constant()


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_exact_encode_blocks_equals_reference(ratio):
    """Exact TopK: exactly k kept per agent (K6 applies the mask), the
    values and the static bits equal the reference's."""
    buf = _buf(13)
    cj, ct = jax_comp.TopK(ratio=ratio), comp.TopK(ratio=ratio)
    with jax.disable_jit():
        pj, bj = cj.encode_blocks(jax.random.PRNGKey(0), jnp.asarray(buf),
                                  DIM)
    pt, bt = ct.encode_blocks(torch.from_numpy(buf), DIM)
    _assert_payload_equal(pt, pj)
    assert float(bt) == float(bj) == np.float32(cj.wire_bits(DIM))
    kept = (pt["values"].reshape(N, -1) != 0).sum(dim=1)
    k = max(1, int(DIM * ratio))
    assert all(int(c) == (0 if i == 2 else k) for i, c in enumerate(kept))
    with pytest.raises(ValueError):
        ct.encode_blocks(torch.from_numpy(buf), DIM,
                         idx=torch.zeros(N, 8, dtype=torch.int64))


@pytest.mark.parametrize("ratio", [0.05, 0.2])
def test_topk_approx_encode_blocks_equals_reference(ratio):
    """Approximate TopK: with the reference's own sample indices, the
    sampled-quantile mask, the values and the counted bits are equal."""
    buf, key = _buf(17), jax.random.PRNGKey(17)
    cj = jax_comp.TopK(ratio=ratio, approx_threshold=True)
    ct = comp.TopK(ratio=ratio, approx_threshold=True)
    m = ct.sample_size(DIM)
    assert m == min(8 * math.ceil(DIM / 512), DIM)
    with jax.disable_jit():
        pj, bj = cj.encode_blocks(key, jnp.asarray(buf), DIM)
    idx = np.array(jax.random.randint(key, (N, m), 0, DIM))
    pt, bt = ct.encode_blocks(torch.from_numpy(buf), DIM,
                              idx=torch.from_numpy(idx).to(torch.int64))
    _assert_payload_equal(pt, pj)
    assert float(bt) == float(bj)
    with pytest.raises(ValueError):
        ct.encode_blocks(torch.from_numpy(buf), DIM)
    u = torch.tensor([[0.0, 0.5, 1.0 - 2 ** -24]])
    assert comp.TopK.indices_from_uniform(u, DIM).tolist() == \
        [[0, DIM // 2, DIM - 1]]


def test_identity_encode_blocks_and_accounting():
    buf = _buf(19)
    pj, bj = jax_comp.Identity().encode_blocks(None, jnp.asarray(buf), DIM)
    pt, bt = comp.Identity().encode_blocks(torch.from_numpy(buf), DIM)
    _assert_payload_equal(pt, pj)
    assert float(bt) == float(bj)
    np.testing.assert_array_equal(
        comp.Identity().decode_blocks(pt).numpy(), buf)
    for cj, ct in ((jax_comp.TopK(0.1), comp.TopK(0.1)),
                   (jax_comp.RandK(0.1), comp.RandK(0.1)),
                   (jax_comp.QuantizePNorm(3, 2.0), comp.QuantizePNorm(3, 2.0)),
                   (jax_comp.Identity(), comp.Identity())):
        assert repr(ct) == repr(cj)
        for d in (1, 512, 1300, 2 ** 20):
            assert ct.wire_bits(d) == cj.wire_bits(d)
