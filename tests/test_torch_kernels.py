"""Parity of the PyTorch port's kernel layer (src/repro_torch/kernels) with
the JAX reference (src/repro/kernels).

On CPU tensors every port wrapper runs its plain PyTorch version.  Those are
held against the reference's eager ref.py oracles (identical codes and
scales, exact decode), against the Pallas kernels in interpret mode (the
kernel bodies, run as tests/test_kernels.py runs them), and against the
reference's blocking helpers.  Inputs are made with numpy from a seed and
fed to both packages.  tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engines.base import fast_uniform as jax_fast_uniform
from repro.kernels import lead_update as jax_lu
from repro.kernels import ops as jax_ops
from repro.kernels import quantize as jax_q
from repro.kernels import ref as jax_ref
from repro_torch.core.engines.base import fast_uniform
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels import lead_update as lu
from repro_torch.kernels import quantize as q
from repro_torch.kernels import ref

ROWS = 2048                 # eager-oracle comparisons
INTERP_ROWS = 512           # interpret-mode comparisons (2 tiles of 256)
BITS = [1, 2, 4, 7]
HYPERS = [(0.1, 1.0, 0.5), (0.01, 0.3, 0.9)]
# K3 against the jitted or interpreted reference, whose graph may contract
# a multiply-add: within 2 ulp of the value (f32 eps = 1.19e-7), or 1e-6
K3_RTOL, K3_ATOL = 2.4e-7, 1e-6


def _planes(seed, rows, count, zero_rows=(3,)):
    """`count` f32 (rows, 512) normal planes with some all-zero rows, and a
    U[0, 1) dither plane."""
    rng = np.random.default_rng(seed)
    planes = [rng.standard_normal((rows, 512)).astype(np.float32)
              for _ in range(count)]
    for p in planes:
        p[list(zero_rows)] = 0.0
    u = rng.random((rows, 512), dtype=np.float32)
    return planes, u


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# -- plain versions against the eager reference oracles ----------------------

@pytest.mark.parametrize("bits", BITS)
def test_diff_encode_equals_eager_oracle(bits):
    """K1: codes and scales identical to ref.lead_diff_encode_ref, eager."""
    (x, g, d, h), u = _planes(bits, ROWS, 4)
    eta = np.float32(0.07)
    with jax.disable_jit():
        jc, js = jax_ref.lead_diff_encode_ref(*_j(x, g, d, h, u),
                                              jnp.asarray(eta), bits)
    tc, ts = lu.lead_diff_encode(*_t(x, g, d, h, u), torch.tensor(eta),
                                 bits=bits)
    assert tc.dtype == torch.int8 and ts.shape == (ROWS, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [2, 4, 7])
def test_quantize_encode_equals_eager_oracle(bits):
    (x,), u = _planes(10 + bits, ROWS, 1)
    with jax.disable_jit():
        jc, js = jax_ref.quantize_encode_ref(*_j(x, u), bits)
    tc, ts = ref.quantize_encode_ref(*_t(x, u), bits)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", BITS)
def test_decode_is_exact(bits):
    """K2: the decode of the same codes and scales is exactly the
    reference's."""
    (x, g, d, h), u = _planes(20 + bits, ROWS, 4)
    code, scale = lu.lead_diff_encode(*_t(x, g, d, h, u), 0.3, bits=bits)
    with jax.disable_jit():
        want = jax_ref.quantize_decode_ref(*_j(code.numpy(), scale.numpy()),
                                           bits)
    got = q.decode(code, scale, bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hyper", HYPERS)
def test_lead_update_matches_eager_oracle(hyper):
    """K3 within atol 1e-6 of ref.lead_update_ref (the reference's own kernel
    tolerance is 1e-4)."""
    planes, _ = _planes(30, ROWS, 7)
    eta, gamma, alpha = (np.float32(v) for v in hyper)
    with jax.disable_jit():
        want = jax_ref.lead_update_ref(*_j(*planes), jnp.asarray(eta),
                                       jnp.asarray(gamma), jnp.asarray(alpha))
    got = lu.lead_update(*_t(*planes), *(torch.tensor(v) for v in
                                         (eta, gamma, alpha)))
    for a, b, name in zip(got, want, ("x", "d", "h", "hw")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=name)


# -- plain versions against the Pallas kernel bodies (interpret mode) --------

@pytest.mark.parametrize("bits", [2, 7])
def test_diff_encode_matches_pallas_interpret(bits):
    """Codes identical to the interpreted kernel; scales within 1 ulp (the
    interpreter's graph is not bit-stable against the eager oracle)."""
    (x, g, d, h), u = _planes(40 + bits, INTERP_ROWS, 4)
    eta = np.float32(0.07)
    jc, js = jax_lu.lead_diff_encode(*_j(x, g, d, h, u), eta, bits=bits,
                                     interpret=True)
    tc, ts = lu.lead_diff_encode(*_t(x, g, d, h, u), float(eta), bits=bits)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


@pytest.mark.parametrize("bits", [2, 7])
def test_decode_matches_pallas_interpret(bits):
    (x, g, d, h), u = _planes(50 + bits, INTERP_ROWS, 4)
    code, scale = lu.lead_diff_encode(*_t(x, g, d, h, u), 0.2, bits=bits)
    want = jax_q.decode(*_j(code.numpy(), scale.numpy()), bits=bits,
                        interpret=True)
    np.testing.assert_array_equal(q.decode(code, scale, bits=bits).numpy(),
                                  np.asarray(want))


def test_lead_update_matches_pallas_interpret():
    planes, _ = _planes(60, INTERP_ROWS, 7)
    eta, gamma, alpha = HYPERS[1]
    want = jax_lu.lead_update(*_j(*planes), eta, gamma, alpha, interpret=True)
    got = lu.lead_update(*_t(*planes), eta, gamma, alpha)
    for a, b, name in zip(got, want, ("x", "d", "h", "hw")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=K3_RTOL,
                                   atol=K3_ATOL, err_msg=name)


# -- fixed points, layout, dither --------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_zero_rows_are_a_fixed_point(bits):
    """An all-zero row encodes to scale 0 and codes 0, decodes to zeros, and
    stays zero through the state update - so tile padding never leaks."""
    (x, g, d, h), u = _planes(70, 16, 4, zero_rows=(0, 5, 15))
    code, scale = lu.lead_diff_encode(*_t(x, g, d, h, u), 0.1, bits=bits)
    for r in (0, 5, 15):
        assert float(scale[r, 0]) == 0.0
        assert int(code[r].abs().sum()) == 0
    dec = q.decode(code, scale, bits=bits)
    assert float(dec[[0, 5, 15]].abs().sum()) == 0.0
    zeros = torch.zeros(4, 512)
    for out in lu.lead_update(*([zeros] * 7), 0.1, 1.0, 0.5):
        assert float(out.abs().sum()) == 0.0


@pytest.mark.parametrize("n", [1, 511, 512, 1000, 70_000])
def test_blocking_helpers_match_reference(n):
    """_to_blocks/_from_blocks/_pick_tile pad and unpad exactly as
    kernels/ops.py does."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for tile in (1, 8, 256):
        assert ops._pick_tile(n, 512, tile) == jax_ops._pick_tile(n, 512, tile)
    tile = ops._pick_tile(n, 512, 256)
    tb, tn = ops._to_blocks(torch.from_numpy(x), 512, tile)
    jb, jn = jax_ops._to_blocks(jnp.asarray(x), 512, tile)
    assert tn == jn and tuple(tb.shape) == jb.shape
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    back = ops._from_blocks(tb, n, (n,), torch.float32)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", [1000, 7777])
def test_flat_wrappers_match_reference(n):
    """lead_update_flat / quantize_decode / lead_diff_encode_flat on flat
    vectors of any length, against kernels/ops.py (jitted, jnp backend)."""
    rng = np.random.default_rng(n)
    arrs = [rng.standard_normal(n).astype(np.float32) for _ in range(7)]
    eta, gamma, alpha = HYPERS[0]
    want = jax_ops.lead_update_flat(*_j(*arrs), eta, gamma, alpha)
    got = ops.lead_update_flat(*_t(*arrs), eta, gamma, alpha)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (n,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=K3_RTOL,
                                   atol=K3_ATOL)

    key = jax.random.PRNGKey(n)
    tile = jax_ops._pick_tile(n, 512, 256)
    xb, _ = jax_ops._to_blocks(jnp.asarray(arrs[0]), 512, tile)
    u = np.asarray(jax.random.uniform(key, xb.shape, jnp.float32))
    jc, js = jax_ops.lead_diff_encode_flat(key, *_j(*arrs[:4]), 0.07, bits=2)
    tc, ts = ops.lead_diff_encode_flat(*_t(*arrs[:4]), 0.07, u=_t(u)[0],
                                       bits=2)
    # the jitted reference may round the difference differently by an ulp:
    # a code may flip at a level boundary, never more than one level
    code_diff = np.abs(tc.numpy().astype(int) - np.asarray(jc).astype(int))
    assert code_diff.max() <= 1 and code_diff.mean() < 1e-3
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)

    dec = ops.quantize_decode(tc, ts, shape=(n,), bits=2)
    jdec = jax_ops.quantize_decode(*_j(tc.numpy(), ts.numpy()), shape=(n,),
                                   bits=2)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))

    gen = torch.Generator().manual_seed(0)
    c2, s2 = ops.lead_diff_encode_flat(*_t(*arrs[:4]), 0.07, generator=gen)
    assert c2.shape == tc.shape and s2.shape == ts.shape
    with pytest.raises(ValueError):
        ops.lead_diff_encode_flat(*_t(*arrs[:4]), 0.07)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 - 1])
def test_fast_uniform_is_the_reference_stream(seed):
    """The counter-hash dither, bit for bit (int64 masked to 32 bits)."""
    shape = (3, 5, 512)
    want = jax_fast_uniform(shape, jnp.asarray(seed, jnp.uint32))
    got = fast_uniform(shape, seed, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_t = fast_uniform(shape, torch.tensor(seed, dtype=torch.int64))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


# -- build -------------------------------------------------------------------

def test_kernel_build_covers_every_source():
    """Every file in csrc/ is compiled (SOURCE) or hashed into the build tag
    as a header (HEADERS): a header left out would keep a stale library in
    use after it changed."""
    assert sorted(p.name for p in cuda_lib.CSRC.iterdir()) == sorted(
        p.name for p in cuda_lib.SOURCE + cuda_lib.HEADERS)
    assert all(p.suffix == ".cu" for p in cuda_lib.SOURCE)
    assert all(p.suffix == ".cuh" for p in cuda_lib.HEADERS)


# -- dispatch ------------------------------------------------------------------

def test_dispatch_by_device_never_falls_back():
    """CPU tensors take the plain version; any device that is neither CPU
    nor CUDA, and mixed devices, raise instead of falling back."""
    (x, g, d, h), u = _planes(80, 8, 4)
    xt, gt, dt, ht, ut = _t(x, g, d, h, u)
    before = cuda_lib.launch_counts()
    lu.lead_diff_encode(xt, gt, dt, ht, ut, 0.1)
    assert cuda_lib.launch_counts() == before     # plain: no kernel launch
    meta = torch.empty(8, 512, device="meta")
    with pytest.raises(ValueError):
        lu.lead_diff_encode(meta, meta, meta, meta, meta, 0.1)
    with pytest.raises(ValueError):
        lu.lead_update(xt, gt, dt, ht, xt, gt, meta, 0.1, 1.0, 0.5)
    with pytest.raises(ValueError):
        q.decode(torch.zeros(8, 512, dtype=torch.int8, device="meta"),
                 torch.zeros(8, 1))
    with pytest.raises(ValueError):
        lu.lead_diff_encode(xt, gt, dt, ht, ut, 0.1, bits=8)
