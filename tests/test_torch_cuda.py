"""The port's CUDA kernels and main path on an NVIDIA GPU.

Every test here needs the card (marker ``cuda``) and skips without one: a
CUDA kernel has no CPU mode.  The file imports nothing of JAX, so it also
runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax for the reference's tests.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import topology
from repro_torch.core.compression import QuantizePNorm, RandK, TopK
from repro_torch.core.convex import LinearRegression
from repro_torch.core.engines import engine_for
from repro_torch.core.simulator import LEADSim, run
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import lead_update as lu
from repro_torch.kernels import quantize as q
from repro_torch.kernels import sparsify as sp

LEAD_KERNELS = ("lead_diff_encode", "quantize_decode", "lead_update")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 7])
def test_kernels_equal_plain_versions(cuda_device, bits):
    """K1, K2 and K3 bit-identical to their plain versions on the card
    (built -fmad=false, IEEE divide), a zero row included; each wrapper
    counts one launch per call."""
    rng = np.random.default_rng(bits)
    planes = [torch.from_numpy(rng.standard_normal((4096, 512))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(7)]
    for p in planes[:4]:
        p[3] = 0.0
    x, g, d, h, hw, qh, wqh = planes
    u = torch.rand(4096, 512, device=cuda_device)
    eta = torch.full((), 0.07, device=cuda_device)
    before = cuda_lib.launch_counts()
    c1, s1 = lu.lead_diff_encode(x, g, d, h, u, eta, bits=bits)
    c2, s2 = lu.lead_diff_encode_plain(x, g, d, h, u, eta, bits)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    assert float(s1[3]) == 0.0 and int(c1[3].abs().sum()) == 0
    assert torch.equal(q.decode(c1, s1, bits=bits),
                       q.decode_plain(c1, s1, bits))
    hyp = [torch.full((), v, device=cuda_device) for v in (0.1, 1.0, 0.5)]
    for a, b in zip(lu.lead_update(*planes, *hyp),
                    lu.lead_update_plain(*planes, *hyp)):
        assert torch.equal(a, b)
    after = cuda_lib.launch_counts()
    assert all(after[k] == before[k] + 1 for k in LEAD_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 7])
def test_wire_kernels_equal_plain_versions(cuda_device, bits):
    """K4 (codes and scales), K5 (rescale on and off, knife-edge dithers)
    and K6 bit-identical to their plain versions on the card, a zero row
    and a row count that is no tile multiple included; K4 gives K1's codes
    for the same values (h = the values, x = g = d = 0)."""
    rng = np.random.default_rng(10 + bits)
    rows = 4099
    x = torch.from_numpy(rng.standard_normal((rows, 512))
                         .astype(np.float32)).to(cuda_device)
    x[3] = 0.0
    u = torch.rand(rows, 512, device=cuda_device)
    before = cuda_lib.launch_counts()
    c1, s1 = q.encode(x, u, bits=bits)
    c2, s2 = q.encode_plain(x, u, bits)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    assert float(s1[3]) == 0.0 and int(c1[3].abs().sum()) == 0
    zero = torch.zeros_like(x)
    ck, sk = lu.lead_diff_encode(zero, zero, zero, -x, u, 0.1, bits=bits)
    assert torch.equal(ck, c1) and torch.equal(sk, s1)
    for ratio in (0.1, 0.7):
        r = np.float32(ratio)
        u.view(-1)[:3] = torch.tensor(
            [np.nextafter(r, np.float32(0)), r, np.nextafter(r, np.float32(1))],
            device=cuda_device)
        for rescale in (True, False):
            got = sp.randk_encode(x, u, ratio=ratio, rescale=rescale)
            want = sp.randk_encode_plain(x, u, ratio,
                                         (1.0 / ratio) if rescale else 1.0)
            assert torch.equal(got, want)
    mask = (u < 0.3).to(torch.float32)
    assert torch.equal(sp.mask_apply(x, mask), sp.mask_apply_plain(x, mask))
    after = cuda_lib.launch_counts()
    assert after["quantize_encode"] == before["quantize_encode"] + 1
    assert after["randk_encode"] == before["randk_encode"] + 4
    assert after["mask_apply"] == before["mask_apply"] + 1


# K6's TMA pipeline (csrc/stream_tiles.cuh) at its edges: one row, a few,
# a row count that is no tile multiple, a plane of less than one 16 KB tile,
# a partial last tile, and the real size (16,384 runs of four tiles)
MASK_SHAPES = [(1, 512), (3, 512), (129, 512), (3, 20), (4097, 512),
               (524288, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MASK_SHAPES, ids=str)
def test_mask_apply_pipeline_edges(cuda_device, shape):
    """K6 bit-identical to its plain version at every edge of its tiling,
    zero padding staying zero; the output's memory is poisoned with NaN
    first, so a tile the kernel missed shows.  One launch per call."""
    rows, cols = shape
    pad = cols - cols // 4                      # zero columns from here on
    gen = torch.Generator(cuda_device).manual_seed(rows * 1000 + cols)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    x[:, pad:] = 0.0
    mask = (torch.rand(shape, generator=gen, device=cuda_device) < 0.3
            ).to(torch.float32)
    mask[:, pad:] = 1.0
    poison = torch.full_like(x, float("nan"))   # freed: the output's block
    del poison
    before = cuda_lib.launch_counts()
    got = sp.mask_apply(x, mask)
    assert cuda_lib.launch_counts() == {**before,
                                        "mask_apply": before["mask_apply"] + 1}
    want = sp.mask_apply_plain(x, mask)
    assert torch.equal(got, want)
    assert not bool(got[:, pad:].any())


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(8, 512, device=cuda_device)
    with pytest.raises(ValueError):                 # not contiguous
        lu.lead_update(*([x.t().contiguous().t()] * 7), 0.1, 1.0, 0.5)
    with pytest.raises(TypeError):                  # wrong dtype
        lu.lead_diff_encode(x.double(), x, x, x, x, 0.1)
    with pytest.raises(ValueError):                 # not one 512 block a row
        lu.lead_diff_encode(*([torch.zeros(8, 256, device=cuda_device)] * 5),
                            0.1)
    with pytest.raises(ValueError):                 # scalar on another device
        lu.lead_update(*([x] * 7), torch.tensor(0.1), 1.0, 0.5)
    with pytest.raises(ValueError):                 # not one 512 block a row
        q.encode(*([torch.zeros(8, 256, device=cuda_device)] * 2))
    with pytest.raises(TypeError):                  # wrong dtype
        sp.mask_apply(x, x.to(torch.int32))
    with pytest.raises(ValueError):                 # mismatched shapes
        sp.randk_encode(x, x[:4], ratio=0.5)


@pytest.mark.cuda
def test_main_path_runs_through_the_kernels(cuda_device):
    """2-bit LEAD through run() launches each kernel once per step and
    converges; uncompressed LEAD on the card matches the CPU run within
    1e-5 of each trace's scale."""
    prob = LinearRegression.generate(torch.Generator(cuda_device).manual_seed(0),
                                     n_agents=8, m=64, d=64,
                                     device=cuda_device)
    mu, L = prob.mu_L
    lead = LEADSim(topology=topology.ring(8), compressor=QuantizePNorm(bits=2),
                   eta=1.0 / L)
    cuda_lib.reset_launch_counts()
    tr = run(lead, prob, prob.x_star, iters=50)
    assert cuda_lib.launch_counts() == {k: 50 if k in LEAD_KERNELS else 0
                                        for k in cuda_lib.LAUNCHES}
    assert np.isfinite(tr.dist).all() and tr.dist[-1] < 1e-2 * tr.dist[0]

    cpu = LinearRegression.from_arrays(prob.A, prob.b, prob.lam, device="cpu")
    exact = LEADSim(topology=topology.ring(8), eta=1.0 / L)
    on_card = run(exact, prob, prob.x_star, iters=100)
    on_cpu = run(exact, cpu, prob.x_star.cpu(), iters=100)
    for a, b in zip(on_card[:3], on_cpu[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(b)))


@pytest.mark.cuda
def test_choco_runs_through_the_wire_kernels(cuda_device):
    """CHOCO through run() launches its wire's kernels once per step - K4
    and K2 for the p=inf quantizer, K5 for RandK, K6 for TopK - and nothing
    else; the quantized run falls toward the optimum."""
    prob = LinearRegression.generate(torch.Generator(cuda_device).manual_seed(0),
                                     n_agents=8, m=64, d=64,
                                     device=cuda_device)
    mu, L = prob.mu_L
    wires = {QuantizePNorm(bits=2): {"quantize_encode", "quantize_decode"},
             RandK(ratio=0.5): {"randk_encode"},
             TopK(ratio=0.5): {"mask_apply"}}
    for comp, kernels in wires.items():
        eng = engine_for(topology.ring(8), comp, prob.d, algorithm="choco",
                         eta=0.5 / L, gamma=0.2, device=cuda_device)
        cuda_lib.reset_launch_counts()
        tr = run(eng, prob, prob.x_star, iters=20)
        assert cuda_lib.launch_counts() == {
            k: 20 if k in kernels else 0 for k in cuda_lib.LAUNCHES}, comp
        assert np.isfinite(tr.dist).all() and tr.dist[-1] < tr.dist[0], comp
