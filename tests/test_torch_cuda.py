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
from repro_torch.core.baselines import CHOCO_SGD, DGD, NIDS
from repro_torch.core.compression import (QuantizePNorm, RandK, TopK,
                                          agent_draws)
from repro_torch.core.convert import state_from_numpy
from repro_torch.core.convex import LinearRegression
from repro_torch.core.engines import engine_for
from repro_torch.core.gossip import DenseGossip
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
    # 256-wide rows run (the strided routine) and equal the plain versions
    rows256 = [torch.randn(8, 256, device=cuda_device) for _ in range(5)]
    assert all(torch.equal(a, b) for a, b in zip(
        lu.lead_diff_encode(*rows256, 0.1),
        lu.lead_diff_encode_plain(*rows256, 0.1, 2)))
    with pytest.raises(ValueError):                 # mismatched u shape
        lu.lead_diff_encode(*rows256[:4], rows256[4][:, :128], 0.1)
    with pytest.raises(ValueError):                 # scalar on another device
        lu.lead_update(*([x] * 7), torch.tensor(0.1), 1.0, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(
        q.encode(*rows256[:2]), q.encode_plain(*rows256[:2], 2)))
    with pytest.raises(ValueError):                 # mismatched u shape
        q.encode(rows256[0], rows256[1][:4])
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


BLOCKS = [1, 3, 16, 100, 256, 512, 1024, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
def test_quantizer_kernels_at_any_block_width(cuda_device, block):
    """K1, K4 and K2 bit-identical to their plain versions at every block
    width (512: the float4 hot path; any other: the strided routine), at
    b = 2, 4 and 7, a zero row included; one launch per call."""
    rows = max(8, (1 << 18) // block)
    gen = torch.Generator(cuda_device).manual_seed(block)
    x, g, d, h = (torch.randn(rows, block, generator=gen, device=cuda_device)
                  for _ in range(4))
    x[1] = 0.0
    u = torch.rand(rows, block, generator=gen, device=cuda_device)
    eta = torch.full((), 0.07, device=cuda_device)
    for bits in (2, 4, 7):
        before = cuda_lib.launch_counts()
        c1, s1 = q.encode(x, u, bits=bits)
        k1, t1 = lu.lead_diff_encode(x, g, d, h, u, eta, bits=bits)
        o1 = q.decode(c1, s1, bits=bits)
        after = cuda_lib.launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k in ("quantize_encode", "lead_diff_encode",
                         "quantize_decode")) for k in after}
        c2, s2 = q.encode_plain(x, u, bits)
        assert torch.equal(c1, c2) and torch.equal(s1, s2)
        assert float(s1[1]) == 0.0 and not bool(c1[1].any())
        k2, t2 = lu.lead_diff_encode_plain(x, g, d, h, u, eta, bits)
        assert torch.equal(k1, k2) and torch.equal(t1, t2)
        assert torch.equal(o1, q.decode_plain(c1, s1, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lead", "choco"])
def test_flat_engines_at_block_256_match_the_cpu(cuda_device, name):
    """The flat LEAD and CHOCO engines with QuantizePNorm(block=256) step on
    the card: from the same state, five steps each agree with the CPU's
    (codes identical, so the states agree to rounding of the mix)."""
    comp = QuantizePNorm(bits=2, block=256)
    engines = {dev: engine_for(topology.ring(8), comp, 1000, algorithm=name,
                               eta=0.05, device=dev)
               for dev in (cuda_device, "cpu")}
    rng = np.random.default_rng(5)
    x0, g0 = (torch.from_numpy(rng.standard_normal((8, 1000))
                               .astype(np.float32)) for _ in range(2))
    st = engines["cpu"].init(x0, g0)
    cuda_lib.reset_launch_counts()
    for step in range(5):
        g = torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32))
        want = engines["cpu"].step(st, g, 11 + step)
        got = engines[cuda_device].step(
            state_from_numpy(type(st), {f: v.numpy() for f, v in
                                        st._asdict().items()},
                             device=cuda_device), g.to(cuda_device), 11 + step)
        for f in want._fields:
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(want, f).numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {f}")
        st = want
    launched = {k for k, v in cuda_lib.launch_counts().items() if v}
    assert launched == ({"lead_diff_encode", "quantize_decode", "lead_update"}
                        if name == "lead"
                        else {"quantize_encode", "quantize_decode"})


@pytest.mark.cuda
def test_topk_mask_on_the_card_equals_the_cpu(cuda_device):
    """The tie-stable TopK mask is the same on the card as on the CPU, on
    tied integer rows and on continuous ones."""
    rng = np.random.default_rng(0)
    for rows in (rng.integers(-3, 4, size=(8, 3000)).astype(np.float32),
                 rng.choice(np.array([-1.0, 1.0], np.float32), size=(8, 40)),
                 rng.standard_normal((8, 5000)).astype(np.float32)):
        for ratio in (0.01, 0.1, 0.5):
            t = torch.from_numpy(rows)
            cpu = TopK(ratio=ratio)._mask_rows(t)
            card = TopK(ratio=ratio)._mask_rows(t.to(cuda_device))
            assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_tree_path_runs_through_the_wire_kernels(cuda_device):
    """Tree LEAD on the 2-bit p=inf wire launches K4 and K2 once per step
    and never K1 or K3; tree CHOCO launches K5 on RandK and K6 on TopK;
    tree NIDS and DGD on the card match their CPU runs."""
    prob = LinearRegression.generate(torch.Generator(cuda_device).manual_seed(0),
                                     n_agents=8, m=64, d=64,
                                     device=cuda_device)
    mu, L = prob.mu_L
    gossip = DenseGossip.from_topology(topology.ring(8), cuda_device)
    lead = LEADSim(gossip=gossip, compressor=QuantizePNorm(bits=2),
                   eta=1.0 / L, engine="tree")
    cuda_lib.reset_launch_counts()
    tr = run(lead, prob, prob.x_star, iters=50)
    assert cuda_lib.launch_counts() == {
        k: 50 if k in ("quantize_encode", "quantize_decode") else 0
        for k in cuda_lib.LAUNCHES}
    assert np.isfinite(tr.dist).all() and tr.dist[-1] < 1e-2 * tr.dist[0]
    for comp, kernel in ((RandK(ratio=0.5, rescale=False), "randk_encode"),
                         (TopK(ratio=0.5), "mask_apply")):
        cuda_lib.reset_launch_counts()
        run(CHOCO_SGD(gossip=gossip, compressor=comp, eta=0.5 / L, gamma=0.2),
            prob, prob.x_star, iters=20)
        assert cuda_lib.launch_counts() == {
            k: 20 if k == kernel else 0 for k in cuda_lib.LAUNCHES}
    cpu = LinearRegression.from_arrays(prob.A, prob.b, prob.lam, device="cpu")
    cpu_gossip = DenseGossip.from_topology(topology.ring(8), "cpu")
    for cls in (NIDS, DGD):
        on_card = run(cls(gossip=gossip, eta=1.0 / L), prob, prob.x_star,
                      iters=100)
        on_cpu = run(cls(gossip=cpu_gossip, eta=1.0 / L), cpu,
                     prob.x_star.cpu(), iters=100)
        for a, b in zip(on_card[:3], on_cpu[:3]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.max(np.abs(b)))


TREE_COMPRESSORS = {"pinf_2bit": (QuantizePNorm(bits=2), "quantize_encode"),
                    "pinf_4bit_b100": (QuantizePNorm(bits=4, block=100),
                                       "quantize_encode"),
                    "randk_0.1": (RandK(ratio=0.1, rescale=False),
                                  "randk_encode"),
                    "randk_0.1_rescaled": (RandK(ratio=0.1), "randk_encode"),
                    "topk_0.01": (TopK(ratio=0.01), "mask_apply")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TREE_COMPRESSORS))
@pytest.mark.parametrize("shape", [(8, 200), (8, 3000), (3, 7, 130)],
                         ids=str)
def test_tree_compress_on_the_card_equals_the_cpu(cuda_device, name, shape):
    """The tree path's per-agent compress (padding to whole blocks, the
    kernel, the way back to the agents' shape) gives on the card, bit for
    bit, what the plain versions give on the CPU for the same X and draws:
    one kernel launch on the card (p=inf: K4 then K2), on continuous rows
    and on tied integer rows."""
    comp, kernel = TREE_COMPRESSORS[name]
    rng = np.random.default_rng(len(shape))
    for X in (rng.standard_normal(shape).astype(np.float32),
              rng.integers(-3, 4, size=shape).astype(np.float32)):
        X = torch.from_numpy(X).to(cuda_device)
        draws = agent_draws(comp, X, seed=7)
        cuda_lib.reset_launch_counts()
        card = comp.compress_agents(X, **draws)
        want = {kernel: 1}
        if kernel == "quantize_encode":
            want["quantize_decode"] = 1
        assert cuda_lib.launch_counts() == {
            k: want.get(k, 0) for k in cuda_lib.LAUNCHES}
        cpu = comp.compress_agents(X.cpu(),
                                   **{k: v.cpu() for k, v in draws.items()})
        assert card.shape == X.shape and torch.equal(card.cpu(), cpu)
