"""The port's CUDA kernels and main path on an NVIDIA GPU.

Every test here needs the card (marker ``cuda``) and skips without one: a
CUDA kernel has no CPU mode.  The file imports nothing of JAX, so it also
runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax for the reference's tests.)
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import faults, topology
from repro_torch.core.baselines import CHOCO_SGD, DGD, NIDS
from repro_torch.core.compression import (Identity, QuantizePNorm, RandK,
                                          TopK, agent_draws, fast_normal)
from repro_torch.core.convert import state_from_numpy
from repro_torch.core.convex import LinearRegression, batch_indices
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
                   eta=1.0 / L, engine="flat")
    cuda_lib.reset_launch_counts()
    tr = run(lead, prob, prob.x_star, iters=50)
    assert cuda_lib.launch_counts() == {k: 50 if k in LEAD_KERNELS else 0
                                        for k in cuda_lib.LAUNCHES}
    assert np.isfinite(tr.dist).all() and tr.dist[-1] < 1e-2 * tr.dist[0]

    cpu = LinearRegression.from_arrays(prob.A, prob.b, prob.lam, device="cpu")
    exact = LEADSim(topology=topology.ring(8), eta=1.0 / L, engine="flat")
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


FAULT_TOPOS = {"ring8": lambda: topology.ring(8),
               "torus_2x4": lambda: topology.torus_2d(2, 4),
               "er8": lambda: topology.erdos_renyi(8, p=0.5, seed=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("topo", sorted(FAULT_TOPOS))
def test_fault_masks_on_the_card_equal_the_cpu(cuda_device, topo, rate):
    """The counter hash's fault realizations on the card, bit for bit the
    CPU's (which the CPU tests hold to the reference's): 64 steps of dense
    and table masks and broadcast flags, the dropped-link counts and
    undetected bit-flip corruption.  The realized gap from the card's SVD
    (run() takes it on the host) within 16 ulp of 1.0 of the CPU's: cuSOLVER
    and LAPACK part by several ulp where sigma_2 is near 1 (an isolated
    agent)."""
    t = FAULT_TOPOS[topo]()
    nbr = torch.as_tensor(t.neighbors, dtype=torch.int64)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 3, 512)).astype(np.float32))
    for detect in (True, False):
        fm = faults.FaultModel(seed=3, link_drop=rate, agent_drop=rate,
                               dropout_window=3, straggler_rate=rate,
                               straggler_tau=2, bitflip_rate=rate,
                               detect_corruption=detect)
        ks = torch.arange(64).reshape(-1, 1, 1)
        kc = ks.to(cuda_device)
        assert torch.equal(fm.dense_mask(kc, 8).cpu(), fm.dense_mask(ks, 8))
        assert torch.equal(fm.table_mask(kc, nbr.to(cuda_device)).cpu(),
                           fm.table_mask(ks, nbr))
        assert torch.equal(fm.broadcast_ok(kc[:, :, 0], 8).cpu(),
                           fm.broadcast_ok(ks[:, :, 0], 8))
        d_card, g_card = faults.link_metrics(fm, t, kc.reshape(-1))
        d_cpu, g_cpu = faults.link_metrics(fm, t, ks.reshape(-1))
        assert torch.equal(d_card.cpu(), d_cpu)
        assert float((g_card.cpu() - g_cpu).abs().max()) <= 16 * 2.0 ** -23
        for k in range(8):
            card = fm.corrupt_values(x.to(cuda_device),
                                     torch.tensor(k, device=cuda_device))
            assert torch.equal(card.cpu().view(torch.int32),
                               fm.corrupt_values(x, k).view(torch.int32))


@pytest.mark.cuda
def test_oracle_draws_on_the_card_equal_the_cpu(cuda_device):
    """Batch indices on the card are the CPU's, bit for bit (integer
    arithmetic on the counter hash); the Box-Muller normals agree within 4
    ulp (log and cos are not correctly rounded); a minibatch gradient on
    the card's indices matches the CPU's within 1e-5."""
    for seed in (0, 7, 2 ** 32 - 1):
        for m in (200, 256, 1000):
            assert torch.equal(
                batch_indices(8, 64, m, seed, device=cuda_device).cpu(),
                batch_indices(8, 64, m, seed, device="cpu"))
        card = fast_normal((8, 1 << 16), seed, device=cuda_device).cpu()
        cpu = fast_normal((8, 1 << 16), seed, device="cpu")
        ulp = torch.nextafter(cpu.abs(), torch.tensor(float("inf"))) \
            - cpu.abs()
        assert float(((card - cpu).abs() / ulp).max()) <= 4.0
    prob = LinearRegression.generate(torch.Generator().manual_seed(0),
                                     n_agents=8, m=64, d=64, device="cpu")
    card = LinearRegression.from_arrays(prob.A, prob.b, prob.lam,
                                        device=cuda_device)
    X = torch.randn(8, 64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        card.minibatch_grad(X.to(cuda_device), seed=3).cpu().numpy(),
        prob.minibatch_grad(X, seed=3).numpy(), rtol=1e-5, atol=1e-5)


class _Quadratic:
    """f_i(x) = 0.5 ||x - t_i||^2 on a device."""

    def __init__(self, n, d, device):
        self.T = torch.randn((n, d), generator=torch.Generator(
            device).manual_seed(0), device=device)
        self.n, self.d, self.x_star = n, d, self.T.mean(0)

    def full_grad(self, X):
        return X - self.T

    def loss(self, X):
        return 0.5 * torch.mean(torch.sum((X - self.T) ** 2, -1))


SYNC_CASES = ("lead_dense", "lead_neighbor", "choco_stale", "lead_noisy",
              "lead_bank", "lead_interval", "cgt_bank")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNC_CASES)
def test_faulted_run_makes_no_per_step_sync(cuda_device, case):
    """A faulted run() synchronises the card with the host as often at 10
    and 20 steps as at 5 (torch.cuda.set_sync_debug_mode flags every
    synchronising call; a run makes a few, the copies of the graph's
    tables to the card when its engine is built and the one copy of the
    trace): the fault masks are hashed on the card, and the realized gap's
    SVD runs on the host after the loop.  Likewise the noisy oracle, and a
    faulted run over a bank (exponential_onepeer(8)) and over an interval
    (ring(8).with_interval(4)): run() hands each step its host counter, so
    picking the round and gating the wire read nothing off the card.  And
    faulted C-GT over random_matching(8): its per-wire seeds are host
    ints, and its two wires share one link realization."""
    prob = _Quadratic(8, 4096, cuda_device)
    q2 = QuantizePNorm(bits=2)
    link = faults.FaultModel(seed=0, link_drop=0.1)
    kw = {}
    if case == "choco_stale":
        algo = engine_for(topology.ring(8), q2, prob.d, algorithm="choco",
                          gossip="neighbor", eta=0.01, gamma=0.8,
                          faults=faults.FaultModel(
                              seed=6, agent_drop=0.2, dropout_window=5,
                              policy="stale"), device=cuda_device)
    elif case == "cgt_bank":
        algo = engine_for(topology.random_matching(8, seed=0), q2, prob.d,
                          algorithm="cgt", gossip="neighbor", eta=0.01,
                          faults=link, device=cuda_device)
    elif case in ("lead_bank", "lead_interval"):
        topo = (topology.exponential_onepeer(8) if case == "lead_bank"
                else topology.ring(8).with_interval(4))
        algo = LEADSim(topology=topo, compressor=q2, eta=0.5, engine="flat",
                       device=cuda_device, engine_gossip="neighbor",
                       faults=link)
    else:
        algo = LEADSim(topology=topology.ring(8), compressor=q2, eta=0.5,
                       engine="flat", device=cuda_device,
                       engine_gossip="neighbor" if "neighbor" in case
                       else "dense",
                       faults=None if case == "lead_noisy" else link)
        kw = {"noise_std": 0.1} if case == "lead_noisy" else {}
    run(algo, prob, prob.x_star, iters=2, **kw)        # builds the kernels

    def syncs(iters):
        """Where each synchronising call of a run came from."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tr = run(algo, prob, prob.x_star, iters=iters, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert all(np.isfinite(a).all() for a in tr)
        return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]

    at5 = syncs(5)
    for iters in (10, 20):
        assert syncs(iters) == at5, iters


NEW_PATH_TOPOS = {"bank": (lambda: topology.exponential_onepeer(8),
                           "neighbor"),
                  "hier": (lambda: topology.hierarchical(topology.ring(4), 2),
                           "hier")}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(NEW_PATH_TOPOS))
def test_bank_and_hier_lead_steps_equal_the_cpu(cuda_device, path):
    """A 2-bit LEAD step on exponential_onepeer(8) and on the hier wire of
    hierarchical(ring(4), 2): from the same state, with the same gradient
    and seed, five steps each agree with the CPU's (payload codes
    identical, states within 1e-5, as the block-256 engine test holds)."""
    build, gossip = NEW_PATH_TOPOS[path]
    engines = {dev: engine_for(build(), QuantizePNorm(bits=2), 1000,
                               gossip=gossip, eta=0.05, device=dev)
               for dev in (cuda_device, "cpu")}
    rng = np.random.default_rng(6)
    x0, g0 = (torch.from_numpy(rng.standard_normal((8, 1000))
                               .astype(np.float32)) for _ in range(2))
    st = engines["cpu"].init(x0, g0)
    for step in range(5):
        g = torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32))
        card_st = state_from_numpy(type(st), {f: v.numpy() for f, v in
                                              st._asdict().items()},
                                   device=cuda_device)
        hy = {dev: eng.hypers_at(s.k) for (dev, eng), s in
              zip(engines.items(), (card_st, st))}
        codes = [eng.encode_stage(s, eng.blockify(gg), 21 + step,
                                  hy[dev])[0]["code"].cpu()
                 for (dev, eng), s, gg in zip(engines.items(), (card_st, st),
                                              (g.to(cuda_device), g))]
        assert torch.equal(codes[0], codes[1]), (path, step)
        want = engines["cpu"].step(st, g, 21 + step, step=step)
        got = engines[cuda_device].step(card_st, g.to(cuda_device), 21 + step,
                                        step=step)
        for f in want._fields:
            np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                       getattr(want, f).numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{path} {f}")
        st = want


@pytest.mark.cuda
def test_new_paths_launch_their_kernels(cuda_device):
    """run() launches, per communicating step: K1, K2 and K3 for flat LEAD
    on a bank; K4 and K2 for CHOCO on the 2-bit wire over a bank; K4, K2
    and K3 for LEAD on the hier wire, and K1 never; on ring(8).
    with_interval(4) LEAD's kernels on 5 of 20 steps and none on the
    local ones."""
    prob = _Quadratic(8, 1024, cuda_device)
    q2 = QuantizePNorm(bits=2)
    lead = LEAD_KERNELS
    wire = ("quantize_encode", "quantize_decode")
    hier = ("quantize_encode", "quantize_decode", "lead_update")
    cases = [
        (LEADSim(topology=topology.exponential_onepeer(8), compressor=q2,
                 eta=0.5, engine="flat", device=cuda_device), lead, 20),
        (engine_for(topology.random_matching(8, seed=0), q2, 1024,
                    algorithm="choco", eta=0.01, gamma=0.8,
                    device=cuda_device), wire, 20),
        (LEADSim(topology=topology.hierarchical(topology.ring(4), 2),
                 compressor=q2, eta=0.5, engine="flat", engine_gossip="hier",
                 device=cuda_device), hier, 20),
        (LEADSim(topology=topology.ring(8).with_interval(4), compressor=q2,
                 eta=0.5, engine="flat", device=cuda_device), lead, 5),
    ]
    for algo, kernels, count in cases:
        cuda_lib.reset_launch_counts()
        tr = run(algo, prob, prob.x_star, iters=20)
        assert cuda_lib.launch_counts() == {
            k: count if k in kernels else 0 for k in cuda_lib.LAUNCHES}
        assert np.isfinite(tr.dist).all()


MULTIWIRE = {"cedas_matching": ("cedas", lambda: topology.random_matching(
                 8, seed=0), "neighbor"),
             "cgt_onepeer": ("cgt", lambda: topology.exponential_onepeer(8),
                             "neighbor"),
             "cgt_ring_dense": ("cgt", lambda: topology.ring(8), "dense")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MULTIWIRE))
def test_cedas_and_cgt_steps_equal_the_cpu(cuda_device, case):
    """Flat CEDAS on a matching bank and C-GT on a one-peer bank and the
    ring: from the same state, with the same gradient and seed, five steps
    each agree with the CPU's (every wire's codes and scales identical,
    states within 1e-5); the tree CEDAS and CGT likewise."""
    from repro_torch.core.baselines import CEDAS, CGT
    name, build, gossip = MULTIWIRE[case]
    engines = {dev: engine_for(build(), QuantizePNorm(bits=2), 1000,
                               algorithm=name, gossip=gossip, eta=0.02,
                               device=dev)
               for dev in (cuda_device, "cpu")}
    tree_cls = CEDAS if name == "cedas" else CGT
    trees = {dev: tree_cls(topology=build(), compressor=QuantizePNorm(bits=2),
                           eta=0.02, device=dev)
             for dev in (cuda_device, "cpu")}
    rng = np.random.default_rng(7)
    x0, g0 = (torch.from_numpy(rng.standard_normal((8, 1000))
                               .astype(np.float32)) for _ in range(2))
    st, tst = engines["cpu"].init(x0, g0), trees["cpu"].init(x0, g0)
    for step in range(5):
        g = torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32))
        card_st, card_tst = (state_from_numpy(
            type(s), {f: v.numpy() for f, v in s._asdict().items()},
            device=cuda_device) for s in (st, tst))
        payloads = [eng.encode_stage(s, eng.blockify(gg), 21 + step,
                                     eng.hypers_at(s.k))[0]
                    for eng, s, gg in zip(engines.values(), (card_st, st),
                                          (g.to(cuda_device), g))]
        pl_card, pl_cpu = (p if isinstance(p, tuple) else (p,)
                           for p in payloads)
        for a, b in zip(pl_card, pl_cpu):
            for f in b:
                assert torch.equal(a[f].cpu(), b[f]), (case, step, f)
        want = engines["cpu"].step(st, g, 21 + step, step=step)
        got = engines[cuda_device].step(card_st, g.to(cuda_device), 21 + step,
                                        step=step)
        twant = trees["cpu"].step(tst, g, 21 + step)
        tgot = trees[cuda_device].step(card_tst, g.to(cuda_device), 21 + step)
        for a, b in ((got, want), (tgot, twant)):
            for f in b._fields:
                np.testing.assert_allclose(getattr(a, f).cpu().numpy(),
                                           getattr(b, f).numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{case} {f}")
        st, tst = want, twant


@pytest.mark.cuda
def test_cedas_and_cgt_launch_their_kernels(cuda_device):
    """run() launches, per step: K4 and K2 once for CEDAS on the 2-bit wire
    and twice for C-GT (one per wire), K5 twice for C-GT on RandK, K6 twice
    on TopK; K1 and K3 never; C-GT under renormalized link drops as on the
    clean wire; C-GT's bits are twice CEDAS's on the same graph."""
    prob = _Quadratic(8, 1024, cuda_device)
    q2 = QuantizePNorm(bits=2)
    wire = ("quantize_encode", "quantize_decode")
    link = faults.FaultModel(seed=0, link_drop=0.1)
    cases = [
        ("cedas", topology.random_matching(8, seed=0), q2, None, wire, 20),
        ("cgt", topology.exponential_onepeer(8), q2, None, wire, 40),
        ("cgt", topology.ring(8), q2, link, wire, 40),
        ("cgt", topology.ring(8), RandK(ratio=0.1, rescale=False), None,
         ("randk_encode",), 40),
        ("cgt", topology.ring(8), TopK(ratio=0.01), None, ("mask_apply",), 40),
    ]
    bits = {}
    for name, topo, comp, fm, kernels, count in cases:
        algo = engine_for(topo, comp, 1024, algorithm=name, eta=0.01,
                          gossip="neighbor", faults=fm, device=cuda_device)
        cuda_lib.reset_launch_counts()
        tr = run(algo, prob, prob.x_star, iters=20)
        assert cuda_lib.launch_counts() == {
            k: count if k in kernels else 0 for k in cuda_lib.LAUNCHES}, name
        assert np.isfinite(tr.dist).all()
        bits[(name, type(comp).__name__, fm is None)] = tr.bits_per_agent[-1]
    cedas_ring = run(engine_for(topology.ring(8), q2, 1024, algorithm="cedas",
                                device=cuda_device),
                     prob, prob.x_star, iters=20).bits_per_agent[-1]
    assert bits[("cgt", "QuantizePNorm", False)] == 2 * cedas_ring


# -- the decentralized LM trainer (dist/trainer.py) ------------------------------

def _trainer_setup(dc_kwargs, seq=32):
    """granite-3-2b reduced (d_ff 341), 4 agents, the state on the CPU from
    a seeded generator, batches 2 x seq on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.dist.trainer import DistConfig, init_train_state

    cfg = get_config("granite-3-2b").reduced()
    dc = DistConfig(**dc_kwargs)
    state = init_train_state(cfg, 4, dc, torch.Generator().manual_seed(0),
                             "cpu")
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=seq, batch_per_agent=2,
                        n_agents=4)
    return cfg, dc, state, lambda i, dev: lm_batch(ds, i, device=dev)


def _tree_on(tree, dev):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda l: l.to(dev), tree)


def _state_on(state, dev):
    return state._replace(params=_tree_on(state.params, dev),
                          algo={f: _tree_on(t, dev)
                                for f, t in state.algo.items()},
                          step=state.step.to(dev))


TRAINER_RUNS = {"lead_uncompressed": {"algorithm": "lead",
                                      "compressor": Identity()},
                "nids": {"algorithm": "nids"}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRAINER_RUNS))
def test_trainer_on_the_card_matches_the_cpu(cuda_device, name):
    """chip_smoke.py's train_small bounds: uncompressed LEAD (K3) and NIDS
    over 5 steps from the same weights on the same batches, params, each
    agent's loss and grad_norm within 1e-4 relative of the CPU's (the
    card's matmul rounding, TF32 off)."""
    from repro_torch.dist.trainer import agent_losses, make_train_step
    from repro_torch.utils.tree import tree_leaves

    cfg, dc, state, batch = _trainer_setup(TRAINER_RUNS[name])
    res = {}
    for dev in ("cpu", cuda_device):
        st = _state_on(state, dev)
        step = make_train_step(cfg, 4, dc, dev)
        norms = []
        for i in range(5):
            st, m = step(st, _tree_on(batch(i, "cpu"), dev), 0, step=i)
            norms.append(float(m["grad_norm"]))
        losses = agent_losses(cfg, st.params,
                              _tree_on(batch(4, "cpu"), dev)).cpu().numpy()
        res[str(dev)] = (tree_leaves(st.params), np.array(norms), losses)
    (cx, cn, cl), (gx, gn, gl) = res["cpu"], res[str(cuda_device)]
    for a, b in zip(gx, cx):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    np.testing.assert_allclose(gn, cn, rtol=1e-4)
    np.testing.assert_allclose(gl, cl, rtol=1e-4)


@pytest.mark.cuda
def test_trainer_2bit_codes_on_the_card_match_the_cpu(cuda_device):
    """2-bit LEAD, one step from the same state and batch: fewer than 1e-5
    of the codes differ from the CPU's (a gradient rounding difference can
    flip a knife-edge code), and the bits are the CPU's exactly."""
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.dist.trainer import make_train_step

    cfg, dc, state, batch = _trainer_setup({"algorithm": "lead"})
    orig = QuantizePNorm.encode_blocks
    codes, bits = {}, {}
    for dev in ("cpu", cuda_device):
        seen = []

        def spy(comp, buf, dim, u):
            payload, b = orig(comp, buf, dim, u)
            seen.append(payload["code"].cpu())
            return payload, b

        QuantizePNorm.encode_blocks = spy
        try:
            _, m = make_train_step(cfg, 4, dc, dev)(
                _state_on(state, dev), batch(0, dev), 0, step=0)
        finally:
            QuantizePNorm.encode_blocks = orig
        codes[str(dev)], bits[str(dev)] = seen, float(m["bits_per_agent"])
    cpu, card = codes["cpu"], codes[str(cuda_device)]
    assert len(cpu) == len(card) == 12
    differ = sum(int((a != b).sum()) for a, b in zip(card, cpu))
    assert differ < 1e-5 * sum(a.numel() for a in cpu), differ
    assert bits["cpu"] == bits[str(cuda_device)]


@pytest.mark.cuda
def test_trainer_step_launches_its_kernels(cuda_device):
    """One 2-bit LEAD step of the trainer: K4, K2 and K3 once per leaf
    (12), K1 never (the reference trainer never calls encode_stage), K5
    and K6 never."""
    from repro_torch.dist.trainer import make_train_step

    cfg, dc, state, batch = _trainer_setup({"algorithm": "lead"})
    step = make_train_step(cfg, 4, dc, cuda_device)
    st = _state_on(state, cuda_device)
    st, _ = step(st, batch(0, cuda_device), 0, step=0)   # builds the kernels
    b = batch(1, cuda_device)
    cuda_lib.reset_launch_counts()
    step(st, b, 0, step=1)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts() == {
        "lead_diff_encode": 0, "quantize_decode": 12, "lead_update": 12,
        "quantize_encode": 12, "randk_encode": 0, "mask_apply": 0}


TRAINER_SYNC_CASES = {
    "bank": lambda: {"topology": topology.exponential_onepeer(4)},
    "interval": lambda: {"topology": topology.ring(4).with_interval(2)},
    "faults": lambda: {"faults": faults.FaultModel(seed=0, link_drop=0.1)},
    "hier": lambda: {"topology": topology.hierarchical(topology.ring(2), 2)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAINER_SYNC_CASES))
def test_trainer_step_makes_no_per_step_sync(cuda_device, case):
    """The trainer's step given its host step counter reads nothing off the
    card: as many synchronising calls in 4 steps as in 2 (torch.cuda.
    set_sync_debug_mode flags each), for a bank's round, an interval's gate,
    the fault masks and the hier wire - all decided from the host counter
    or hashed on the card."""
    from repro_torch.dist.trainer import make_train_step

    cfg, dc, state, batch = _trainer_setup(
        {"algorithm": "lead", **TRAINER_SYNC_CASES[case]()})
    step = make_train_step(cfg, 4, dc, cuda_device)
    st = _state_on(state, cuda_device)
    st, _ = step(st, batch(0, cuda_device), 0, step=0)   # builds the kernels
    batches = [batch(i, cuda_device) for i in range(1, 5)]
    torch.cuda.synchronize()

    def syncs(n, st):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(n):
                    st, m = step(st, batches[i], 0, step=i + 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(m["grad_norm"]).item()
        return [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]

    assert syncs(4, st) == syncs(2, st)


# -- the trainer on every model family -------------------------------------------

FAMILY_ARCHS = {"granite-moe-1b-a400m": {}, "kimi-k2-1t-a32b": {},
                "xlstm-1.3b": {"n_layers": 6},
                "recurrentgemma-2b": {"n_layers": 3},
                "llama-3.2-vision-11b": {}, "whisper-tiny": {}}


def _family_setup(arch, dc_kwargs):
    """`arch` at .reduced(**FAMILY_ARCHS[arch]), 4 agents, the state on the
    CPU from a seeded generator; batch(i, dev) the 2 x 32 batch of step i
    with the stub memory of a vlm or audio model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import (LMStreamConfig, lm_batch,
                                            stub_memory)
    from repro_torch.dist.trainer import DistConfig, init_train_state

    cfg = get_config(arch).reduced(**FAMILY_ARCHS[arch])
    dc = DistConfig(**dc_kwargs)
    state = init_train_state(cfg, 4, dc, torch.Generator().manual_seed(0),
                             "cpu")
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=32, batch_per_agent=2,
                        n_agents=4)
    memory = stub_memory(cfg.family, (4, 2), cfg, device="cpu")

    def batch(i, dev):
        b = lm_batch(ds, i, device="cpu")
        if memory is not None:
            b["memory"] = memory
        return _tree_on(b, dev)

    return cfg, dc, state, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_trainer_on_the_card_matches_the_cpu(cuda_device, arch):
    """Uncompressed LEAD (K3) over 3 steps of each family from the same
    weights on the same batches: params, each agent's loss and grad_norm
    within 1e-4 relative of the CPU's, as train_small holds them (xLSTM
    each step from the CPU's state before it, its params against the
    state's largest |x|: its step at eta 0.03 amplifies a rounding
    difference 15-90x a step and moves the embedding by several times its
    size).  An MoE routes every
    token as the CPU does (a near-tie of the router's probabilities could
    swap experts; the count is in the message)."""
    from repro_torch.dist.trainer import agent_losses, make_train_step
    from repro_torch.models import moe
    from repro_torch.utils.tree import tree_leaves

    cfg, dc, state, batch = _family_setup(
        arch, {"algorithm": "lead", "compressor": Identity()})
    res, routes, cpu_states = {}, {}, [state]
    restart = arch == "xlstm-1.3b"
    orig = moe.route
    for dev in ("cpu", cuda_device):
        seen = []

        def spy(p, xt, top_k, capacity_factor):
            out = orig(p, xt, top_k, capacity_factor)
            seen.append(out[2].cpu())
            return out

        moe.route = spy
        try:
            st = _state_on(state, dev)
            step = make_train_step(cfg, 4, dc, dev)
            norms = []
            for i in range(3):
                if restart and dev != "cpu":
                    st = _state_on(cpu_states[i], dev)
                st, m = step(st, batch(i, dev), 0, step=i)
                if dev == "cpu":
                    cpu_states.append(st)
                norms.append(float(m["grad_norm"]))
            losses = agent_losses(cfg, st.params, batch(2, dev)).cpu()
        finally:
            moe.route = orig
        res[str(dev)] = (tree_leaves(st.params), np.array(norms),
                         losses.numpy())
        routes[str(dev)] = seen
    flips = sum(int((a != b).any(-1).sum()) for a, b in
                zip(routes["cpu"], routes[str(cuda_device)]))
    assert flips == 0, f"{flips} tokens route differently"
    (cx, cn, cl), (gx, gn, gl) = res["cpu"], res[str(cuda_device)]
    state_scale = max(float(b.abs().max()) for b in cx)
    for a, b in zip(gx, cx):
        scale = state_scale if restart else float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    np.testing.assert_allclose(gn, cn, rtol=1e-4)
    np.testing.assert_allclose(gl, cl, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_trainer_step_launches_its_kernels(cuda_device, arch):
    """One 2-bit LEAD step of each family: K4, K2 and K3 once per leaf
    (sub-block leaves, the 0-d gates and whisper's 51,865 x 384 embedding
    included), K1, K5 and K6 never; the bits the CPU's exactly."""
    from repro_torch.dist.trainer import make_train_step
    from repro_torch.utils.tree import tree_leaves

    cfg, dc, state, batch = _family_setup(arch, {"algorithm": "lead"})
    n = len(tree_leaves(state.params))
    step = make_train_step(cfg, 4, dc, cuda_device)
    st = _state_on(state, cuda_device)
    st, _ = step(st, batch(0, cuda_device), 0, step=0)   # builds the kernels
    cuda_lib.reset_launch_counts()
    _, m = step(st, batch(1, cuda_device), 0, step=1)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts() == {
        "lead_diff_encode": 0, "quantize_decode": n, "lead_update": n,
        "quantize_encode": n, "randk_encode": 0, "mask_apply": 0}
    _, mc = make_train_step(cfg, 4, dc, "cpu")(
        _state_on(st, "cpu"), batch(1, "cpu"), 0, step=1)
    assert float(m["bits_per_agent"]) == float(mc["bits_per_agent"])


# -- serving: the KV page codec, decode_step, the engine's syncs ----------------

def _serve_page_shapes():
    """The KV page shapes serving meets: granite-3-2b's at page 16 (8,192
    elements, block 512) and each reduced config's (its pick_block)."""
    from repro_torch.configs.registry import get_config, list_archs

    shapes = {(16, 8, 64)}
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        shapes.add((16, cfg.kv_heads, cfg.head_dim))
    return sorted(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 7])
def test_kv_codec_card_equals_cpu(cuda_device, bits):
    """encode_rows and decode_rows on the card bit for bit the CPU's, at
    block 512 and at the block pick_block gives each reduced config's page
    (a zero page and a loud position included); one K4 per encode, one K2
    per decode."""
    from repro_torch.serve import kv_quant as kvq

    rng = np.random.default_rng(bits)
    for shape in _serve_page_shapes():
        x = torch.from_numpy(rng.standard_normal((33, *shape))
                             .astype(np.float32))
        x[1] = 0.0
        x[2, 0] *= 1e4
        spec = kvq.KVQuantSpec(bits, kvq.pick_block(int(np.prod(shape))))
        cc, cs = kvq.encode_rows(x, spec)
        cuda_lib.reset_launch_counts()
        gc, gs = kvq.encode_rows(x.to(cuda_device), spec)
        assert torch.equal(gc.cpu(), cc) and torch.equal(gs.cpu(), cs)
        for dtype in (torch.float32, torch.bfloat16):
            got = kvq.decode_rows(gc, gs, spec, shape, dtype)
            assert torch.equal(got.cpu(),
                               kvq.decode_rows(cc, cs, spec, shape, dtype))
        torch.cuda.synchronize()
        counts = cuda_lib.launch_counts()
        assert counts["quantize_encode"] == 1
        assert counts["quantize_decode"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b"])
@pytest.mark.parametrize("kv_bits", [None, 4])
def test_serve_decode_step_card_equals_cpu(cuda_device, arch, kv_bits):
    """Reduced granite and gemma, the same weights and prompt: prefill and
    four decode steps on the contiguous path (kv_bits None) or the 4-bit
    paged path (paged_from_contiguous of the CPU's prefill cache), f32
    caches, the card fed the CPU's tokens, logits within 1e-4 of the
    largest |logit|; the 4-bit decode step launches K4 and K2 twice per
    layer."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous
    from repro_torch.utils.tree import tree_map

    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, toks, cache_len=64,
                                cache_dtype=torch.float32)
    caches = {"cpu": cache,
              "cuda": {**cache, "pos": cache["pos"].to(cuda_device),
                       "layers": tuple(type(c)(c.k.to(cuda_device),
                                               c.v.to(cuda_device),
                                               c.rolling)
                                       for c in cache["layers"])}}
    if kv_bits:
        caches = {d: paged_from_contiguous(c, cfg, page=16, kv_bits=kv_bits)
                  for d, c in caches.items()}
    dparams = tree_map(lambda l: l.to(cuda_device), params)
    tok = lg[:, -1].argmax(-1)[:, None]
    for i in range(4):
        cuda_lib.reset_launch_counts()
        with torch.no_grad():
            glg, caches["cuda"] = tfm.decode_step(
                dparams, cfg, tok.to(cuda_device), caches["cuda"])
            clg, caches["cpu"] = tfm.decode_step(params, cfg, tok,
                                                 caches["cpu"])
        counts = cuda_lib.launch_counts()
        want = 2 * cfg.n_layers if kv_bits else 0
        assert counts["quantize_encode"] == counts["quantize_decode"] == want
        assert float((glg.cpu() - clg).abs().max()) \
            <= 1e-4 * float(clg.abs().max()), i
        tok = clg[:, -1].argmax(-1)[:, None]


@pytest.mark.cuda
def test_engine_decode_step_makes_one_sync(cuda_device):
    """Six engine ticks with no admission (two sequences decoding at 4-bit
    pages, a page boundary and its growth among them) each synchronise the
    card with the host once: the copy of the step's tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("granite-3-2b").reduced()
    params = tfm.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                             cuda_device)
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=2, max_len=64,
                                               page=16, kv_bits=4),
                      device=cuda_device)
    eng.submit(list(range(13)), max_new=20)
    eng.submit(list(range(5, 30)), max_new=20)
    with torch.no_grad():
        eng.step()                          # admits both, builds the kernels
        for _ in range(6):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    assert eng.step() == 2
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                     for w in caught if "called a synchronizing CUDA "
                     "operation" in str(w.message)]
            assert len(syncs) == 1 and syncs[0].startswith("engine.py"), \
                syncs
