#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper GPU.

    PYTHONPATH=src python3 chip_smoke.py

Builds the kernels from src/repro_torch/csrc, then runs six phases, each
printing one JSON line; a failed check exits nonzero.

  env            card name and power limit, torch and CUDA versions, build time
  kernels        K1 lead_diff_encode, K2 quantize decode (each at b = 2, 4, 7)
                 and K3 lead_update held bit for bit against their plain
                 PyTorch versions at both shapes of LEAD's path: the
                 headline's (8 rows, d = 64 zero-padded to one block per
                 agent) and the real size's (8 agents x 65,536 rows of 512);
                 K4 quantize encode (b = 2, 4, 7), K5 randk encode (ratio
                 0.1, rescale on and off) and K6 mask apply likewise at both
                 shapes of the baselines' path: Fig. 2's (8 agents x 16
                 blocks, d = 7,840 zero-padded) and the real size's; then
                 every kernel timed at the real size with CUDA events (10
                 launches back to back) against its byte bound, and K2 and
                 K6 in turns with the one PyTorch call that computes each
                 (kernel, library, library, kernel)
  headline       the README's run on the card: ring-8 linear regression, LEAD
                 with the 2-bit quantizer against DGD for 300 iterations,
                 every LEAD kernel launched once per step; plus uncompressed
                 LEAD on the card against the same run on the CPU
  fig2           the paper's Fig. 2 on the card: ring-8 logistic regression,
                 LEAD and the compressed baselines on the 2-bit quantizer,
                 the exact baselines on 32-bit values, 200 iterations; the
                 paper's ordering checked, each compressed baseline through
                 K4 and K2 once per step, and the exact baselines held
                 against the same runs on the CPU
  lead_at_scale  LEAD's path at real size: n = 8 agents, d = 2^25 f32
                 parameters each, 2-bit LEAD for 20 steps through run(), then
                 a per-stage breakdown of run() itself from CUDA events at
                 its stage marks (core/stage_timer.py)
  baselines_at_scale
                 the baselines' path at the same size: CHOCO for 20 steps on
                 each compressed wire - the 2-bit quantizer (K4, K2), RandK
                 (K5) and exact TopK (K6) - with its ms/step, peak memory and
                 stage breakdown

The line before the last lists every kernel with its launches on the main
path, its error against the plain version and its times; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
nonzero before printing anything.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

ROWS = 8 * 65536            # n_agents * nb at the real size
BLOCK = 512
D_SCALE = 2 ** 25           # per-agent parameters at the real size
HEADLINE_D = 64             # per-agent parameters of the README's run
FIG2_D = 784 * 10           # Fig. 2's parameters per agent (16 blocks)
# run()'s stage marks (core/stage_timer.py) by what each stage runs
STAGE_NAMES = {"gradient": "gradient", "dither": "dither",
               "diff_encode": "K1_diff_encode", "decode": "K2_decode",
               "mix": "dense_mix", "update": "K3_update",
               "comp_err": "comp_err", "metrics": "metrics"}
REPS = 20                   # kernel timing: median of 20 batches of 10 calls
BATCH = 10
TRACE_RTOL = 1e-5           # trajectory tolerance, as the CPU parity tests
TRACE_FLOOR = 1e-2
LEAD_KERNELS = ("lead_diff_encode", "quantize_decode", "lead_update")

# Fig. 2: benchmarks/bench_logreg.py's hypers (eta 0.1; CHOCO gamma 0.6,
# DeepSqueeze and QDGD gamma 0.4), plus DCD, EXTRA and D2 at eta 0.1
FIG2_ITERS = 200
FIG2_ETA = 0.1
FIG2 = {"lead": {}, "choco": {"gamma": 0.6}, "deepsqueeze": {"gamma": 0.4},
        "qdgd": {"gamma": 0.4}, "dcd": {}, "dgd": {}, "nids": {},
        "extra": {}, "d2": {}}
FIG2_COMPRESSED = ("choco", "deepsqueeze", "qdgd", "dcd")
FIG2_EXACT = ("dgd", "nids", "extra", "d2")

# CHOCO at scale on the objective of lead_at_scale, eta 0.01 (the mean
# error falls 0.99^2 a step while the drift of the heterogeneous local
# optima stays within what gossip removes); gamma per wire, chosen on the
# CPU at d = 2^16, where the reference's CHOCO falls with the same hypers
# (dist after 20 steps 0.69x, 0.77x and 0.82x of the first step's).
# RandK does not rescale: CHOCO needs a contractive compressor, and
# xhat += q with q rescaled by 1/ratio diverges at any gamma.
CHOCO_ETA = 0.01
CHOCO_WIRES = {   # wire: (gamma, kernels it launches, its stage names)
    "pinf_2bit": (0.8, ("quantize_encode", "quantize_decode"),
                  {"dither": "dither", "encode": "K4_encode",
                   "decode": "K2_decode"}),
    "randk_0.1": (0.2, ("randk_encode",),
                  {"dither": "dither", "encode": "K5_randk_encode",
                   "decode": "decode_identity"}),
    "topk_0.01": (0.2, ("mask_apply",),
                  {"topk_mask": "topk_mask", "encode": "K6_mask_apply",
                   "decode": "decode_identity"}),
}
CHOCO_STAGES = {"gradient": "gradient", "message": "message",
                "mix": "dense_mix", "update": "update",
                "comp_err": "comp_err", "metrics": "metrics"}


def choco_compressor(wire):
    from repro_torch.core.compression import QuantizePNorm, RandK, TopK
    return {"pinf_2bit": QuantizePNorm(bits=2),
            "randk_0.1": RandK(ratio=0.1, rescale=False),
            "topk_0.01": TopK(ratio=0.01)}[wire]


# the H100 SXM's data sheet (dense): HBM bytes/s, fp32 non-tensor flop/s
H100_SXM = ("H100 80GB HBM3", 3.35e12, 67e12)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name):
    key, bw, flops = H100_SXM
    if key not in name:
        raise SystemExit(f"chip_smoke: {name!r} is not an H100 SXM, the one "
                         "card whose data-sheet rates the bounds use")
    return bw, flops


def time_ms(fn, reps=REPS, batch=BATCH, warmup=3):
    """fn's device time: the median over `reps` of the CUDA-event time of
    `batch` calls queued back to back, divided by `batch`.  One untimed call
    ahead of the first event keeps the device busy while the host queues
    the rest, so no host-side launch cost enters."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def time_in_turns(kernel, library):
    """Kernel and library call timed in turns - kernel, library, library,
    kernel - each turn a time_ms median, so that neither side gains from
    going first.  Returns each side's mean of its two medians and the two
    medians themselves."""
    k1 = time_ms(kernel)
    l1 = time_ms(library)
    l2 = time_ms(library)
    k2 = time_ms(kernel)
    return (k1 + k2) / 2, (l1 + l2) / 2, [k1, k2], [l1, l2]


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def expect_launches(launches, counts, what):
    """Fail unless each kernel launched exactly counts.get(name, 0) times."""
    want = {k: counts.get(k, 0) for k in launches}
    check(launches == want, f"{what}: kernel launches {launches}, expected "
          f"{want}")


def trace_gap(a, b, what):
    """Hold trace `a` against trace `b` by the CPU tests' trajectory bound
    (tests/test_torch_engine.py::_trace_close): pointwise 1e-5 relative
    wherever b is at least 1e-2 of its first value, and at every step in
    norm space, |sqrt(a) - sqrt(b)| within 1e-5 of sqrt(b[0]).  Returns
    the gaps of dist, consensus and loss."""
    gap = {}
    for f in ("dist", "consensus", "loss"):
        x, y = getattr(a, f), getattr(b, f)
        keep = y >= TRACE_FLOOR * y[0]
        rel = float(np.max(np.abs(x[keep] - y[keep]) / y[keep]))
        norm = float(np.max(np.abs(np.sqrt(x) - np.sqrt(y))) / np.sqrt(y[0]))
        gap[f] = {"pointwise_rel": rel, "steps": int(keep.sum()),
                  "norm_space": norm}
        check(rel <= TRACE_RTOL and norm <= TRACE_RTOL,
              f"{what} {f} cuda vs cpu {gap[f]}")
    return gap


def stage_breakdown(run_fn, dev, names, what):
    """Median ms per stage of run_fn() (6 steps) under core/stage_timer.py,
    step 0 dropped as warm-up; `names` maps each mark to what it runs and
    must cover every stage."""
    from repro_torch.core.stage_timer import StageTimer

    with StageTimer(dev) as timer:
        run_fn()
    stages = timer.stages()
    first = [name for name, _ in stages].index("metrics") + 1
    acc = {}
    for name, ms in stages[first:]:
        acc.setdefault(names.get(name, name), []).append(ms)
    check(set(acc) == set(names.values()), f"{what}: stages {sorted(acc)}")
    return {s: statistics.median(v) for s, v in acc.items()}


class Quadratic:
    """f_i(x) = 0.5 ||x - t_i||^2, x* = mean_i t_i: the objective that
    benchmarks/bench_lead_step.py drives at scale (a local copy)."""

    def __init__(self, gen, n, d, device):
        self.T = torch.randn((n, d), generator=gen, device=device)
        self.n, self.d = n, d
        self.x_star = self.T.mean(0)

    def full_grad(self, X):
        return X - self.T

    def loss(self, X):
        return 0.5 * torch.mean(torch.sum((X - self.T) ** 2, -1))


def hold_against_plain(dev, d):
    """K1 and K2 at b = 2, 4 and 7, and K3, against their plain versions on
    the planes that the flat engine gives them at per-agent dimension d:
    n = 8 agents blockified (zero past d, as blockify pads), the engine's
    own dither plane and hypers, and one zero row.  Every output must be
    bit-identical; the zero row and the padding must stay zero.  Returns
    each kernel's max |kernel - plain| and the rows it was held at."""
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.engines import engine_for
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q

    n = 8
    eng = engine_for(topology.ring(n), QuantizePNorm(bits=2), d, device=dev)
    gen = torch.Generator(dev).manual_seed(d)
    pad = eng.nb * BLOCK - d                    # zero columns of each agent

    def plane():
        rows = eng._rows(eng.blockify(
            torch.randn((n, d), generator=gen, device=dev)))
        rows[0] = 0.0                           # a zero row stays zero
        return rows

    x, g, dd, h, hw, qh, wqh = (plane() for _ in range(7))
    k0 = torch.zeros((), dtype=torch.int64, device=dev)
    u = eng._rows(eng._dither_plane(12345, k0))
    hy = eng.hypers_at(k0)
    rows = x.shape[0]
    where = f"rows={rows} d={d}"

    def padded(t):                              # agent-major pad columns
        return t.reshape(n, -1)[:, d:] if pad else t[:0]

    err = {"lead_diff_encode": 0.0, "quantize_decode": 0.0, "lead_update": 0.0}
    for bits in (2, 4, 7):
        c1, s1 = lu.lead_diff_encode(x, g, dd, h, u, hy["eta"], bits=bits)
        c2, s2 = lu.lead_diff_encode_plain(x, g, dd, h, u, hy["eta"], bits)
        n_code = int((c1 != c2).sum())
        n_scale = int((s1 != s2).sum())
        check(n_code == 0 and n_scale == 0,
              f"K1 {where} b={bits}: {n_code} codes, {n_scale} scales differ")
        check(float(s1[0]) == 0.0 and not bool(c1[0].any())
              and not bool(padded(c1).any()),
              f"K1 {where} b={bits}: the zero row or the padding is not zero")
        err["lead_diff_encode"] = max(err["lead_diff_encode"],
                                      max_abs(c1, c2), max_abs(s1, s2))
        o1 = q.decode(c1, s1, bits=bits)
        o2 = q.decode_plain(c1, s1, bits)
        e = max_abs(o1, o2)
        check(e == 0.0, f"K2 {where} b={bits}: max |kernel - plain| = {e}")
        err["quantize_decode"] = max(err["quantize_decode"], e)
        del c1, c2, s1, s2, o1, o2

    planes = (x, g, dd, h, hw, qh, wqh)
    hyp = (hy["eta"], hy["gamma"], hy["alpha"])
    outs1 = lu.lead_update(*planes, *hyp)
    outs2 = lu.lead_update_plain(*planes, *hyp)
    e = max(max_abs(a, b) for a, b in zip(outs1, outs2))
    check(e == 0.0, f"K3 {where}: max |kernel - plain| = {e} (built "
          "-fmad=false, so bit-identity is the bar)")
    check(not any(bool(o[0].any()) or bool(padded(o).any()) for o in outs1),
          f"K3 {where}: the zero row or the padding is not zero")
    err["lead_update"] = e
    return err, rows


def hold_wire_against_plain(dev, d):
    """K4 at b = 2, 4 and 7, K5 (ratio 0.1, rescale on and off) and K6
    against their plain versions on the planes that the baselines' wire
    gives them at per-agent dimension d: a message of n = 8 agents
    blockified (zero past d) with one zero row; the engine's dither plane
    (K4) and its logical part padded with 1.0 past d (K5, as RandK pads
    it); the exact-k mask of TopK(0.01) (K6).  Every output must be
    bit-identical, and the zero row and the padding must stay zero.
    Returns each kernel's max |kernel - plain| and the rows it was held
    at."""
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm, TopK, _rows_to_flat
    from repro_torch.core.engines import engine_for
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import sparsify as sp

    n = 8
    eng = engine_for(topology.ring(n), QuantizePNorm(bits=2), d,
                     algorithm="choco", device=dev)
    gen = torch.Generator(dev).manual_seed(d + 1)
    buf = eng.blockify(torch.randn((n, d), generator=gen, device=dev))
    x = eng._rows(buf)
    x[0] = 0.0                                  # a zero row stays zero
    k0 = torch.zeros((), dtype=torch.int64, device=dev)
    plane = eng._dither_plane(12345, k0)
    u = eng._rows(plane)
    u_keep = eng._rows(_rows_to_flat(eng.unblockify(plane), buf, value=1.0))
    mask = eng._rows(_rows_to_flat(
        TopK(ratio=0.01)._mask_rows(eng.unblockify(buf)).to(torch.float32),
        buf))
    del plane
    rows = x.shape[0]
    where = f"rows={rows} d={d}"
    pad = eng.nb * BLOCK - d

    def padded(t):                              # agent-major pad columns
        return t.reshape(n, -1)[:, d:] if pad else t[:0]

    err = {"quantize_encode": 0.0, "randk_encode": 0.0, "mask_apply": 0.0}
    for bits in (2, 4, 7):
        c1, s1 = q.encode(x, u, bits=bits)
        c2, s2 = q.encode_plain(x, u, bits)
        n_code, n_scale = int((c1 != c2).sum()), int((s1 != s2).sum())
        check(n_code == 0 and n_scale == 0,
              f"K4 {where} b={bits}: {n_code} codes, {n_scale} scales differ")
        check(float(s1[0]) == 0.0 and not bool(c1[0].any())
              and not bool(padded(c1).any()),
              f"K4 {where} b={bits}: the zero row or the padding is not zero")
        err["quantize_encode"] = max(err["quantize_encode"], max_abs(c1, c2),
                                     max_abs(s1, s2))
        del c1, c2, s1, s2
    for rescale in (True, False):
        o1 = sp.randk_encode(x, u_keep, ratio=0.1, rescale=rescale)
        o2 = sp.randk_encode_plain(x, u_keep, 0.1,
                                   (1.0 / 0.1) if rescale else 1.0)
        e = max_abs(o1, o2)
        check(e == 0.0 and torch.equal(o1, o2),
              f"K5 {where} rescale={rescale}: max |kernel - plain| = {e}")
        check(not bool(o1[0].any()) and not bool(padded(o1).any()),
              f"K5 {where}: the zero row or the padding is not zero")
        err["randk_encode"] = max(err["randk_encode"], e)
        del o1, o2
    o1, o2 = sp.mask_apply(x, mask), sp.mask_apply_plain(x, mask)
    e = max_abs(o1, o2)
    check(e == 0.0 and torch.equal(o1, o2),
          f"K6 {where}: max |kernel - plain| = {e}")
    check(not bool(padded(o1).any()), f"K6 {where}: the padding is not zero")
    err["mask_apply"] = e
    return err, rows


def phase_kernels(dev, bw, flops):
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import sparsify as sp

    # bit-identity at both shapes of each path: LEAD's (the headline's d =
    # 64, one zero-padded block per agent, 8 rows) and the baselines' (Fig.
    # 2's d = 7,840, 16 blocks per agent, 128 rows), and the real size's
    held = []
    for hold, d_small in ((hold_against_plain, HEADLINE_D),
                          (hold_wire_against_plain, FIG2_D)):
        for d in (d_small, D_SCALE):
            held.append(hold(dev, d))
            torch.cuda.empty_cache()
    err = {k: max(e[k] for e, _ in held if k in e)
           for e, _ in held for k in e}
    check(held[1][1] == ROWS and held[3][1] == ROWS,
          f"real-size rows {held[1][1]}, {held[3][1]} != {ROWS}")

    # device time at the real size
    n = ROWS * BLOCK
    gen = torch.Generator(dev).manual_seed(0)
    x, g, d, h, hw, qh, wqh = (torch.randn(ROWS, BLOCK, generator=gen,
                                           device=dev) for _ in range(7))
    u = torch.rand(ROWS, BLOCK, generator=gen, device=dev)
    eta = torch.full((), 0.07, device=dev)
    k1_ms = time_ms(lambda: lu.lead_diff_encode(x, g, d, h, u, eta, bits=2))
    k1_plain = time_ms(lambda: lu.lead_diff_encode_plain(x, g, d, h, u, eta, 2))
    code, scale = lu.lead_diff_encode(x, g, d, h, u, eta, bits=2)
    # one PyTorch call computes decode: int8 codes times the f32 (rows, 1)
    # column scale * 2^(1-b), whose product is exact, so it gives the plain
    # version's bits; the column's product is part of the function
    def k2_library():
        return torch.mul(code, scale * 2.0 ** (1 - 2))

    check(torch.equal(k2_library(), q.decode(code, scale, bits=2)),
          "torch.mul(code, scale * 2**(1-bits)) != K2")
    k2_ms, k2_lib, k2_halves, k2_lib_halves = time_in_turns(
        lambda: q.decode(code, scale, bits=2), k2_library)
    k2_plain = time_ms(lambda: q.decode_plain(code, scale, 2))
    del u, code, scale
    planes = (x, g, d, h, hw, qh, wqh)
    hyp = tuple(torch.full((), v, device=dev) for v in (0.5, 1.0, 0.5))
    k3_ms = time_ms(lambda: lu.lead_update(*planes, *hyp))
    k3_plain = time_ms(lambda: lu.lead_update_plain(*planes, *hyp))
    del planes, g, d, h, hw, qh, wqh
    torch.cuda.empty_cache()
    u = torch.rand(ROWS, BLOCK, generator=gen, device=dev)
    k4_ms = time_ms(lambda: q.encode(x, u, bits=2))
    k4_plain = time_ms(lambda: q.encode_plain(x, u, 2))
    k5_ms = time_ms(lambda: sp.randk_encode(x, u, ratio=0.1))
    k5_plain = time_ms(lambda: sp.randk_encode_plain(x, u, 0.1, 1.0 / 0.1))
    n_kept = int((u < 0.1).sum())
    mask = (u < 0.01).to(torch.float32)
    check(torch.equal(torch.mul(x, mask), sp.mask_apply(x, mask)),
          "torch.mul(x, mask) != K6")
    k6_ms, k6_lib, k6_halves, k6_lib_halves = time_in_turns(
        lambda: sp.mask_apply(x, mask), lambda: torch.mul(x, mask))
    k6_plain = time_ms(lambda: sp.mask_apply_plain(x, mask))
    del x, u, mask
    torch.cuda.empty_cache()

    # least device time for the same work: each input read once, each output
    # written once, over the HBM rate; operations over the fp32 rate
    specs = {
        "lead_diff_encode": dict(
            replaces="src/repro/kernels/lead_update.py:90",
            bytes=n * 21 + ROWS * 4 + 4, ops=n * 13, ms=k1_ms,
            plain_ms=k1_plain),
        "quantize_decode": dict(
            replaces="src/repro/kernels/quantize.py:84",
            bytes=n * 5 + ROWS * 4, ops=n + ROWS, ms=k2_ms,
            plain_ms=k2_plain, library_ms=k2_lib,
            library="torch.mul(code, scale * 2**(1-bits))",
            turns=(k2_halves, k2_lib_halves)),
        "lead_update": dict(
            replaces="src/repro/kernels/lead_update.py:49",
            bytes=n * 44 + 12, ops=n * 15, ms=k3_ms, plain_ms=k3_plain),
        "quantize_encode": dict(
            replaces="src/repro/kernels/quantize.py:52",
            bytes=n * 9 + ROWS * 4, ops=n * 8, ms=k4_ms, plain_ms=k4_plain),
        "randk_encode": dict(
            replaces="src/repro/kernels/sparsify.py:49",
            bytes=n * 12, ops=n + n_kept, ms=k5_ms, plain_ms=k5_plain),
        "mask_apply": dict(
            replaces="src/repro/kernels/sparsify.py:76",
            bytes=n * 12, ops=n, ms=k6_ms, plain_ms=k6_plain,
            library_ms=k6_lib, library="torch.mul(x, mask)",
            turns=(k6_halves, k6_lib_halves)),
    }
    sources = {"lead_diff_encode": "lead_kernels.cu",
               "quantize_decode": "lead_kernels.cu",
               "lead_update": "lead_kernels.cu"}
    rows = []
    for name, s in specs.items():
        byte_ms = s["bytes"] / bw * 1e3
        op_ms = s["ops"] / flops * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
                      + sources.get(name, "wire_kernels.cu"),
            "replaces": s["replaces"], "max_abs_err": err[name],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": s.get("library_ms"), "bytes": s["bytes"],
            "achieved_GBps": s["bytes"] / (s["ms"] * 1e-3) / 1e9})
        if "library" in s:
            # timed in turns: the kernel loses when its mean exceeds the
            # library's by more than the larger spread of either side's two
            # medians in this call
            halves, lib_halves = s["turns"]
            spread = max(abs(halves[0] - halves[1]),
                         abs(lib_halves[0] - lib_halves[1]))
            rows[-1].update(
                library=s["library"], ms_turns=halves,
                library_ms_turns=lib_halves,
                loses_to_library=s["ms"] - s["library_ms"] > spread)
    emit({"phase": "kernels", "held_at_rows": [r for _, r in held],
          "timed_rows": ROWS, "block": BLOCK, "hbm_Bps": bw, "kernels": rows})
    return rows


def phase_headline(dev):
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.convex import LinearRegression
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    prob = LinearRegression.generate(torch.Generator(dev).manual_seed(0),
                                     n_agents=8, m=64, d=64, device=dev)
    topo = topology.ring(8)
    mu, L = prob.mu_L
    eta = 1.0 / L
    x_star = prob.x_star

    lead = LEADSim(topology=topo, compressor=QuantizePNorm(bits=2), eta=eta,
                   device=dev)
    cuda_lib.reset_launch_counts()
    tr = run(lead, prob, x_star, iters=300)
    launches = cuda_lib.launch_counts()
    expect_launches(launches, dict.fromkeys(LEAD_KERNELS, 300), "headline")
    dgd = engine_for(topo, None, prob.d, algorithm="dgd", eta=eta, device=dev)
    tr_dgd = run(dgd, prob, x_star, iters=300)
    for t in (tr, tr_dgd):
        check(all(np.isfinite(a).all() for a in t), "headline: non-finite trace")
    ratio = tr.dist[-1] / tr_dgd.dist[-1]
    check(ratio < 1e-3, f"headline: LEAD dist {tr.dist[-1]} is not below "
          f"1e-3 x DGD's {tr_dgd.dist[-1]}")

    # uncompressed LEAD on the card (K3 kernel, cuBLAS mix) against the same
    # run on the CPU (plain versions), which the CPU tests hold against the
    # JAX reference
    cpu_prob = LinearRegression.from_arrays(prob.A, prob.b, prob.lam,
                                            device="cpu")
    runs = [run(LEADSim(topology=topo, eta=eta, device=p.A.device), p,
                x_star.to(p.A.device), iters=100)
            for p in (prob, cpu_prob)]
    # dist falls ~9 decades in 100 steps, below which f32 rounding of the
    # iterates rules: hence trace_gap's norm-space bound
    gap = trace_gap(runs[0], runs[1], "headline: uncompressed LEAD")
    emit({"phase": "headline", "lead_dist": tr.dist[-1],
          "dgd_dist": tr_dgd.dist[-1], "ratio": ratio,
          "bits_saving": tr_dgd.bits_per_agent[-1] / tr.bits_per_agent[-1],
          "launches": launches, "uncompressed_cuda_vs_cpu": gap,
          "mu": mu, "L": L})
    return launches


def phase_lead_at_scale(dev):
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    hyper = dict(eta=0.5, gamma=1.0, alpha=0.5)
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    lead = LEADSim(topology=topology.ring(n), compressor=QuantizePNorm(bits=2),
                   device=dev, **hyper)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    tr = run(lead, prob, prob.x_star, iters=iters)   # ends in one .cpu()
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, dict.fromkeys(LEAD_KERNELS, iters),
                    "lead_at_scale")
    check(all(np.isfinite(a).all() for a in tr), "lead_at_scale: non-finite")
    check(tr.dist[-1] < 1e-2 * tr.dist[0],
          f"lead_at_scale: dist {tr.dist[0]} -> {tr.dist[-1]}")
    check(tr.consensus[-1] < 1e-2 * tr.consensus[0],
          f"lead_at_scale: consensus {tr.consensus[0]} -> {tr.consensus[-1]}")

    # per-stage device time of run() itself: StageTimer records a CUDA event
    # at each stage mark of the step's own code (after the counted run, so
    # its launches are not counted)
    breakdown = stage_breakdown(
        lambda: run(lead, prob, prob.x_star, iters=6), dev, STAGE_NAMES,
        "lead_at_scale")
    emit({"phase": "lead_at_scale", "n": n, "d": d, "iters": iters,
          "ms_per_step": wall * 1e3 / iters, "breakdown_ms": breakdown,
          "breakdown_total_ms": sum(breakdown.values()),
          "max_memory_allocated_GB": peak / 1e9, "launches": launches,
          "dist": [tr.dist[0], tr.dist[-1]],
          "consensus": [tr.consensus[0], tr.consensus[-1]],
          "loss": [tr.loss[0], tr.loss[-1]], "comp_err_last": tr.comp_err[-1]})
    return launches


def phase_fig2(dev):
    """The paper's Fig. 2 on the card (the Motivation table of the port's
    second slice): the port's own logistic-regression problem, x* by 800
    steps of gradient descent, 200 iterations of each algorithm through
    run()."""
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.convex import LogisticRegression
    from repro_torch.core.engines import engine_for, is_exact
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    prob = LogisticRegression.generate(torch.Generator(dev).manual_seed(1),
                                       n_agents=8, m_per_agent=256, d=784,
                                       n_classes=10, heterogeneous=True,
                                       device=dev)
    check(prob.d == FIG2_D, f"fig2: d = {prob.d}")
    x_star = prob.solve_x_star(iters=800)
    topo, q2 = topology.ring(8), QuantizePNorm(bits=2)

    def algo(name, device):
        if name == "lead":
            return LEADSim(topology=topo, compressor=q2, eta=FIG2_ETA,
                           device=device)
        return engine_for(topo, None if is_exact(name) else q2, prob.d,
                          algorithm=name, eta=FIG2_ETA, device=device,
                          **FIG2[name])

    tr, launches = {}, {}
    for name in FIG2:
        cuda_lib.reset_launch_counts()
        tr[name] = run(algo(name, dev), prob, x_star, iters=FIG2_ITERS)
        launches[name] = cuda_lib.launch_counts()
        check(all(np.isfinite(a).all() for a in tr[name]),
              f"fig2: {name} non-finite")
    expect_launches(launches["lead"], dict.fromkeys(LEAD_KERNELS, FIG2_ITERS),
                    "fig2 lead")
    for name in FIG2_COMPRESSED:
        expect_launches(launches[name], {"quantize_encode": FIG2_ITERS,
                                         "quantize_decode": FIG2_ITERS},
                        f"fig2 {name}")
    for name in FIG2_EXACT:
        expect_launches(launches[name], {}, f"fig2 {name}")

    final = {k: {"dist": t.dist[-1], "consensus": t.consensus[-1],
                 "bits_per_agent": t.bits_per_agent[-1]}
             for k, t in tr.items()}
    lead = final["lead"]
    check(lead["dist"] <= 1.01 * final["nids"]["dist"],
          f"fig2: LEAD dist {lead['dist']} > 1.01 x NIDS's "
          f"{final['nids']['dist']}")
    for name in FIG2_COMPRESSED + ("dgd",):
        check(lead["dist"] < final[name]["dist"],
              f"fig2: LEAD dist {lead['dist']} not below {name}'s "
              f"{final[name]['dist']}")
    for name in FIG2_COMPRESSED:
        check(10 * lead["consensus"] <= final[name]["consensus"],
              f"fig2: LEAD consensus {lead['consensus']} not 10x below "
              f"{name}'s {final[name]['consensus']}")
    d = prob.d
    analytic = 32 * d / (3 * d + 32 * -(-d // BLOCK))
    ratio = final["dgd"]["bits_per_agent"] / lead["bits_per_agent"]
    check(abs(ratio / analytic - 1) < 1e-6,
          f"fig2: bit ratio {ratio}, analytic {analytic}")

    # the exact baselines on the card against the same runs on the CPU
    # (plain torch), which the CPU tests hold against the JAX reference
    cpu_prob = LogisticRegression.from_arrays(prob.feats, prob.labels,
                                              prob.n_classes, prob.lam,
                                              device="cpu")
    gaps = {name: trace_gap(tr[name], run(algo(name, "cpu"), cpu_prob,
                                          x_star.cpu(), iters=FIG2_ITERS),
                            f"fig2: {name}")
            for name in FIG2_EXACT}
    emit({"phase": "fig2", "n": prob.n, "d": d, "iters": FIG2_ITERS,
          "eta": FIG2_ETA, "dist0": {k: t.dist[0] for k, t in tr.items()},
          "final": final, "bit_ratio": ratio,
          "lead_consensus_below": {k: final[k]["consensus"]
                                   / lead["consensus"]
                                   for k in FIG2_COMPRESSED},
          "launches": {k: {n: c for n, c in v.items() if c}
                       for k, v in launches.items()},
          "exact_cuda_vs_cpu": gaps})
    return launches


def phase_baselines_at_scale(dev):
    """CHOCO on each compressed wire at the real size: n = 8 ring, d = 2^25
    per agent, the objective of lead_at_scale, 20 steps through run()."""
    from repro_torch.core import topology
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    launches = {}
    for wire, (gamma, kernels, names) in CHOCO_WIRES.items():
        eng = engine_for(topology.ring(n), choco_compressor(wire), d,
                         algorithm="choco", eta=CHOCO_ETA, gamma=gamma,
                         device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run(eng, prob, prob.x_star, iters=iters)   # ends in one .cpu()
        wall = time.perf_counter() - t0
        launches[wire] = cuda_lib.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"baselines_at_scale {wire}"
        expect_launches(launches[wire], dict.fromkeys(kernels, iters), what)
        check(all(np.isfinite(a).all() for a in tr), f"{what}: non-finite")
        check(tr.dist[-1] < tr.dist[0],
              f"{what}: dist {tr.dist[0]} -> {tr.dist[-1]}")
        breakdown = stage_breakdown(
            lambda: run(eng, prob, prob.x_star, iters=6), dev,
            {**CHOCO_STAGES, **names}, what)
        emit({"phase": "baselines_at_scale", "wire": wire,
              "compressor": repr(eng.compressor), "algorithm": "choco",
              "eta": CHOCO_ETA, "gamma": gamma, "n": n, "d": d,
              "iters": iters, "ms_per_step": wall * 1e3 / iters,
              "breakdown_ms": breakdown,
              "breakdown_total_ms": sum(breakdown.values()),
              "max_memory_allocated_GB": peak / 1e9,
              "launches": launches[wire],
              "dist": [tr.dist[0], tr.dist[-1]],
              "consensus": [tr.consensus[0], tr.consensus[-1]],
              "bits_per_agent_per_step": tr.bits_per_agent[-1] / iters,
              "comp_err_last": tr.comp_err[-1]})
        del eng, tr
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s})

    rows = phase_kernels(dev, bw, flops)
    headline = phase_headline(dev)
    fig2 = phase_fig2(dev)
    lead_at_scale = phase_lead_at_scale(dev)
    baselines = phase_baselines_at_scale(dev)
    # launches: each kernel's count on its path at the real size (LEAD's for
    # K1-K3, CHOCO's wire for K4-K6), each path run with the counts at 0
    at_scale = {"quantize_encode": baselines["pinf_2bit"],
                "randk_encode": baselines["randk_0.1"],
                "mask_apply": baselines["topk_0.01"]}
    for r in rows:
        k = r["name"]
        r["launches"] = at_scale.get(k, lead_at_scale)[k]
        r["launches_by_path"] = {
            "lead_at_scale": lead_at_scale[k], "headline": headline[k],
            "fig2": sum(v[k] for v in fig2.values()),
            **{f"baselines_at_scale/{w}": v[k] for w, v in baselines.items()}}
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
