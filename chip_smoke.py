#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper GPU.

    PYTHONPATH=src python3 chip_smoke.py

Builds the kernels from src/repro_torch/csrc, then runs twenty-eight
phases, each printing one JSON line (the at-scale phases one per run); a
failed check exits nonzero.

  env            card name and power limit, torch and CUDA versions, build time
  kernels        K1 lead_diff_encode, K2 quantize decode (each at b = 2, 4, 7)
                 and K3 lead_update held bit for bit against their plain
                 PyTorch versions at every shape of LEAD's path: the
                 headline's and Fig. 1's (8 rows, d = 64 and d = 200
                 zero-padded to one block per agent) and the real size's (8
                 agents x 65,536 rows of 512); K4 quantize encode (b = 2, 4,
                 7), K5 randk encode (ratio 0.1, rescale on and off) and K6
                 mask apply likewise at every shape of the baselines' and
                 the tree path's wire: Fig. 2's (8 agents x 16 blocks, d =
                 7,840 zero-padded), Fig. 1's (8 rows) and the real size's;
                 then
                 every kernel timed at the real size with CUDA events (10
                 launches back to back) against its byte bound, and K2 and
                 K6 in turns with the one PyTorch call that computes each
                 (kernel, library, library, kernel)
  blocks         K1, K4 and K2 at block widths 1, 3, 16, 100, 256, 512, 1024
                 and 4096 (512 is the float4 hot path, every other width the
                 strided routine), b = 2, 4 and 7, each bit-identical to its
                 plain version with one launch per call; then K1, K4 and K2
                 timed at 2^28 elements in blocks of 16, 256 and 512, the 512
                 rows held within 5% of the hot path's recorded times on a
                 700 W card (below 700 W the check is skipped, and the
                 kernels line and the standard error say so)
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
  fig1           the paper's Fig. 1 on the card through the tree path: ring-8
                 linear regression (m = d = 200), eta 0.05, 300 iterations of
                 tree LEAD, flat LEAD, NIDS, DGD, CHOCO, DeepSqueeze and QDGD
                 (the baselines are the tree algorithms); the reference's
                 ordering checked, tree LEAD through K4 and K2 once per step
                 and never K1 or K3, and NIDS and DGD held against the same
                 runs on the CPU; then each tree compressor's per-agent
                 compress (p=inf 2-bit, RandK 0.1, TopK 0.01) at n = 8, d =
                 200 held bit for bit against the CPU's on the same input
                 and draws
  lead_at_scale  LEAD's path at real size: n = 8 agents, d = 2^25 f32
                 parameters each, 2-bit LEAD for 20 steps through run(), then
                 a per-stage breakdown of run() itself from CUDA events at
                 its stage marks (core/stage_timer.py)
  baselines_at_scale
                 the baselines' path at the same size: CHOCO for 20 steps on
                 each compressed wire - the 2-bit quantizer (K4, K2), RandK
                 (K5) and exact TopK (K6) - with its ms/step, peak memory and
                 stage breakdown
  tree_at_scale  the tree path at the same size, 20 steps after one warm-up
                 step: tree LEAD and tree CHOCO on the 2-bit quantizer (K4,
                 K2 once per step; K1 and K3 never), tree CHOCO on RandK
                 (K5) and exact TopK (K6), each with its ms/step, peak memory
                 and stage breakdown; then the per-agent compress held
                 against the CPU as in fig1, at n = 8, d = 2^25
  fig3           the paper's Fig. 3 on the card: fig2's problem with minibatch
                 gradients of 64 samples (run(stochastic=True)), 200
                 iterations of LEAD on its default (tree) engine and the flat
                 one, flat LEAD on the Theorem-2 schedule, and the tree NIDS,
                 DGD, CHOCO, QDGD and DeepSqueeze; the reference's ordering
                 checked, tree LEAD through K4 and K2 once per step and flat
                 LEAD through K1-K3, and NIDS and DGD held against the same
                 runs (the same batch indices) on the CPU
  faults_at_scale
                 fault injection at the real size (lead_at_scale's objective,
                 one warm-up step, 20 steps): flat LEAD under an inactive
                 fault model (its trace must be lead_at_scale's, bit for
                 bit), under 10% link drops on dense and on neighbor gossip,
                 and clean on neighbor gossip; flat CHOCO on neighbor gossip,
                 clean and under agent outages served from the stale cache;
                 the fault fields held to the CPU's step_metrics, each
                 faulted run's device stage sum within 15% of its clean
                 twin's; then uncompressed faulted LEAD at d = 2,048 on the
                 card against the same run on the CPU
  oracle_at_scale
                 the noisy oracle at the real size: flat LEAD through
                 run(noise_std=0.1) for 20 steps (dist falls 10x), and one
                 seed's Gaussian plane on the card within 4 ulp of the CPU's
  bank_at_scale  time-varying gossip at the real size (lead_at_scale's
                 objective, one warm-up step, 20 steps): 2-bit LEAD on
                 exponential_onepeer(8) (period 3) on neighbor and dense
                 gossip (K1-K3 once per step), CHOCO on the 2-bit wire over
                 random_matching(8, seed=0) (K4, K2), and LEAD on that bank
                 under 10% link drops (its fault fields the CPU's exactly)
  hier_at_scale  2-bit LEAD on hierarchical(ring(4), 2) with gossip="hier",
                 clean and under 10% link drops: K4, K2 and K3 once per
                 step and K1 never, bits exactly lead_at_scale's over 2
  interval_at_scale
                 2-bit LEAD on ring(8).with_interval(4), clean and under
                 10% link drops: K1-K3 on 5 of the 20 steps, bits exactly
                 lead_at_scale's over 4, comp_err and link metrics 0 on the
                 skipped steps
                 Each run of these three phases prints its ms/step, stage
                 breakdown and peak memory; its configuration also runs at
                 d = 4,096 for 50 steps on the card and on the CPU, the two
                 traces held by the CPU tests' bound, and the CPU run
                 predicts the factors by which the run's dist and
                 consensus move in 20 steps (held within 2x)
  multiwire_at_scale
                 CEDAS on random_matching(8) and C-GT, the two-wire engine,
                 on exponential_onepeer(8) and on ring(8) under 10% link
                 drops, at the real size with 2-bit p=inf on neighbor
                 gossip (one warm-up step, 20 steps): K4 and K2 once per
                 step for CEDAS and twice for C-GT, K1 and K3 never; C-GT's
                 bits exactly twice the same graph's single-wire run's; its
                 tracker sum (sum s == sum g_prev) held at every step; each
                 configuration at d = 4,096 on the card against the CPU as
                 above; each run's ms/step, stage sums and peak memory
  train_small    the decentralized LM trainer (dist/trainer.py) on the card
                 against the CPU, for every family at .reduced() size:
                 granite-3-2b (d_ff 341: padded leaves), granite-moe and
                 kimi-k2 (MoE), xlstm-1.3b at 6 layers (mLSTM and sLSTM),
                 recurrentgemma-2b at 3 (RG-LRU and local attention),
                 llama-3.2-vision (gated cross-attention to the vision
                 stub) and whisper-tiny (the audio encoder and its frame
                 stub); 4 agents on ring(4), batch 2 x seq 32, the same
                 weights, batches and memory on both; uncompressed LEAD (K3)
                 and NIDS over 5 steps, params, each agent's loss and
                 grad_norm within 1e-4; 2-bit LEAD one step from the same
                 state, the share of differing codes below 1e-5 and the
                 bits exact; an MoE's tokens whose experts differ from the
                 CPU's counted (the bounds held on the steps before the
                 first); one line per arch
  ranks_small    the trainer's rank path (dist/trainer.py on
                 torch.distributed) on train_small's reduced granite, 4
                 agents, 10 steps, in a one-rank NCCL group (every round
                 local) against the no-group path on the card: LEAD 2-bit,
                 allreduce and LEAD on hierarchical(ring(2), 2), bit for
                 bit, K4 = K2 = K3 = one per leaf per step; on a machine
                 with two or more cards also one rank per card (2 or 4
                 ranks, chip_smoke.py --rank-worker), held against the
                 one-rank run, and train_at_scale's granite at one agent
                 per card timed with the bytes handed to isend; with one
                 card the line says the cross-card run was not made
  train_at_scale, moe_at_scale, recurrent_at_scale, audio_at_scale
                 the trainer at each arch's published width, one function
                 over TRAIN_AT_SCALE: granite-3-2b cut to 2 layers (12
                 leaves, 322,983,936 parameters per agent, 4 agents),
                 granite-moe-1b-a400m cut to 4 layers (32 experts top-8,
                 13 leaves, 314,719,232, 4 agents), xlstm-1.3b cut to one
                 pattern period of 6 layers (60 leaves, 427,151,400, 2
                 agents on ring(2)), whisper-tiny whole (4 encoder and 4
                 decoder layers, 1,500 stub frames, 51 leaves, 56,357,380, 4
                 agents); 2-bit LEAD in blocks of 512, SGD at eta 0.03
                 (xLSTM: Adam at 1e-3), batch 2 x seq 128, one warm-up step
                 and 10 timed: K4 = K2 = K3 = one per leaf and K1 = K5 = K6
                 = 0, the bits exactly the pinned count per agent and step,
                 the loss falling, the dual sum below 1e-3 x 0.03 / eta,
                 peak allocated below 75 GB; each with
                 its ms/step, stage sums, gradient FLOP/s and peak memory,
                 and the MoE's routing (pairs dropped, heaviest expert);
                 train_at_scale's granite again through the rank path in
                 a one-rank NCCL group (train_at_scale/ranks): the same
                 steps, its ms/step beside the no-group path's, the final
                 state bit for bit
  ckpt_at_scale  checkpoint and resume: whisper-tiny whole, 4 agents, 2-bit
                 LEAD, 2 steps, the 3.6 GB state saved (repro_torch
                 .checkpoint, the reference's npz format), restored into a
                 fresh state and run 2 more steps: bit for bit the
                 straight 4-step run; the file's GB, save and restore
                 seconds; then the same through the trainer's rank path
                 in a one-rank NCCL group (ckpt_at_scale/ranks), the file
                 written and read through its layout: equal to the first
                 file leaf for leaf, resumed bit for bit, and the device
                 memory save and restore allocate above the live state at
                 most the largest stacked leaf's bytes
  serve_small    serving (serve/, the models' prefill and decode) on the
                 card against the CPU for every registry arch at .reduced()
                 size (xlstm at 6 layers, recurrentgemma at 3): a 20-token
                 prompt at B = 2, 24 decode steps on the contiguous path
                 with an f32 and a bf16 cache, logits within 1e-4 / 1e-3
                 of the largest |logit|; for granite-3-2b, gemma3-12b and
                 granite-moe-1b-a400m also the exact paged cache against
                 the contiguous one on the card, bit for bit (gemma for
                 150 steps, its rings wrapping), and 4-bit pages on both
                 devices, codes differing below 1e-5, K4 and K2 twice per
                 layer per step; one line per arch
  serve_at_scale, serve_rolling_at_scale
                 the whole granite-3-2b (40 layers, 2,634,201,088 f32
                 parameters) and the whole gemma3-12b (48 layers, 40 local
                 with window 1,024 and 8 global; 12,630,470,400), weights
                 drawn on the card, served through launch/serve.py's
                 serve_requests by the engine at 4-bit pages
                 (max_len 2,048, page 16, block 512): 32 requests of
                 64-768 tokens on 16 lanes, 128 new tokens each; 6 of
                 1,040-1,500 tokens on 4 lanes (every ring wraps in
                 prefill), 48 new each; K4 = K2 = two per layer in every
                 decode step and prefill chunk, K1, K3, K5, K6 never;
                 bits/elem 5.0625; peak below 75 GB; each with its decode
                 ms per step and prefill ms per chunk (CUDA events), its
                 tokens/s and its cache report; then the exact engine on
                 the first 4 / 1 requests against the contiguous
                 single-sequence path (equal up to a near-tie)
  serve_at_scale/ranks
                 granite-3-2b whole through dist/serve.py in a one-rank
                 NCCL group: 16 lanes of a 256-token prompt, make_prefill,
                 paged_from_rows and 32 steps of make_paged_decode's fn
                 (4-bit pages, block 512, a 2,048-token cache; one
                 all-gather of the written page rows per layer) in
                 lockstep with the no-group prefill and decode_step:
                 logits, greedy tokens and pools bit for bit at every
                 step, K4 = K2 = 80 per decode step; each path's ms per
                 step and the bytes gathered per step; with 2 or 4 cards
                 also one rank per card (chip_smoke.py
                 --serve-rank-worker): every rank's pools identical, each
                 lane's greedy stream the one-card run's up to a near-tie
  moe_ep_at_scale
                 granite-moe-1b-a400m whole (24 layers, 32 experts top-8)
                 with moe_ep_axis "data": 16 lanes of a 256-token prompt
                 through make_prefill (the expert-parallel all-to-all
                 dispatch, models/moe_ep.py) in a one-rank NCCL group
                 against the no-group prefill, logits and cache bit for
                 bit, the all_to_all_single bytes as counted, ms per
                 prefill; the pairs each of the ep path and the plain MoE
                 drops at capacity factor 1.25; at 8.0 (nothing drops) the
                 ep path's logits within 1e-4 of the plain MoE's; at 0.5
                 (both capacities drop) the group path bit for bit against
                 the no-group path on 4 lanes, the drops a count of each
                 bin's overflow; then
                 paged_from_rows and 4 steps of make_paged_decode's fn
                 (the plain MoE routing the whole batch) bit for bit
                 against the no-group path, K4 = K2 = 48 per step; with 2
                 or 4 cards also one rank per card (chip_smoke.py
                 --moe-ep-rank-worker: each rank its lanes and its block
                 of experts)

The script's seconds and the card's name and power limit are printed
before the kernels line.  The line before the last lists every kernel
with its launches on the main path, its error against the plain version
and its times; the last line is {"ok": true, "device": {...}}.  Without
a CUDA device the script exits nonzero before printing anything.
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
FIG1_D = 200                # Fig. 1's parameters per agent (one block)
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


# block widths held bit for bit (blocks phase), and those timed at 2^28
# elements; the recorded times of the 512-wide hot path (PERF.md, NVIDIA
# H100 80GB HBM3, 700 W), held within 5% on a 700 W card
BLOCKS = (1, 3, 16, 100, 256, 512, 1024, 4096)
TIMED_BLOCKS = (16, 256, 512)
HOT_PATH_MS = {"lead_diff_encode": 1.827, "quantize_encode": 0.775}

# Fig. 1: benchmarks/bench_linreg.py's run (ring 8, m = d = 200, lam 0.1,
# eta 0.05, 300 iterations, 2-bit p=inf in blocks of 512)
FIG1_ITERS = 300
FIG1_ETA = 0.05

# the tree path at scale: (run, kernels it launches, its stage names)
TREE_RUNS = {
    "lead_pinf_2bit": (("quantize_encode", "quantize_decode"),
                       {"dither": "dither", "encode": "K4_encode",
                        "decode": "K2_decode"}),
    "choco_pinf_2bit": (("quantize_encode", "quantize_decode"),
                        {"dither": "dither", "encode": "K4_encode",
                         "decode": "K2_decode"}),
    "choco_randk_0.1": (("randk_encode",),
                        {"dither": "dither", "encode": "K5_randk_encode"}),
    "choco_topk_0.01": (("mask_apply",),
                        {"topk_mask": "topk_mask",
                         "encode": "K6_mask_apply"}),
}
TREE_STAGES = {"gradient": "gradient", "message": "message",
               "mix": "dense_mix", "update": "update",
               "comp_err": "comp_err", "metrics": "metrics"}


# Fig. 3: benchmarks/bench_logreg.py's fig3_het_minibatch (Fig. 2's problem
# and hypers, minibatch gradients of 64 samples, 200 iterations); LEAD on
# its default (tree) engine and the flat one, flat LEAD on the Theorem-2
# schedule eta / (1 + 0.01 k), and the tree baselines
FIG3_ITERS = 200
FIG3_BATCH = 64
FIG3_COMPRESSED = ("choco", "qdgd", "deepsqueeze")

# faults_at_scale: lead_at_scale's objective and hypers; the fault models
# of the reference's measurements (10% link drops; 20% agent outages in
# windows of 5 steps served from the stale cache) and an inactive model
LEAD_HYPER = dict(eta=0.5, gamma=1.0, alpha=0.5)
LINK_DROP = dict(seed=0, link_drop=0.1)
STALE = dict(seed=6, agent_drop=0.2, dropout_window=5, policy="stale")
# run: (algorithm, gossip, fault model or None, its clean twin)
# (each twin runs before the runs held against it)
FAULT_RUNS = {
    "lead_inactive": ("lead", "dense", dict(seed=0), None),
    "lead_faulted_dense": ("lead", "dense", LINK_DROP, "lead_inactive"),
    "lead_clean_neighbor": ("lead", "neighbor", None, None),
    "lead_faulted_neighbor": ("lead", "neighbor", LINK_DROP,
                              "lead_clean_neighbor"),
    "choco_clean_neighbor": ("choco", "neighbor", None, None),
    "choco_stale_neighbor": ("choco", "neighbor", STALE,
                             "choco_clean_neighbor"),
}
# bank_at_scale, hier_at_scale, interval_at_scale: lead_at_scale's
# objective and hypers (CHOCO: baselines_at_scale's on the 2-bit wire);
# run: (algorithm, topology, gossip, fault model or None, the kernels it
# launches, the interval: each kernel launches once per communicating step)
NEW_PATHS = {
    "bank_at_scale": {
        "lead_onepeer_neighbor": ("lead", lambda t: t.exponential_onepeer(8),
                                  "neighbor", None, LEAD_KERNELS, 1),
        "lead_onepeer_dense": ("lead", lambda t: t.exponential_onepeer(8),
                               "dense", None, LEAD_KERNELS, 1),
        "choco_matching": ("choco", lambda t: t.random_matching(8, seed=0),
                           "neighbor", None,
                           ("quantize_encode", "quantize_decode"), 1),
        "lead_matching_faulted": ("lead",
                                  lambda t: t.random_matching(8, seed=0),
                                  "neighbor", LINK_DROP, LEAD_KERNELS, 1),
    },
    "hier_at_scale": {   # K1 never: the node mean comes before the encode
        "lead_hier": ("lead", lambda t: t.hierarchical(t.ring(4), 2), "hier",
                      None, ("quantize_encode", "quantize_decode",
                             "lead_update"), 1),
        "lead_hier_faulted": ("lead", lambda t: t.hierarchical(t.ring(4), 2),
                              "hier", LINK_DROP,
                              ("quantize_encode", "quantize_decode",
                               "lead_update"), 1),
    },
    "interval_at_scale": {
        "lead_interval": ("lead", lambda t: t.ring(8).with_interval(4),
                          "dense", None, LEAD_KERNELS, 4),
        "lead_interval_faulted": ("lead",
                                  lambda t: t.ring(8).with_interval(4),
                                  "dense", LINK_DROP, LEAD_KERNELS, 4),
    },
}
NEW_STAGES = {"bank_at_scale": {"round_mix": "round_mix"},
              "hier_at_scale": {"intra_project": "intra_project"},
              "interval_at_scale": {"local": "local_step"}}
# multiwire_at_scale: CEDAS and C-GT on the 2-bit wire over neighbor
# gossip, lead_at_scale's objective; run: (algorithm, topology, fault
# model or None, hypers, K4 and K2 launches per step).  Hypers chosen on
# the CPU at d = 2^14, where each run's dist falls in 20 steps (C-GT under
# drops stalls, in the reference as in the port: dist 1.8e3 -> 6.3e2)
MULTIWIRE_RUNS = {
    "cedas_matching": ("cedas", lambda t: t.random_matching(8, seed=0), None,
                       dict(eta=0.5, gamma=0.5, alpha=0.5), 1),
    "cgt_onepeer": ("cgt", lambda t: t.exponential_onepeer(8), None,
                    dict(eta=0.1, gamma=0.5, alpha=0.5), 2),
    "cgt_ring_faulted": ("cgt", lambda t: t.ring(8), LINK_DROP,
                         dict(eta=0.1, gamma=0.5, alpha=0.5), 2),
}
MULTIWIRE_STAGES = {"gradient": "gradient", "message": "message",
                    "dither": "dither", "encode": "K4_encode",
                    "decode": "K2_decode", "update": "update",
                    "comp_err": "comp_err", "metrics": "metrics"}
TRACKER_RTOL = 1e-4         # |sum s - sum g_prev| <= 1e-4 (1 + max |g_prev|)
SMALL_D, SMALL_ITERS = 4096, 50   # each new run's configuration held to the
                                  # CPU's, which also predicts its factors
PREDICT_TOL = 2.0           # at-scale factor within 2x of the predicted
TWIN_RTOL = 0.15            # faulted stage sum within 15% of its twin's
SMALL_FAULT_D = 2048        # the faulted run held against the CPU
ORACLE_NOISE = 0.1


def choco_compressor(wire):
    from repro_torch.core.compression import QuantizePNorm, RandK, TopK
    return {"pinf_2bit": QuantizePNorm(bits=2),
            "randk_0.1": RandK(ratio=0.1, rescale=False),
            "topk_0.01": TopK(ratio=0.01)}[wire]


# the H100 SXM's data sheet (dense): HBM bytes/s, fp32 non-tensor flop/s
H100_SXM = ("H100 80GB HBM3", 3.35e12, 67e12)


PHASE_SECONDS = {}
_LAST_EMIT = [time.perf_counter()]


def emit(obj):
    """Print obj as one JSON line; the host seconds since the previous
    line go to its phase's entry of PHASE_SECONDS."""
    now = time.perf_counter()
    if "phase" in obj:
        name = obj["phase"]
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) \
            + now - _LAST_EMIT[0]
    _LAST_EMIT[0] = now
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


def stage_breakdown(run_fn, dev, names, what, per_step=False):
    """Median ms per stage of run_fn() under core/stage_timer.py, step 0
    dropped as warm-up; `names` maps each mark to what it runs and must
    cover every stage.  With per_step, also the mean device ms of a step
    (every stage of the steps after the first, over their count): the
    measure of a run whose steps differ, as an interval's do."""
    from repro_torch.core.stage_timer import StageTimer

    with StageTimer(dev) as timer:
        run_fn()
    stages = timer.stages()
    first = [name for name, _ in stages].index("metrics") + 1
    acc = {}
    for name, ms in stages[first:]:
        acc.setdefault(names.get(name, name), []).append(ms)
    check(set(acc) == set(names.values()), f"{what}: stages {sorted(acc)}")
    medians = {s: statistics.median(v) for s, v in acc.items()}
    if not per_step:
        return medians
    steps = len(acc[names["metrics"]])
    return medians, sum(ms for _, ms in stages[first:]) / steps


class Quadratic:
    """f_i(x) = 0.5 ||x - t_i||^2, x* = mean_i t_i: the objective that
    benchmarks/bench_lead_step.py drives at scale (a local copy)."""

    def __init__(self, gen, n, d, device, targets=None):
        self.T = (torch.randn((n, d), generator=gen, device=device)
                  if targets is None else targets.to(device))
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
    u_keep = eng._rows(_rows_to_flat(eng.unblockify(plane), eng.nb, BLOCK,
                                     value=1.0))
    mask = eng._rows(_rows_to_flat(
        TopK(ratio=0.01)._mask_rows(eng.unblockify(buf)), eng.nb, BLOCK))
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


def hold_tree_against_cpu(dev, d):
    """The tree path's per-agent compress of each compressor that the tree
    runs use - p=inf 2-bit (K4 then K2), RandK(0.1) with and without the
    rescale (K5) and exact TopK(0.01) (K6) - on n = 8 agents of dimension
    d on the card, held bit for bit against the same compress on the CPU
    (the plain versions) for the same X and the same draws: the padding to
    whole blocks, the kernel and the way back to the agents' shape.  X is
    standard normal, then rounded to integers so that TopK's threshold
    ties.  Each card call must launch its kernels once.  Returns, per
    compressor, the card's launches and the seconds the CPU side took."""
    from repro_torch.core.compression import (QuantizePNorm, RandK, TopK,
                                              agent_draws)
    from repro_torch.kernels import cuda_lib

    comps = {"pinf_2bit": (QuantizePNorm(bits=2),
                           ("quantize_encode", "quantize_decode")),
             "randk_0.1": (RandK(ratio=0.1, rescale=False), ("randk_encode",)),
             "randk_0.1_rescaled": (RandK(ratio=0.1), ("randk_encode",)),
             "topk_0.01": (TopK(ratio=0.01), ("mask_apply",))}
    gen = torch.Generator(dev).manual_seed(d + 2)
    X = torch.randn((8, d), generator=gen, device=dev)
    out = {}
    for name, (comp, kernels) in comps.items():
        cpu_s = 0.0
        for kind, x in (("normal", X), ("tied", torch.round(X))):
            what = f"tree compress {name} {kind} n=8 d={d}"
            draws = agent_draws(comp, x, seed=d)
            before = cuda_lib.launch_counts()
            card = comp.compress_agents(x, **draws)
            after = cuda_lib.launch_counts()
            launched = {k: after[k] - before[k] for k in after}
            check(launched == {k: int(k in kernels) for k in after},
                  f"{what}: launched {launched}")
            t0 = time.perf_counter()
            plain = comp.compress_agents(
                x.cpu(), **{k: v.cpu() for k, v in draws.items()})
            cpu_s += time.perf_counter() - t0
            n_diff = int((card.cpu() != plain).sum())
            check(card.shape == x.shape and n_diff == 0,
                  f"{what}: {n_diff} entries differ from the CPU's")
            del draws, card, plain
        out[name] = {"launches_per_call": {k: 1 for k in kernels},
                     "cpu_s": cpu_s}
    del X
    torch.cuda.empty_cache()
    return out


def phase_kernels(dev, bw, flops):
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import sparsify as sp

    # bit-identity at every shape of each path: LEAD's (the headline's d =
    # 64 and Fig. 1's d = 200, one zero-padded block per agent, 8 rows), the
    # baselines' and the tree path's wire (Fig. 2's d = 7,840, 16 blocks per
    # agent, 128 rows; Fig. 1's d = 200, 8 rows), and the real size's
    held = []
    for hold, ds in ((hold_against_plain, (HEADLINE_D, FIG1_D, D_SCALE)),
                     (hold_wire_against_plain, (FIG2_D, FIG1_D, D_SCALE))):
        for d in ds:
            err_d, rows_d = hold(dev, d)
            held.append((err_d, rows_d, d))
            torch.cuda.empty_cache()
    err = {k: max(e[k] for e, _, _ in held if k in e)
           for e, _, _ in held for k in e}
    real = [r for _, r, d in held if d == D_SCALE]
    check(real == [ROWS, ROWS], f"real-size rows {real} != {ROWS}")

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
    emit({"phase": "kernels",
          "held_at": [{"d": d, "rows": r} for _, r, d in held],
          "timed_rows": ROWS, "block": BLOCK, "hbm_Bps": bw, "kernels": rows})
    return rows


def phase_blocks(dev, bw, flops, power_w):
    """K1, K4 and K2 at every block width of BLOCKS against their plain
    versions (bit-identical, one launch per call), then timed at 2^28
    elements for TIMED_BLOCKS."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import lead_update as lu
    from repro_torch.kernels import quantize as q

    def once(name, fn):
        """fn() with a check that it launched `name` once and nothing else."""
        before = cuda_lib.launch_counts()
        out = fn()
        after = cuda_lib.launch_counts()
        check({k: after[k] - before[k] for k in after}
              == {k: int(k == name) for k in after},
              f"blocks: {name} launched {after} after {before}")
        return out

    held = {}
    for block in BLOCKS:
        rows = max(8, (1 << 20) // block)
        gen = torch.Generator(dev).manual_seed(block)
        x, g, d, h = (torch.randn(rows, block, generator=gen, device=dev)
                      for _ in range(4))
        x[1] = 0.0                              # a zero row stays zero
        u = torch.rand(rows, block, generator=gen, device=dev)
        eta = torch.full((), 0.07, device=dev)
        for bits in (2, 4, 7):
            where = f"block={block} rows={rows} b={bits}"
            c1, s1 = once("quantize_encode", lambda: q.encode(x, u, bits=bits))
            c2, s2 = q.encode_plain(x, u, bits)
            check(torch.equal(c1, c2) and torch.equal(s1, s2),
                  f"K4 {where}: {int((c1 != c2).sum())} codes, "
                  f"{int((s1 != s2).sum())} scales differ")
            check(float(s1[1]) == 0.0 and not bool(c1[1].any()),
                  f"K4 {where}: the zero row is not zero")
            k1, t1 = once("lead_diff_encode", lambda: lu.lead_diff_encode(
                x, g, d, h, u, eta, bits=bits))
            k2, t2 = lu.lead_diff_encode_plain(x, g, d, h, u, eta, bits)
            check(torch.equal(k1, k2) and torch.equal(t1, t2),
                  f"K1 {where}: {int((k1 != k2).sum())} codes, "
                  f"{int((t1 != t2).sum())} scales differ")
            o1 = once("quantize_decode", lambda: q.decode(c1, s1, bits=bits))
            e = max_abs(o1, q.decode_plain(c1, s1, bits))
            check(e == 0.0, f"K2 {where}: max |kernel - plain| = {e}")
        held[block] = rows
        del x, g, d, h, u
    torch.cuda.empty_cache()

    n = ROWS * BLOCK
    timed = {}
    for block in TIMED_BLOCKS:
        rows = n // block
        gen = torch.Generator(dev).manual_seed(block)
        x, g, d, h = (torch.randn(rows, block, generator=gen, device=dev)
                      for _ in range(4))
        u = torch.rand(rows, block, generator=gen, device=dev)
        eta = torch.full((), 0.07, device=dev)
        code, scale = q.encode(x, u, bits=2)
        specs = {
            "lead_diff_encode": (lambda: lu.lead_diff_encode(
                x, g, d, h, u, eta, bits=2), n * 21 + rows * 4 + 4, n * 13),
            "quantize_encode": (lambda: q.encode(x, u, bits=2),
                                n * 9 + rows * 4, n * 8),
            "quantize_decode": (lambda: q.decode(code, scale, bits=2),
                                n * 5 + rows * 4, n + rows),
        }
        for name, (fn, nbytes, ops) in specs.items():
            ms = time_ms(fn)
            bound = max(nbytes / bw, ops / flops) * 1e3
            timed[f"{name}/{block}"] = {"ms": ms, "bound_ms": bound,
                                        "share_of_bound": bound / ms}
        del x, g, d, h, u, code, scale
        torch.cuda.empty_cache()
    # the recorded times are a 700 W card's: a card capped below runs slower
    # under load, so there the check is skipped, and the kernels line and
    # the standard error say so
    hot_path = {}
    for name, ms in HOT_PATH_MS.items():
        got = timed[f"{name}/512"]["ms"]
        hot_path[name] = {"ms_512": got, "recorded_ms": ms,
                          "held_within_5pct": power_w >= 700.0}
        if power_w >= 700.0:
            check(got <= 1.05 * ms, f"blocks: {name} at 512 takes {got} ms, "
                  f"more than 5% over the recorded {ms}")
        else:
            hot_path[name]["skipped_because"] = (
                f"power limit {power_w} W < the recorded card's 700 W")
            print(f"chip_smoke: {name} at 512 ({got} ms) NOT held to the "
                  f"recorded {ms} ms: the card's power limit is {power_w} W",
                  file=sys.stderr, flush=True)
    emit({"phase": "blocks", "held_rows": held, "bits": [2, 4, 7],
          "timed_elements": n, "timed": timed, "hot_path_512": hot_path})
    return hot_path


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
                   engine="flat", device=dev)
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
    runs = [run(LEADSim(topology=topo, eta=eta, engine="flat",
                        device=p.A.device), p,
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
                   engine="flat", device=dev, **hyper)
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
    return launches, tr


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
                           engine="flat", device=device)
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


def bits_to_reach(tr, level):
    """Cumulative bits per agent at the first recorded step whose dist is
    below `level` (inf if none is)."""
    hit = np.nonzero(tr.dist < level)[0]
    return float(tr.bits_per_agent[hit[0]]) if len(hit) else float("inf")


def phase_fig1(dev):
    """The paper's Fig. 1 on the card (benchmarks/bench_linreg.py's
    configuration) through the tree path, on the port's own problem."""
    from repro_torch.core import topology
    from repro_torch.core.baselines import (CHOCO_SGD, DGD, NIDS, QDGD,
                                            DeepSqueeze)
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.convex import LinearRegression
    from repro_torch.core.gossip import DenseGossip
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    prob = LinearRegression.generate(torch.Generator(dev).manual_seed(0),
                                     n_agents=8, m=200, d=200, lam=0.1,
                                     device=dev)
    x_star = prob.x_star
    q2 = QuantizePNorm(bits=2, block=512)

    def algo(name, device):
        g = DenseGossip.from_topology(topology.ring(8), device)
        lead = dict(compressor=q2, eta=FIG1_ETA, gamma=1.0, alpha=0.5)
        return {
            "lead_tree": lambda: LEADSim(gossip=g, engine="tree", **lead),
            "lead_flat": lambda: LEADSim(gossip=g, engine="flat", **lead),
            "nids": lambda: NIDS(gossip=g, eta=FIG1_ETA),
            "dgd": lambda: DGD(gossip=g, eta=FIG1_ETA),
            "choco": lambda: CHOCO_SGD(gossip=g, compressor=q2, eta=FIG1_ETA,
                                       gamma=0.8),
            "deepsqueeze": lambda: DeepSqueeze(gossip=g, compressor=q2,
                                               eta=FIG1_ETA, gamma=0.2),
            "qdgd": lambda: QDGD(gossip=g, compressor=q2, eta=FIG1_ETA,
                                 gamma=0.2),
        }[name]()

    names = ("lead_tree", "lead_flat", "nids", "dgd", "choco", "deepsqueeze",
             "qdgd")
    tr, launches = {}, {}
    for name in names:
        cuda_lib.reset_launch_counts()
        tr[name] = run(algo(name, dev), prob, x_star, iters=FIG1_ITERS)
        launches[name] = cuda_lib.launch_counts()
        check(all(np.isfinite(a).all() for a in tr[name]),
              f"fig1: {name} non-finite")
    expect_launches(launches["lead_tree"],
                    {"quantize_encode": FIG1_ITERS,
                     "quantize_decode": FIG1_ITERS}, "fig1 lead_tree")
    expect_launches(launches["lead_flat"],
                    dict.fromkeys(LEAD_KERNELS, FIG1_ITERS), "fig1 lead_flat")
    for name in ("choco", "deepsqueeze", "qdgd"):
        expect_launches(launches[name], {"quantize_encode": FIG1_ITERS,
                                         "quantize_decode": FIG1_ITERS},
                        f"fig1 {name}")
    for name in ("nids", "dgd"):
        expect_launches(launches[name], {}, f"fig1 {name}")

    final = {k: t.dist[-1] for k, t in tr.items()}
    bits = {k: bits_to_reach(t, 1e-6) for k, t in tr.items()}
    lead = final["lead_tree"]
    check(lead <= 1e-3 * final["dgd"],
          f"fig1: tree LEAD dist {lead} > 1e-3 x DGD's {final['dgd']}")
    check(bits["lead_tree"] <= bits["nids"] / 5,
          f"fig1: tree LEAD reaches 1e-6 on {bits['lead_tree']} bits, more "
          f"than 1/5 of NIDS's {bits['nids']}")
    for name in ("dgd", "choco", "qdgd", "deepsqueeze"):
        check(final[name] > 1e-2, f"fig1: {name} ends at {final[name]}")

    # the exact runs on the card against the same runs on the CPU (plain
    # torch), which the CPU tests hold against the JAX reference
    cpu_prob = LinearRegression.from_arrays(prob.A, prob.b, prob.lam,
                                            device="cpu")
    gaps = {name: trace_gap(tr[name], run(algo(name, "cpu"), cpu_prob,
                                          x_star.cpu(), iters=FIG1_ITERS),
                            f"fig1: {name}")
            for name in ("nids", "dgd")}
    check(prob.d == FIG1_D, f"fig1: d = {prob.d}")
    tree_compress = hold_tree_against_cpu(dev, FIG1_D)
    emit({"phase": "fig1", "n": prob.n, "d": prob.d, "iters": FIG1_ITERS,
          "eta": FIG1_ETA, "final_dist": final, "bits_to_1e-6": bits,
          "lead_over_dgd": lead / final["dgd"],
          "nids_bits_over_lead": bits["nids"] / bits["lead_tree"],
          "consensus": {k: t.consensus[-1] for k, t in tr.items()},
          "comp_err_last": {k: t.comp_err[-1] for k, t in tr.items()},
          "launches": {k: {n: c for n, c in v.items() if c}
                       for k, v in launches.items()},
          "exact_cuda_vs_cpu": gaps,
          "tree_compress_cuda_equals_cpu": tree_compress})
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


def phase_tree_at_scale(dev):
    """The tree path at the real size: n = 8 ring, d = 2^25 per agent, the
    objective of lead_at_scale; tree LEAD (its hypers) and tree CHOCO (eta
    0.01, the gammas of baselines_at_scale) on each compressed wire, one
    warm-up step, then 20 steps through run()."""
    from repro_torch.core import topology
    from repro_torch.core.baselines import CHOCO_SGD
    from repro_torch.core.gossip import DenseGossip
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    gossip = DenseGossip.from_topology(topology.ring(n), dev)

    def algo(name):
        if name == "lead_pinf_2bit":
            return LEADSim(gossip=gossip, compressor=QuantizePNorm(bits=2),
                           engine="tree", eta=0.5, gamma=1.0, alpha=0.5)
        wire = {"choco_pinf_2bit": "pinf_2bit", "choco_randk_0.1": "randk_0.1",
                "choco_topk_0.01": "topk_0.01"}[name]
        return CHOCO_SGD(gossip=gossip, compressor=choco_compressor(wire),
                         eta=CHOCO_ETA, gamma=CHOCO_WIRES[wire][0])

    launches = {}
    for name, (kernels, names) in TREE_RUNS.items():
        alg = algo(name)
        run(alg, prob, prob.x_star, iters=1)           # warm-up step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run(alg, prob, prob.x_star, iters=iters)  # ends in one .cpu()
        wall = time.perf_counter() - t0
        launches[name] = cuda_lib.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"tree_at_scale {name}"
        expect_launches(launches[name], dict.fromkeys(kernels, iters), what)
        check(all(np.isfinite(a).all() for a in tr), f"{what}: non-finite")
        if name.startswith("lead"):
            check(tr.dist[-1] < 1e-2 * tr.dist[0]
                  and tr.consensus[-1] < 1e-2 * tr.consensus[0],
                  f"{what}: dist {tr.dist[0]} -> {tr.dist[-1]}, consensus "
                  f"{tr.consensus[0]} -> {tr.consensus[-1]}")
        else:
            check(tr.dist[-1] < tr.dist[0],
                  f"{what}: dist {tr.dist[0]} -> {tr.dist[-1]}")
        breakdown = stage_breakdown(
            lambda: run(alg, prob, prob.x_star, iters=6), dev,
            {**TREE_STAGES, **names}, what)
        emit({"phase": "tree_at_scale", "run": name,
              "compressor": repr(alg.compressor), "n": n, "d": d,
              "iters": iters, "ms_per_step": wall * 1e3 / iters,
              "breakdown_ms": breakdown,
              "breakdown_total_ms": sum(breakdown.values()),
              "max_memory_allocated_GB": peak / 1e9,
              "launches": launches[name],
              "dist": [tr.dist[0], tr.dist[-1]],
              "consensus": [tr.consensus[0], tr.consensus[-1]],
              "bits_per_agent_per_step": tr.bits_per_agent[-1] / iters,
              "comp_err_last": tr.comp_err[-1]})
        del alg, tr
    del prob
    torch.cuda.empty_cache()
    emit({"phase": "tree_at_scale", "run": "compress_cuda_equals_cpu",
          "n": n, "d": d, "compressors": hold_tree_against_cpu(dev, d)})
    return launches


def phase_fig3(dev):
    """The paper's Fig. 3 on the card (benchmarks/bench_logreg.py's
    fig3_het_minibatch) on the port's own problem: Fig. 2's logistic
    regression with minibatch gradients of 64 samples, 200 iterations of
    each run through run(stochastic=True)."""
    from repro_torch.core import baselines, topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.convex import LogisticRegression
    from repro_torch.core.gossip import DenseGossip
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    prob = LogisticRegression.generate(torch.Generator(dev).manual_seed(1),
                                       n_agents=8, m_per_agent=256, d=784,
                                       n_classes=10, heterogeneous=True,
                                       device=dev)
    check(prob.d == FIG2_D, f"fig3: d = {prob.d}")
    x_star = prob.solve_x_star(iters=800)
    q2, eta = QuantizePNorm(bits=2, block=512), FIG2_ETA

    def algo(name, device):
        g = DenseGossip.from_topology(topology.ring(8), device)
        return {
            "lead": lambda: LEADSim(gossip=g, compressor=q2, eta=eta),
            "lead_flat": lambda: LEADSim(gossip=g, compressor=q2, eta=eta,
                                         engine="flat"),
            "lead_flat_thm2": lambda: LEADSim(
                gossip=g, compressor=q2, engine="flat",
                eta=lambda k: eta / (1.0 + 0.01 * k)),
            "nids": lambda: baselines.NIDS(gossip=g, eta=eta),
            "dgd": lambda: baselines.DGD(gossip=g, eta=eta),
            "choco": lambda: baselines.CHOCO_SGD(gossip=g, compressor=q2,
                                                 eta=eta, gamma=0.6),
            "deepsqueeze": lambda: baselines.DeepSqueeze(
                gossip=g, compressor=q2, eta=eta, gamma=0.4),
            "qdgd": lambda: baselines.QDGD(gossip=g, compressor=q2, eta=eta,
                                           gamma=0.4),
        }[name]()

    names = ("lead", "lead_flat", "lead_flat_thm2", "nids", "dgd", "choco",
             "qdgd", "deepsqueeze")
    tr, launches = {}, {}
    for name in names:
        cuda_lib.reset_launch_counts()
        tr[name] = run(algo(name, dev), prob, x_star, iters=FIG3_ITERS,
                       stochastic=True, batch=FIG3_BATCH)
        launches[name] = cuda_lib.launch_counts()
        check(all(np.isfinite(a).all() for a in tr[name]),
              f"fig3: {name} non-finite")
    wire = {"quantize_encode": FIG3_ITERS, "quantize_decode": FIG3_ITERS}
    expect_launches(launches["lead"], wire, "fig3 lead (tree)")
    for name in ("lead_flat", "lead_flat_thm2"):
        expect_launches(launches[name],
                        dict.fromkeys(LEAD_KERNELS, FIG3_ITERS),
                        f"fig3 {name}")
    for name in FIG3_COMPRESSED:
        expect_launches(launches[name], wire, f"fig3 {name}")
    for name in ("nids", "dgd"):
        expect_launches(launches[name], {}, f"fig3 {name}")

    final = {k: {"dist": t.dist[-1], "consensus": t.consensus[-1]}
             for k, t in tr.items()}
    for lead in ("lead", "lead_flat"):
        got = final[lead]
        check(got["dist"] <= 1.05 * final["nids"]["dist"],
              f"fig3: {lead} dist {got['dist']} > 1.05 x NIDS's "
              f"{final['nids']['dist']}")
        for name in ("dgd",) + FIG3_COMPRESSED:
            check(got["dist"] < final[name]["dist"],
                  f"fig3: {lead} dist {got['dist']} not below {name}'s "
                  f"{final[name]['dist']}")
            if name != "dgd":
                check(10 * got["consensus"] <= final[name]["consensus"],
                      f"fig3: {lead} consensus {got['consensus']} not 10x "
                      f"below {name}'s {final[name]['consensus']}")

    # the exact runs on the card against the same runs on the CPU: the
    # batch indices are the same integers on both (the counter hash)
    cpu_prob = LogisticRegression.from_arrays(prob.feats, prob.labels,
                                              prob.n_classes, prob.lam,
                                              device="cpu")
    gaps = {name: trace_gap(tr[name], run(algo(name, "cpu"), cpu_prob,
                                          x_star.cpu(), iters=FIG3_ITERS,
                                          stochastic=True, batch=FIG3_BATCH),
                            f"fig3: {name}")
            for name in ("nids", "dgd")}
    emit({"phase": "fig3", "n": prob.n, "d": prob.d, "iters": FIG3_ITERS,
          "batch": FIG3_BATCH, "eta": eta, "final": final,
          "lead_consensus_below": {k: final[k]["consensus"]
                                   / final["lead"]["consensus"]
                                   for k in FIG3_COMPRESSED},
          "launches": {k: {n: c for n, c in v.items() if c}
                       for k, v in launches.items()},
          "exact_cuda_vs_cpu": gaps})
    return launches


def fault_metrics_on_cpu(model, topo, iters, node_size=1, tau=1):
    """The Trace's fault fields for `iters` steps from nothing but the
    model and the graph, on the CPU: step_metrics at each step k (a bank's
    round graph of step k), with the staleness ages replayed from
    broadcast_ok.  On a hier wire `topo` is the inter graph and an ok
    repeats over the node_size agents of its node; with an interval tau
    the steps k % tau != 0 fire no wire: no link metrics, ages frozen."""
    from repro_torch.core import faults

    age = torch.zeros(topo.n * node_size, dtype=torch.int32)
    rows = []
    for k in range(iters):
        comm = k % tau == 0
        if comm:
            ok = model.broadcast_ok(k, topo.n, device="cpu")
            ok = ok.repeat_interleave(node_size)
            age = torch.where(ok, torch.zeros_like(age), age + 1)
        m = [float(v) for v in faults.step_metrics(model, topo, k, age)]
        rows.append(m if comm else [0.0, 0.0] + m[2:])
    return {f: np.array(col) for f, col in zip(
        ("dropped_links", "realized_gap", "staleness_mean", "staleness_max"),
        zip(*rows))}


def phase_faults_at_scale(dev, clean_trace):
    """Fault injection at the real size: n = 8 ring, d = 2^25 per agent,
    lead_at_scale's objective, one warm-up step, then 20 steps through
    run() of each FAULT_RUNS entry; then a small uncompressed faulted run
    on the card held against the CPU."""
    from repro_torch.core import faults, topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    topo = topology.ring(n)
    q2 = QuantizePNorm(bits=2)
    launches, sums = {}, {}
    for name, (alg_name, gossip, model, twin) in FAULT_RUNS.items():
        fm = None if model is None else faults.FaultModel(**model)
        active = fm is not None and fm.is_active
        mix = {"mix": f"{'faulted_' if active else ''}{gossip}_mix"}
        if alg_name == "lead":
            alg = LEADSim(topology=topo, compressor=q2, engine="flat",
                          engine_gossip=gossip, faults=fm, device=dev,
                          **LEAD_HYPER)
            kernels, names = LEAD_KERNELS, {**STAGE_NAMES, **mix}
        else:
            gamma, kernels, wire_names = CHOCO_WIRES["pinf_2bit"]
            alg = engine_for(topo, q2, d, algorithm="choco", gossip=gossip,
                             eta=CHOCO_ETA, gamma=gamma, faults=fm,
                             device=dev)
            names = {**CHOCO_STAGES, **wire_names, **mix}
        run(alg, prob, prob.x_star, iters=1)           # warm-up step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run(alg, prob, prob.x_star, iters=iters)  # ends in one .cpu()
        wall = time.perf_counter() - t0
        launches[name] = cuda_lib.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"faults_at_scale {name}"
        expect_launches(launches[name], dict.fromkeys(kernels, iters), what)
        check(all(np.isfinite(a).all() for a in tr), f"{what}: non-finite")
        out = {}
        if active:
            check(tr.dist[-1] < tr.dist[0] or alg_name == "choco",
                  f"{what}: dist {tr.dist[0]} -> {tr.dist[-1]}")
            want = fault_metrics_on_cpu(fm, topo, iters)
            for f in ("dropped_links", "staleness_mean", "staleness_max"):
                check(np.array_equal(getattr(tr, f), want[f]),
                      f"{what}: {f} {getattr(tr, f)} != the CPU's {want[f]}")
            gap = float(np.max(np.abs(tr.realized_gap
                                      - want["realized_gap"])))
            check(gap <= 1e-6, f"{what}: realized_gap off the CPU's by {gap}")
            out = {"dropped_links_total": float(tr.dropped_links.sum()),
                   "realized_gap_mean": float(tr.realized_gap.mean()),
                   "realized_gap_vs_cpu": gap,
                   "staleness_max": float(tr.staleness_max.max())}
            if fm.policy == "stale":
                check(tr.staleness_max.max() >= 5,
                      f"{what}: staleness_max {tr.staleness_max.max()} < 5")
        elif fm is not None:                           # inactive model
            for f in clean_trace._fields:
                check(np.array_equal(getattr(tr, f),
                                     getattr(clean_trace, f)),
                      f"{what}: {f} differs from lead_at_scale's trace")
            out = {"equals_lead_at_scale": True}
        breakdown = stage_breakdown(
            lambda: run(alg, prob, prob.x_star, iters=6), dev, names, what)
        sums[name] = sum(breakdown.values())
        if twin is not None:
            ratio = sums[name] / sums[twin]
            out["stage_sum_over_twin"] = ratio
            check(abs(ratio - 1) <= TWIN_RTOL,
                  f"{what}: device stage sum {sums[name]} ms is not within "
                  f"{TWIN_RTOL:.0%} of {twin}'s {sums[twin]}")
        emit({"phase": "faults_at_scale", "run": name, "algorithm": alg_name,
              "gossip": gossip, "faults": model, "n": n, "d": d,
              "iters": iters, "ms_per_step": wall * 1e3 / iters,
              "breakdown_ms": breakdown, "breakdown_total_ms": sums[name],
              "max_memory_allocated_GB": peak / 1e9,
              "launches": launches[name],
              "dist": [tr.dist[0], tr.dist[-1]],
              "consensus": [tr.consensus[0], tr.consensus[-1]], **out})
        del alg, tr
    del prob
    torch.cuda.empty_cache()

    # uncompressed faulted LEAD at a small width on the card against the
    # same run on the CPU (which the CPU tests hold against the reference),
    # as headline does for the clean run
    T = 100.0 * torch.randn((n, SMALL_FAULT_D),
                            generator=torch.Generator().manual_seed(0))
    fm = faults.FaultModel(**LINK_DROP)
    runs = [run(LEADSim(topology=topo, eta=0.5, engine="flat", faults=fm,
                        device=device),
                prob_d, prob_d.x_star, iters=100)
            for device, prob_d in ((dev, Quadratic(None, n, SMALL_FAULT_D,
                                                   dev, T)),
                                   ("cpu", Quadratic(None, n, SMALL_FAULT_D,
                                                     "cpu", T)))]
    gap = trace_gap(runs[0], runs[1], "faults_at_scale: small faulted LEAD")
    for f in ("dropped_links", "staleness_mean", "staleness_max"):
        check(np.array_equal(getattr(runs[0], f), getattr(runs[1], f)),
              f"faults_at_scale small run: {f} differs from the CPU's")
    emit({"phase": "faults_at_scale", "run": "small_cuda_vs_cpu",
          "d": SMALL_FAULT_D, "iters": 100, "faults": LINK_DROP,
          "dist": [runs[0].dist[0], runs[0].dist[-1]], "cuda_vs_cpu": gap})
    return launches


def phase_new_paths(dev, phase, lead_trace):
    """One of bank_at_scale, hier_at_scale and interval_at_scale: each
    NEW_PATHS[phase] run at the real size (lead_at_scale's objective, one
    warm-up step, 20 counted steps) with its launches pinned, its ms/step,
    stage breakdown and peak memory; its dist and consensus factors over
    the 20 steps held to those of the same configuration on the CPU at
    d = SMALL_D, which also runs on the card and is held to the CPU's trace
    by trace_gap; bits and fault fields held exactly."""
    from repro_torch.core import faults, topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    T = torch.randn((n, SMALL_D), generator=torch.Generator().manual_seed(0))
    small = {device: Quadratic(None, n, SMALL_D, device, T)
             for device in (dev, "cpu")}
    q2 = QuantizePNorm(bits=2)
    launches = {}
    for name, (alg_name, build, gossip, model, kernels, every) in \
            NEW_PATHS[phase].items():
        topo = build(topology)
        fm = None if model is None else faults.FaultModel(**model)

        def make(device, dim):
            if alg_name == "lead":
                return LEADSim(topology=topo, compressor=q2, engine="flat",
                               engine_gossip=gossip, faults=fm,
                               device=device, **LEAD_HYPER)
            return engine_for(topo, q2, dim, algorithm="choco",
                              gossip=gossip, eta=CHOCO_ETA,
                              gamma=CHOCO_WIRES["pinf_2bit"][0], faults=fm,
                              device=device)

        alg = make(dev, d)
        what = f"{phase} {name}"
        run(alg, prob, prob.x_star, iters=1)           # warm-up step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run(alg, prob, prob.x_star, iters=iters)  # ends in one .cpu()
        wall = time.perf_counter() - t0
        launches[name] = cuda_lib.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_launches(launches[name],
                        dict.fromkeys(kernels, -(-iters // every)), what)
        check(all(np.isfinite(a).all() for a in tr), f"{what}: non-finite")

        # the same configuration at SMALL_D: on the CPU it predicts the
        # factors by which dist and consensus move in 20 steps; on the card
        # it is held to the CPU's trace
        runs = {device: run(make(device, SMALL_D), prob_d, prob_d.x_star,
                            iters=SMALL_ITERS)
                for device, prob_d in small.items()}
        gap = trace_gap(runs[dev], runs["cpu"], f"{what} at d={SMALL_D}")
        factors = {}
        for f in ("dist", "consensus"):
            want = getattr(runs["cpu"], f)[iters - 1] / getattr(
                runs["cpu"], f)[0]
            got = getattr(tr, f)[-1] / getattr(tr, f)[0]
            factors[f] = {"at_scale": got, "predicted": want}
            check(1 / PREDICT_TOL <= got / want <= PREDICT_TOL,
                  f"{what}: {f} moved {got}x in {iters} steps, the CPU at "
                  f"d={SMALL_D} predicts {want}x")
        out = {}
        tau = int(getattr(topo, "comm_interval", 1))
        node = int(getattr(topo, "node_size", 1)) if gossip == "hier" else 1
        if tau > 1 or node > 1:
            # one encode per node, one exchange per tau steps: the bits
            # are the every-step flat ring-8 run's over node_size * tau
            want_bits = lead_trace.bits_per_agent[-1] / (node * tau)
            check(tr.bits_per_agent[-1] == want_bits,
                  f"{what}: bits {tr.bits_per_agent[-1]} != lead_at_scale's "
                  f"/ {node * tau} = {want_bits}")
            out["bits_over_lead_at_scale"] = (tr.bits_per_agent[-1]
                                              / lead_trace.bits_per_agent[-1])
        if tau > 1:
            skipped = np.arange(iters) % tau != 0
            check(not tr.comp_err[skipped].any()
                  and tr.comp_err[~skipped].all(),
                  f"{what}: comp_err on skipped steps {tr.comp_err}")
            check(not np.diff(tr.bits_per_agent)[skipped[1:]].any(),
                  f"{what}: bits grew on a skipped step")
            check(not tr.dropped_links[skipped].any()
                  and not tr.realized_gap[skipped].any(),
                  f"{what}: link metrics on skipped steps")
        if fm is not None:
            metric_topo = topo.inter if node > 1 else topo
            want = fault_metrics_on_cpu(fm, metric_topo, iters, node, tau)
            for f in ("dropped_links", "staleness_mean", "staleness_max"):
                check(np.array_equal(getattr(tr, f), want[f]),
                      f"{what}: {f} {getattr(tr, f)} != the CPU's {want[f]}")
            fgap = float(np.max(np.abs(tr.realized_gap
                                       - want["realized_gap"])))
            check(fgap <= 1e-6, f"{what}: realized_gap off the CPU's by "
                  f"{fgap}")
            check(tr.dropped_links.sum() > 0, f"{what}: no link dropped")
            out.update(dropped_links_total=float(tr.dropped_links.sum()),
                       realized_gap_mean=float(tr.realized_gap.mean()),
                       realized_gap_vs_cpu=fgap,
                       staleness_max=float(tr.staleness_max.max()))
        names = {**(STAGE_NAMES if alg_name == "lead" and gossip != "hier"
                    else {**CHOCO_STAGES, **CHOCO_WIRES["pinf_2bit"][2],
                          "update": "K3_update" if alg_name == "lead"
                          else "update"}),
                 "mix": f"{'faulted_' if fm else ''}{gossip}_mix",
                 **NEW_STAGES[phase]}
        steps = 2 * tau + 2
        breakdown, step_ms = stage_breakdown(
            lambda: run(alg, prob, prob.x_star, iters=steps), dev, names,
            what, per_step=True)
        emit({"phase": phase, "run": name, "algorithm": alg_name,
              "topology": repr(topo), "gossip": gossip, "faults": model,
              "n": n, "d": d, "iters": iters,
              "ms_per_step": wall * 1e3 / iters, "breakdown_ms": breakdown,
              "breakdown_total_ms": sum(breakdown.values()),
              "device_ms_per_step": step_ms,
              "max_memory_allocated_GB": peak / 1e9,
              "launches": launches[name],
              "dist": [tr.dist[0], tr.dist[-1]],
              "consensus": [tr.consensus[0], tr.consensus[-1]],
              "bits_per_agent": tr.bits_per_agent[-1], "factors": factors,
              "small_d": SMALL_D, "small_iters": SMALL_ITERS,
              "small_cuda_vs_cpu": gap, **out})
        del alg, tr, runs
    del prob
    torch.cuda.empty_cache()
    return launches


def stage_sums(run_fn, dev, names, what):
    """Device ms per step of each stage of run_fn() under
    core/stage_timer.py, summed over the stage's marks within a step (a
    multi-wire step marks dither, encode, decode and mix once per wire)
    and averaged over the steps after the first; `names` maps each mark to
    what it runs and must cover every stage.  Returns (ms per stage, marks
    per step of each stage, device ms per step)."""
    from repro_torch.core.stage_timer import StageTimer

    with StageTimer(dev) as timer:
        run_fn()
    stages = timer.stages()
    first = [name for name, _ in stages].index("metrics") + 1
    ms, marks = {}, {}
    for name, t in stages[first:]:
        key = names.get(name, name)
        ms[key] = ms.get(key, 0.0) + t
        marks[key] = marks.get(key, 0) + 1
    check(set(ms) == set(names.values()), f"{what}: stages {sorted(ms)}")
    steps = marks[names["metrics"]]
    return ({k: v / steps for k, v in ms.items()},
            {k: v / steps for k, v in marks.items()},
            sum(ms.values()) / steps)


class TrackerProbe:
    """A flat engine whose steps also record C-GT's tracker gap
    max |sum_i s_i - sum_i g_prev_i| / (1 + max |g_prev|) after each step,
    in a device tensor (no host read inside the run); every other
    attribute is the engine's, so run() drives it as it drives the
    engine."""

    def __init__(self, engine):
        self.engine, self.gaps = engine, []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def _record(self, st):
        gap = (st.s.sum(0, dtype=torch.float64)
               - st.g_prev.sum(0, dtype=torch.float64)).abs().max()
        self.gaps.append(gap / (1.0 + st.g_prev.abs().max().double()))

    def step_with_wire(self, st, g, seed, step=None):
        out = self.engine.step_with_wire(st, g, seed, step)
        self._record(out[0])
        return out

    def step_with_wire_faulted(self, st, fs, g, seed, step=None):
        out = self.engine.step_with_wire_faulted(st, fs, g, seed, step)
        self._record(out[0])
        return out


def phase_multiwire_at_scale(dev, lead_trace, smi):
    """CEDAS and C-GT at the real size (lead_at_scale's objective, one
    warm-up step, 20 counted steps, 2-bit p=inf in blocks of 512, neighbor
    gossip): each MULTIWIRE_RUNS entry with its launches pinned (K4 and K2
    once per step and wire, K1 and K3 never), its ms/step, stage sums and
    peak memory; C-GT's bits exactly twice a single-wire run's on the same
    graph (CEDAS's: lead_at_scale's); C-GT's tracker sum held at every
    counted step (a second run of the same seeds through TrackerProbe);
    the fault fields the CPU's; the configuration at d = SMALL_D on the
    card held to the CPU's trace, which also predicts the dist and
    consensus factors over 20 steps (held within 2x).  `smi` (the card's
    name and power limit) goes on each run's line."""
    from repro_torch.core import faults, topology
    from repro_torch.core.compression import QuantizePNorm
    from repro_torch.core.engines import engine_for
    from repro_torch.core.simulator import run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    T = torch.randn((n, SMALL_D), generator=torch.Generator().manual_seed(0))
    small = {device: Quadratic(None, n, SMALL_D, device, T)
             for device in (dev, "cpu")}
    q2 = QuantizePNorm(bits=2)
    wire = ("quantize_encode", "quantize_decode")
    launches = {}
    for name, (alg_name, build, model, hyper, wires) in \
            MULTIWIRE_RUNS.items():
        topo = build(topology)
        fm = None if model is None else faults.FaultModel(**model)

        def make(device, dim, algorithm=alg_name):
            return engine_for(topo, q2, dim, algorithm=algorithm,
                              gossip="neighbor", faults=fm, device=device,
                              **hyper)

        eng = make(dev, d)
        what = f"multiwire_at_scale {name}"
        run(eng, prob, prob.x_star, iters=1)            # warm-up step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        tr = run(eng, prob, prob.x_star, iters=iters)   # ends in one .cpu()
        wall = time.perf_counter() - t0
        launches[name] = cuda_lib.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_launches(launches[name], dict.fromkeys(wire, wires * iters),
                        what)
        check(all(np.isfinite(a).all() for a in tr), f"{what}: non-finite")
        out = {}
        if alg_name == "cgt":
            # the same graph's single-wire run: CEDAS, two steps
            single = run(make(dev, d, "cedas"), prob, prob.x_star, iters=2)
            check(tr.bits_per_agent[1] == 2 * single.bits_per_agent[1],
                  f"{what}: bits {tr.bits_per_agent[1]} after 2 steps, the "
                  f"single wire's {single.bits_per_agent[1]}")
            probe = TrackerProbe(eng)
            run(probe, prob, prob.x_star, iters=iters)
            gaps = torch.stack(probe.gaps).cpu().numpy()
            check(len(gaps) == iters and gaps.max() <= TRACKER_RTOL,
                  f"{what}: tracker gap {gaps}")
            out.update(tracker_gap_max=float(gaps.max()),
                       bits_over_single_wire=(tr.bits_per_agent[1]
                                              / single.bits_per_agent[1]))
            del probe
        else:
            check(np.array_equal(tr.bits_per_agent,
                                 lead_trace.bits_per_agent),
                  f"{what}: bits differ from lead_at_scale's single wire")
        if fm is not None:
            want = fault_metrics_on_cpu(fm, topo, iters)
            for f in ("dropped_links", "staleness_mean", "staleness_max"):
                check(np.array_equal(getattr(tr, f), want[f]),
                      f"{what}: {f} {getattr(tr, f)} != the CPU's {want[f]}")
            fgap = float(np.max(np.abs(tr.realized_gap
                                       - want["realized_gap"])))
            check(fgap <= 1e-6, f"{what}: realized_gap off the CPU's by "
                  f"{fgap}")
            check(tr.dropped_links.sum() > 0, f"{what}: no link dropped")
            out.update(dropped_links_total=float(tr.dropped_links.sum()),
                       realized_gap_vs_cpu=fgap)

        # the configuration at SMALL_D: on the card held to the CPU's
        # trace; on the CPU it predicts the 20-step factors at scale
        runs = {device: run(make(device, SMALL_D), prob_d, prob_d.x_star,
                            iters=SMALL_ITERS)
                for device, prob_d in small.items()}
        gap = trace_gap(runs[dev], runs["cpu"], f"{what} at d={SMALL_D}")
        factors = {}
        for f in ("dist", "consensus"):
            want_f = getattr(runs["cpu"], f)[iters - 1] / getattr(
                runs["cpu"], f)[0]
            got_f = getattr(tr, f)[-1] / getattr(tr, f)[0]
            factors[f] = {"at_scale": got_f, "predicted": want_f}
            check(1 / PREDICT_TOL <= got_f / want_f <= PREDICT_TOL,
                  f"{what}: {f} moved {got_f}x in {iters} steps, the CPU at "
                  f"d={SMALL_D} predicts {want_f}x")
        names = {**MULTIWIRE_STAGES,
                 "mix": f"{'faulted_' if fm else ''}neighbor_mix"}
        if isinstance(topo, topology.TopologyBank):
            names["round_mix"] = "round_mix"
        breakdown, marks, step_ms = stage_sums(
            lambda: run(eng, prob, prob.x_star, iters=4), dev, names, what)
        emit({"phase": "multiwire_at_scale", "run": name,
              "algorithm": alg_name, "topology": repr(topo),
              "gossip": "neighbor", "faults": model, "hyper": hyper,
              "n": n, "d": d, "iters": iters, "nvidia_smi": smi,
              "ms_per_step": wall * 1e3 / iters, "breakdown_ms": breakdown,
              "marks_per_step": marks, "breakdown_total_ms": step_ms,
              "max_memory_allocated_GB": peak / 1e9,
              "launches": launches[name],
              "dist": [tr.dist[0], tr.dist[-1]],
              "consensus": [tr.consensus[0], tr.consensus[-1]],
              "bits_per_agent": tr.bits_per_agent[-1], "factors": factors,
              "small_d": SMALL_D, "small_iters": SMALL_ITERS,
              "small_cuda_vs_cpu": gap, **out})
        del eng, tr, runs
        torch.cuda.empty_cache()
    del prob
    torch.cuda.empty_cache()
    return launches


def phase_oracle_at_scale(dev):
    """The noisy oracle at the real size: flat 2-bit LEAD, n = 8 ring,
    d = 2^25, lead_at_scale's objective and hypers, run(noise_std=0.1) for
    20 steps; then one seed's noise plane on the card against the CPU's."""
    from repro_torch.core import topology
    from repro_torch.core.compression import QuantizePNorm, fast_normal
    from repro_torch.core.simulator import LEADSim, run
    from repro_torch.kernels import cuda_lib

    n, d, iters = 8, D_SCALE, 20
    prob = Quadratic(torch.Generator(dev).manual_seed(0), n, d, dev)
    lead = LEADSim(topology=topology.ring(n), compressor=QuantizePNorm(bits=2),
                   engine="flat", device=dev, **LEAD_HYPER)
    run(lead, prob, prob.x_star, iters=1, noise_std=ORACLE_NOISE)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    tr = run(lead, prob, prob.x_star, iters=iters, noise_std=ORACLE_NOISE)
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, dict.fromkeys(LEAD_KERNELS, iters),
                    "oracle_at_scale")
    check(all(np.isfinite(a).all() for a in tr), "oracle_at_scale: non-finite")
    check(tr.dist[-1] <= 0.1 * tr.dist[0],
          f"oracle_at_scale: dist {tr.dist[0]} -> {tr.dist[-1]}, not 10x")
    breakdown = stage_breakdown(
        lambda: run(lead, prob, prob.x_star, iters=6, noise_std=ORACLE_NOISE),
        dev, STAGE_NAMES, "oracle_at_scale")
    del prob
    torch.cuda.empty_cache()

    # the noise plane of one seed: the uniforms are the same bits on both,
    # the normals agree within 4 ulp (log and cos are not correctly rounded)
    t1 = time.perf_counter()
    card = fast_normal((n, d), 12345, device=dev).cpu()
    cpu = fast_normal((n, d), 12345, device="cpu")
    ulp = torch.nextafter(cpu.abs(), torch.tensor(float("inf"))) - cpu.abs()
    ulps = float(((card - cpu).abs() / ulp).max())
    n_diff = int((card != cpu).sum())
    check(ulps <= 4.0, f"oracle_at_scale: noise plane {ulps} ulp off the CPU's")
    emit({"phase": "oracle_at_scale", "n": n, "d": d, "iters": iters,
          "noise_std": ORACLE_NOISE, "ms_per_step": wall * 1e3 / iters,
          "breakdown_ms": breakdown,
          "breakdown_total_ms": sum(breakdown.values()),
          "max_memory_allocated_GB": peak / 1e9, "launches": launches,
          "dist": [tr.dist[0], tr.dist[-1]],
          "consensus": [tr.consensus[0], tr.consensus[-1]],
          "noise_plane_max_ulp": ulps, "noise_plane_elements_differing":
          n_diff, "noise_plane_check_s": time.perf_counter() - t1})
    del card, cpu, ulp
    return launches


# the decentralized LM trainer (dist/trainer.py): 4 agents on ring(4) (2 on
# ring(2) where 4 would not fit), LEAD on the 2-bit p=inf wire in blocks of
# 512, SGD at the CLI's eta 0.03 (gamma and alpha the engine's)
TRAIN_AGENTS = 4
TRAIN_SMALL_STEPS = 5
TRAIN_RTOL = 1e-4           # card against CPU: matmul rounding, TF32 off
TRAIN_CODE_FRAC = 1e-5      # codes that differ (tests/dist_worker.py:328)
TRAIN_STEPS = 10            # timed, after one warm-up step
TRAIN_SEQ, TRAIN_BATCH = 128, 2
TRAIN_DUAL_SUM = 1e-3       # max |sum_agents d| (tests/dist_worker.py:143)
TRAIN_ETA = 0.03            # ... at the trainer's eta 0.03; the sum is 0 up
                            # to rounding times gamma / (2 eta), so at
                            # another eta the bound scales by 0.03 / eta
TRAIN_PEAK_GB = 75.0
# train_small: every family at .reduced() size (these keywords), the card
# against the CPU, free over its steps or, with restart, each step from the
# CPU's state before it and the params held against the state's largest
# |x|: xLSTM's step at eta 0.03 amplifies a rounding difference 15-90x a
# step (the port against itself on the CPU, only the summation order
# changed, parts by 1e-6, 7.5e-5, 1.2e-2, 0.55 over 4 steps; every other
# family stays below 1e-6), and a step moves its embedding by several
# times the embedding's size (grad_norm ~240 at eta 0.03 on 0.02-scale
# rows), so a 6e-5 gradient difference is 2e-4 of that leaf's size
TRAIN_SMALL_ARCHS = (("granite-3-2b", {}, False),
                     ("granite-moe-1b-a400m", {}, False),
                     ("kimi-k2-1t-a32b", {}, False),
                     ("xlstm-1.3b", {"n_layers": 6}, True),
                     ("recurrentgemma-2b", {"n_layers": 3}, False),
                     ("llama-3.2-vision-11b", {}, False),
                     ("whisper-tiny", {}, False))
# the at-scale trainer phases: each arch at its published width, its depth
# cut (n_layers; None keeps the whole model) so that the agents' LEAD state
# fits the card; the optimizer and LEAD's eta; pinned: leaves and
# parameters per agent, and the bits per agent and step (3 bits an element
# and 32 a 512-block; a leaf below one block or not a multiple of 512 pays
# for its last block whole).  xLSTM trains with Adam at eta 1e-3: with SGD
# at eta 0.03 (or 0.01) its gradient (norm ~300, growing) drives the input
# and forget gates until the reference's chunkwise mLSTM divides 0 by 0
# (both packages do: tests/test_torch_recurrent.py), so the loss is NaN by
# the second step; SGD at 1e-3 or 3e-3 stays finite but its loss does not
# fall in 10 steps
TRAIN_AT_SCALE = {
    "train_at_scale": dict(arch="granite-3-2b", n_layers=2, agents=4,
                           optimizer="sgd", eta=TRAIN_ETA, leaves=12,
                           params=322_983_936, bits=989_138_304,
                           ranks=True),
    "moe_at_scale": dict(arch="granite-moe-1b-a400m", n_layers=4, agents=4,
                         optimizer="sgd", eta=TRAIN_ETA, leaves=13,
                         params=314_719_232, bits=963_827_648),
    "recurrent_at_scale": dict(arch="xlstm-1.3b", n_layers=6, agents=2,
                               optimizer="adam", eta=1e-3, leaves=60,
                               params=427_151_400, bits=1_308_151_320),
    "audio_at_scale": dict(arch="whisper-tiny", n_layers=None, agents=4,
                           optimizer="sgd", eta=TRAIN_ETA, leaves=51,
                           params=56_357_380, bits=172_594_604),
}
# the trainer's stage marks (dist/trainer.py and the engine's apply_stage;
# the trainer records no comp_err, so it computes none)
TRAIN_STAGES = {"gradient": "gradient", "optimizer": "optimizer",
                "block": "block", "message": "message", "dither": "dither",
                "encode": "K4_encode", "decode": "K2_decode", "mix": "mix",
                "update": "K3_update", "unblock": "unblock"}


def train_gradient_flop(cfg, n_agents, batch, seq):
    """The floating-point operations of one trainer gradient (forward and
    backward, 3x the forward) over all agents, 2 per multiply-add of every
    product the model forms.  Per token: every matmul weight of its blocks
    (q, k, v, o; the swiglu or gelu MLP; an MoE's router; mLSTM's up, gate,
    per-head q, k, v, gate and down projections; sLSTM's input, recurrent
    and FFN weights; RG-LRU's five) and an untied head (the embedding is a
    gather, not a matmul).  Attention: 2 n_heads head_dim per visible key
    (causal: seq (seq + 1) / 2 keys a sequence; local: at most window + 1 a
    query).  An MoE's experts over all E x C slots of each agent's dispatch
    buffer, kept or not (C from the agent's batch x seq tokens).  mLSTM's
    chunks: 2 G^2 hd + 2 G hd^2 per head and chunk.  Cross-attention (vlm
    every cross_attn_every layers, audio after every decoder layer): q and
    o per token, k and v per memory row, 2 n_heads head_dim per (token,
    memory row).  The audio encoder: its layers over the frames, their
    attention bidirectional."""
    from repro_torch.models.moe import capacity

    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.kv_heads
    seqs = n_agents * batch
    tokens = seqs * seq
    qkvo = d * (nq + 2 * nkv) * hd + nq * hd * d
    mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
    causal_keys = seq * (seq + 1) // 2
    macs = 0
    for t in cfg.layer_types():
        if t in ("attn", "local", "global"):
            keys = (causal_keys if t != "local" else
                    sum(min(i + 1, cfg.window + 1) for i in range(seq)))
            macs += qkvo * tokens + 2 * nq * hd * keys * seqs
            if cfg.n_experts:
                C = capacity(batch * seq, cfg.top_k, cfg.n_experts,
                             cfg.capacity_factor)
                macs += d * cfg.n_experts * tokens
                macs += 3 * d * cfg.d_ff * cfg.n_experts * C * n_agents
            else:
                macs += mlp * tokens
        elif t == "mlstm":
            di = 2 * d
            hdm = di // nq
            G = min(128, seq)
            while seq % G:
                G -= 1
            macs += (3 * d * di + 3 * di * hdm + 2 * nq * di) * tokens
            macs += (seq // G) * nq * (2 * G * G * hdm + 2 * G * hdm * hdm) \
                * seqs
        elif t == "slstm":
            macs += (4 * d * d + 4 * d * (d // nq) + 2 * d * (4 * d // 3)) \
                * tokens
        elif t == "rglru":
            macs += (5 * d * d + mlp) * tokens
    if cfg.cross_attn_every or cfg.encoder_layers:
        M = cfg.vis_tokens if cfg.cross_attn_every else cfg.n_audio_frames
        n_cross = (cfg.n_layers // cfg.cross_attn_every
                   if cfg.cross_attn_every else cfg.n_layers)
        macs += n_cross * (2 * d * nq * hd * tokens
                           + 2 * d * nkv * hd * M * seqs
                           + 2 * nq * hd * M * tokens)
    if cfg.encoder_layers:
        F = cfg.n_audio_frames
        macs += cfg.encoder_layers * (qkvo + mlp + 2 * nq * hd * F) * F * seqs
    if not cfg.tie_embeddings:
        macs += d * cfg.vocab * tokens
    return 3 * 2 * macs


def _tree_to(tree, device):
    """Every leaf (a tensor, or a numpy array as a gather leaves it) as a
    tensor on `device`."""
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda l: torch.as_tensor(l).to(device), tree)


def _state_to(state, device):
    """A dist/trainer.TrainState copied to `device`."""
    return state._replace(params=_tree_to(state.params, device),
                          algo={f: _tree_to(t, device)
                                for f, t in state.algo.items()},
                          opt=_tree_to(state.opt, device),
                          step=state.step.to(device))


class CodeSpy:
    """Records the codes of every QuantizePNorm.encode_blocks call made
    inside its with block (on the host), to hold one device's codes
    against another's."""

    def __enter__(self):
        from repro_torch.core.compression import QuantizePNorm

        self.codes, self._cls = [], QuantizePNorm
        self._orig = QuantizePNorm.encode_blocks
        spy = self

        def encode_blocks(comp, buf, dim, u):
            payload, bits = spy._orig(comp, buf, dim, u)
            spy.codes.append(payload["code"].cpu())
            return payload, bits

        QuantizePNorm.encode_blocks = encode_blocks
        return self

    def __exit__(self, *exc):
        self._cls.encode_blocks = self._orig


class RouteSpy:
    """Records the (expert ids, keep) of every MoE routing
    (models/moe.route) made inside its with block, on the device, in call
    order: to hold one device's routing against another's, and to count
    the dropped pairs and the experts' loads."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._mod, self._orig = [], moe, moe.route
        spy = self

        def route(p, xt, top_k, capacity_factor):
            out = spy._orig(p, xt, top_k, capacity_factor)
            spy.calls.append((out[2].detach(), out[4].detach(), out[5]))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._mod.route = self._orig

    def flips(self, other):
        """Tokens whose experts differ between this run's calls and
        `other`'s (same calls in the same order)."""
        check(len(self.calls) == len(other.calls),
              f"{len(self.calls)} routings against {len(other.calls)}")
        return sum(int((a.cpu() != b.cpu()).any(-1).sum())
                   for (a, _, _), (b, _, _) in zip(self.calls, other.calls))

    def load(self, n_experts):
        """(share of (token, choice) pairs dropped, the heaviest expert's
        pairs over the balanced load T k / E, before capacity; the
        capacity over the balanced load)."""
        dropped = sum(int((~keep).sum()) for _, keep, _ in self.calls)
        pairs = sum(keep.numel() for _, keep, _ in self.calls)
        heavy, cap = 0.0, 0.0
        for ids, keep, C in self.calls:
            per = torch.bincount(ids.reshape(-1), minlength=n_experts)
            balanced = ids.numel() / n_experts
            heavy = max(heavy, float(per.max()) / balanced)
            cap = C / balanced
        return dropped / pairs, heavy, cap


def _train_batches(cfg, ds, steps, device, start=0):
    """lm_batch of each step on `device`, with the vlm's or audio model's
    stub memory (the same every step, as the reference CLI's)."""
    from repro_torch.data.synthetic import lm_batch, stub_memory

    memory = stub_memory(cfg.family, (ds.n_agents, ds.batch_per_agent), cfg,
                         device=device)
    out = []
    for i in range(start, start + steps):
        b = lm_batch(ds, i, device=device)
        if memory is not None:
            b["memory"] = memory
        out.append(b)
    return out


def train_small_arch(dev, arch, kw, restart):
    """One arch of train_small: `arch` at .reduced(**kw), 4 agents on
    ring(4), batch 2 x seq 32, the same weights and batches (and stub
    memory) on the card and the CPU.  Uncompressed LEAD (K3, no
    quantizer) and NIDS over TRAIN_SMALL_STEPS steps (with `restart`, each
    card step from the CPU's state before it, the params against the
    state's largest |x|): params, each agent's loss and grad_norm within
    TRAIN_RTOL of the CPU's.  LEAD on 2 bits, one
    step from the same state and batch: the share of codes that differ
    below TRAIN_CODE_FRAC, the bits the CPU's exactly.  An MoE's routing is
    recorded on both: the tokens whose experts differ (a near-tie of the
    router's probabilities) are counted; the bounds are then held on the
    steps before the first such flip (all of them when there is none)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compression import Identity
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.dist.trainer import (DistConfig, agent_losses,
                                          init_train_state, make_train_step)
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch).reduced(**kw)
    A = TRAIN_AGENTS
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=32, batch_per_agent=2,
                        n_agents=A)
    batches = _train_batches(cfg, ds, TRAIN_SMALL_STEPS, "cpu")
    out = {"arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_ff": cfg.d_ff, "n_agents": A, "restart": restart}
    flips_total = 0
    for name, dc in (("lead_uncompressed",
                      DistConfig(algorithm="lead", compressor=Identity())),
                     ("nids", DistConfig(algorithm="nids"))):
        st0 = init_train_state(cfg, A, dc, torch.Generator().manual_seed(0),
                               "cpu")
        res, cpu_states = {}, [st0]
        for device in ("cpu", dev):
            st = _state_to(st0, device)
            step = make_train_step(cfg, A, dc, device)
            per_step = []
            with RouteSpy() as spy:
                for i, b in enumerate(batches):
                    if restart and device != "cpu":
                        st = _state_to(cpu_states[i], device)
                    st, m = step(st, _tree_to(b, device), 0, step=i)
                    if device == "cpu":
                        cpu_states.append(st)
                    n_calls = len(spy.calls)
                    losses = agent_losses(cfg, st.params,
                                          _tree_to(batches[-1], device))
                    del spy.calls[n_calls:]    # the loss's routings
                    per_step.append((
                        [l.cpu() for l in tree_leaves(st.params)],
                        float(m["grad_norm"]), losses.cpu().double(),
                        n_calls))
            res[device] = (per_step, spy)
        (cpu_steps, cspy), (card_steps, gspy) = res["cpu"], res[dev]
        # the steps whose routing agrees with the CPU's, from the start
        held = len(cpu_steps)
        flips = 0
        if cfg.n_experts:
            flips = gspy.flips(cspy)
            for i, (_, _, _, n_calls) in enumerate(cpu_steps):
                calls = slice(0, n_calls)
                agree = all(torch.equal(a.cpu(), b.cpu()) for (a, _, _), (
                    b, _, _) in zip(gspy.calls[calls], cspy.calls[calls]))
                if not agree:
                    held = i
                    break
        flips_total += flips
        gaps = {"params_rel": 0.0, "loss_rel": 0.0, "grad_norm_rel": 0.0}
        for (cx, cn, cl, _), (gx, gn, gl, _) in zip(cpu_steps[:held],
                                                    card_steps[:held]):
            # each leaf against its own largest |x|; with restart against
            # the state's (the CPU parity tests' scale): there a step moves
            # a leaf by several times its size
            state_scale = max(float(c.abs().max()) for c in cx)
            gaps["params_rel"] = max(gaps["params_rel"], max(
                max_abs(g, c) / (state_scale if restart
                                 else float(c.abs().max()))
                for g, c in zip(gx, cx)))
            gaps["loss_rel"] = max(gaps["loss_rel"],
                                   float(((gl - cl).abs() / cl.abs()).max()))
            gaps["grad_norm_rel"] = max(gaps["grad_norm_rel"],
                                        abs(gn - cn) / abs(cn))
        out[name] = {**gaps, "steps_held": held, "routing_flips": flips,
                     "loss": [float(cpu_steps[-1][2].mean()),
                              float(card_steps[-1][2].mean())]}
        check(max(gaps.values()) <= TRAIN_RTOL,
              f"train_small {cfg.name} {name}: card vs CPU {out[name]}")
        routed = sum(ids.shape[0] for ids, _, _ in cspy.calls)
        check(flips <= 0.01 * routed, f"train_small {cfg.name} {name}: "
              f"{flips} of {routed} routed tokens flip")

    dc = DistConfig(algorithm="lead")
    st0 = init_train_state(cfg, A, dc, torch.Generator().manual_seed(0),
                           "cpu")
    spied = {}
    for device in ("cpu", dev):
        step = make_train_step(cfg, A, dc, device)
        with CodeSpy() as spy, RouteSpy() as rspy:
            _, m = step(_state_to(st0, device), _tree_to(batches[0], device),
                        0, step=0)
        spied[device] = (spy.codes, float(m["bits_per_agent"]), rspy)
    (cc, cb, crs), (gc, gb, grs) = spied["cpu"], spied[dev]
    differ = sum(int((a != b).sum()) for a, b in zip(gc, cc))
    total = sum(a.numel() for a in cc)
    flips = grs.flips(crs) if cfg.n_experts else 0
    out["lead_2bit"] = {"codes_differing": differ, "codes": total,
                        "share": differ / total, "bits_per_agent": gb,
                        "routing_flips": flips}
    check(len(gc) == len(cc) == len(tree_leaves(st0.params)),
          f"train_small {cfg.name} lead_2bit: {len(gc)} encodes, {len(cc)} "
          "on the CPU")
    check(flips > 0 or differ / total < TRAIN_CODE_FRAC,
          f"train_small {cfg.name} lead_2bit: {differ} of {total} codes "
          "differ")
    check(gb == cb, f"train_small {cfg.name} lead_2bit: bits {gb}, the "
          f"CPU's {cb}")
    out["routing_flips"] = flips_total + flips
    emit({"phase": "train_small", **out})
    return out


def phase_train_small(dev):
    """The trainer on the card against the CPU for every family at
    .reduced() size (TRAIN_SMALL_ARCHS): granite-3-2b (d_ff 341, so leaves
    are padded to whole blocks), the MoE archs, xLSTM at 6 layers (the
    sLSTM block; each card step from the CPU's state), RecurrentGemma at
    3 (its local attention), the vlm and the audio model with their stub
    memory; one line each."""
    return {arch: train_small_arch(dev, arch, kw, restart)
            for arch, kw, restart in TRAIN_SMALL_ARCHS}


# -- the trainer across ranks (torch.distributed) and checkpoints -------------------

RANKS_SMALL_STEPS = 10
RANKS_RTOL = 1e-6           # rank path vs no group where the sums differ
RANKS_MAX_CARDS = 4
# ranks_small's runs: DistConfig fields; "hier" on hierarchical(ring(2), 2)
RANKS_SMALL_RUNS = {"lead_2bit": dict(algorithm="lead"),
                    "allreduce": dict(algorithm="allreduce"),
                    "hier": dict(algorithm="lead", topology="hier")}
CKPT_ARCH, CKPT_STEPS = "whisper-tiny", 2


class OneRankGroup:
    """A one-rank NCCL process group (a FileStore in a temporary
    directory) and its (1, 1) rank mesh, for the trainer's rank path on
    one card; destroyed on exit."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import tempfile

        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        torch.cuda.set_device(self.dev)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(self.dir, "store"), 1),
            rank=0, world_size=1)
        return make_mesh((1, 1))

    def __exit__(self, *exc):
        import shutil

        import torch.distributed as dist

        dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)


def _dist_config(kw):
    from repro_torch.core import topology
    from repro_torch.dist.trainer import DistConfig

    kw = dict(kw)
    if kw.get("topology") == "hier":
        kw["topology"] = topology.hierarchical(topology.ring(2), 2)
    return DistConfig(**kw)


def _state_gap(a, b):
    """(bit-identical, max |a - b| over b's largest |x|) of two
    TrainStates' params and algo fields."""
    from repro_torch.utils.tree import tree_leaves

    la = tree_leaves((a.params, a.algo))
    lb = tree_leaves((b.params, b.algo))
    same = all(torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))
    scale = max(float(l.abs().max()) for l in tree_leaves(b.params))
    gap = max(max_abs(x, y.to(x.device)) for x, y in zip(la, lb)) / scale
    return same, gap


def _train_run(cfg, dc, dev, batches, mesh=None, seed=0, warmup=0,
               on_step=None):
    """init_train_state and len(batches) steps of make_train_step on `dev`
    (the rank path when `mesh`): (state, metrics, launches, ms/step by
    the host clock), the first `warmup` steps untimed and uncounted;
    on_step() after each step."""
    from repro_torch.dist.sharding import train_batch_rows
    from repro_torch.dist.trainer import (init_train_state, layout_of,
                                          make_train_step)
    from repro_torch.kernels import cuda_lib

    A = TRAIN_AGENTS
    lay = layout_of(cfg, mesh, A)
    st = init_train_state(cfg, A, dc, torch.Generator(dev).manual_seed(seed),
                          dev, mesh=mesh)
    step = make_train_step(cfg, A, dc, dev, mesh=mesh)
    metrics = []
    for i, b in enumerate(batches):
        if i == warmup:
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
        st, m = step(st, train_batch_rows(lay, b), 0, step=i)
        metrics.append(m)
        if on_step is not None:
            on_step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - warmup)
    return st, metrics, cuda_lib.launch_counts(), ms


def _cross_card_run(n_cards, what):
    """One run with one rank per card on n_cards cards (chip_smoke.py
    --rank-worker, NCCL over a FileStore; `what` is "small" or
    "at_scale", see rank_worker): rank 0's json, with the gathered state
    of a "small" run."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank-worker", str(r), str(n_cards), tmp,
                               what],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n_cards)]
    errs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not errs, f"ranks_small {what} across {n_cards} cards: "
          + "\n".join(errs))
    with open(os.path.join(tmp, "rank0.json")) as f:
        res = json.load(f)
    if what == "small":
        res["state"] = SimpleNamespace(**torch.load(
            os.path.join(tmp, "state.pt")))
    shutil.rmtree(tmp, ignore_errors=True)
    return res


class SendSpy:
    """Counts what every batch_isend_irecv inside its with block hands to
    isend: [(calls, bytes)] per step, as step() calls mark_step."""

    def __enter__(self):
        import torch.distributed as dist

        self.steps, self._dist = [[0, 0]], dist
        self._orig = dist.batch_isend_irecv
        spy = self

        def batch_isend_irecv(ops):
            spy.steps[-1][0] += 1
            spy.steps[-1][1] += sum(
                op.tensor.numel() * op.tensor.element_size()
                for op in ops if op.op is dist.isend)
            return spy._orig(ops)

        dist.batch_isend_irecv = batch_isend_irecv
        return self

    def mark_step(self):
        self.steps.append([0, 0])

    def __exit__(self, *exc):
        self._dist.batch_isend_irecv = self._orig


def rank_worker(rank, world, tmp, what):
    """One rank of a cross-card run: cuda:rank, NCCL, a (world, 1) mesh
    over TRAIN_AGENTS agents, 2-bit LEAD on ring(4).  "small": the
    ranks_small run (reduced granite, RANKS_SMALL_STEPS steps), rank 0
    writing the gathered state; "at_scale": train_at_scale's granite (2
    layers, batch 2 x seq 128), one warm-up step and TRAIN_STEPS timed,
    with the bytes each step hands to isend."""
    import dataclasses

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.dist.trainer import layout_of
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    dc = _dist_config(RANKS_SMALL_RUNS["lead_2bit"])
    whole = None
    try:
        mesh = make_mesh((world, 1))
        if what == "small":
            cfg = get_config("granite-3-2b").reduced()
            ds = LMStreamConfig(vocab=cfg.vocab, seq_len=32,
                                batch_per_agent=2, n_agents=TRAIN_AGENTS)
            batches = _train_batches(cfg, ds, RANKS_SMALL_STEPS, dev)
            st, metrics, launches, ms = _train_run(cfg, dc, dev, batches,
                                                   mesh)
            # rank 0 gathers every agent's rows into host arrays
            whole = layout_of(cfg, mesh, TRAIN_AGENTS).gather(
                st._replace(opt=()))
            sends = None
        else:
            cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
            ds = LMStreamConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                batch_per_agent=TRAIN_BATCH,
                                n_agents=TRAIN_AGENTS, seed=0)
            batches = _train_batches(cfg, ds, TRAIN_STEPS + 1, dev)
            with SendSpy() as spy:
                _, metrics, launches, ms = _train_run(cfg, dc, dev, batches,
                                                      mesh, warmup=1,
                                                      on_step=spy.mark_step)
            sends = spy.steps[1:-1]
        bits = [float(m["bits_per_agent"]) for m in metrics]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        if whole is not None:
            whole = _state_to(whole, "cpu")
            torch.save({"params": whole.params, "algo": whole.algo},
                       os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "rank0.json"), "w") as f:
            json.dump({"ms_per_step": ms, "launches": launches,
                       "bits": bits, "sends": sends}, f)
    return 0


def phase_ranks_small(dev, smi):
    """The trainer's rank path (dist/trainer.py on torch.distributed) on
    the card: train_small's reduced granite-3-2b, 4 agents, batch 2 x seq
    32, RANKS_SMALL_STEPS steps, in a one-rank NCCL group (its (1, 1)
    mesh holds all 4 agents, so every round is local) against the
    no-group path on the card, for LEAD 2-bit, allreduce and LEAD on
    hierarchical(ring(2), 2): bit for bit (the two paths sum in the same
    order), else within RANKS_RTOL of the state's scale; bits and
    grad_norm equal; K4 = K2 = K3 = one per leaf per step on LEAD's runs,
    none on allreduce's, on both paths.  With two or more cards, the LEAD
    run also with one rank per card (2 or 4 ranks, chip_smoke.py
    --rank-worker), held against the one-rank run the same way; else the
    line says the cross-card run was not made."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("granite-3-2b").reduced()
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=32, batch_per_agent=2,
                        n_agents=TRAIN_AGENTS)
    batches = _train_batches(cfg, ds, RANKS_SMALL_STEPS, dev)
    n_leaves = None
    out, launches_by_run, rank_states = {}, {}, {}
    with OneRankGroup(dev) as mesh:
        for name, kw in RANKS_SMALL_RUNS.items():
            dc = _dist_config(kw)
            runs = {path: _train_run(cfg, dc, dev, batches, m)
                    for path, m in (("no_group", None), ("rank", mesh))}
            (s0, m0, l0, ms0), (s1, m1, l1, ms1) = runs["no_group"], \
                runs["rank"]
            n_leaves = len(tree_leaves(s0.params))
            per = n_leaves * RANKS_SMALL_STEPS
            want = ({} if kw["algorithm"] == "allreduce" else
                    {"quantize_encode": per, "quantize_decode": per,
                     "lead_update": per})
            expect_launches(l0, want, f"ranks_small {name} no group")
            expect_launches(l1, want, f"ranks_small {name} rank path")
            same, gap = _state_gap(s1, s0)
            check(same or gap <= RANKS_RTOL,
                  f"ranks_small {name}: rank path vs no group {gap}")
            for k in m0[0]:
                a = torch.stack([m[k] for m in m0]).cpu()
                b = torch.stack([m[k] for m in m1]).cpu()
                tol = 0 if k != "grad_norm" else RANKS_RTOL
                check(bool(((a - b).abs() <= tol * a.abs()).all()),
                      f"ranks_small {name}: {k} {a.tolist()} {b.tolist()}")
            out[name] = {"bit_identical": same, "gap": gap,
                         "ms_per_step_no_group": ms0,
                         "ms_per_step_rank": ms1, "launches_rank": l1,
                         "bits_per_agent": float(m1[0].get(
                             "bits_per_agent", 0.0))}
            launches_by_run[name] = l1
            rank_states[name] = _state_to(s1, "cpu")
            del runs, s0, s1
    cards = torch.cuda.device_count()
    n_cards = min(cards, RANKS_MAX_CARDS)
    n_cards = n_cards if n_cards in (2, 4) else (2 if cards >= 2 else 1)
    if n_cards >= 2:
        res = _cross_card_run(n_cards, "small")
        same, gap = _state_gap(res["state"], rank_states["lead_2bit"])
        check(same or gap <= RANKS_RTOL,
              f"ranks_small across {n_cards} cards: {gap}")
        # on ring(4) over 2 or 4 ranks, both rounds deliver a remote
        # payload to each rank: K2 decodes its own and one per round
        small = n_leaves * RANKS_SMALL_STEPS
        expect_launches(res["launches"], {
            "quantize_encode": small, "quantize_decode": 3 * small,
            "lead_update": small}, f"ranks_small across {n_cards} cards")
        big = _cross_card_run(n_cards, "at_scale")
        per = TRAIN_AT_SCALE["train_at_scale"]["leaves"] * TRAIN_STEPS
        expect_launches(big["launches"], {
            "quantize_encode": per, "quantize_decode": 3 * per,
            "lead_update": per}, f"train_at_scale across {n_cards} cards")
        check(big["bits"] == [TRAIN_AT_SCALE["train_at_scale"]["bits"]]
              * (TRAIN_STEPS + 1), f"at_scale across cards: {big['bits']}")
        out["cross_card"] = {
            "cards": n_cards, "bit_identical": same, "gap": gap,
            "ms_per_step": res["ms_per_step"],
            "launches_rank0": res["launches"],
            "train_at_scale": {
                "ms_per_step": big["ms_per_step"],
                "launches_rank0": big["launches"],
                "isend_calls_and_bytes_per_step_rank0": big["sends"]}}
    else:
        out["cross_card"] = ("not made: this machine has one card "
                             "(NCCL takes one rank per card)")
        print("ranks_small: the cross-card run was not made (one card)",
              file=sys.stderr)
    emit({"phase": "ranks_small", "arch": cfg.name, "n_agents": TRAIN_AGENTS,
          "steps": RANKS_SMALL_STEPS, "leaves": n_leaves, "nvidia_smi": smi,
          **out})
    return launches_by_run


def _ckpt_run(cfg, dc, dev, batches, tmp, mesh=None):
    """ckpt_at_scale's run (the rank path on `mesh` when given): 2 x
    CKPT_STEPS steps straight; CKPT_STEPS steps, checkpoint.save into
    `tmp` (with the layout on a mesh), a fresh state of another seed
    restored from it (equal to the saved state bit for bit), CKPT_STEPS
    more.  Returns the straight and resumed states on the host, the
    straight run's launches, the file, the save and restore seconds and
    the device memory each allocated above the live state (peak minus
    what was allocated before the save; peak minus what was allocated
    after the restore, its result included)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.dist.sharding import train_batch_rows
    from repro_torch.dist.trainer import (init_train_state, layout_of,
                                          make_train_step)
    from repro_torch.kernels import cuda_lib

    A = TRAIN_AGENTS
    lay = layout_of(cfg, mesh, A)
    step = make_train_step(cfg, A, dc, dev, mesh=mesh)

    def fresh(seed):
        return init_train_state(cfg, A, dc,
                                torch.Generator(dev).manual_seed(seed), dev,
                                mesh=mesh)

    def run(st, lo, hi):
        for i in range(lo, hi):
            st, _ = step(st, train_batch_rows(lay, batches[i]), 0, step=i)
        return st

    cuda_lib.reset_launch_counts()
    straight = _state_to(run(fresh(0), 0, 2 * CKPT_STEPS), "cpu")
    launches = cuda_lib.launch_counts()
    half = run(fresh(0), 0, CKPT_STEPS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    path = ckpt.save(tmp, CKPT_STEPS, half, layout=lay)
    save_s = time.perf_counter() - t0
    save_extra = torch.cuda.max_memory_allocated(dev) - before
    other = fresh(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    back, at = ckpt.restore(tmp, other, layout=lay)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_extra = (torch.cuda.max_memory_allocated(dev)
                     - torch.cuda.memory_allocated(dev))
    del other
    same_restore, _ = _state_gap(back, half)
    check(at == CKPT_STEPS and same_restore and int(back.step) == CKPT_STEPS,
          f"ckpt_at_scale: restored step {at} differs from the saved state")
    del half
    resumed = _state_to(run(back, CKPT_STEPS, 2 * CKPT_STEPS), "cpu")
    del back
    torch.cuda.empty_cache()
    return {"straight": straight, "resumed": resumed, "launches": launches,
            "path": path, "save_s": save_s, "restore_s": restore_s,
            "save_extra": save_extra, "restore_extra": restore_extra}


def _same_files(a, b):
    """Two checkpoint files hold the same path keys and leaves (dtype,
    shape and every value), compared one leaf at a time."""
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files) or \
                json.loads(x["__meta__"].item()) != \
                json.loads(y["__meta__"].item()):
            return False
        for k in x.files:
            u, v = x[k], y[k]
            if u.dtype != v.dtype or not np.array_equal(u, v):
                return False
    return True


def phase_ckpt_at_scale(dev, smi):
    """Checkpoint and resume at scale: whisper-tiny whole (4 encoder and 4
    decoder layers, 56,357,380 parameters per agent), 4 agents, 2-bit LEAD
    (SGD at eta 0.03, batch 2 x seq 128 and the audio stub).  CKPT_STEPS
    steps, checkpoint.save (params, h, hw and d of every agent), a fresh
    state of another seed restored from the file (equal to the saved state
    bit for bit), CKPT_STEPS more steps: the result equals an uninterrupted
    run of 2 x CKPT_STEPS steps bit for bit.  Then ckpt_at_scale/ranks: the
    same run through the trainer's rank path in a one-rank NCCL group that
    holds all 4 agents, the file written and read through its layout: the
    file equal to the first run's leaf for leaf, the resumed run bit for
    bit the straight one, and the device memory that save and restore
    allocate above the live state at most the largest stacked leaf's bytes
    (the tree staged on the host, never on the card).  Prints the file's
    GB and each run's save and restore seconds and extra memory; the
    directories are deleted.  Returns each run's launches."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(CKPT_ARCH)
    A = TRAIN_AGENTS
    dc = _dist_config({"algorithm": "lead"})
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                        batch_per_agent=TRAIN_BATCH, n_agents=A, seed=0)
    batches = _train_batches(cfg, ds, 2 * CKPT_STEPS, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        one = _ckpt_run(cfg, dc, dev, batches, os.path.join(tmp, "one"))
        with OneRankGroup(dev) as mesh:
            ranks = _ckpt_run(cfg, dc, dev, batches,
                              os.path.join(tmp, "ranks"), mesh)
        same_file = _same_files(one["path"], ranks["path"])
        size = os.path.getsize(one["path"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    largest = max(l.numel() * l.element_size()
                  for l in tree_leaves(one["straight"]) if l.ndim)
    n_params = sum(l[0].numel() for l in tree_leaves(one["resumed"].params))
    out = {}
    for name, r in (("no_group", one), ("ranks", ranks)):
        same, gap = _state_gap(r["resumed"], r["straight"])
        out[name] = {"save_s": r["save_s"], "restore_s": r["restore_s"],
                     "save_GB_per_s": size / 1e9 / r["save_s"],
                     "restore_GB_per_s": size / 1e9 / r["restore_s"],
                     "save_extra_bytes": r["save_extra"],
                     "restore_extra_bytes": r["restore_extra"],
                     "bit_identical": same, "launches_straight":
                     r["launches"]}
        check(same, f"ckpt_at_scale {name}: resumed run differs from the "
              f"straight run ({gap} of the state's scale)")
    same_paths, _ = _state_gap(ranks["resumed"], one["resumed"])
    emit({"phase": "ckpt_at_scale", "arch": cfg.name, "n_agents": A,
          "params_per_agent": n_params, "steps": [CKPT_STEPS, CKPT_STEPS],
          "file_GB": size / 1e9, "largest_stacked_leaf_bytes": largest,
          "files_equal": same_file, "ranks_equal_no_group": same_paths,
          "nvidia_smi": smi, **out})
    check(same_file, "ckpt_at_scale/ranks: the layout's file differs from "
          "the one-process file")
    check(same_paths, "ckpt_at_scale/ranks: the rank path's resumed state "
          "differs from the no-group path's")
    check(ranks["save_extra"] <= largest and ranks["restore_extra"] <= largest,
          f"ckpt_at_scale/ranks: save staged {ranks['save_extra']} and "
          f"restore {ranks['restore_extra']} bytes on the card above the live "
          f"state, more than the largest stacked leaf's {largest}")
    torch.cuda.empty_cache()
    return one["launches"], ranks["launches"]


def phase_train_at_scale(dev, smi, flops, what):
    """The trainer at scale, TRAIN_AT_SCALE[what]: the arch at its published
    width, depth cut to the spec's n_layers, its agents on a ring, LEAD on
    the 2-bit p=inf wire in blocks of 512, the spec's optimizer and eta
    (SGD at 0.03 but for xLSTM), the heterogeneous stream at batch 2 x seq
    128 (and the stub memory of a vlm or audio model), seed 0.  One warm-up
    step, then TRAIN_STEPS timed: launches per step K4 = K2 = K3 = one per
    leaf and K1 = K5 = K6 = 0; the leaves, parameters and bits exactly the
    spec's (the bits every step); the mean loss over agents on batch 0
    below its value at step 0; the dual sum below TRAIN_DUAL_SUM (x 0.03 /
    eta) on every leaf; everything finite; peak allocated below
    TRAIN_PEAK_GB.  Prints ms/step by the host clock, the
    stage sums of two more steps (core/stage_timer.py; each stage summed
    over its per-leaf marks), the gradient's operations
    (train_gradient_flop) and its rate against the card's fp32 peak
    `flops`, the peak allocated and `smi`; for an MoE the routing of batch
    0 on the final weights (pairs dropped, the heaviest expert's load).
    A spec with ``ranks`` runs again through the rank path
    (train_at_scale_ranks).  Returns (launches, the rank path's launches
    or None)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.stage_timer import StageTimer
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.dist.trainer import (DistConfig, agent_losses,
                                          init_train_state, make_train_step)
    from repro_torch.kernels import cuda_lib
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    spec = TRAIN_AT_SCALE[what]
    cfg = get_config(spec["arch"])
    if spec["n_layers"] is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    A, n_leaves = spec["agents"], spec["leaves"]
    dc = DistConfig(algorithm="lead", hyper={"eta": spec["eta"]},
                    optimizer=make_optimizer(spec["optimizer"]))
    dual_bound = TRAIN_DUAL_SUM * TRAIN_ETA / spec["eta"]
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                        batch_per_agent=TRAIN_BATCH, n_agents=A, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, A, dc, torch.Generator(dev).manual_seed(0),
                             dev)
    leaves = tree_leaves(state.params)
    n_params = sum(l[0].numel() for l in leaves)
    check(len(leaves) == n_leaves and n_params == spec["params"],
          f"{what}: {len(leaves)} leaves, {n_params} parameters")
    step = make_train_step(cfg, A, dc, dev)
    b0 = _train_batches(cfg, ds, 1, dev)[0]
    loss0 = float(agent_losses(cfg, state.params, b0).mean())
    state, _ = step(state, b0, 0, step=0)                  # warm-up step
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = _train_batches(cfg, ds, TRAIN_STEPS, dev, start=1)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    metrics = []
    for i, b in enumerate(batches, start=1):
        state, m = step(state, b, 0, step=i)
        events[i].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the device's time per step (between the events queued after each
    # step) and the allocator's retries: a host clock above the device's
    # sum is time the card waited on the host
    device_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    expect_launches(launches, {"quantize_encode": n_leaves * TRAIN_STEPS,
                               "quantize_decode": n_leaves * TRAIN_STEPS,
                               "lead_update": n_leaves * TRAIN_STEPS}, what)
    bits = torch.stack([m["bits_per_agent"] for m in metrics]).cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).cpu()
    check(bool((bits == spec["bits"]).all()), f"{what}: bits {bits.tolist()}")
    finite = all(bool(torch.isfinite(l).all())
                 for t in (state.params, *state.algo.values())
                 for l in tree_leaves(t))
    check(finite and bool(torch.isfinite(norms).all()),
          f"{what}: non-finite state or grad_norm")
    routing = {}
    with RouteSpy() as spy:
        loss1 = float(agent_losses(cfg, state.params, b0).mean())
    if cfg.n_experts:
        dropped, heavy, cap = spy.load(cfg.n_experts)
        routing = {"routing": {"capacity": spy.calls[0][2],
                               "dropped_share": dropped,
                               "heaviest_expert_load": heavy,
                               "capacity_over_balanced": cap,
                               "routings": len(spy.calls)}}
    check(loss1 < loss0, f"{what}: loss {loss0} -> {loss1}")
    dual = [float(l.sum(0).abs().max()) for l in tree_leaves(state.algo["d"])]
    check(max(dual) < dual_bound, f"{what}: dual sum {max(dual)}")
    check(peak / 1e9 < TRAIN_PEAK_GB, f"{what}: peak {peak / 1e9} GB")

    # stage sums of two more steps, each stage summed over its marks (one
    # per leaf) and averaged over the steps
    extra = _train_batches(cfg, ds, 2, dev, start=TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    with StageTimer(dev) as timer:
        for i, b in enumerate(extra, start=TRAIN_STEPS + 1):
            state, _ = step(state, b, 0, step=i)
    acc, marks = {}, {}
    for name, ms in timer.stages():
        key = TRAIN_STAGES.get(name, name)
        acc[key] = acc.get(key, 0.0) + ms / len(extra)
        marks[key] = marks.get(key, 0) + 1 / len(extra)
    check(set(acc) == set(TRAIN_STAGES.values()), f"{what}: stages "
          f"{sorted(acc)}")
    gb_plane = A * n_params * 4 / 1e9
    grad_flop = train_gradient_flop(cfg, A, TRAIN_BATCH, TRAIN_SEQ)
    grad_rate = grad_flop / (acc["gradient"] * 1e-3)
    emit({"phase": what, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.kv_heads],
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "block_pattern": list(cfg.block_pattern),
          "encoder_layers": cfg.encoder_layers,
          "n_agents": A, "optimizer": spec["optimizer"], "eta": spec["eta"],
          "params_per_agent": n_params,
          "leaves": len(leaves), "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "steps": TRAIN_STEPS, "nvidia_smi": smi,
          "ms_per_step": wall * 1e3 / TRAIN_STEPS,
          "breakdown_ms": acc, "marks_per_step": marks,
          "breakdown_total_ms": sum(acc.values()),
          "gradient_flop": grad_flop, "gradient_flop_per_s": grad_rate,
          "gradient_f32_peak_share": grad_rate / flops,
          "device_ms_per_step": device_ms,
          "max_memory_allocated_GB": peak / 1e9,
          "max_memory_reserved_GB": torch.cuda.max_memory_reserved() / 1e9,
          "alloc_retries": retries,
          "f32_plane_GB": gb_plane, "setup_s": setup_s,
          "launches": launches, "launches_per_step": per_step,
          "bits_per_agent": float(bits[0]),
          "bits_ratio_vs_f32": 32.0 * n_params / float(bits[0]),
          "loss": [loss0, loss1], "grad_norm": [float(norms[0]),
                                                float(norms[-1])],
          "dual_sum_max": max(dual), "dual_sum_bound": dual_bound,
          **routing})
    rank_launches = None
    if spec.get("ranks"):
        held = _state_to(state, "cpu")
        del state, step
        torch.cuda.empty_cache()
        rank_launches = train_at_scale_ranks(
            cfg, dc, dev, [b0] + batches + extra, held,
            wall * 1e3 / TRAIN_STEPS, what, smi, n_leaves)
        del held
    else:
        del state, step
    del batches, extra, metrics
    torch.cuda.empty_cache()
    return launches, rank_launches


def train_at_scale_ranks(cfg, dc, dev, batches, held, no_group_ms, what,
                         smi, n_leaves):
    """`what`'s run again through the rank path in a one-rank NCCL group
    (its (1, 1) mesh holds every agent): the same warm-up step, the same
    TRAIN_STEPS timed steps by the host clock, the two steps after; the
    final state against the no-group run's `held` (on the host), bit for
    bit or within RANKS_RTOL of its scale; launches as the no-group
    path's."""
    from repro_torch.dist.trainer import init_train_state, make_train_step
    from repro_torch.kernels import cuda_lib

    A = TRAIN_AGENTS
    with OneRankGroup(dev) as mesh:
        state = init_train_state(cfg, A, dc,
                                 torch.Generator(dev).manual_seed(0), dev,
                                 mesh=mesh)
        step = make_train_step(cfg, A, dc, dev, mesh=mesh)
        state, _ = step(state, batches[0], 0, step=0)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(1, TRAIN_STEPS + 1):
            state, _ = step(state, batches[i], 0, step=i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        launches = cuda_lib.launch_counts()
        for i in range(TRAIN_STEPS + 1, len(batches)):
            state, _ = step(state, batches[i], 0, step=i)
        same, gap = _state_gap(state, held)
        del state, step
    torch.cuda.empty_cache()
    per = n_leaves * TRAIN_STEPS
    expect_launches(launches, {"quantize_encode": per,
                               "quantize_decode": per, "lead_update": per},
                    f"{what} rank path")
    check(same or gap <= RANKS_RTOL,
          f"{what} rank path vs no group: {gap} of the state's scale")
    emit({"phase": f"{what}/ranks", "world": 1, "bit_identical": same,
          "gap": gap, "ms_per_step_rank": ms,
          "ms_per_step_no_group": no_group_ms, "launches": launches,
          "nvidia_smi": smi})
    return launches


# -- serving (serve/, the decode side of models/) -------------------------------

SERVE_KERNELS = ("quantize_encode", "quantize_decode")
SERVE_PROMPT = 20           # serve_small: the prompt (B = 2) and its steps
SERVE_STEPS = 24
# card against CPU, of the largest |logit|, by the cache's dtype (a bf16
# cache: a k whose f32 value differs in its last bit may round to the next
# bf16, 2^-8 away; the CPU tests' 1e-3)
SERVE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
SERVE_CODE_FRAC = 1e-5      # 4-bit pages: codes that may differ, card vs CPU
SERVE_PEAK_GB = 75.0
# serve_small's depth where two layers miss a block type of the family
SERVE_SMALL_DEPTH = {"xlstm-1.3b": 6, "recurrentgemma-2b": 3}
# the paged engine's archs in serve_small: (cache_len, decode steps); gemma
# decodes past its 128-token window so that its rings wrap
SERVE_PAGED = {"granite-3-2b": (64, 24), "gemma3-12b": (192, 150),
               "granite-moe-1b-a400m": (64, 24)}
# the serving phases at scale, each a whole published model with f32 weights
# drawn on the card: the engine at 4-bit pages, its load (n requests with
# counter-hash prompts spread evenly over the lengths, all submitted at
# once), then the exact engine on the first `exact` requests against the
# contiguous single-sequence path; pinned: parameters, and K4 = K2 = two
# launches per layer per decode step and per prefill chunk
SERVE_AT_SCALE = {
    "serve_at_scale": dict(arch="granite-3-2b", params=2_634_201_088,
                           max_batch=16, requests=32, prompt=(64, 768),
                           max_new=128, exact=4),
    "serve_rolling_at_scale": dict(arch="gemma3-12b",
                                   params=12_630_470_400, max_batch=4,
                                   requests=6, prompt=(1040, 1500),
                                   max_new=48, exact=1),
}
SERVE_PAGE, SERVE_MAX_LEN, SERVE_BITS = 16, 2048, 4


def _contiguous_run(params, cfg, toks, steps, cache_len, memory=None,
                    feed=None, paged=None, cache_dtype=torch.bfloat16):
    """prefill then `steps` greedy decode steps on the contiguous path
    (with `paged`, a paged_from_contiguous(**paged) copy of the prefill's
    cache decoded beside it).  `feed` gives the tokens to decode (another
    device's argmax), else each step's own argmax.  Returns the logits of
    every step on the host (prefill first), the tokens fed, the paged
    run's logits and its last cache."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous

    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, toks, memory=memory,
                                cache_len=cache_len, cache_dtype=cache_dtype)
        pcache = (paged_from_contiguous(cache, cfg, **paged)
                  if paged is not None else None)
        if pcache is not None:
            # a second contiguous cache for the paged twin to start from
            _, cache = tfm.prefill(params, cfg, toks, memory=memory,
                                   cache_len=cache_len,
                                   cache_dtype=cache_dtype)
        logits, fed, plogits = [lg.cpu()], [], []
        tok = lg[:, -1].argmax(-1)[:, None]
        ptok = tok
        for i in range(steps):
            if feed is not None:
                tok = ptok = feed[i].to(toks.device)
            fed.append(tok.cpu())
            lg, cache = tfm.decode_step(params, cfg, tok, cache)
            logits.append(lg.cpu())
            if pcache is not None:
                plg, pcache = tfm.decode_step(params, cfg, ptok, pcache)
                plogits.append(plg.cpu())
                ptok = plg[:, -1].argmax(-1)[:, None]
            tok = lg[:, -1].argmax(-1)[:, None]
    return logits, fed, plogits, pcache


def _held_steps(spy_card, spy_cpu, calls_per_step):
    """How many leading entries of a run (prefill, then each decode step)
    routed every MoE token as the CPU did, and the tokens that flip."""
    if not spy_cpu.calls:
        return None, 0
    flips = spy_card.flips(spy_cpu)
    for c, ((a, _, _), (b, _, _)) in enumerate(zip(spy_card.calls,
                                                   spy_cpu.calls)):
        if not torch.equal(a.cpu(), b.cpu()):
            return c // calls_per_step, flips
    return None, flips


def serve_small_arch(dev, arch):
    """One arch of serve_small at .reduced() (deeper where SERVE_SMALL_DEPTH
    says), the same weights, prompt (B = 2, SERVE_PROMPT tokens) and stub
    memory on the card and the CPU: prefill and SERVE_STEPS decode steps
    on the contiguous path with an f32 and a bf16 cache, the card fed the
    CPU's tokens, every step's logits within SERVE_RTOL of the CPU's
    largest |logit| (an MoE's on the steps before its first routing
    flip; fed is the bf16 run's tokens, the cache the paged runs use).  For the SERVE_PAGED archs also:
    the exact paged cache against the contiguous one on the card, bit for
    bit at every step (gemma past its window: the rings wrap), and 4-bit
    pages (paged_from_contiguous of each device's prefill cache) decoded
    on both devices with the CPU's tokens: of every code the run encodes,
    those differing below SERVE_CODE_FRAC; K4 and K2 twice per layer per
    step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import stub_memory
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch).reduced(n_layers=SERVE_SMALL_DEPTH.get(arch, 2))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, SERVE_PROMPT),
                         generator=torch.Generator().manual_seed(1))
    mem = stub_memory(cfg.family, (2,), cfg, device="cpu")
    cache_len = SERVE_PAGED.get(arch, (64,))[0]
    out = {"arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers}
    dparams = _tree_to(params, dev)
    for dtype in (torch.float32, torch.bfloat16):
        with RouteSpy() as cspy:
            clog, fed, _, _ = _contiguous_run(params, cfg, toks, SERVE_STEPS,
                                              cache_len, mem,
                                              cache_dtype=dtype)
        with RouteSpy() as gspy:
            glog, _, _, _ = _contiguous_run(
                dparams, cfg, toks.to(dev), SERVE_STEPS, cache_len,
                None if mem is None else mem.to(dev), feed=fed,
                cache_dtype=dtype)
        first_flip, flips = _held_steps(gspy, cspy, max(1, sum(
            t in ("attn", "local", "global") for t in cfg.layer_types())))
        held = len(clog) if first_flip is None else first_flip
        gap = max((max_abs(g, c) / float(c.abs().max())
                   for g, c in zip(glog[:held], clog[:held])), default=0.0)
        name = f"contiguous_{str(dtype).split('.')[-1]}"
        out[name] = {"logit_gap": gap, "bound": SERVE_RTOL[dtype],
                     "steps_held": held, "routing_flips": flips}
        check(gap <= SERVE_RTOL[dtype], f"serve_small {cfg.name}: card vs "
              f"CPU logits {out[name]}")
        check(flips <= 0.01 * sum(ids.shape[0] for ids, _, _ in cspy.calls),
              f"serve_small {cfg.name}: {flips} routing flips")
    if arch not in SERVE_PAGED:
        emit({"phase": "serve_small", **out})
        return out, {k: 0 for k in SERVE_KERNELS}
    cache_len, steps = SERVE_PAGED[arch]
    logs, _, plogs, _ = _contiguous_run(dparams, cfg, toks.to(dev), steps,
                                        cache_len, paged={"page": 16})
    equal = [torch.equal(a, b) for a, b in zip(logs[1:], plogs)]
    first = next((i for i, e in enumerate(equal) if not e), None)
    out["paged_exact"] = {"cache_len": cache_len, "steps": steps,
                          "bit_identical_steps": sum(equal)}
    check(first is None, f"serve_small {cfg.name}: exact paged logits "
          f"differ from the contiguous path's at step {first}")
    paged4 = {"page": 16, "kv_bits": SERVE_BITS}
    runs = {}
    for device in ("cpu", dev):
        p = params if device == "cpu" else dparams
        cuda_lib.reset_launch_counts()
        with KVCodeSpy() as spy:
            _, _, qlog, _ = _contiguous_run(
                p, cfg, toks.to(device), SERVE_STEPS, cache_len,
                feed=fed, paged=paged4)
        runs[device] = (qlog, spy.codes)
    launches = cuda_lib.launch_counts()
    # paged_from_contiguous encodes every page once, then each decode step
    # encodes the tails and decodes the view: K and V of every layer
    per_step = 2 * cfg.n_layers
    expect_launches(launches, {"quantize_encode": per_step * (SERVE_STEPS + 1),
                               "quantize_decode": per_step * SERVE_STEPS},
                    f"serve_small {cfg.name} 4-bit")
    (cq, cc), (gq, gc) = runs["cpu"], runs[dev]
    check(len(gc) == len(cc), f"serve_small {cfg.name}: {len(gc)} encodes, "
          f"{len(cc)} on the CPU")
    differ = sum(int((a != b).sum()) for a, b in zip(gc, cc))
    total = sum(b.numel() for b in cc)
    held = len(cq) if first_flip is None else max(first_flip - 1, 0)
    out["paged_4bit"] = {
        "codes_differing": differ, "codes": total, "share": differ / total,
        "logit_gap": max((max_abs(g, c) / float(c.abs().max())
                          for g, c in zip(gq[:held], cq[:held])),
                         default=0.0),
        "launches": launches}
    check(first_flip is not None or differ < SERVE_CODE_FRAC * total,
          f"serve_small {cfg.name}: {differ} of {total} codes differ")
    emit({"phase": "serve_small", **out})
    return out, launches


def phase_serve_small(dev):
    """Every registry arch served on the card against the CPU (one line
    each); returns the K4/K2 launches of the 4-bit paged runs, summed."""
    from repro_torch.configs.registry import list_archs

    total = {k: 0 for k in SERVE_KERNELS}
    for arch in sorted(list_archs()):
        _, launches = serve_small_arch(dev, arch)
        for k in total:
            total[k] += launches[k]
    return total


class KVCodeSpy:
    """Records, on the host, the codes of every K4 encode (kernels/quantize
    .encode, which kv_quant.encode_rows calls) made inside its with block,
    in call order: to hold one device's KV codes against another's."""

    def __enter__(self):
        from repro_torch.kernels import quantize

        self.codes, self._mod, self._orig = [], quantize, quantize.encode
        spy = self

        def encode(x, u, *, bits=2):
            code, scale = spy._orig(x, u, bits=bits)
            spy.codes.append(code.cpu())
            return code, scale

        quantize.encode = encode
        return self

    def __exit__(self, *exc):
        self._mod.encode = self._orig


class StepSpy:
    """Wraps ServeEngine's two step functions while active: a CUDA event
    pair around every call (device time, read after the run) and the
    kernel launches each call made (host counters, no sync)."""

    def __enter__(self):
        from repro_torch.kernels import cuda_lib
        from repro_torch.serve.engine import ServeEngine

        self.calls = {"decode": [], "prefill": []}
        self._cls, self._orig = ServeEngine, (ServeEngine._decode,
                                              ServeEngine._prefill)
        spy = self

        def wrap(kind, fn):
            def timed(eng, *args):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                before = cuda_lib.launch_counts()
                a.record()
                out = fn(eng, *args)
                b.record()
                after = cuda_lib.launch_counts()
                spy.calls[kind].append(
                    (a, b, {k: after[k] - before[k] for k in after}))
                return out
            return timed

        ServeEngine._decode = wrap("decode", self._orig[0])
        ServeEngine._prefill = wrap("prefill", self._orig[1])
        return self

    def __exit__(self, *exc):
        self._cls._decode, self._cls._prefill = self._orig

    def summary(self, kind):
        """(median ms per call, the distinct launch counts per call)."""
        calls = self.calls[kind]
        ms = [a.elapsed_time(b) for a, b, _ in calls]
        kinds = {tuple(sorted(d.items())) for _, _, d in calls}
        return statistics.median(ms), [dict(k) for k in kinds], len(calls)


class LogitSpy:
    """Records, on the host, the top two logits and the largest |logit| of
    every lane of every decode step (transformer.decode_step) and of the
    last prefill chunk of every slot (transformer.prefill_chunk) made
    inside its with block: the exact engine's margins, to read a
    near-tie."""

    def __enter__(self):
        from repro_torch.models import transformer as tfm

        self.decode, self.prefill = [], {}
        self._mod, self._orig = tfm, (tfm.decode_step, tfm.prefill_chunk)
        spy = self

        def top2(lg):
            top = torch.topk(lg, 2)
            return (top.values[..., 0] - top.values[..., 1]).cpu(), \
                lg.abs().amax(-1).cpu()

        def decode_step(params, cfg, token, cache, memory=None):
            lg, cache = spy._orig[0](params, cfg, token, cache, memory)
            spy.decode.append(top2(lg[:, -1]))
            return lg, cache

        def prefill_chunk(params, cfg, tokens, cache, slot, start,
                          valid_len):
            lg, cache = spy._orig[1](params, cfg, tokens, cache, slot, start,
                                     valid_len)
            spy.prefill[slot] = top2(lg[0, -1])
            return lg, cache

        tfm.decode_step, tfm.prefill_chunk = decode_step, prefill_chunk
        return self

    def __exit__(self, *exc):
        self._mod.decode_step, self._mod.prefill_chunk = self._orig

    def margin(self, slot, token):
        """(top-1 minus top-2 logit, largest |logit|) behind `token` of the
        sequence in `slot` (token 0 from its prefill, token t from decode
        step t - 1: every sequence admitted in the first tick)."""
        if token == 0:
            m, a = self.prefill[slot]
            return float(m), float(a)
        m, a = self.decode[token - 1]
        return float(m[slot]), float(a[slot])


def _serve_jobs(cfg, n, lo, hi, max_new, seed=0):
    """n requests: counter-hash prompts (faults.counter_hash of the request
    and position, mod vocab) of lengths spread evenly over [lo, hi]."""
    from repro_torch.core.faults import counter_hash

    jobs = []
    for i in range(n):
        L = lo + (hi - lo) * i // max(n - 1, 1)
        h = counter_hash(seed, i, torch.arange(L), 0, 0x5E7E, device="cpu")
        jobs.append(((h % cfg.vocab).tolist(), max_new))
    return jobs


def _greedy_with_margins(params, cfg, prompt, max_new, cache_len, dev):
    """The contiguous single-sequence greedy stream of one prompt, with the
    top-1 minus top-2 logit margin and the largest |logit| behind every
    token (to read a near-tie)."""
    from repro_torch.models import transformer as tfm

    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, torch.tensor([prompt],
                                                          device=dev),
                                cache_len=cache_len)
        toks, margins = [], []
        for i in range(max_new):
            top = torch.topk(lg[0, -1], 2)
            toks.append(top.indices[0:1])
            margins.append(torch.stack([top.values[0] - top.values[1],
                                        lg[0, -1].abs().amax()]))
            if i + 1 < max_new:
                lg, cache = tfm.decode_step(params, cfg,
                                            top.indices[0].reshape(1, 1),
                                            cache)
    return (torch.cat(toks).cpu().tolist(),
            torch.stack(margins).cpu().tolist())


def phase_serve_at_scale(dev, smi, what):
    """SERVE_AT_SCALE[what]: the whole published model, f32 weights drawn on
    the card from a seeded generator (parameters pinned), served through
    launch/serve.serve_requests (the driver's function) by the engine at
    ServeConfig(max_batch, max_len 2048, page 16, kv_bits 4): a bf16 tail,
    block 512.  Every request finishes with max_new tokens; K4 and K2
    launch twice per layer in every decode step and every prefill chunk
    and K1, K3, K5, K6 never; bits/elem exactly 5.0625 and the pool 16 /
    5.0625 smaller than bf16; one step signature each; peak allocated
    below SERVE_PEAK_GB (the weights' drawing included).  Then the exact
    engine (kv_bits=None) on the first `exact` requests: its greedy
    streams equal the contiguous single-sequence path's up to a near-tie
    (the first token where they part must have both paths' top-2 margins
    within SERVE_RTOL[bf16] of the largest |logit|: the two paths round
    differently, chunked prefill against one pass, 16 lanes against one);
    the 4-bit streams' agreement with them is printed, not held
    (random-init margins are noise)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeConfig
    from repro_torch.utils.tree import tree_size

    spec = SERVE_AT_SCALE[what]
    cfg = get_config(spec["arch"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = tree_size(params)
    init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(n_params == spec["params"], f"{what}: {n_params} parameters")
    scfg = ServeConfig(max_batch=spec["max_batch"], max_len=SERVE_MAX_LEN,
                       page=SERVE_PAGE, kv_bits=SERVE_BITS)
    jobs = _serve_jobs(cfg, spec["requests"], *spec["prompt"],
                       spec["max_new"])
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launch_counts()
    with StepSpy() as spy:
        eng, res, rids, wall = serve_requests(cfg, params, scfg, jobs, dev)
    launches = cuda_lib.launch_counts()
    serve_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    st, rep = eng.stats(), eng.cache_report()
    block = eng.cache["layers"][0].spec.block
    del eng
    torch.cuda.empty_cache()
    dec_ms, dec_launches, n_dec = spy.summary("decode")
    pre_ms, pre_launches, n_pre = spy.summary("prefill")
    per_call = {k: (2 * cfg.n_layers if k in SERVE_KERNELS else 0)
                for k in launches}
    check(all(len(res[r]["tokens"]) == m for r, (_, m) in zip(rids, jobs)),
          f"{what}: a request did not finish")
    check(dec_launches == [per_call] and pre_launches == [per_call],
          f"{what}: launches per decode step {dec_launches}, per prefill "
          f"chunk {pre_launches}, expected {per_call}")
    check(block == 512 and rep["bits_per_elem"] == 5.0625
          and rep["hbm_reduction_pool"] == 16 / 5.0625,
          f"{what}: block {block}, cache report {rep}")
    check(st["decode_compiles"] == 1 and st["prefill_compiles"] == 1,
          f"{what}: step signatures {st}")
    check(max(init_peak, serve_peak) < SERVE_PEAK_GB,
          f"{what}: peak {init_peak:.2f} / {serve_peak:.2f} GB")

    # the exact engine against the contiguous single-sequence path
    k = spec["exact"]
    torch.cuda.reset_peak_memory_stats(dev)
    with LogitSpy() as logit_spy:
        exact, eres, erids, _ = serve_requests(
            cfg, params, dataclasses.replace(scfg, kv_bits=None), jobs[:k],
            dev)
    # the k requests fill slots 0..k-1 in order at the first tick
    slots = list(range(k))
    del exact
    torch.cuda.empty_cache()
    streams = [eres[r]["tokens"] for r in erids]
    refs = [_greedy_with_margins(params, cfg, p, m, SERVE_MAX_LEN, dev)
            for p, m in jobs[:k]]
    exact_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    first_diff = [next((i for i, (a, b) in enumerate(zip(s, r)) if a != b),
                       None) for s, (r, _) in zip(streams, refs)]
    # a stream may part from the contiguous path's only at a near-tie: where
    # both paths' top-2 margins lie within the bf16 cache's logit bound
    ties = []
    for slot, d, (_, margins) in zip(slots, first_diff, refs):
        if d is not None:
            em, ea = logit_spy.margin(slot, d)
            cm, ca = margins[d]
            ties.append({"token": d, "engine_margin": em,
                         "contiguous_margin": cm, "max_logit": max(ea, ca),
                         "near_tie": max(em, cm) <= SERVE_RTOL[
                             torch.bfloat16] * max(ea, ca)})
    quant = [res[r]["tokens"] for r in rids[:k]]
    agree = sum(a == b for q, s in zip(quant, streams) for a, b in zip(q, s))
    out = {"phase": what, "nvidia_smi": smi, "arch": cfg.name,
           "n_layers": cfg.n_layers, "params": n_params,
           "weights_gb": 4 * n_params / 1e9, "init_s": init_s,
           "serve_config": dataclasses.asdict(scfg), "block": block,
           "requests": len(jobs), "prompt_tokens": sum(len(p)
                                                       for p, _ in jobs),
           "max_new": spec["max_new"], "wall_s": wall,
           "decode_steps": st["decode_steps"], "tokens_out":
           st["tokens_out"], "tokens_per_sec": st["tokens_per_sec"],
           "decode_ms_median": dec_ms, "decode_calls": n_dec,
           "prefill_ms_per_chunk_median": pre_ms, "prefill_chunks": n_pre,
           "launches_per_decode_step": dec_launches[0],
           "launches_per_prefill_chunk": pre_launches[0],
           "launches": launches, "cache_report": rep,
           "step_signatures": {"decode": st["decode_compiles"],
                               "prefill": st["prefill_compiles"]},
           "peak_gb": {"init": init_peak, "serve": serve_peak,
                       "exact_check": exact_peak},
           "exact_vs_contiguous_first_difference": first_diff,
           "exact_vs_contiguous_ties": ties,
           "quant4_tokens_equal_to_exact": [agree, k * spec["max_new"]]}
    emit(out)
    check(all(t["near_tie"] for t in ties),
          f"{what}: the exact engine's streams part from the contiguous "
          f"path's away from a near-tie: {ties}")
    del params
    torch.cuda.empty_cache()
    return launches


# serve_at_scale/ranks: granite-3-2b whole through dist/serve.py's make_*
# (make_prefill, paged_from_rows, make_paged_decode) at serve_at_scale's
# settings, B lanes of one prompt length (pos % page == page - 1 twice per
# lane in the run: every lane flushes a page at steps 15 and 31), held
# against the no-group prefill and decode_step; on 2 or 4 cards also one
# rank per card (chip_smoke.py --serve-rank-worker)
SERVE_RANKS = dict(arch="granite-3-2b", params=2_634_201_088, batch=16,
                   prompt=256, steps=32)
# across cards the lanes' GEMMs run at B / n rows, so logits may round
# differently: a token may part from the one-card run's only where the
# one-card top-1 minus top-2 margin is within the bf16 cache's logit bound
SERVE_RANKS_TIE = SERVE_RTOL[torch.bfloat16]


class GatherSpy:
    """Counts what every all-gather inside its with block is handed:
    [(calls, bytes)] per step, as the caller calls mark_step."""

    def __enter__(self):
        import torch.distributed as dist

        self.steps, self._dist, self._orig = [[0, 0]], dist, {}
        spy = self
        for name in ("all_gather_single", "all_gather_into_tensor"):
            orig = getattr(dist, name, None)
            if orig is None:
                continue
            self._orig[name] = orig

            def gather(out, inp, *a, _orig=orig, **kw):
                spy.steps[-1][0] += 1
                spy.steps[-1][1] += inp.numel() * inp.element_size()
                return _orig(out, inp, *a, **kw)

            setattr(dist, name, gather)
        return self

    def mark_step(self):
        self.steps.append([0, 0])

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self._dist, name, orig)


def _serve_ranks_inputs(dev):
    """SERVE_RANKS' config, its f32 weights drawn on `dev` from seed 0 and
    its (B, prompt) counter-hash prompts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_size

    spec = SERVE_RANKS
    cfg = get_config(spec["arch"])
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    check(tree_size(params) == spec["params"],
          f"serve_at_scale/ranks: {tree_size(params)} parameters")
    jobs = _serve_jobs(cfg, spec["batch"], spec["prompt"], spec["prompt"], 0)
    tokens = torch.tensor([p for p, _ in jobs], device=dev)
    return cfg, params, tokens


def _serve_fns(cfg, mesh):
    """make_prefill's and make_paged_decode's (fn, shardings) on `mesh` at
    SERVE_RANKS' batch, the cache SERVE_MAX_LEN long."""
    from repro_torch.configs.base import InputShape
    from repro_torch.dist import serve as dserve
    from repro_torch.dist.sharding import make_profile

    B = SERVE_RANKS["batch"]
    prof = make_profile(cfg, mesh.axis_names)
    pre, _, pre_sh, _ = dserve.make_prefill(
        cfg, mesh, prof, InputShape("prefill", SERVE_MAX_LEN, B, "prefill"))
    dec, _, dec_sh, _ = dserve.make_paged_decode(
        cfg, mesh, prof, InputShape("decode", SERVE_MAX_LEN, B, "decode"),
        page=SERVE_PAGE, kv_bits=SERVE_BITS)
    return pre, pre_sh, dec, dec_sh


def _pool_digest(cache):
    """sha256 of every layer's pool bytes, the spare row aside."""
    import hashlib

    h = hashlib.sha256()
    for c in cache["layers"]:
        for n in c.pool_fields:
            h.update(getattr(c, n)[:-1].contiguous().view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


class _Timed:
    """CUDA events around calls and the kernel launches each made."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn, *args):
        from repro_torch.kernels import cuda_lib

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        before = cuda_lib.launch_counts()
        a.record()
        out = fn(*args)
        b.record()
        after = cuda_lib.launch_counts()
        self.calls.append((a, b, {k: after[k] - before[k] for k in after}))
        return out

    def ms(self):
        return statistics.median(a.elapsed_time(b) for a, b, _ in self.calls)

    def launches(self):
        return [d for _, _, d in self.calls]


def card_rank_worker(flag, rank, world, tmp):
    """One rank across cards (``chip_smoke.py flag rank world tmp``):
    cuda:rank, NCCL over a FileStore in tmp, a (world, 1) mesh; saves the
    results of RANK_RUNS[flag](dev, mesh) as tmp/rank{rank}.pt."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        res = RANK_RUNS[flag](dev, make_mesh((world, 1)))
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    return 0


def _across_cards(flag, n_cards, what):
    """Run card_rank_worker(flag) on n_cards cards, one process each, and
    return their results in rank order."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               flag, str(r), str(n_cards), tmp], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(n_cards)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not errs, f"{what} across {n_cards} cards: " + "\n".join(errs))
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
           for r in range(n_cards)]
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def _serve_rank_run(dev, mesh):
    """One rank of serve_at_scale/ranks across cards on `dev` over `mesh`
    (a (world, 1) mesh): the rank's B / world lanes through make_prefill,
    paged_from_rows and SERVE_RANKS' steps of make_paged_decode's fn,
    greedy on its own logits; its tokens and logits (on the host), its
    pools' digest, ms per step and the bytes it handed to each step's
    all-gathers."""
    from repro_torch.dist import serve as dserve

    cfg, params, tokens = _serve_ranks_inputs(dev)
    pre, pre_sh, dec, _ = _serve_fns(cfg, mesh)
    timed = _Timed()
    with torch.no_grad(), GatherSpy() as spy:
        lg, cache = pre(params, dserve.place(tokens, pre_sh["tokens"]))
        paged = dserve.paged_from_rows(cache, cfg, mesh, SERVE_RANKS["batch"],
                                       page=SERVE_PAGE, kv_bits=SERVE_BITS)
        del cache
        logits = [lg[:, -1].cpu()]
        for _ in range(SERVE_RANKS["steps"]):
            spy.mark_step()
            tok = lg[:, -1].argmax(-1)[:, None]
            lg, paged = timed(dec, params, tok, paged)
            logits.append(lg[:, -1].cpu())
    torch.cuda.synchronize()
    return {"first": pre_sh["tokens"].start, "logits": logits,
            "digest": _pool_digest(paged), "ms_per_step": timed.ms(),
            "launches": timed.launches(), "gathered": spy.steps[1:]}


def _serve_cross_cards(n_cards, one_card):
    """serve_at_scale/ranks with one rank per card on n_cards cards: every
    rank's pools identical; each lane's greedy stream equal to the one-card
    run's up to a step where the one-card top-1 minus top-2 margin is
    within SERVE_RANKS_TIE of the largest |logit|; the logits' gap before
    each lane's first differing token."""
    return _hold_cross_cards(
        _across_cards("--serve-rank-worker", n_cards,
                      "serve_at_scale/ranks"), one_card)


def _hold_cross_cards(res, one_card):
    """_serve_cross_cards' checks of the ranks' results `res`."""
    n_cards = len(res)
    ref_logits, margins = one_card["logits"], one_card["margins"]
    parted, gap, bit_identical = [], 0.0, True
    prefill_gap = max(max_abs(r["logits"][0], ref_logits[0][
        r["first"]:r["first"] + r["logits"][0].shape[0]])
        / float(ref_logits[0].abs().max()) for r in res)
    for r in res:
        for j in range(r["logits"][0].shape[0]):
            lane = r["first"] + j
            mine = [lg[j] for lg in r["logits"]]
            want = [lg[lane] for lg in ref_logits]
            first = next((i for i, (a, b) in enumerate(zip(mine, want))
                          if int(a.argmax()) != int(b.argmax())), None)
            held = len(mine) if first is None else first + 1
            for a, b in zip(mine[:held], want[:held]):
                bit_identical &= torch.equal(a, b)
                gap = max(gap, max_abs(a, b) / float(b.abs().max()))
            if first is not None:
                m, top = margins[first][lane]
                parted.append({"lane": lane, "step": first, "margin": m,
                               "max_logit": top,
                               "near_tie": m <= SERVE_RANKS_TIE * top})
    out = {"cards": n_cards,
           "pools_identical": len({r["digest"] for r in res}) == 1,
           "logits_bit_identical_before_parting": bit_identical,
           "logit_gap_before_parting": gap, "prefill_logit_gap": prefill_gap,
           "tie_bound": SERVE_RANKS_TIE,
           "lanes_parted": parted,
           "ms_per_step": [r["ms_per_step"] for r in res],
           "gathered_calls_and_bytes_per_step": [r["gathered"][0]
                                                 for r in res],
           "launches_per_step_rank0": res[0]["launches"][0]}
    check(out["pools_identical"], f"serve_at_scale/ranks across {n_cards} "
          f"cards: the ranks' pools differ")
    check(all(p["near_tie"] for p in parted), f"serve_at_scale/ranks "
          f"across {n_cards} cards: a stream parts away from a near-tie: "
          f"{parted}")
    for r in res:
        for d in r["launches"]:
            expect_launches(d, one_card["per_step"], "serve_at_scale/ranks "
                            f"across {n_cards} cards, a decode step")
    return out


def phase_serve_ranks(dev, smi):
    """serve_at_scale/ranks: granite-3-2b whole (40 layers, f32 weights
    drawn on the card), B = 16 lanes of one 256-token counter-hash prompt,
    page 16, 4-bit KV (block 512), a SERVE_MAX_LEN cache, through
    dist/serve.py in a one-rank NCCL group - make_prefill, paged_from_rows,
    then SERVE_RANKS' steps of make_paged_decode's fn (one all-gather of
    the written page rows per layer) - in lockstep with the no-group
    prefill, paged_from_contiguous and decode_step on the same weights and
    prompts, each greedy on its own logits: logits, greedy tokens and every
    pool tensor (the spare row aside) bit-identical at every step; K4 = K2
    = two per layer in every decode step on both paths.  Prints each
    path's ms per decode step (CUDA events, median) and the calls and bytes
    handed to the all-gathers per step.  With 2 or 4 cards, also one rank
    per card (_serve_cross_cards); with one, the line says that run was
    not made.  Returns the rank path's launches in its decode steps."""
    from repro_torch.dist import serve as dserve
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous

    spec = SERVE_RANKS
    B = spec["batch"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, tokens = _serve_ranks_inputs(dev)
    per_step = {k: 2 * cfg.n_layers for k in SERVE_KERNELS}
    one, ranked = _Timed(), _Timed()
    equal_logits = equal_pools = equal_tokens = 0
    logits, margins = [], []
    with OneRankGroup(dev) as mesh, torch.no_grad(), GatherSpy() as spy:
        pre, pre_sh, dec, dec_sh = _serve_fns(cfg, mesh)
        lg0, c0 = tfm.prefill(params, cfg, tokens, cache_len=SERVE_MAX_LEN)
        p0 = paged_from_contiguous(c0, cfg, page=SERVE_PAGE,
                                   kv_bits=SERVE_BITS)
        del c0
        lg1, c1 = pre(params, dserve.place(tokens, pre_sh["tokens"]))
        p1 = dserve.paged_from_rows(c1, cfg, mesh, B, page=SERVE_PAGE,
                                    kv_bits=SERVE_BITS)
        del c1
        check(torch.equal(lg0, lg1), "serve_at_scale/ranks: make_prefill's "
              "logits differ from prefill's")
        check(p1["layers"][0].spec.block == 512, "serve_at_scale/ranks: "
              f"block {p1['layers'][0].spec.block}")

        def same_pools():
            return all(torch.equal(getattr(a, n)[:-1], getattr(b, n)[:-1])
                       for a, b in zip(p0["layers"], p1["layers"])
                       for n in a.pool_fields)

        check(same_pools(), "serve_at_scale/ranks: paged_from_rows's pools "
              "differ from paged_from_contiguous's")
        def note(lg):
            """The one-card logits and, per lane, the top-1 minus top-2
            margin and the largest |logit|, on the host."""
            top = torch.topk(lg[:, -1], 2)
            logits.append(lg[:, -1].cpu())
            margins.append(torch.stack(
                [top.values[:, 0] - top.values[:, 1],
                 lg[:, -1].abs().amax(-1)], -1).cpu().tolist())

        for _ in range(spec["steps"]):
            spy.mark_step()
            note(lg0)
            t0, t1 = lg0[:, -1].argmax(-1)[:, None], \
                lg1[:, -1].argmax(-1)[:, None]
            equal_tokens += torch.equal(t0, t1)
            lg0, p0 = one(tfm.decode_step, params, cfg, t0, p0)
            lg1, p1 = ranked(dec, params, t1, p1)
            equal_logits += torch.equal(lg0, lg1)
            equal_pools += same_pools()
        note(lg0)
        gathered = spy.steps[1:]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del p0, p1, params
    torch.cuda.empty_cache()
    steps = spec["steps"]
    out = {"phase": "serve_at_scale/ranks", "nvidia_smi": smi,
           "arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
           "prompt": spec["prompt"], "decode_steps": steps,
           "page": SERVE_PAGE, "kv_bits": SERVE_BITS,
           "max_len": SERVE_MAX_LEN,
           "decode_ms_median_no_group": one.ms(),
           "decode_ms_median_rank": ranked.ms(),
           "gathered_calls_and_bytes_per_step": gathered[0],
           "steps_equal": {"logits": equal_logits, "tokens": equal_tokens,
                           "pools": equal_pools},
           "launches_per_step_rank": ranked.launches()[0],
           "launches_per_step_no_group": one.launches()[0],
           "peak_gb": peak}
    check(equal_logits == equal_tokens == equal_pools == steps,
          f"serve_at_scale/ranks: the rank path parts from the no-group "
          f"path: {out['steps_equal']}")
    check(all(g == gathered[0] for g in gathered)
          and gathered[0][0] == cfg.n_layers,
          f"serve_at_scale/ranks: all-gathers per step {gathered}")
    for what, t in (("rank", ranked), ("no_group", one)):
        for d in t.launches():
            expect_launches(d, per_step, f"serve_at_scale/ranks {what}, a "
                            "decode step")
    cards = torch.cuda.device_count()
    n_cards = min(cards, RANKS_MAX_CARDS)
    n_cards = n_cards if n_cards in (2, 4) else (2 if cards >= 2 else 1)
    if n_cards >= 2:
        out["cross_card"] = _serve_cross_cards(
            n_cards, {"logits": logits, "margins": margins,
                      "per_step": per_step})
    else:
        out["cross_card"] = ("not made: this machine has one card "
                             "(NCCL takes one rank per card)")
        print("serve_at_scale/ranks: the cross-card run was not made (one "
              "card)", file=sys.stderr)
    emit(out)
    # the rank path's decode steps (the counts read around each call)
    return {k: sum(d[k] for d in ranked.launches())
            for k in cuda_lib.launch_counts()}


MOE_EP = dict(arch="granite-moe-1b-a400m", params=1_384_963_072, batch=16,
              prompt=256, max_len=512, steps=4, check_batch=4)
MOE_EP_NO_DROP = 8.0        # the capacity factor at which nothing drops
MOE_EP_DROPS = 0.5          # one at which both capacities drop pairs
# the ep path against the plain MoE where nothing drops: the card's f32
# bound of serving (logits within 1e-4 of the largest |logit|)
MOE_EP_RTOL = SERVE_RTOL[torch.float32]


class SlotSpy:
    """(token, choice) pairs that the expert-parallel dispatch drops inside
    its with block (models/moe_ep._slots: at hop 1's C_s and at the
    experts' C_e; an id outside the bins marks an empty received slot),
    and the same count made apart from _slots: each bin's ids beyond its
    capacity."""

    def __enter__(self):
        from repro_torch.models import moe_ep

        self.dropped, self.per_bin = [], []
        self._mod, self._orig = moe_ep, moe_ep._slots
        spy = self

        def slots(ids, n_bins, cap):
            slot, keep = spy._orig(ids, n_bins, cap)
            spy.dropped.append(((ids < n_bins) & ~keep).sum())
            counts = torch.bincount(torch.clamp(ids, 0, n_bins),
                                    minlength=n_bins + 1)[:n_bins]
            spy.per_bin.append(torch.clamp(counts - cap, min=0).sum())
            return slot, keep

        moe_ep._slots = slots
        return self

    def total(self):
        return int(sum(int(d) for d in self.dropped))

    def total_per_bin(self):
        return int(sum(int(d) for d in self.per_bin))

    def __exit__(self, *exc):
        self._mod._slots = self._orig


def combine_ms(dev, T, k, d, reps=10):
    """CUDA-event medians (ms) of one MoE combine of (T * k, d) f32 rows
    into (T, d), forward alone and forward + backward, by models/moe.py's
    fold in choice order and by the index_add it replaced, in turns on
    the same rows."""
    from repro_torch.models import moe

    g = torch.Generator(dev).manual_seed(0)
    w = torch.randn((T * k, d), generator=g, device=dev, requires_grad=True)
    grad = torch.randn((T, d), generator=g, device=dev)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    ways = {"fold": lambda: moe.combine(w, T, k),
            "index_add": lambda: torch.zeros(
                (T, d), device=dev).index_add(0, tok, w)}
    times = {f"{n}_{m}": [] for n in ways for m in ("fwd", "fwd_bwd")}
    for rep in range(reps + 2):
        for name, fn in ways.items():
            for mode in ("fwd", "fwd_bwd"):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn()
                if mode == "fwd_bwd":
                    torch.autograd.grad(out, w, grad)
                b.record()
                torch.cuda.synchronize()
                if rep >= 2:
                    times[f"{name}_{mode}"].append(a.elapsed_time(b))
    return {key: statistics.median(v) for key, v in times.items()}


def _moe_ep_inputs(dev):
    """MOE_EP's config, its f32 weights drawn on `dev` from seed 0 and its
    (B, prompt) counter-hash prompts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_size

    spec = MOE_EP
    cfg = get_config(spec["arch"])
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    check(tree_size(params) == spec["params"],
          f"moe_ep_at_scale: {tree_size(params)} parameters")
    jobs = _serve_jobs(cfg, spec["batch"], spec["prompt"], spec["prompt"], 0)
    tokens = torch.tensor([p for p, _ in jobs], device=dev)
    return cfg, params, tokens


def moe_ep_bytes(cfg, T, nsh, ntp, cf):
    """The bytes one MoE layer hands all_to_all_single on each rank for T
    local tokens (models/moe_ep.py: hop 1's f32 tokens, int64 ids and f32
    flags and hop 2's f32 results in (nsh, C_s) buffers; both Ulysses
    transposes of the f32 (E_loc, C_e, d / ntp) buffer), and C_s, C_e."""
    E_loc, d_loc = cfg.n_experts // nsh, cfg.d_model // ntp
    C_s = max(ntp, int(cf * T * cfg.top_k / nsh) // ntp * ntp)
    C_e = max(ntp, int(cf * nsh * C_s / E_loc) // ntp * ntp)
    hop = nsh * C_s * (4 * d_loc + 8 + 4 + 4 * d_loc)
    return hop + 2 * 4 * E_loc * C_e * d_loc, C_s, C_e


def _moe_ep_fns(cfg, mesh, batch):
    """make_prefill's fn for cfg with moe_ep_axis "data" and
    make_paged_decode's on `mesh` at `batch` lanes, MOE_EP's cache."""
    import dataclasses

    from repro_torch.configs.base import InputShape
    from repro_torch.dist import serve as dserve
    from repro_torch.dist.sharding import make_profile

    cfg = dataclasses.replace(cfg, moe_ep_axis="data")
    L = MOE_EP["max_len"]
    prof = make_profile(cfg, mesh.axis_names)
    pre, _, pre_sh, _ = dserve.make_prefill(
        cfg, mesh, prof, InputShape("prefill", L, batch, "prefill"))
    dec, _, _, _ = dserve.make_paged_decode(
        cfg, mesh, prof, InputShape("decode", L, batch, "decode"),
        page=SERVE_PAGE, kv_bits=SERVE_BITS)
    return pre, pre_sh["tokens"], dec


def _moe_ep_rank_run(dev, mesh):
    """The rank's B / n lanes and E / n experts: make_prefill's fn once
    under the spies, then 3 timed calls; at MOE_EP_NO_DROP its rows of
    the first check_batch lanes; paged_from_rows and MOE_EP's steps of
    make_paged_decode's fn (the pool's digest, launches per step)."""
    import dataclasses

    from repro_torch.dist import serve as dserve
    from repro_torch.launch.mesh import CollectiveSpy

    spec = MOE_EP
    B = spec["batch"]
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, tokens = _moe_ep_inputs(dev)
    pre, rows, dec = _moe_ep_fns(cfg, mesh, B)
    mine = dserve.place(tokens, rows)
    timed, steps = _Timed(), _Timed()
    with torch.no_grad():
        with SlotSpy() as slots, CollectiveSpy() as spy:
            lg, cache = pre(params, mine)
        for _ in range(3):
            timed(pre, params, mine)
        nb = spec["check_batch"]
        pre8, rows8, _ = _moe_ep_fns(
            dataclasses.replace(cfg, capacity_factor=MOE_EP_NO_DROP), mesh,
            nb)
        lg8, _ = pre8(params, dserve.place(tokens[:nb], rows8))
        paged = dserve.paged_from_rows(cache, cfg, mesh, B, page=SERVE_PAGE,
                                       kv_bits=SERVE_BITS)
        del cache
        for _ in range(spec["steps"]):
            lg, paged = steps(dec, params, lg[:, -1].argmax(-1)[:, None],
                              paged)
    torch.cuda.synchronize()
    return {"first": rows.start, "first8": rows8.start,
            "logits8": lg8[:, -1].cpu(), "prefill_ms": timed.ms(),
            "dropped": slots.total(), "collectives": spy.seen,
            "digest": _pool_digest(paged), "launches": steps.launches(),
            "decode_ms": steps.ms(),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _moe_ep_cross_cards(n_cards, one_card):
    """moe_ep_at_scale with one rank per card on n_cards cards (each rank
    its B / n lanes and E / n experts): every rank's pool identical after
    the decode steps; at MOE_EP_NO_DROP the lanes' logits within
    MOE_EP_RTOL of the one-card plain MoE's; K4 = K2 = two per layer per
    decode step; each rank's all_to_all_single bytes the count of
    moe_ep_bytes."""
    return _hold_moe_ep_cards(
        _across_cards("--moe-ep-rank-worker", n_cards, "moe_ep_at_scale"),
        one_card)


def _hold_moe_ep_cards(res, one_card):
    """_moe_ep_cross_cards' checks of the ranks' results `res`."""
    n_cards = len(res)
    cfg, want8 = one_card["cfg"], one_card["logits8"]
    gap8 = max(max_abs(r["logits8"], want8[r["first8"]:r["first8"]
                                           + r["logits8"].shape[0]])
               for r in res) / float(want8.abs().max())
    T = MOE_EP["batch"] // n_cards * MOE_EP["prompt"]
    per_layer, C_s, C_e = moe_ep_bytes(cfg, T, n_cards, 1,
                                       cfg.capacity_factor)
    out = {"cards": n_cards, "C_s": C_s, "C_e": C_e,
           "pools_identical": len({r["digest"] for r in res}) == 1,
           "no_drop_logit_gap": gap8, "bound": MOE_EP_RTOL,
           "prefill_ms": [r["prefill_ms"] for r in res],
           "decode_ms": [r["decode_ms"] for r in res],
           "dropped_pairs": sum(r["dropped"] for r in res),
           "collectives_per_prefill": [r["collectives"] for r in res],
           "a2a_bytes_per_layer_counted": per_layer,
           "peak_gb": [r["peak_gb"] for r in res]}
    check(out["pools_identical"], f"moe_ep_at_scale across {n_cards} "
          "cards: the ranks' pools differ")
    check(gap8 <= MOE_EP_RTOL, f"moe_ep_at_scale across {n_cards} cards: "
          f"logits at capacity factor {MOE_EP_NO_DROP} {gap8} from the "
          "plain MoE's")
    for r in res:
        check(r["collectives"]["all_to_all_single"]
              == [6 * cfg.n_layers, per_layer * cfg.n_layers],
              f"moe_ep_at_scale across {n_cards} cards: all_to_all_single "
              f"{r['collectives']['all_to_all_single']}, counted "
              f"{per_layer} bytes a layer")
        for d in r["launches"]:
            expect_launches(d, one_card["per_step"], "moe_ep_at_scale "
                            f"across {n_cards} cards, a decode step")
    return out


def phase_moe_ep(dev, smi):
    """moe_ep_at_scale: granite-moe-1b-a400m whole (24 layers, d_model
    1024, 32 experts top-8, vocab 49,155; f32 weights drawn on the card),
    B = 16 lanes of one 256-token counter-hash prompt, moe_ep_axis "data".
    In a one-rank NCCL group, make_prefill's fn (the expert-parallel
    dispatch, models/moe_ep.py, over one-rank ep and tp groups: every
    all_to_all_single, all-reduce and all-gather called) against the
    no-group prefill on the same weights and prompts: logits and every
    layer's contiguous cache bit for bit, all_to_all_single bytes the
    count of moe_ep_bytes; ms per prefill (CUDA events, median of 3 after
    one call under the spies).  The (token, choice) pairs dropped at
    capacity factor 1.25 by the ep path and by the plain MoE (none with
    these prompts: each expert's load stays under both capacities); at
    MOE_EP_NO_DROP, where nothing drops, the ep path's logits within
    MOE_EP_RTOL of the plain MoE's on the first check_batch lanes; at
    MOE_EP_DROPS, where both capacities drop pairs, the group path's
    logits and cache bit for bit the no-group path's on those lanes, and
    the pairs dropped those of a count of each bin's overflow.  Then
    paged_from_rows (4-bit pages, K4) and MOE_EP's steps of
    make_paged_decode's fn (its plain MoE routing the whole batch over
    the data group) in lockstep with paged_from_contiguous and
    decode_step: logits and pools bit for bit, K4 = K2 = two per layer per
    step.  The MoE combine's times by the fold and by index_add
    (combine_ms) at the prefill's tokens and at a trainer agent's.  With 2
    or 4 cards, also one rank per card (_moe_ep_cross_cards).
    Returns the group path's launches (paged_from_rows and the decode
    steps)."""
    import dataclasses

    from repro_torch.dist import serve as dserve
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import CollectiveSpy
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous

    spec = MOE_EP
    B, L, nb = spec["batch"], spec["max_len"], spec["check_batch"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params, tokens = _moe_ep_inputs(dev)
    ep_cfg = dataclasses.replace(cfg, moe_ep_axis="data")
    per_step = {k: 2 * cfg.n_layers for k in SERVE_KERNELS}
    one, ranked, conv = _Timed(), _Timed(), _Timed()
    dec_one, dec_ranked = _Timed(), _Timed()
    equal = {"logits": 0, "pools": 0}
    with OneRankGroup(dev) as mesh, torch.no_grad():
        pre, rows, dec = _moe_ep_fns(cfg, mesh, B)
        mine = dserve.place(tokens, rows)
        with SlotSpy() as ep_slots:
            lg0, c0 = tfm.prefill(params, ep_cfg, tokens, cache_len=L)
        with CollectiveSpy() as spy:
            lg1, c1 = pre(params, mine)
        check(torch.equal(lg0, lg1), "moe_ep_at_scale: make_prefill's "
              "logits differ from the no-group prefill's")
        check(all(torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
                  for a, b in zip(c0["layers"], c1["layers"])),
              "moe_ep_at_scale: make_prefill's cache differs from the "
              "no-group prefill's")
        for _ in range(3):
            one(lambda: tfm.prefill(params, ep_cfg, tokens, cache_len=L))
            ranked(pre, params, mine)
        with RouteSpy() as plain_route:
            lg_plain, _ = tfm.prefill(params, cfg, tokens, cache_len=L)
        plain_gap = max_abs(lg_plain, lg0) / float(lg_plain.abs().max())
        cfg8 = dataclasses.replace(cfg, capacity_factor=MOE_EP_NO_DROP)
        lg8, _ = tfm.prefill(params, cfg8, tokens[:nb], cache_len=L)
        with SlotSpy() as slots8:
            lg8_ep, _ = tfm.prefill(
                params, dataclasses.replace(cfg8, moe_ep_axis="data"),
                tokens[:nb], cache_len=L)
        gap8 = max_abs(lg8_ep, lg8) / float(lg8.abs().max())
        cfg_d = dataclasses.replace(cfg, capacity_factor=MOE_EP_DROPS)
        pre_d, rows_d, _ = _moe_ep_fns(cfg_d, mesh, nb)
        with SlotSpy() as drops:
            lgd0, cd0 = tfm.prefill(
                params, dataclasses.replace(cfg_d, moe_ep_axis="data"),
                tokens[:nb], cache_len=L)
        lgd1, cd1 = pre_d(params, dserve.place(tokens[:nb], rows_d))
        drops_equal = torch.equal(lgd0, lgd1) and all(
            torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
            for a, b in zip(cd0["layers"], cd1["layers"]))
        del cd0, cd1
        p0 = conv(lambda: paged_from_contiguous(
            c0, ep_cfg, page=SERVE_PAGE, kv_bits=SERVE_BITS))
        p1 = conv(lambda: dserve.paged_from_rows(
            c1, ep_cfg, mesh, B, page=SERVE_PAGE, kv_bits=SERVE_BITS))
        del c0, c1
        for _ in range(spec["steps"]):
            t0 = lg0[:, -1].argmax(-1)[:, None]
            t1 = lg1[:, -1].argmax(-1)[:, None]
            lg0, p0 = dec_one(tfm.decode_step, params, ep_cfg, t0, p0)
            lg1, p1 = dec_ranked(dec, params, t1, p1)
            equal["logits"] += torch.equal(lg0, lg1)
            equal["pools"] += all(
                torch.equal(getattr(a, n)[:-1], getattr(b, n)[:-1])
                for a, b in zip(p0["layers"], p1["layers"])
                for n in a.pool_fields)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del p0, p1, params
    torch.cuda.empty_cache()
    T = B * spec["prompt"]
    per_layer, C_s, C_e = moe_ep_bytes(cfg, T, 1, 1, cfg.capacity_factor)
    dropped_plain = sum(int((~keep).sum()) for _, keep, _ in
                        plain_route.calls)
    out = {"phase": "moe_ep_at_scale", "nvidia_smi": smi,
           "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "batch": B, "prompt": spec["prompt"],
           "max_len": L, "capacity_factor": cfg.capacity_factor,
           "C_s": C_s, "C_e": C_e,
           "prefill_ms_no_group": one.ms(), "prefill_ms_rank": ranked.ms(),
           "prefill_ms_runs": {"no_group": [a.elapsed_time(b) for a, b, _
                                            in one.calls],
                               "rank": [a.elapsed_time(b) for a, b, _
                                        in ranked.calls]},
           "collectives_per_prefill": spy.seen,
           "a2a_bytes_per_layer_counted": per_layer,
           "pairs_routed": T * cfg.top_k * cfg.n_layers,
           "pairs_dropped": {"ep": ep_slots.total(),
                             "plain": dropped_plain},
           "plain_vs_ep_logit_gap": plain_gap,
           "no_drop": {"capacity_factor": MOE_EP_NO_DROP, "batch": nb,
                       "dropped_ep": slots8.total(), "logit_gap": gap8,
                       "bound": MOE_EP_RTOL},
           "drops": {"capacity_factor": MOE_EP_DROPS, "batch": nb,
                     "pairs_routed": nb * spec["prompt"] * cfg.top_k
                     * cfg.n_layers, "dropped_ep": drops.total(),
                     "dropped_counted_per_bin": drops.total_per_bin(),
                     "group_path_equal": drops_equal},
           "decode_steps": spec["steps"],
           "decode_ms_median_no_group": dec_one.ms(),
           "decode_ms_median_rank": dec_ranked.ms(),
           "steps_equal": equal,
           "launches_paged_from": {"no_group": conv.launches()[0],
                                   "rank": conv.launches()[1]},
           "launches_per_step_rank": dec_ranked.launches()[0],
           "launches_per_step_no_group": dec_one.launches()[0],
           "peak_gb": peak,
           "combine_ms": {
               f"T{t}_k{cfg.top_k}_d{cfg.d_model}": combine_ms(
                   dev, t, cfg.top_k, cfg.d_model)
               for t in (T, TRAIN_BATCH * TRAIN_SEQ)}}
    check(equal["logits"] == equal["pools"] == spec["steps"],
          f"moe_ep_at_scale: the rank path's decode parts from the no-group "
          f"path: {equal}")
    check(spy.seen.get("all_to_all_single")
          == [6 * cfg.n_layers, per_layer * cfg.n_layers],
          f"moe_ep_at_scale: all_to_all_single {spy.seen}, counted "
          f"{per_layer} bytes a layer")
    check(slots8.total() == 0 and gap8 <= MOE_EP_RTOL,
          f"moe_ep_at_scale: at capacity factor {MOE_EP_NO_DROP} "
          f"{slots8.total()} pairs dropped, logits {gap8} from the plain "
          "MoE's")
    check(drops_equal and 0 < drops.total() == drops.total_per_bin()
          < out["drops"]["pairs_routed"],
          f"moe_ep_at_scale: at capacity factor {MOE_EP_DROPS} {out['drops']}")
    check(conv.launches()[0] == conv.launches()[1],
          f"moe_ep_at_scale: paged_from_rows launched "
          f"{conv.launches()[1]}, paged_from_contiguous "
          f"{conv.launches()[0]}")
    for what, t in (("rank", dec_ranked), ("no_group", dec_one)):
        for d in t.launches():
            expect_launches(d, per_step, f"moe_ep_at_scale {what}, a decode "
                            "step")
    cards = torch.cuda.device_count()
    n_cards = min(cards, RANKS_MAX_CARDS)
    n_cards = n_cards if n_cards in (2, 4) else (2 if cards >= 2 else 1)
    if n_cards >= 2:
        out["cross_card"] = _moe_ep_cross_cards(
            n_cards, {"cfg": cfg, "logits8": lg8[:, -1].cpu(),
                      "per_step": per_step})
    else:
        out["cross_card"] = ("not made: this machine has one card "
                             "(NCCL takes one rank per card)")
        print("moe_ep_at_scale: the cross-card run was not made (one card)",
              file=sys.stderr)
    emit(out)
    # the group path: paged_from_rows and the decode steps
    return {k: conv.launches()[1][k] + sum(d[k] for d in dec_ranked.launches())
            for k in cuda_lib.launch_counts()}


# the runs of one rank per card, by the flag that starts them
RANK_RUNS = {"--serve-rank-worker": _serve_rank_run,
             "--moe-ep-rank-worker": _moe_ep_rank_run}


def main():
    start = time.perf_counter()
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

    power_w = float(smi.split(",")[-1].strip().split()[0])
    rows = phase_kernels(dev, bw, flops)
    hot_path = phase_blocks(dev, bw, flops, power_w)
    headline = phase_headline(dev)
    fig2 = phase_fig2(dev)
    fig1 = phase_fig1(dev)
    lead_at_scale, lead_trace = phase_lead_at_scale(dev)
    baselines = phase_baselines_at_scale(dev)
    tree = phase_tree_at_scale(dev)
    fig3 = phase_fig3(dev)
    faulted = phase_faults_at_scale(dev, lead_trace)
    oracle = phase_oracle_at_scale(dev)
    new_paths = {phase: phase_new_paths(dev, phase, lead_trace)
                 for phase in NEW_PATHS}
    multiwire = phase_multiwire_at_scale(dev, lead_trace, smi)
    phase_train_small(dev)
    ranks = {f"ranks_small/{k}": v
             for k, v in phase_ranks_small(dev, smi).items()}
    train = {}
    for what in TRAIN_AT_SCALE:
        train[what], rank_path = phase_train_at_scale(dev, smi, flops, what)
        if rank_path is not None:
            ranks[f"{what}/ranks"] = rank_path
    ranks["ckpt_at_scale"], ranks["ckpt_at_scale/ranks"] = \
        phase_ckpt_at_scale(dev, smi)
    serve = {"serve_small": phase_serve_small(dev)}
    serve.update({what: phase_serve_at_scale(dev, smi, what)
                  for what in SERVE_AT_SCALE})
    serve["serve_at_scale/ranks"] = phase_serve_ranks(dev, smi)
    serve["moe_ep_at_scale"] = phase_moe_ep(dev, smi)
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
            "fig1": sum(v[k] for v in fig1.values()),
            **{f"baselines_at_scale/{w}": v[k] for w, v in baselines.items()},
            **{f"tree_at_scale/{w}": v[k] for w, v in tree.items()},
            "fig3": sum(v[k] for v in fig3.values()),
            **{f"faults_at_scale/{w}": v[k] for w, v in faulted.items()},
            "oracle_at_scale": oracle[k],
            **{f"{phase}/{w}": v[k] for phase, runs in new_paths.items()
               for w, v in runs.items()},
            **{f"multiwire_at_scale/{w}": v[k]
               for w, v in multiwire.items()},
            **{what: v[k] for what, v in train.items()},
            **{what: v.get(k, 0) for what, v in ranks.items()},
            **{what: v.get(k, 0) for what, v in serve.items()}}
        if k in hot_path:
            r["hot_path_512"] = hot_path[k]
    emit({"phase": "script", "seconds": time.perf_counter() - start,
          "phase_seconds": PHASE_SECONDS, "nvidia_smi": smi})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] and sys.argv[1] in RANK_RUNS:
        sys.exit(card_rank_worker(sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
