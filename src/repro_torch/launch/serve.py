"""Serving driver: continuous batching over the paged, optionally
wire-codec-quantized KV cache (the port of ``examples/serve_lm.py``).

Examples:
    # the reduced granite on the CPU, 4-bit cold pages:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --kv-bits 4 --device cpu

    # fit the reduced model on counting first (real greedy margins), on
    # the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --kv-bits 4 \
        --fit-steps 200

Submits a staggered batch of prompts to the ServeEngine (admission queue,
page-table-backed cache, eviction on max_new) and reports tokens/sec, the
KV-cache bytes fp against paged and the wire meter's bits/elem.  Recurrent
and cross-attention families (xlstm, recurrentgemma, whisper, the vlm) run
the contiguous prefill + decode path: the paged cache serves attention
block stacks only.  ``--device`` is the port's addition.
"""
import argparse
import time
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import stub_memory
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.demo import counting_prompt, fit_counting_lm


def pageable(cfg) -> bool:
    """True for attention block stacks without cross-attention memories:
    the families the paged engine serves."""
    return (all(t in ("attn", "local", "global") for t in cfg.layer_types())
            and not cfg.cross_attn_every and not cfg.encoder_layers)


def serve_requests(cfg, params, scfg: ServeConfig,
                   jobs: Sequence[Tuple[List[int], int]], device=None):
    """Submit every (prompt, max_new) job to one ServeEngine and drain it.
    Returns (engine, {rid: result}, the rids in job order, wall seconds
    ending in a synchronize)."""
    dev = resolve_device(device)
    with torch.no_grad():
        eng = ServeEngine(cfg, params, scfg, device=dev)
        rids = [eng.submit(p, max_new=m) for p, m in jobs]
        t0 = time.perf_counter()
        results = eng.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return eng, results, rids, time.perf_counter() - t0


def greedy_contiguous(params, cfg, prompts: torch.Tensor, max_new: int,
                      cache_len: int, memory=None,
                      cache_dtype=torch.bfloat16) -> List[List[int]]:
    """Greedy decode of prompts (B, S) on the contiguous cache path: prefill
    then max_new - 1 decode steps.  Returns each sequence's max_new tokens."""
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, memory=memory,
                                cache_len=cache_len, cache_dtype=cache_dtype)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out = [tok]
        for _ in range(max_new - 1):
            logits, cache = decode_step(params, cfg, tok, cache)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(tok)
    return torch.cat(out, 1).cpu().tolist()


def paged_demo(cfg, args, dev) -> Dict[str, float]:
    gen = torch.Generator(dev).manual_seed(0)
    if args.fit_steps > 0:
        t0 = time.time()
        params, loss = fit_counting_lm(cfg, gen, steps=args.fit_steps,
                                       device=dev)
        print(f"fit on counting: {args.fit_steps} steps, loss={loss:.4f} "
              f"({time.time() - t0:.1f}s)")
    else:
        params = init_params(cfg, gen, dev)
        print("random-init weights: token streams are noise; pass "
              "--fit-steps 200 for a model with real greedy margins")
    max_len = args.prompt_len + args.gen
    max_len += (-max_len) % args.page                  # whole pages
    scfg = ServeConfig(max_batch=args.batch, max_len=max_len, page=args.page,
                       kv_bits=args.kv_bits)
    jobs = [(counting_prompt(cfg, 31 * i, max(1, args.prompt_len - 7 * i)),
             args.gen) for i in range(2 * args.batch)]
    eng, results, _, wall = serve_requests(cfg, params, scfg, jobs, dev)
    st, rep = eng.stats(), eng.cache_report()
    print(f"{cfg.name}: served {len(results)} sequences ({st['admitted']} "
          f"admitted / {st['evicted']} evicted, queue peak "
          f"{st['queued_peak']}) in {wall:.2f}s")
    print(f"throughput: {st['tokens_per_sec']:.1f} tokens/sec over "
          f"{st['decode_steps']} decode steps (signatures: "
          f"{st['decode_compiles']} decode / {st['prefill_compiles']} "
          "prefill)")
    print(f"kv cache: {rep['paged_bytes'] / 1024:.1f} KiB paged "
          f"({rep['bits_per_elem']:.4f} bits/elem pool) vs "
          f"{rep['fp_bytes'] / 1024:.1f} KiB contiguous fp - pool reduction "
          f"{rep['hbm_reduction_pool']:.2f}x, total "
          f"{rep['hbm_reduction_total']:.2f}x")
    print("sample token ids:", results[min(results)]["tokens"][:16])
    return st


def contiguous_demo(cfg, args, dev) -> None:
    gen = torch.Generator(dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    memory = stub_memory(cfg.family, (B,), cfg, device=dev)
    t0 = time.time()
    out = greedy_contiguous(params, cfg, prompts, args.gen, S + args.gen,
                            memory=memory)
    dt = time.time() - t0
    print(f"{cfg.name}: prefill {B}x{S} and {args.gen} tokens/seq in "
          f"{dt:.2f}s ({B * args.gen / dt:.0f} tokens/sec)")
    print("sample token ids:", out[0][:16])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="quantize cold KV pages to this many bits (1-7); "
                    "default keeps fp pages")
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--fit-steps", type=int, default=0,
                    help="fit the reduced model on counting first (e.g. 200)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    print(f"registry: arch={args.arch} -> {cfg.name} (family={cfg.family}) "
          "via repro_torch.configs.registry; algorithm=none compressor=none "
          f"gossip=none (serving path) on {dev}")
    if pageable(cfg):
        paged_demo(cfg, args, dev)
    else:
        print(f"note: {args.arch} has non-attention or cross-attention "
              "blocks - paged serving unavailable, using the contiguous "
              "cache path (no --kv-bits)")
        contiguous_demo(cfg, args, dev)


if __name__ == "__main__":
    main()
