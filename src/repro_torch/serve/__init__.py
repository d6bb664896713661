"""Serving: continuous batching over a paged, optionally wire-codec-
quantized KV cache (the port of ``src/repro/serve``).

The LEAD wire quantizer is the KV page codec: a page of K (or V) is
``page * kv_heads * head_dim`` contiguous elements, flattened page-major
the codec's ``(rows, block)`` layout, so cold pages are stored as int8
codes and per-block scales at ``(bits+1) + 32/block`` bits/elem, encoded
by K4 as they flush and decoded by K2 on every read.

Layers:
    kv_quant.py     page codec (encode/decode page rows + bits/elem meter)
    paged_cache.py  PagedKVCache (page table, exact tail page, pools)
    scheduler.py    host-side page allocator + admission queue + slots
    engine.py       ServeEngine: continuous batching over the decode step
    demo.py         the counting LM with real greedy margins
"""
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.kv_quant import KVQuantSpec
from repro_torch.serve.paged_cache import (PagedKVCache, init_paged_cache,
                                           paged_from_contiguous)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeConfig", "ServeEngine", "KVQuantSpec", "PagedKVCache",
           "init_paged_cache", "paged_from_contiguous", "Request",
           "Scheduler"]
