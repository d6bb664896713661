"""ServeEngine: continuous batching over the paged decode step (the port of
``src/repro/serve/engine.py``).

The engine keeps a static ``(max_batch, ...)`` device state (the paged
cache, the last tokens, the active mask) and two step functions:

  * ``_decode`` - one greedy decode step for the whole batch
    (``transformer.decode_step`` with one position per sequence; inactive
    lanes compute padding and their page flushes go to the spare row);
  * ``_prefill`` - one page-sized prompt chunk of one sequence
    (``transformer.prefill_chunk``; slot, start and valid_len are host
    ints).

Everything else is host-side plumbing (scheduler.py): admissions pop the
queue when a slot and pages are free, prompts stream in page-sized chunks,
finished sequences (EOS or max_new) free their pages at once.  No
admission, eviction, prompt length or batch occupancy changes a shape, so
under XLA the two functions would compile once: ``compile_stats`` counts
the distinct shape and dtype signatures each has seen, which must stay at
one each.  The decode step makes one host sync (the tokens' copy) and an
admission one (its first token); page-table edits are ``fill_`` of a host
int on the device, never a host-to-device copy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serve import paged_cache as pc
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (the model config rides separately).

    kv_bits=None keeps fp pages; 1..7 stores cold pages through the wire
    codec at (kv_bits+1) + 32/block bits/elem (kv_quant.py)."""
    max_batch: int = 4
    max_len: int = 256
    page: int = 16
    kv_bits: Optional[int] = None
    block: Optional[int] = None
    cache_dtype: str = "bfloat16"
    eos_id: Optional[int] = None
    n_pages_full: Optional[int] = None
    n_pages_roll: Optional[int] = None


def _signature(*trees) -> tuple:
    """The shapes and dtypes of every tensor in the trees, and the types of
    the other leaves: what a tracing compiler keys its cache on."""
    sig = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype))
        elif isinstance(x, pc.PagedKVCache):
            walk(x.tensors())
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for c in x:
                walk(c)
        else:
            sig.append(type(x))

    walk(trees)
    return tuple(sig)


class ServeEngine:
    def __init__(self, model_cfg, params, cfg: ServeConfig = ServeConfig(),
                 device: DeviceLike = None):
        self.model_cfg, self.params, self.cfg = model_cfg, params, cfg
        self.device = resolve_device(device)
        self.cache = pc.init_paged_cache(
            model_cfg, cfg.max_batch, cfg.max_len, page=cfg.page,
            kv_bits=cfg.kv_bits, block=cfg.block,
            dtype=getattr(torch, cfg.cache_dtype),
            n_pages_full=cfg.n_pages_full, n_pages_roll=cfg.n_pages_roll,
            device=self.device)
        npp_full, npp_roll = pc._geometry(model_cfg, cfg.max_len, cfg.page)
        kinds = [c.rolling for c in self.cache["layers"]]
        self._full_idx = [i for i, r in enumerate(kinds) if not r]
        self._roll_idx = [i for i, r in enumerate(kinds) if r]
        self.sched = Scheduler(
            max_batch=cfg.max_batch, npp_full=npp_full, npp_roll=npp_roll,
            n_pages_full=cfg.n_pages_full or cfg.max_batch * npp_full,
            n_pages_roll=cfg.n_pages_roll or cfg.max_batch * npp_roll,
            has_rolling=bool(self._roll_idx))
        self.last_token = torch.zeros((cfg.max_batch, 1), dtype=torch.int64,
                                      device=self.device)
        self.finished: Dict[int, Dict[str, Any]] = {}
        self._decode_sigs, self._prefill_sigs = set(), set()
        self.decode_steps = 0
        self.decode_s = 0.0
        self.tokens_out = 0

    # -- the two step functions ---------------------------------------------
    def _decode(self, token, cache):
        self._decode_sigs.add(_signature(token, cache))
        logits, cache = tfm.decode_step(self.params, self.model_cfg, token,
                                        cache)
        return torch.argmax(logits[:, -1], -1), cache

    def _prefill(self, tokens, cache, slot: int, start: int, valid_len: int):
        self._prefill_sigs.add(_signature(tokens, cache, slot, start,
                                          valid_len))
        return tfm.prefill_chunk(self.params, self.model_cfg, tokens, cache,
                                 slot, start, valid_len)

    # -- page-table plumbing -------------------------------------------------
    def _table(self, kind_idx: List[int]):
        """The page-table tensor that the layers of one kind share."""
        return self.cache["layers"][kind_idx[0]].page_table if kind_idx \
            else None

    def _edit_tables(self, kind_idx: List[int], edits) -> None:
        """Apply (slot, col, pid) edits to one kind's shared page table:
        scalar writes on the device, no host sync."""
        pt = self._table(kind_idx)
        if pt is None:
            return
        for slot, col, pid in edits:
            pt[slot, col].fill_(pid)

    def _clear_slot_tables(self, slot: int) -> None:
        for idx in (self._full_idx, self._roll_idx):
            pt = self._table(idx)
            if pt is not None:
                pt[slot].fill_(-1)

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new: int = 32) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("a prompt needs at least one token")
        if len(prompt) + max_new > self.cfg.max_len:
            raise ValueError(f"prompt({len(prompt)}) + max_new({max_new}) "
                             f"exceeds max_len={self.cfg.max_len}")
        return self.sched.submit(prompt, max_new)

    def _admit(self, adm) -> None:
        req, slot = adm["req"], adm["slot"]
        C = self.cfg.page
        self._edit_tables(self._full_idx,
                          [(slot, c, p) for c, p in adm["full"]])
        self._edit_tables(self._roll_idx,
                          [(slot, c, p) for c, p in adm["roll"]])
        toks = req.prompt
        n_chunks = -(-len(toks) // C)
        padded = torch.tensor(toks + [0] * (n_chunks * C - len(toks)),
                              dtype=torch.int64)
        if self.device.type == "cuda":
            # one asynchronous copy from pinned memory: no host sync
            padded = padded.pin_memory().to(self.device, non_blocking=True)
        logits = None
        for j in range(n_chunks):
            valid = min(len(toks) - j * C, C)
            logits, self.cache = self._prefill(
                padded[None, j * C:(j + 1) * C], self.cache, slot, j * C,
                valid)
        first = int(torch.argmax(logits[0, -1]))      # host sync point
        self.cache["pos"][slot].fill_(len(toks))
        self.cache["active"][slot].fill_(True)
        self.last_token[slot, 0].fill_(first)
        seq = self.sched.slots[slot]
        seq.generated.append(first)
        self.tokens_out += 1
        self._maybe_finish(seq)

    def _maybe_finish(self, seq) -> bool:
        done = (len(seq.generated) >= seq.max_new
                or (self.cfg.eos_id is not None
                    and seq.generated[-1] == self.cfg.eos_id))
        if done:
            self.finished[seq.rid] = {"tokens": list(seq.generated),
                                      "prompt_len": seq.prompt_len}
            slot = seq.slot
            self.sched.evict(slot)
            self._clear_slot_tables(slot)
            self.cache["active"][slot].fill_(False)
            self.cache["pos"][slot].fill_(0)
        return done

    def step(self) -> int:
        """One engine tick: admit what fits, grow lazily allocated pages,
        run one decode step, harvest tokens, evict finished sequences.
        Returns the number of sequences that decoded this tick."""
        while True:
            adm = self.sched.try_admit(self.cfg.page)
            if adm is None:
                break
            self._admit(adm)
        active = self.sched.active_slots()
        if not active:
            return 0
        self._edit_tables(self._full_idx,
                          self.sched.grow_for_step(self.cfg.page))
        t0 = time.perf_counter()
        tok, self.cache = self._decode(self.last_token, self.cache)
        toks = tok.cpu().tolist()                     # host sync point
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        self.last_token = tok[:, None]
        for seq in active:
            seq.generated.append(toks[seq.slot])
            self._maybe_finish(seq)
        self.tokens_out += len(active)
        return len(active)

    def run(self, max_steps: int = 100_000) -> Dict[int, Dict[str, Any]]:
        """Drive until the queue and the batch drain; returns {rid:
        result}."""
        for _ in range(max_steps):
            if not self.sched.queue and not self.sched.active_slots():
                break
            if self.step() == 0 and self.sched.queue:
                raise RuntimeError(
                    "admission stalled with an empty batch: page pools too "
                    "small for the queued prompt")
        return dict(self.finished)

    # -- introspection -------------------------------------------------------
    def compile_stats(self) -> Dict[str, int]:
        """The distinct input signatures each step function has seen (what
        a tracing compiler would compile for): 1 + 1 after warm-up, and
        they must stay there across any admission or eviction pattern."""
        return {"decode_compiles": len(self._decode_sigs),
                "prefill_compiles": len(self._prefill_sigs)}

    def cache_report(self) -> Dict[str, float]:
        """Wire-meter HBM accounting over all layers (see
        PagedKVCache.meter_bits)."""
        agg = {"pool_bits": 0.0, "tail_bits": 0.0, "table_bits": 0.0,
               "fp_bits": 0.0}
        for c in self.cache["layers"]:
            m = c.meter_bits()
            for k in agg:
                agg[k] += m[k]
        total = agg["pool_bits"] + agg["tail_bits"] + agg["table_bits"]
        return {
            "fp_bytes": agg["fp_bits"] / 8,
            "paged_bytes": total / 8,
            "pool_bytes": agg["pool_bits"] / 8,
            "bits_per_elem":
                self.cache["layers"][0].meter_bits()["bits_per_elem"],
            "hbm_reduction_pool": agg["fp_bits"] / max(agg["pool_bits"], 1.0),
            "hbm_reduction_total": agg["fp_bits"] / max(total, 1.0),
        }

    def stats(self) -> Dict[str, float]:
        s = dict(self.sched.stats)
        s.update(decode_steps=self.decode_steps,
                 tokens_out=self.tokens_out,
                 decode_s=self.decode_s,
                 tokens_per_sec=(self.tokens_out / self.decode_s
                                 if self.decode_s else 0.0))
        s.update(self.compile_stats())
        return s
