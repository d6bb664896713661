"""Host-side serving control plane: page allocator, admission queue, slots
(the port of ``src/repro/serve/scheduler.py``, line for line).

Pure Python, run between device steps: it decides which page-table rows
change and never a shape.  Two page-id spaces exist per engine (see
paged_cache.init_paged_cache): one shared by all full-attention layers, one
by all rolling-window layers.  An id allocated here denotes the same page
row in every layer's pool of that kind.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence


@dataclasses.dataclass
class Request:
    """One prompt to serve.  ``max_new`` bounds generation; ``eos_id``
    (engine-level) or the bound evicts the sequence."""
    rid: int
    prompt: List[int]
    max_new: int = 32


@dataclasses.dataclass
class RunningSeq:
    rid: int
    slot: int
    prompt_len: int
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def pos(self) -> int:
        """Next position to be written (prompt + generated so far)."""
        return self.prompt_len + len(self.generated)


class PageAllocator:
    """Free-list allocator over one page-id space."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free_list: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self.free_list)

    def alloc(self, k: int) -> Optional[List[int]]:
        if k > self.n_free:
            return None
        return [self.free_list.pop() for _ in range(k)]

    def free(self, pids: Sequence[int]) -> None:
        for p in pids:
            if not 0 <= p < self.n_pages or p in self.free_list:
                raise ValueError(f"page {p} is not an allocated page")
            self.free_list.append(p)


class Scheduler:
    """Admission queue, slot bookkeeping and host mirrors of the page
    tables.

    The engine owns the device tensors; the scheduler decides which rows
    change and hands back (slot, column, page id) updates.  Full layers
    allocate pages lazily (a page is granted just before the first write
    into it), so a queued prompt needs only its prompt pages up front;
    rolling layers ring over a window's worth of pages granted at
    admission."""

    def __init__(self, *, max_batch: int, npp_full: int, npp_roll: int,
                 n_pages_full: int, n_pages_roll: int, has_rolling: bool):
        self.max_batch = max_batch
        self.npp_full, self.npp_roll = npp_full, npp_roll
        self.has_rolling = has_rolling
        self.alloc_full = PageAllocator(n_pages_full)
        self.alloc_roll = PageAllocator(n_pages_roll)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[RunningSeq]] = [None] * max_batch
        # host mirrors: slot -> the page ids allocated to it, per kind
        self.pages_full: List[List[int]] = [[] for _ in range(max_batch)]
        self.pages_roll: List[List[int]] = [[] for _ in range(max_batch)]
        self._rid = itertools.count()
        self.stats: Dict[str, int] = {"admitted": 0, "evicted": 0,
                                      "queued_peak": 0}

    # -- queue ---------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32) -> int:
        rid = next(self._rid)
        self.queue.append(Request(rid, list(prompt), max_new))
        self.stats["queued_peak"] = max(self.stats["queued_peak"],
                                        len(self.queue))
        return rid

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- admission -----------------------------------------------------------
    def try_admit(self, page: int) -> Optional[Dict]:
        """Admit the head of the queue if a slot and its pages are free.
        Returns {"req", "slot", "full": [(col, pid)...], "roll": [...]}, the
        page-table rows to write, or None."""
        if not self.queue:
            return None
        slot = self.free_slot()
        if slot is None:
            return None
        req = self.queue[0]
        n_prompt_pages = min(-(-len(req.prompt) // page), self.npp_full)
        full_pids = self.alloc_full.alloc(n_prompt_pages)
        if full_pids is None:
            return None
        roll_pids: List[int] = []
        if self.has_rolling:
            got = self.alloc_roll.alloc(self.npp_roll)
            if got is None:
                self.alloc_full.free(full_pids)
                return None
            roll_pids = got
        self.queue.popleft()
        self.slots[slot] = RunningSeq(req.rid, slot, len(req.prompt),
                                      req.max_new)
        self.pages_full[slot] = full_pids
        self.pages_roll[slot] = roll_pids
        self.stats["admitted"] += 1
        return {"req": req, "slot": slot,
                "full": list(enumerate(full_pids)),
                "roll": list(enumerate(roll_pids))}

    # -- lazy growth -----------------------------------------------------------
    def grow_for_step(self, page: int) -> List:
        """Page-table updates needed before the next decode step: for every
        active sequence about to write position ``seq.pos``, grant the full
        layers' logical page if it is not yet backed.  Raises if the pool is
        exhausted (sized pools should admit less instead)."""
        updates = []
        for seq in self.slots:
            if seq is None:
                continue
            col = seq.pos // page
            if col < self.npp_full and col >= len(self.pages_full[seq.slot]):
                got = self.alloc_full.alloc(1)
                if got is None:
                    raise RuntimeError(
                        "full-layer page pool exhausted mid-decode; size "
                        "n_pages_full for the worst case or admit less")
                self.pages_full[seq.slot].append(got[0])
                updates.append((seq.slot, col, got[0]))
        return updates

    # -- eviction --------------------------------------------------------------
    def evict(self, slot: int) -> RunningSeq:
        seq = self.slots[slot]
        if seq is None:
            raise ValueError(f"slot {slot} holds no sequence")
        self.alloc_full.free(self.pages_full[slot])
        if self.pages_roll[slot]:
            self.alloc_roll.free(self.pages_roll[slot])
        self.pages_full[slot] = []
        self.pages_roll[slot] = []
        self.slots[slot] = None
        self.stats["evicted"] += 1
        return seq

    def active_slots(self) -> List[RunningSeq]:
        return [s for s in self.slots if s is not None]
