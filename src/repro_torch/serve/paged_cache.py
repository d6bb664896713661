"""Paged KV cache: fixed-size pages in a per-layer pool, indexed by a
per-sequence page table (the port of ``src/repro/serve/paged_cache.py``).

One ``PagedKVCache`` per attention layer:

  * **pool** - ``n_pages`` pages.  Exact mode stores fp pages ``(page,
    kv_heads, head_dim)``; quantized mode stores the wire-codec form, int8
    codes ``(nb, block)`` and f32 scales ``(nb, 1)`` per page, for K and V
    (kv_quant.py: a page flattened page-major is the codec's block layout).
    Each pool has one spare row past the last page, ``n_pages``: writes
    that must not land (an inactive lane, an unallocated page, a partial
    prefill chunk) go there.  torch has no drop-mode scatter, and clamping
    the id instead would let an inactive lane overwrite a page that another
    lane writes in the same step.  Reads never see the spare row (ids are
    clipped to ``n_pages - 1``, as the reference clips them), and neither
    ``n_pages`` nor the meter counts it.
  * **page_table** - ``(max_batch, pages_per_seq)`` int64 page ids, -1
    where unallocated.  Full layers index logical page ``pos // page``;
    rolling (sliding-window) layers ring over ``window // page`` pages,
    slot for slot the contiguous ring (``slot = pos % window``), so exact
    decode is bit-identical to ``attention.KVCache``.
  * **tail** - ``(max_batch, page, kv_heads, head_dim)`` fp staging buffer
    holding each sequence's current, partly written page.  The tail is
    always exact: a page is encoded (quantized) once, when it flushes.

Every update is a scatter or gather with device-side indices and every
write lands in place, so a serving step changes data and never a shape,
and makes no host sync.  Layers of one kind share one page-table tensor:
an edit to it reaches every such layer.

Across ranks (dist/serve.py) each rank holds its lanes' page tables and
tails and a whole copy of the pool.  A cache with a ``group`` keeps the
copies equal: each decode step's written page rows (the encoded codes and
scales, or fp pages) and their page ids are all-gathered over the group,
one collective per layer, and every rank writes all of them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import all_gather_bytes
from repro_torch.serve.kv_quant import (KVQuantSpec, decode_rows, encode_rows,
                                        pick_block)

_POOL_FIELDS = ("kp", "vp", "kc", "ksc", "vc", "vsc")


class PagedKVCache:
    """One layer's paged KV cache.  ``spec is None`` => exact fp pool.

    Tensors (exact):  kp, vp, page_table, tail_k, tail_v
    Tensors (quant):  kc, ksc, vc, vsc, page_table, tail_k, tail_v
    Each pool tensor has n_pages + 1 rows (the last is the spare row).
    ``group`` (a torch.distributed group, None in one process): the ranks
    whose lanes write into this pool's copies (see the module docstring)."""

    def __init__(self, *, page: int, rolling: bool,
                 spec: Optional[KVQuantSpec], page_table, tail_k, tail_v,
                 kp=None, vp=None, kc=None, ksc=None, vc=None, vsc=None,
                 group=None):
        self.page, self.rolling, self.spec = page, rolling, spec
        self.page_table, self.tail_k, self.tail_v = page_table, tail_k, tail_v
        self.kp, self.vp = kp, vp
        self.kc, self.ksc, self.vc, self.vsc = kc, ksc, vc, vsc
        self.group = group

    @property
    def pool_fields(self) -> Tuple[str, ...]:
        """The pool tensors' names (exact: kp, vp; quantized: kc, ksc, vc,
        vsc)."""
        return tuple(n for n in _POOL_FIELDS if getattr(self, n) is not None)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the layer by field name, the page table first."""
        names = ("page_table", "tail_k", "tail_v") + _POOL_FIELDS
        return {n: getattr(self, n) for n in names
                if getattr(self, n) is not None}

    # -- geometry -----------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return (self.kp if self.spec is None else self.kc).shape[0] - 1

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def view_len(self) -> int:
        return self.pages_per_seq * self.page

    @property
    def page_shape(self) -> Tuple[int, int, int]:
        return tuple(self.tail_k.shape[1:])

    @property
    def dtype(self):
        return self.tail_k.dtype

    def _cur_page(self, pos):
        """Logical page-table column holding position ``pos`` (a tensor or
        a host int)."""
        npp = self.pages_per_seq
        if self.rolling:
            return (pos // self.page) % npp
        if isinstance(pos, int):
            return min(max(pos // self.page, 0), npp - 1)
        return torch.clamp(pos // self.page, 0, npp - 1)

    # -- pool access ---------------------------------------------------------
    def _gather_pages(self, pt):
        """pt: page ids of any shape -> fp pages (*pt, page, nkv, hd),
        decoding the wire codec (K2) for quantized pools."""
        safe = torch.clamp(pt, 0, self.n_pages - 1)
        if self.spec is None:
            return self.kp[safe], self.vp[safe]
        k = decode_rows(self.kc[safe], self.ksc[safe], self.spec,
                        self.page_shape, self.dtype)
        v = decode_rows(self.vc[safe], self.vsc[safe], self.spec,
                        self.page_shape, self.dtype)
        return k, v

    def _scatter_page(self, pid, k_pages, v_pages, group=None) -> None:
        """Write fp pages (pid.numel(), *page_shape) at the ids ``pid`` (the
        spare row n_pages takes the writes that must not land).  Quantized
        pools encode through the wire codec (K4) here, the one lossy step
        in a page's life.  With a ``group``, every rank's ids and encoded
        rows are all-gathered first and all of them written."""
        pid = pid.reshape(-1)
        if self.spec is None:
            rows = (k_pages.to(self.kp.dtype), v_pages.to(self.vp.dtype))
        else:
            kc, ksc = encode_rows(k_pages.reshape(-1, *self.page_shape),
                                  self.spec)
            vc, vsc = encode_rows(v_pages.reshape(-1, *self.page_shape),
                                  self.spec)
            rows = (kc, ksc, vc, vsc)
        writes = ([(pid, rows)] if group is None
                  else _all_gathered(pid, rows, group))
        for ids, parts in writes:
            for name, r in zip(self.pool_fields, parts):
                getattr(self, name).index_copy_(0, ids, r)

    # -- decode-step paths ---------------------------------------------------
    def view(self, pos):
        """Per-sequence KV view for decode attention.

        pos: (B,) current positions.  Returns (k, v), each (B, view_len,
        nkv, hd): the pool pages gathered through the page table (quantized
        pages decoded on read) with the exact tail overlaid on the current
        page at offsets <= pos % page.  Offsets beyond that fall through to
        the pool: for rolling layers the previous wrap's values, what the
        contiguous ring holds there.  One layer's pages are the only
        transient."""
        B, npp, page = pos.shape[0], self.pages_per_seq, self.page
        kpg, vpg = self._gather_pages(self.page_table)   # (B, npp, page, ...)
        lane = torch.arange(B, device=pos.device)
        cur = self._cur_page(pos)
        use_tail = (torch.arange(page, device=pos.device)[None, :]
                    <= (pos % page)[:, None])[..., None, None]
        for pages, tail in ((kpg, self.tail_k), (vpg, self.tail_v)):
            pages[lane, cur] = torch.where(use_tail, tail.to(pages.dtype),
                                           pages[lane, cur])
        nkv, hd = kpg.shape[-2:]
        return (kpg.reshape(B, npp * page, nkv, hd),
                vpg.reshape(B, npp * page, nkv, hd))

    def update(self, k_new, v_new, pos) -> "PagedKVCache":
        """Insert one token's k/v (B, 1, nkv, hd) per sequence at positions
        ``pos`` (B,), in place.

        The token lands in the exact tail; when it completes a page
        (pos % page == page - 1) the tail flushes to the pool at the page
        table's id for the current logical page (rolling layers ring over
        their pages in place).  Lanes with no allocated page (id -1, e.g.
        inactive lanes) flush to the spare row.  The tails are encoded on
        every step, as in the reference: the flush decides where they
        land."""
        B, page = pos.shape[0], self.page
        off = pos % page
        lane = torch.arange(B, device=pos.device)
        self.tail_k[lane, off] = k_new[:, 0].to(self.dtype)
        self.tail_v[lane, off] = v_new[:, 0].to(self.dtype)
        pid = self.page_table[lane, self._cur_page(pos)]
        write = (off == page - 1) & (pid >= 0)
        self._scatter_page(torch.where(write, pid, self.n_pages),
                           self.tail_k, self.tail_v, self.group)
        return self

    # -- chunked-prefill paths ----------------------------------------------
    def prefill_view(self, slot: int, start: int):
        """KV view and logical positions for one sequence's prefill chunk.

        slot: the batch lane; start: the chunk's first position (host ints).
        Returns (k (1, view_len, nkv, hd), v, k_pos (view_len,), k_valid
        (view_len,)): the slot's pool pages with each slot's position
        rebuilt - full layers hold position s at slot s (valid iff s <
        start); rolling layers hold the last write to the ring slot (valid
        iff it exists).  The tail never takes part: chunks are page-aligned,
        and only the last (partial) chunk writes the tail."""
        L = self.view_len
        kpg, vpg = self._gather_pages(self.page_table[slot])
        nkv, hd = kpg.shape[-2:]
        s = torch.arange(L, device=kpg.device)
        if self.rolling:
            k_pos = start - 1 - torch.remainder(start - 1 - s, L)
            k_valid = (k_pos >= 0) & (start > 0)
        else:
            k_pos = s
            k_valid = s < start
        return (kpg.reshape(1, L, nkv, hd), vpg.reshape(1, L, nkv, hd),
                k_pos, k_valid)

    def insert_chunk(self, k_chunk, v_chunk, slot: int, start: int,
                     valid_len: int) -> "PagedKVCache":
        """Insert one prefill chunk (1, page, nkv, hd) of sequence ``slot``
        starting at position ``start`` (page-aligned), in place.  A full
        chunk (valid_len == page) flushes straight to its pool page; the
        last, partial chunk lands in the exact tail instead (its pad
        positions write garbage there, masked by position wherever it is
        read)."""
        page = self.page
        if k_chunk.shape[1] != page:
            raise ValueError(f"a prefill chunk is one page ({page}), got "
                             f"{k_chunk.shape[1]}")
        pid = self.page_table[slot, self._cur_page(start)]
        full = (pid >= 0) & (valid_len >= page)
        self._scatter_page(torch.where(full, pid, self.n_pages),
                           k_chunk.to(self.dtype), v_chunk.to(self.dtype))
        self.tail_k[slot] = torch.where(full, self.tail_k[slot],
                                        k_chunk[0].to(self.dtype))
        self.tail_v[slot] = torch.where(full, self.tail_v[slot],
                                        v_chunk[0].to(self.dtype))
        return self

    # -- metering ------------------------------------------------------------
    def meter_bits(self) -> Dict[str, float]:
        """Wire-accurate storage meter of this layer (K + V).

        pool_bits charges quantized pages at the codec rate ((bits + 1) per
        element + 32 per block scale) and exact pages at the container
        width; tail and table bits are the exact overhead; fp_bits is the
        contiguous fp cache of the same per-sequence capacity (the baseline
        of the HBM-reduction claim).  The spare row is not counted."""
        npp = self.pages_per_seq
        B = self.page_table.shape[0]
        elems = 1
        for s in self.page_shape:
            elems *= int(s)
        dtype_bits = self.tail_k.element_size() * 8
        if self.spec is None:
            pool_bits = 2 * self.n_pages * elems * dtype_bits
            bits_per_elem = float(dtype_bits)
        else:
            pool_bits = 2 * self.n_pages * self.spec.page_bits(elems)
            bits_per_elem = self.spec.bits_per_elem
        return {
            "pool_bits": float(pool_bits),
            "tail_bits": float(2 * B * elems * dtype_bits),
            "table_bits": float(B * npp * 32),
            "bits_per_elem": float(bits_per_elem),
            "fp_bits": float(2 * B * npp * elems * dtype_bits),
        }


def _all_gathered(pid, rows, group):
    """[(ids, rows)] of every rank of `group`, in rank order: this rank's
    page ids (int64) and pool rows packed into one byte buffer and moved by
    one all-gather, each rank's part read back as views."""
    parts = (pid,) + tuple(rows)
    out = all_gather_bytes(torch.cat([p.contiguous().reshape(-1)
                                      .view(torch.uint8) for p in parts]),
                           group)
    writes = []
    for row in out:
        views, at = [], 0
        for p in parts:
            n = p.numel() * p.element_size()
            views.append(row[at:at + n].view(p.dtype).reshape(p.shape))
            at += n
        writes.append((views[0], views[1:]))
    return writes


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _attn_layer_kinds(cfg) -> Tuple[str, ...]:
    types = cfg.layer_types()
    bad = [t for t in types if t not in ("attn", "local", "global")]
    if bad:
        raise ValueError(f"paged serving supports attention block stacks "
                         f"only, got {bad}; recurrent / cross-attention "
                         "families use the contiguous path")
    if cfg.cross_attn_every or cfg.encoder_layers:
        raise ValueError("paged serving does not carry cross-attention "
                         "memories")
    return types


def _geometry(cfg, max_len: int, page: int):
    if max_len % page:
        raise ValueError(f"max_len {max_len} is not a whole number of "
                         f"pages ({page})")
    w_eff = min(cfg.window, max_len)
    if w_eff % page:
        raise ValueError(f"rolling window {w_eff} must be a whole number "
                         f"of pages ({page})")
    return max_len // page, w_eff // page


def _with_spare(pages: torch.Tensor) -> torch.Tensor:
    """pages (n, ...) -> (n + 1, ...): the spare row appended, zero."""
    return torch.cat([pages, torch.zeros_like(pages[:1])])


def _empty_layer(cfg, kind: str, batch: int, n_pages: int,
                 spec: Optional[KVQuantSpec], dtype, page: int,
                 page_table) -> PagedKVCache:
    nkv, hd = cfg.kv_heads, cfg.head_dim
    dev = page_table.device

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    kw: Dict[str, Any] = dict(page=page, rolling=(kind == "local"),
                              spec=spec, page_table=page_table,
                              tail_k=zeros((batch, page, nkv, hd), dtype),
                              tail_v=zeros((batch, page, nkv, hd), dtype))
    rows = n_pages + 1                                # + the spare row
    if spec is None:
        kw.update(kp=zeros((rows, page, nkv, hd), dtype),
                  vp=zeros((rows, page, nkv, hd), dtype))
    else:
        nb = page * nkv * hd // spec.block
        kw.update(kc=zeros((rows, nb, spec.block), torch.int8),
                  ksc=zeros((rows, nb, 1), torch.float32),
                  vc=zeros((rows, nb, spec.block), torch.int8),
                  vsc=zeros((rows, nb, 1), torch.float32))
    return PagedKVCache(**kw)


def init_paged_cache(cfg, batch: int, max_len: int, *, page: int = 16,
                     kv_bits: Optional[int] = None,
                     block: Optional[int] = None, dtype=torch.bfloat16,
                     n_pages_full: Optional[int] = None,
                     n_pages_roll: Optional[int] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Empty paged serving cache for an attention-stack model on `device`
    ("cuda" when None).

    Layers of one kind (full or rolling) share one page-table tensor and
    one page-id space: the scheduler allocates a page id once and it
    denotes the same page row in every such layer's pool.  Pools default
    to full provisioning (batch * pages_per_seq); smaller pools make
    admission wait on freed pages."""
    dev = resolve_device(device)
    types = _attn_layer_kinds(cfg)
    npp_full, npp_roll = _geometry(cfg, max_len, page)
    spec = None
    if kv_bits is not None:
        elems = page * cfg.kv_heads * cfg.head_dim
        spec = KVQuantSpec(kv_bits, block or pick_block(elems))
    pt_full = torch.full((batch, npp_full), -1, dtype=torch.int64, device=dev)
    pt_roll = torch.full((batch, npp_roll), -1, dtype=torch.int64, device=dev)
    n_full = n_pages_full or batch * npp_full
    n_roll = n_pages_roll or batch * npp_roll
    layers = tuple(
        _empty_layer(cfg, t, batch, n_roll if t == "local" else n_full,
                     spec, dtype, page, pt_roll if t == "local" else pt_full)
        for t in types)
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int64, device=dev),
            "active": torch.zeros((batch,), dtype=torch.bool, device=dev)}


def paged_from_contiguous(cache: Dict[str, Any], cfg, *, page: int = 16,
                          kv_bits: Optional[int] = None,
                          block: Optional[int] = None) -> Dict[str, Any]:
    """A contiguous ``init_cache`` / ``prefill`` cache in the paged layout
    (slot-major page ids, the pool fully provisioned), on the cache's
    device: the bit-identity pins start both paths from the same values.
    Reads the scalar position on the host."""
    if "cross_mem" in cache or "enc_mem" in cache:
        raise ValueError("paged serving does not carry cross-attention "
                         "memories")
    pos_val = int(cache["pos"])
    layers = []
    for c in cache["layers"]:
        B, L, nkv, hd = c.k.shape
        if L % page:
            raise ValueError(f"cache length {L} is not a whole number of "
                             f"pages ({page})")
        npp = L // page
        spec = None
        if kv_bits is not None:
            spec = KVQuantSpec(kv_bits, block or pick_block(page * nkv * hd))
        pt = torch.arange(B * npp, dtype=torch.int64,
                          device=c.k.device).reshape(B, npp)
        kpages = c.k.reshape(B * npp, page, nkv, hd)
        vpages = c.v.reshape(B * npp, page, nkv, hd)
        cur = (pos_val // page) % npp if c.rolling \
            else min(pos_val // page, npp - 1)
        kw: Dict[str, Any] = dict(
            page=page, rolling=c.rolling, spec=spec, page_table=pt,
            tail_k=c.k[:, cur * page:(cur + 1) * page].clone(),
            tail_v=c.v[:, cur * page:(cur + 1) * page].clone())
        if spec is None:
            kw.update(kp=_with_spare(kpages), vp=_with_spare(vpages))
        else:
            kc, ksc = encode_rows(kpages, spec)
            vc, vsc = encode_rows(vpages, spec)
            kw.update(kc=_with_spare(kc), ksc=_with_spare(ksc),
                      vc=_with_spare(vc), vsc=_with_spare(vsc))
        layers.append(PagedKVCache(**kw))
    B = cache["layers"][0].k.shape[0]
    dev = cache["layers"][0].k.device
    return {"layers": tuple(layers),
            "pos": torch.full((B,), pos_val, dtype=torch.int64, device=dev),
            "active": torch.ones((B,), dtype=torch.bool, device=dev)}
