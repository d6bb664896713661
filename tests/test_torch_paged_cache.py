"""The port's paged KV cache and its scheduler against the JAX reference on
the CPU (serve/paged_cache.py, serve/scheduler.py, prefill_chunk).

* the scheduler, pure host Python, exactly: the same page ids, admission
  order, growth edits, evictions and stats under one random trace;
* exact (fp) paged decode against the port's own contiguous path, bit for
  bit, for granite and for gemma with its rolling ring wrapping;
* the spare-row scatter: an inactive lane (page id -1) and a lane writing
  page n_pages - 1 in the same step;
* prefill_chunk against the reference from the same paged cache (carried
  over with ``paged_cache_from_numpy``): logits within 1e-5 of the largest
  |logit|, pools within 1e-5, 4-bit codes differing in fewer than 1e-5 of
  the elements; paged_from_contiguous's codes and the meter exactly.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as jax_tfm
from repro.serve import paged_cache as jax_pc
from repro.serve import scheduler as jax_sched
from repro_torch.configs.registry import get_config
from repro_torch.core.convert import (cache_from_numpy,
                                      paged_cache_from_numpy,
                                      params_from_numpy)
from repro_torch.models import transformer as tfm
from repro_torch.serve import paged_cache as pc
from repro_torch.serve import scheduler as sched
from test_torch_serve_models import (B, CACHE_LEN, CPU, RING, RTOL, S, STEPS,
                                     carried, configs, gap, t, to_np)

CODE_FRAC = 1e-5
PAGED = ["granite-3-2b", "granite-moe-1b-a400m", RING]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(mod, ops):
    """Run one trace of scheduler operations on module `mod`'s Scheduler
    and return everything it said and holds after each operation."""
    s = mod.Scheduler(max_batch=3, npp_full=4, npp_roll=2, n_pages_full=7,
                      n_pages_roll=6, has_rolling=True)
    log = []
    for op, arg in ops:
        if op == "submit":
            out = s.submit(list(range(arg)), max_new=arg % 5 + 1)
        elif op == "admit":
            adm = s.try_admit(16)
            out = None if adm is None else (adm["req"].rid, adm["slot"],
                                            adm["full"], adm["roll"])
        elif op == "grow":
            try:
                out = s.grow_for_step(16)
            except RuntimeError as e:
                out = str(e)
            for seq in s.active_slots():
                seq.generated.append(7)
        else:
            active = s.active_slots()
            out = None
            if active:
                out = s.evict(active[arg % len(active)].slot).rid
        log.append((op, out, [None if q is None else (q.rid, q.slot, q.pos)
                              for q in s.slots],
                    [list(p) for p in s.pages_full],
                    [list(p) for p in s.pages_roll],
                    list(s.alloc_full.free_list), list(s.alloc_roll.free_list),
                    dict(s.stats), [r.rid for r in s.queue]))
    return log


def test_scheduler_matches_reference_exactly():
    """One random trace of 300 submissions, admissions, growth steps and
    evictions (prompts of 1-60 tokens over pages of 16, pools small enough
    to make admission wait and growth run dry): every output and the whole
    host state after every operation equal the reference's."""
    rng = random.Random(0)
    ops = [(rng.choice(["submit", "admit", "admit", "grow", "grow",
                        "evict"]), rng.randrange(1, 61)) for _ in range(300)]
    assert _drive(sched, ops) == _drive(jax_sched, ops)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-12b"])
def test_paged_exact_is_bit_identical_to_contiguous(arch):
    """tests/test_serve.py:61 on the port: fp paged decode logits equal the
    contiguous path's exactly, every step; gemma decodes 150 steps past its
    128-token window so the ring wraps (the pool must supply the previous
    wrap's values beyond the current offset)."""
    cfg = get_config(arch).reduced(d_model=64, vocab=128)
    cache_len, steps = (64, 24) if arch == "granite-3-2b" else (192, 150)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, toks, cache_len=cache_len)
        _, twin = tfm.prefill(params, cfg, toks, cache_len=cache_len)
        pcache = pc.paged_from_contiguous(twin, cfg, page=16)
        t1 = t2 = lg[:, -1].argmax(-1)[:, None]
        for i in range(steps):
            lg1, cache = tfm.decode_step(params, cfg, t1, cache)
            lg2, pcache = tfm.decode_step(params, cfg, t2, pcache)
            assert torch.equal(lg1, lg2), f"diverged at decode step {i}"
            t1 = lg1[:, -1].argmax(-1)[:, None]
            t2 = lg2[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("kv_bits", [None, 4])
def test_spare_row_takes_the_writes_that_must_not_land(kv_bits):
    """Two lanes flush in one step: lane 0 into page n_pages - 1, lane 1
    inactive (page id -1).  Lane 0's page holds lane 0's tail (its codes,
    quantized), every other page is untouched; clamping -1 to the last
    page instead would have let lane 1 overwrite it."""
    cfg = get_config("granite-3-2b").reduced(d_model=64, vocab=128)
    cache = pc.init_paged_cache(cfg, 2, 32, page=16, kv_bits=kv_bits,
                                n_pages_full=3, device=CPU)
    layer = cache["layers"][0]
    n = layer.n_pages
    assert n == 3
    layer.page_table[0, 0] = n - 1
    gen = torch.Generator().manual_seed(0)
    shape = (2, 1, cfg.kv_heads, cfg.head_dim)
    for p in range(16):
        k, v = (torch.randn(shape, generator=gen) for _ in range(2))
        layer.update(k, v, torch.tensor([p, p]))
    tail = layer.tail_k[0]
    if kv_bits is None:
        pool = layer.kp
        assert torch.equal(pool[n - 1], tail)
    else:
        pool = layer.kc
        code, _ = pc.encode_rows(tail[None], layer.spec)
        assert torch.equal(pool[n - 1], code[0])
    assert not torch.equal(layer.tail_k[1], tail)
    assert torch.all(pool[:n - 1] == 0)
    assert layer.meter_bits() == jax_pc.init_paged_cache(
        jax_get_config("granite-3-2b").reduced(d_model=64, vocab=128), 2, 32,
        page=16, kv_bits=kv_bits, n_pages_full=3)["layers"][0].meter_bits()


def test_paged_from_contiguous_matches_reference():
    """The 4-bit conversion of one contiguous cache: the codes, scales,
    page tables and tails of both packages equal; the meter too."""
    jcfg, tcfg = configs("gemma3-12b")
    rng = np.random.default_rng(4)
    jc = jax_tfm.init_cache(jcfg, B, CACHE_LEN, jnp.float32)
    layers = []
    for c in jc["layers"]:
        k, v = (rng.standard_normal(c.k.shape).astype(np.float32)
                for _ in range(2))
        layers.append(type(c)(jnp.asarray(k), jnp.asarray(v), c.rolling))
    jc["layers"] = tuple(layers)
    jc["pos"] = jnp.asarray(21, jnp.int32)
    ref = to_np(jax_pc.paged_from_contiguous(jc, jcfg, page=16, kv_bits=4))
    mine = pc.paged_from_contiguous(cache_from_numpy(to_np(jc), CPU), tcfg,
                                    page=16, kv_bits=4)
    for a, b in zip(mine["layers"], ref["layers"]):
        assert a.rolling == b.rolling and a.spec.block == b.spec.block
        assert torch.equal(a.kc[:-1], torch.tensor(b.kc))
        assert torch.equal(a.vsc[:-1], torch.tensor(b.vsc))
        assert torch.equal(a.tail_v, torch.tensor(b.tail_v))
        assert np.array_equal(a.page_table.numpy(), b.page_table)
        assert a.meter_bits() == b.meter_bits()
    assert mine["pos"].tolist() == ref["pos"].tolist()


def _reference_paged(jcfg, jp, prompt, kv_bits):
    """The reference's paged cache after admitting `prompt` into slot 0 of
    a 2-slot cache (prompt pages, plus the ring's for rolling layers),
    chunk by chunk: the caches before each chunk and the chunks' logits."""
    page = 16
    jcache = jax_pc.init_paged_cache(jcfg, B, CACHE_LEN, page=page,
                                     kv_bits=kv_bits, dtype=jnp.float32)
    npp_full, npp_roll = jax_pc._geometry(jcfg, CACHE_LEN, page)
    layers = []
    for c in jcache["layers"]:
        npp = npp_roll if c.rolling else npp_full
        layers.append(c.replace(page_table=c.page_table.at[0].set(
            jnp.arange(npp, dtype=jnp.int32) + 1)))
    jcache["layers"] = tuple(layers)
    fn = jax.jit(lambda p, tk, c, start, valid: jax_tfm.prefill_chunk(
        p, jcfg, tk, c, 0, start, valid))
    caches, logits = [], []
    for start in range(0, len(prompt), page):
        chunk = prompt[start:start + page]
        valid = len(chunk)
        chunk = chunk + [0] * (page - valid)
        caches.append(to_np(jcache))
        lg, jcache = fn(jp, jnp.asarray([chunk], jnp.int32), jcache,
                        start, valid)
        logits.append(np.asarray(lg))
    return caches, logits, to_np(jcache)


def _codes_and_pools_close(tcache, jcache, kv_bits):
    """The port's pools against the reference's: exact pools within 1e-5;
    codes differing in fewer than CODE_FRAC of the elements, scales within
    1e-5."""
    diff = total = 0
    for a, b in zip(tcache["layers"], jcache["layers"]):
        assert torch.equal(a.page_table, torch.tensor(
            np.asarray(b.page_table), dtype=torch.int64))
        assert gap(a.tail_k, b.tail_k) <= RTOL["float32"]
        if kv_bits is None:
            assert gap(a.kp[:-1], b.kp) <= RTOL["float32"]
            assert gap(a.vp[:-1], b.vp) <= RTOL["float32"]
            continue
        for mine, ref in ((a.kc, b.kc), (a.vc, b.vc)):
            diff += int((mine[:-1] != torch.tensor(np.asarray(ref))).sum())
            total += ref.size
        assert gap(a.ksc[:-1], b.ksc) <= RTOL["float32"]
    assert diff <= CODE_FRAC * total, (diff, total)


@pytest.mark.parametrize("kv_bits", [None, 4])
@pytest.mark.parametrize("name", PAGED)
def test_prefill_chunk_matches_reference(name, kv_bits):
    """prefill_chunk of a 20-token prompt (one full chunk, one of 4) into
    a paged cache carried over from the reference's before each chunk:
    the chunks' logits and the pools; then STEPS decode steps of the two
    lanes (slot 1 idle, its page ids -1) on the carried paged cache."""
    jcfg, tcfg = configs(name)
    jp = carried(tcfg)
    tp = params_from_numpy(jp, device=CPU)
    prompt = [int(x) for x in
              np.random.default_rng(3).integers(0, jcfg.vocab, S)]
    caches, logits, jcache = _reference_paged(jcfg, jp, prompt, kv_bits)
    for j, (before, want) in enumerate(zip(caches, logits)):
        start = 16 * j
        chunk = prompt[start:start + 16]
        valid = len(chunk)
        tc = paged_cache_from_numpy(before, device=CPU)
        with torch.no_grad():
            lg, tc = tfm.prefill_chunk(
                tp, tcfg, torch.tensor([chunk + [0] * (16 - valid)]), tc,
                0, start, valid)
        assert lg.shape == want.shape
        assert gap(lg, want) <= RTOL["float32"], f"chunk {j}"
    _codes_and_pools_close(tc, jcache, kv_bits)
    # decode both lanes from the reference's cache, lane 0 at position S
    jcache["pos"] = np.array([S, 0], np.int32)
    step = jax.jit(lambda p, tk, c: jax_tfm.decode_step(p, jcfg, tk, c))
    tok = np.array([[int(np.argmax(logits[-1][0, -1]))], [0]])
    for i in range(STEPS):
        tc = paged_cache_from_numpy(jcache, device=CPU)
        jlg, jc = step(jp, jnp.asarray(tok, jnp.int32), jcache)
        with torch.no_grad():
            tlg, tc = tfm.decode_step(tp, tcfg, t(tok), tc)
        assert gap(tlg[:1], np.asarray(jlg)[:1]) <= RTOL["float32"], i
        jcache = to_np(jc)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1)[:, None]
