"""Serving across ranks (src/repro_torch/dist/serve.py and
dist/sharding.serve_batch_spec) against the JAX reference and against the
one-process port, on the CPU.

* ``serve_batch_spec`` against the reference's PartitionSpec on every rank
  of (data, model) and (pod, data, model) grids, "data" dividing B and
  not, tensors of 0-4 dimensions;
* ``_batched`` against the reference's on the cases of
  tests/test_serve.py::test_batched_sharding_classifies_by_path_not_shape
  (a pool with n_pages == B, a contiguous cache with cache_len == B, a
  misclassified leaf), and the make_* placements against the
  reference's;
* a 2-rank gloo world, mesh (2, 1), and a (2, 2) one (4 ranks: two data
  indices, each with a replica along "model"), started when the module
  starts (this file run as a script per rank, a FileStore under tmp_path,
  one torch thread): reduced granite-3-2b (d_model 64, vocab 128), 4-bit
  KV pages, B = 4, a 28-token prompt, make_prefill, paged_from_rows and 8
  greedy steps of make_paged_decode's fn, lane 0's first page-table entry
  naming the page that lane B - 1 (on the other data index) flushes at
  step 3.  Each rank's logits and every rank's pool after every step equal
  the one-process port's bit for bit; without the gather lane 0 reads a
  stale page once it is flushed;
* MoE with the rows split (the same worlds): reduced granite-moe-1b-a400m
  (4 experts, top-2, capacity factor 1.25), B = 4, a 20-token prompt
  whose routing overflows an expert, make_prefill, paged_from_rows and 2
  greedy steps of make_paged_decode's fn.  Each rank's last-token logits,
  its rows of the contiguous cache and its decode logits equal the
  one-process port's bit for bit: every MoE layer routes the whole batch,
  as the reference's GSPMD program does, where routing each rank's rows
  alone gives other logits;
* the one-process port's prefill and paged decode against the reference's
  make_prefill / make_paged_decode fns on the same weights, each step from
  the reference's cache: logits within 1e-5 of the largest |logit| (the
  serving tests' bound for an f32 cache), 4-bit codes differing in fewer
  than 1e-5 of the elements.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dist_serve.py
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300
B, S, CACHE_LEN, STEPS, PAGE, KV_BITS = 4, 28, 64, 8, 16, 4
FLUSH = 3                        # the step at which position 31 ends page 1
WORLDS = {"2x1": (2, 1), "2x2": (2, 2)}
RTOL, CODE_FRAC = 1e-5, 1e-5
MOE_S, MOE_STEPS = 20, 2


def _config():
    from repro_torch.configs.registry import get_config
    return get_config("granite-3-2b").reduced(d_model=64, vocab=128)


def _inputs(cfg):
    """The weights (the port's init from seed 0) and the (B, S) prompt."""
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    return params, tokens


def _moe_config():
    from repro_torch.configs.registry import get_config
    return get_config("granite-moe-1b-a400m").reduced()


def _moe_inputs(cfg):
    """The reduced MoE's weights (seed 0) and its (B, MOE_S) prompt."""
    from repro_torch.models import transformer as tfm
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, MOE_S),
                           generator=torch.Generator().manual_seed(2))
    return params, tokens


def _kv(cache):
    """Every layer's contiguous (k, v), copied."""
    return [(c.k.clone(), c.v.clone()) for c in cache["layers"]]


def moe_run(prefill, decode, paged_from, params, tokens):
    """prefill, then MOE_STEPS greedy paged decode steps: the logits of
    each and the prefill's contiguous cache."""
    with torch.no_grad():
        lg, cache = prefill(params, tokens)
        kv = _kv(cache)
        paged = paged_from(cache)
        logits = [lg]
        for _ in range(MOE_STEPS):
            lg, paged = decode(params, lg[:, -1].argmax(-1)[:, None], paged)
            logits.append(lg)
    return logits, kv


def moe_one_process(cfg, params, tokens):
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous

    return moe_run(
        lambda p, t: tfm.prefill(p, cfg, t, cache_len=CACHE_LEN),
        lambda p, t, c: tfm.decode_step(p, cfg, t, c),
        lambda c: paged_from_contiguous(c, cfg, page=PAGE, kv_bits=KV_BITS),
        params, tokens)


def _pools(cache):
    """Every layer's pool tensors without the spare row, copied."""
    return [[getattr(c, n)[:-1].clone() for n in c.pool_fields]
            for c in cache["layers"]]


def _point_lane0_at_last_lane(cache, first):
    """Lane 0's first page-table entry names lane B - 1's second page (the
    page it flushes at step FLUSH), on the rank that holds global lane 0."""
    for c in cache["layers"]:
        if first == 0:
            c.page_table[0, 0] = (B - 1) * c.pages_per_seq + 1


class GatherSpy:
    """Bytes that each all-gather inside the with block is handed, per
    step (mark_step): [[calls, bytes], ...]."""

    def __enter__(self):
        import torch.distributed as dist

        self.steps, self._dist, self._orig = [[0, 0]], dist, {}
        for name in ("all_gather_single", "all_gather_into_tensor"):
            orig = getattr(dist, name, None)
            if orig is None:
                continue
            self._orig[name] = orig

            def spy(out, inp, *a, _orig=orig, **kw):
                self.steps[-1][0] += 1
                self.steps[-1][1] += inp.numel() * inp.element_size()
                return _orig(out, inp, *a, **kw)

            setattr(dist, name, spy)
        return self

    def mark_step(self):
        self.steps.append([0, 0])

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self._dist, name, orig)


def one_process_run(cfg, params, tokens):
    """The one-process port: prefill, paged_from_contiguous and STEPS
    greedy paged decode steps (lane 0 pointed at lane B - 1's page):
    per step the logits and the pools."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import paged_from_contiguous

    with torch.no_grad():
        lg, cache = tfm.prefill(params, cfg, tokens, cache_len=CACHE_LEN)
        paged = paged_from_contiguous(cache, cfg, page=PAGE, kv_bits=KV_BITS)
        _point_lane0_at_last_lane(paged, 0)
        tok = lg[:, -1].argmax(-1)[:, None]
        logits, pools = [lg], []
        for _ in range(STEPS):
            lg, paged = tfm.decode_step(params, cfg, tok, paged)
            logits.append(lg)
            pools.append(_pools(paged))
            tok = lg[:, -1].argmax(-1)[:, None]
    return logits, pools


# -- the rank side ---------------------------------------------------------

def rank_main(out_dir, world, rank):
    """One rank of a `world` ("2x1" or "2x2") run: the rank's rows through
    make_prefill, paged_from_rows and STEPS greedy steps of
    make_paged_decode's fn, then the same steps again without the gather
    (the layers' group cleared); saves its logits, pools and the bytes it
    handed to each all-gather."""
    import torch.distributed as dist

    from repro_torch.configs.base import InputShape
    from repro_torch.dist import serve as dserve
    from repro_torch.dist.sharding import make_profile
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm

    torch.set_num_threads(1)
    shape = WORLDS[world]
    n = shape[0] * shape[1]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, f"{world}.store"),
                                     n), rank=rank, world_size=n)
    try:
        mesh = make_mesh(shape)
        cfg = _config()
        prof = make_profile(cfg, mesh.axis_names)
        params, tokens = _inputs(cfg)
        # the shape's seq_len is the cache length; the prompt is shorter
        prefill, _, pre_sh, _ = dserve.make_prefill(
            cfg, mesh, prof, InputShape("p", CACHE_LEN, B, "prefill"))
        fn, _, dec_sh, _ = dserve.make_paged_decode(
            cfg, mesh, prof, InputShape("d", CACHE_LEN, B, "decode"),
            page=PAGE, kv_bits=KV_BITS)
        first = pre_sh["tokens"].start
        runs = {}
        for gather in (True, False):
            with torch.no_grad(), GatherSpy() as spy:
                lg, cache = prefill(params, dserve.place(tokens,
                                                         pre_sh["tokens"]))
                paged = dserve.paged_from_rows(cache, cfg, mesh, B,
                                               page=PAGE, kv_bits=KV_BITS)
                _point_lane0_at_last_lane(paged, first)
                tok = lg[:, -1].argmax(-1)[:, None]
                logits, pools = [lg], []
                for _ in range(STEPS):
                    spy.mark_step()
                    if gather:
                        lg, paged = fn(params, tok, paged)
                    else:
                        lg, paged = tfm.decode_step(params, cfg, tok, paged)
                    logits.append(lg)
                    pools.append(_pools(paged))
                    tok = lg[:, -1].argmax(-1)[:, None]
            runs[gather] = (logits, pools, spy.steps)
        # MoE: the rank's rows through make_prefill and make_paged_decode
        mcfg = _moe_config()
        mparams, mtokens = _moe_inputs(mcfg)
        mprof = make_profile(mcfg, mesh.axis_names)
        mpre, _, mpre_sh, _ = dserve.make_prefill(
            mcfg, mesh, mprof, InputShape("p", CACHE_LEN, B, "prefill"))
        mdec, _, _, _ = dserve.make_paged_decode(
            mcfg, mesh, mprof, InputShape("d", CACHE_LEN, B, "decode"),
            page=PAGE, kv_bits=KV_BITS)
        moe = moe_run(
            mpre, mdec,
            lambda c: dserve.paged_from_rows(c, mcfg, mesh, B, page=PAGE,
                                             kv_bits=KV_BITS),
            mparams, dserve.place(mtokens, mpre_sh["tokens"]))
    finally:
        dist.destroy_process_group()
    logits, pools, steps = runs[True]
    torch.save({"first": first, "stop": pre_sh["tokens"].stop,
                "coords": mesh.coords(), "logits": logits, "pools": pools,
                "gathered": steps, "split": dec_sh["cache"]["pos"].split,
                "logits_no_gather": runs[False][0], "moe": moe},
               os.path.join(out_dir, f"{world}.{rank}.pt"))


# -- the test side ---------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both rank worlds, started together when the module starts; a test
    that reads one waits for it."""
    out = tmp_path_factory.mktemp("serve_ranks")
    procs = {w: [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), w, str(r)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(s[0] * s[1])] for w, s in WORLDS.items()}
    done = {}

    def wait(world):
        if world not in done:
            ps = procs.pop(world)
            deadline = time.time() + TIMEOUT
            errs = []
            try:
                for p in ps:
                    o, e = p.communicate(
                        timeout=max(deadline - time.time(), 1))
                    if p.returncode:
                        errs.append(o[-2000:] + e[-4000:])
            finally:
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            assert not errs, f"{world}: " + "\n".join(errs)
            done[world] = [torch.load(out / f"{world}.{r}.pt")
                           for r in range(len(ps))]
        return done[world]

    yield wait
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(worlds):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_process():
    cfg = _config()
    return one_process_run(cfg, *_inputs(cfg))


def _ref_spec(dims, ndim, batch):
    from repro.dist.sharding import serve_batch_spec
    mesh = SimpleNamespace(shape=dict(dims), axis_names=tuple(dims))
    return serve_batch_spec(mesh, ndim, batch)


@pytest.mark.parametrize("dims,batch", [
    ({"data": 2, "model": 2}, 4), ({"data": 2, "model": 2}, 3),
    ({"data": 4, "model": 1}, 2), ({"data": 1, "model": 2}, 3),
    ({"pod": 2, "data": 2, "model": 2}, 4)])
def test_serve_batch_spec_matches_reference(dims, batch):
    """Every rank's placement is the reference's PartitionSpec: rows
    [i B / D, (i + 1) B / D) at data index i under P("data", None, ...),
    the whole tensor under P(None, ...); ranks along pod and model hold
    their data index's rows."""
    from jax.sharding import PartitionSpec as P

    from repro_torch.dist.sharding import serve_batch_spec
    from repro_torch.launch.mesh import RankMesh

    shape = tuple(dims.values())
    for rank in range(int(np.prod(shape))):
        mesh = RankMesh(shape=shape, axis_names=tuple(dims), rank=rank)
        D, i = dims["data"], mesh.coords()["data"]
        for ndim in range(5):
            ref = _ref_spec(dims, ndim, batch)
            got = serve_batch_spec(mesh, ndim, batch)
            if ref == P("data", *([None] * (ndim - 1))) and ndim:
                n = batch // D
                assert (got.start, got.stop) == (i * n, (i + 1) * n)
            else:
                assert ref == P(*([None] * ndim)) and not got.split, got
            x = torch.arange(max(batch, 1) * 3).reshape(batch, 3)
            assert torch.equal(got.take(x), x[got.start:got.stop])


def _split(sh):
    """A reference NamedSharding: is dim 0 on "data"?"""
    spec = sh.spec
    return len(spec) > 0 and spec[0] == "data"


def test_batched_classifies_by_path_not_shape():
    """The reference's regression (tests/test_serve.py): with n_pages == B
    the pool stays replicated and page_table, tails, pos and active are
    rows; a contiguous cache with cache_len == B has k/v in rows and pos
    replicated; the make_* placements match the reference's
    leaf for leaf; a per-sequence leaf that does not lead with B raises
    in both packages."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs.base import InputShape as RefShape
    from repro.configs.registry import get_config as jax_get_config
    from repro.dist import serve as ref_serve
    from repro.models import transformer as jax_tfm
    from repro.serve.paged_cache import init_paged_cache as jax_paged
    from repro_torch.configs.base import InputShape
    from repro_torch.dist import serve as dserve
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.paged_cache import init_paged_cache

    cfg = _config()
    jcfg = jax_get_config("granite-3-2b").reduced(d_model=64, vocab=128)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    mesh = RankMesh(shape=(1,), axis_names=("data",))
    n = 2
    paged = dserve._batched(mesh, init_paged_cache(
        cfg, n, 32, page=16, kv_bits=4, n_pages_full=n, device="meta"), n)
    ref = ref_serve._batched(jmesh, jax.eval_shape(lambda: jax_paged(
        jcfg, n, 32, page=16, kv_bits=4, n_pages_full=n)), n)
    for mine, theirs in zip(paged["layers"], ref["layers"]):
        for name, rows in mine.tensors().items():
            assert rows.split == _split(getattr(theirs, name)), name
        assert not any(getattr(mine, f).split for f in mine.pool_fields)
    assert paged["pos"].split and paged["active"].split
    assert _split(ref["pos"]) and _split(ref["active"])
    contig = dserve._batched(mesh, tfm.init_cache(cfg, n, n, device="meta"),
                             n)
    jcontig = ref_serve._batched(jmesh, jax.eval_shape(
        lambda: jax_tfm.init_cache(jcfg, n, n)), n)
    for mine, theirs in zip(contig["layers"], jcontig["layers"]):
        assert mine.k.split and mine.v.split
        assert all(_split(s) for s in jax.tree_util.tree_leaves(
            theirs, is_leaf=lambda x: isinstance(x, NamedSharding)))
    assert not contig["pos"].split and ref_serve._batched(
        jmesh, jax.eval_shape(lambda: jax_tfm.init_cache(jcfg, n, n)),
        n)["pos"].spec == ()
    with pytest.raises(ValueError, match="per-sequence"):
        dserve._batched(mesh, {"tail_k": torch.empty((5, 4),
                                                     device="meta")}, n)
    with pytest.raises(AssertionError, match="per-sequence"):
        ref_serve._batched(jmesh, {"tail_k": jax.ShapeDtypeStruct(
            (5, 4), jnp.float32)}, n)
    # make_decode and make_paged_decode: every placement of their trees
    for make in ("make_decode", "make_paged_decode"):
        _, sds, sh, _ = getattr(dserve, make)(
            cfg, mesh, None, InputShape("d", 32, n, "decode"))
        _, _, jsh, _ = getattr(ref_serve, make)(
            jcfg, jmesh, None, RefShape("d", 32, n, "decode"))
        assert sh["token"].split == _split(jsh["token"])
        assert all(not r.split for r in tfm_leaves(sh["params"]))
        mine = [r.split for r in tfm_leaves(sh["cache"])]
        theirs = [_split(s) for s in jax.tree_util.tree_leaves(
            jsh["cache"], is_leaf=lambda x: isinstance(x, NamedSharding))]
        assert sorted(mine) == sorted(theirs) and len(mine) == len(theirs)
        assert all(t.is_meta for t in tfm_leaves(sds["cache"]))


def tfm_leaves(tree):
    """The leaves of a serving tree (dist/serve._map's walk)."""
    from repro_torch.dist.serve import _map
    out = []
    _map(lambda path, leaf: out.append(leaf), tree)
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_paged_decode_across_ranks_matches_one_process(worlds, one_process,
                                                       world):
    """Every rank's prefill and decode logits are the one-process port's
    rows, bit for bit, at every step; after every step every rank's pool
    equals the one-process pool (the spare row aside); each step hands one
    all-gather per layer of the rank's lanes' page ids, codes and scales."""
    logits, pools = one_process
    cfg = _config()
    for res in worlds(world):
        lo, hi = res["first"], res["stop"]
        assert res["split"] and hi - lo == B // WORLDS[world][0]
        for i, (mine, want) in enumerate(zip(res["logits"], logits)):
            assert torch.equal(mine, want[lo:hi]), (world, res["coords"], i)
        for i, (mine, want) in enumerate(zip(res["pools"], pools)):
            assert all(torch.equal(a, b) for la, lb in zip(mine, want)
                       for a, b in zip(la, lb)), (world, res["coords"], i)
        # per lane and layer: its page id, 2 x (codes + f32 scales)
        elems = PAGE * cfg.kv_heads * cfg.head_dim
        per_lane = 8 + 2 * (elems + 4 * (elems // 512))
        assert res["gathered"][1:] == [[cfg.n_layers,
                                        cfg.n_layers * (hi - lo) * per_lane]
                                       ] * STEPS


def test_replicas_along_model_are_identical(worlds):
    """On the (2, 2) grid the two ranks of each data index (model 0 and 1)
    hold the same rows and compute the same logits and pools."""
    res = worlds("2x2")
    by_data = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], []).append(r)
    assert sorted(by_data) == [0, 1]
    for a, b in by_data.values():
        assert (a["first"], a["stop"]) == (b["first"], b["stop"])
        assert all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                     b["logits"]))
        assert all(torch.equal(x, y) for pa, pb in zip(a["pools"], b["pools"])
                   for la, lb in zip(pa, pb) for x, y in zip(la, lb))


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_page_flushed_on_one_rank_is_read_on_another(worlds, one_process,
                                                       world):
    """Lane 0 (data index 0) reads, through its first page-table entry, the
    page that lane B - 1 (data index 1) flushes at decode step FLUSH (each
    layer's update lands before its view, so lane 0 reads the new page in
    that same step).  With the gather its logits equal the one-process
    run's at every step; without it they equal them before the flush and
    part from them at it (the page on rank 0 is stale)."""
    logits, _ = one_process
    rank0 = worlds(world)[0]
    assert rank0["first"] == 0
    stale = rank0["logits_no_gather"]
    for i, (mine, want) in enumerate(zip(rank0["logits"], logits)):
        assert torch.equal(mine[0], want[0]), i
    # entry 0 is the prefill, entry i decode step i - 1
    assert all(torch.equal(stale[i][0], logits[i][0])
               for i in range(FLUSH + 1))
    assert not torch.equal(stale[FLUSH + 1][0], logits[FLUSH + 1][0])


@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_with_split_rows_routes_the_whole_batch(worlds, world):
    """Reduced granite-moe with the batch's rows split over "data": each
    rank's prefill logits, its rows of every layer's contiguous k and v,
    and its logits in both decode steps equal the one-process port's bit
    for bit.  The prompt makes the whole-batch routing differ from each
    rank's rows routed alone (an expert overflows at capacity factor 1.25):
    the one-process prefill of a rank's rows alone gives other logits."""
    from repro_torch.models import transformer as tfm

    cfg = _moe_config()
    params, tokens = _moe_inputs(cfg)
    logits, kv = moe_one_process(cfg, params, tokens)
    alone_differs = False
    for res in worlds(world):
        lo, hi = res["first"], res["stop"]
        mine, mine_kv = res["moe"]
        assert len(mine) == len(logits) == MOE_STEPS + 1
        for i, (a, b) in enumerate(zip(mine, logits)):
            assert torch.equal(a, b[lo:hi]), (world, res["coords"], i)
        for (k, v), (wk, wv) in zip(mine_kv, kv):
            assert torch.equal(k, wk[lo:hi]) and torch.equal(v, wv[lo:hi])
        with torch.no_grad():
            alone, _ = tfm.prefill(params, cfg, tokens[lo:hi],
                                   cache_len=CACHE_LEN)
        alone_differs |= not torch.equal(alone, logits[0][lo:hi])
    assert alone_differs


def test_one_process_matches_reference_decode():
    """The port's make_prefill and make_paged_decode fns in one process
    against the reference's on the same weights (the port's init as numpy)
    and prompt: prefill's last-token logits within 1e-5 of the largest
    |logit|; then, from both packages' f32 prefill caches in 4-bit pages,
    each decode step from the reference's paged cache (carried over):
    logits within 1e-5 (the serving tests' bound for an f32 cache); after
    the last step the pools' codes differing in fewer than 1e-5 of the
    elements, scales within 1e-5."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs.base import InputShape as RefShape
    from repro.configs.registry import get_config as jax_get_config
    from repro.dist import serve as ref_serve
    from repro.models import transformer as jax_tfm
    from repro.serve import paged_cache as jax_pc
    from repro_torch.configs.base import InputShape
    from repro_torch.core.convert import (paged_cache_from_numpy,
                                          params_from_numpy)
    from repro_torch.dist import serve as dserve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils.tree import tree_map

    cfg = _config()
    jcfg = jax_get_config("granite-3-2b").reduced(d_model=64, vocab=128)
    params, tokens = _inputs(cfg)
    jp = tree_map(lambda x: x.numpy(), params)
    tp = params_from_numpy(jp, device="cpu")
    jtok = jnp.asarray(tokens.numpy(), jnp.int32)
    mesh = make_mesh((1, 1))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    pre, _, _, _ = dserve.make_prefill(cfg, mesh, None,
                                       InputShape("p", S, B, "prefill"))
    dec, _, _, _ = dserve.make_paged_decode(
        cfg, mesh, None, InputShape("d", CACHE_LEN, B, "decode"), page=PAGE,
        kv_bits=KV_BITS)
    jpre, _, _, _ = ref_serve.make_prefill(jcfg, jmesh, None,
                                           RefShape("p", S, B, "prefill"))
    jdec, _, _, _ = ref_serve.make_paged_decode(
        jcfg, jmesh, None, RefShape("d", CACHE_LEN, B, "decode"), page=PAGE,
        kv_bits=KV_BITS)
    with torch.no_grad():
        lg, _ = pre(tp, tokens)
    assert _gap(lg, jax.jit(jpre)(jp, jtok)[0]) <= RTOL
    jlg, jcache = jax_tfm.prefill(jp, jcfg, jtok, cache_len=CACHE_LEN,
                                  cache_dtype=jnp.float32)
    jpaged = jax_pc.paged_from_contiguous(jcache, jcfg, page=PAGE,
                                          kv_bits=KV_BITS)
    step = jax.jit(jdec)
    tok = np.asarray(jlg)[:, -1].argmax(-1)[:, None]
    for i in range(STEPS):
        tc = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jpaged), "cpu")
        jlg, jpaged = step(jp, jnp.asarray(tok, jnp.int32), jpaged)
        with torch.no_grad():
            tlg, tc = dec(tp, torch.tensor(tok), tc)
        assert _gap(tlg, jlg) <= RTOL, i
        tok = np.asarray(jlg)[:, -1].argmax(-1)[:, None]
    diff = total = 0
    for a, b in zip(tc["layers"], jpaged["layers"]):
        for mine, theirs in ((a.kc, b.kc), (a.vc, b.vc)):
            diff += int((mine[:-1] != torch.tensor(np.asarray(theirs)))
                        .sum())
            total += theirs.size
        assert _gap(a.ksc[:-1], b.ksc) <= RTOL
        assert _gap(a.vsc[:-1], b.vsc) <= RTOL
    assert diff <= CODE_FRAC * total, (diff, total)


def _gap(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.detach().double().numpy()
    return float(np.max(np.abs(port - ref)) / max(np.max(np.abs(ref)), 1e-30))


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
