"""The port's serving engine (serve/engine.py), its demo model
(serve/demo.py) and its driver (launch/serve.py) on the CPU, against the
JAX reference where the two must agree exactly.

* the continuous-batching episode of tests/test_serve.py:88: both
  packages' engines on the same weights give the same streams, stats and
  cache report, and every port stream equals the port's contiguous
  single-sequence path; the step functions' signatures hold at 1 and 1;
* EOS evicts early; the signatures hold at 1 and 1 with 4-bit pages and
  with gemma's rolling layers too;
* the counting LM: the reference's prompts, and a few Adam steps of the
  port's fit lower the loss (the reference's own fit misses its bar under
  this jax and costs ~20 s, so no fit runs to the end here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import demo as jax_demo
from repro_torch.configs.registry import get_config
from repro_torch.core.convert import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tfm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import demo
from repro_torch.utils.tree import tree_map

CPU = "cpu"
JOBS = [([3] * 5, 4), (list(range(16)), 18), (list(range(7, 40)), 12)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(arch="granite-3-2b", **kw):
    cfg = get_config(arch).reduced(**kw)
    return cfg, tfm.init_params(cfg, torch.Generator().manual_seed(0), CPU)


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, ServeConfig(**kw), device=CPU)


def test_continuous_batching_episode_matches_reference():
    """2 slots, 3 requests (page-aligned, unaligned and multi-page prompts,
    staggered max_new): the third waits and is admitted into the slot the
    first eviction frees.  The port's engine and the reference's, on the
    same weights, give the same streams, stats and cache report; each port
    stream equals the port's contiguous single-sequence path; the step
    functions see one signature each from the first tick on."""
    cfg, params = _model()
    eng = _engine(cfg, params, max_batch=2, max_len=64, page=16)
    rids = [eng.submit(p, max_new=m) for p, m in JOBS]
    with torch.no_grad():
        eng.step()
        warm = eng.compile_stats()
        assert warm == {"decode_compiles": 1, "prefill_compiles": 1}
        res = eng.run()
    assert eng.compile_stats() == warm
    st = eng.stats()
    assert st["admitted"] == st["evicted"] == 3 and st["queued_peak"] >= 2
    for rid, (prompt, max_new) in zip(rids, JOBS):
        want = serve_cli.greedy_contiguous(params, cfg,
                                           torch.tensor([prompt]), max_new,
                                           cache_len=64)[0]
        assert res[rid]["tokens"] == want, rid

    jcfg = jax_get_config("granite-3-2b").reduced()
    jeng = JaxServeEngine(jcfg, tree_map(lambda x: x.numpy(), params),
                          JaxServeConfig(max_batch=2, max_len=64, page=16))
    jrids = [jeng.submit(p, max_new=m) for p, m in JOBS]
    jres = jeng.run()
    assert [res[r] for r in rids] == [jres[r] for r in jrids]
    jst = jeng.stats()
    for k in ("admitted", "evicted", "queued_peak", "decode_steps",
              "tokens_out", "decode_compiles", "prefill_compiles"):
        assert st[k] == jst[k], k
    assert eng.cache_report() == jeng.cache_report()


def test_eos_evicts_early():
    cfg, params = _model()
    with torch.no_grad():
        probe = _engine(cfg, params, max_batch=1, max_len=64, page=16)
        probe.submit([3] * 5, max_new=8)
        toks = probe.run()[0]["tokens"]
        eos = toks[2]
        eng = _engine(cfg, params, max_batch=1, max_len=64, page=16,
                      eos_id=eos)
        rid = eng.submit([3] * 5, max_new=8)
        out = eng.run()[rid]["tokens"]
    assert out == toks[:toks.index(eos) + 1]     # stopped at, and kept, EOS
    assert eng.stats()["evicted"] == 1


@pytest.mark.parametrize("arch,kv_bits", [("granite-3-2b", 4),
                                          ("gemma3-12b", None),
                                          ("gemma3-12b", 4)])
def test_signatures_hold_across_admissions(arch, kv_bits):
    """Five requests through two slots (admissions, evictions, page growth,
    gemma's rings, which wrap in the last request): one decode and one
    prefill signature throughout; the 4-bit report is the reference's
    (5.0625 bits/elem, pool 16 / 5.0625)."""
    cfg, params = _model(arch, d_model=64, vocab=128)
    eng = _engine(cfg, params, max_batch=2, max_len=160, page=16,
                  kv_bits=kv_bits)
    for i in range(5):
        eng.submit(list(range(i, i + 9 + 28 * i)), max_new=6 + 5 * i)
    with torch.no_grad():
        res = eng.run()
    assert len(res) == 5
    assert eng.compile_stats() == {"decode_compiles": 1,
                                   "prefill_compiles": 1}
    if kv_bits:
        rep = eng.cache_report()
        assert rep["bits_per_elem"] == 5.0625
        assert rep["hbm_reduction_pool"] == pytest.approx(16 / 5.0625)
        jcfg = jax_get_config(arch).reduced(d_model=64, vocab=128)
        jeng = JaxServeEngine(jcfg, jax.eval_shape(
            lambda: jax.tree_util.tree_map(jnp.asarray,
                                           tree_map(lambda x: x.numpy(),
                                                    params))),
            JaxServeConfig(max_batch=2, max_len=160, page=16,
                           kv_bits=kv_bits))
        assert rep == jeng.cache_report()


def test_counting_lm():
    """The reference's prompts; the batch counts; five Adam steps of the
    port's fit on a tiny config lower the loss."""
    cfg = get_config("granite-3-2b").reduced(d_model=64, vocab=64)
    jcfg = jax_get_config("granite-3-2b").reduced(d_model=64, vocab=64)
    assert demo.counting_prompt(cfg, 60, 9) \
        == jax_demo.counting_prompt(jcfg, 60, 9)
    batch = demo.counting_batch(cfg, torch.Generator().manual_seed(0), 4, 16)
    assert torch.equal(batch["labels"], (batch["tokens"] + 1) % cfg.vocab)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    probe = demo.counting_batch(cfg, torch.Generator().manual_seed(2), 8, 48)
    with torch.no_grad():
        before = float(tfm.loss_fn(params, cfg, probe)[0])
    fitted, _ = demo.fit_counting_lm(cfg, torch.Generator().manual_seed(1),
                                     steps=5, device=CPU)
    with torch.no_grad():
        after = float(tfm.loss_fn(fitted, cfg, probe)[0])
    assert after < before


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-1.3b"])
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    """launch/serve.py: the paged engine for an attention stack, the
    contiguous path for a recurrent family."""
    serve_cli.main(["--arch", arch, "--device", CPU, "--batch", "2",
                    "--prompt-len", "12", "--gen", "4", "--kv-bits", "4"])
    out = capsys.readouterr().out
    if arch == "granite-3-2b":
        assert "served 4 sequences" in out and "5.0625 bits/elem" in out
    else:
        assert "contiguous cache path" in out
    assert "sample token ids" in out
