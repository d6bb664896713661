"""The port's expert-parallel MoE dispatch (src/repro_torch/models/moe_ep.py)
against the JAX reference's (src/repro/models/moe_ep.py), on the CPU.

d_model 64, d_ff 128, 8 experts, top-2, x (4, 16, 64); weights and input
numpy from a seed, handed to both packages.  Capacity factor 8.0, where
nothing drops, and 0.5, where pairs are dropped at both capacities (C_s
per destination rank, C_e per local expert); ``seq_chunk`` 0 and 8.

* The reference runs in one subprocess with 4 placeholder devices, as
  tests/test_moe_ep.py runs it, on (data, model) meshes (1, 1), (2, 1) and
  (2, 2), jitted, the batch on "data".
* The port runs in one process (no groups: the (1, 1) mesh) and in gloo
  worlds of 2 ranks, mesh (2, 1), and 4 ranks, mesh (2, 2) (this file run
  as a script per rank, a FileStore under tmp_path, one torch thread):
  ep = the data group, tp = the model group, each rank its rows of x.

Outputs are held within 1e-5 of the reference's, and at 8.0 of the dense
``moe_apply``'s.  The kept (token, expert) pairs are read the same way in
both packages, from the layer itself: with every expert's w_down zeroed
but expert e's, a token's output is nonzero exactly where its pair with e
was kept.  The ranks' collectives are counted: per chunk, three
all_to_all_single calls over ep for hop 1 and one for hop 2 (fixed
buffers), two over tp for the Ulysses transposes and one all-reduce of
the router logits; per call one all-gather of the output columns over
tp.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe_ep.py
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300
D, DFF, E, K, B, S = 64, 128, 8, 2, 4, 16
CFS = (8.0, 0.5)
DROPS = 0.5
CHUNKS = (0, 8)
MESHES = {"1x1": (1, 1), "2x1": (2, 1), "2x2": (2, 2)}
WORLDS = ("2x1", "2x2")
ATOL = 1e-5


def _inputs():
    """The weights (moe_init's scales) and x, numpy from seed 0."""
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "w_gate": rng.standard_normal((E, D, DFF)) * D ** -0.5,
         "w_up": rng.standard_normal((E, D, DFF)) * D ** -0.5,
         "w_down": rng.standard_normal((E, DFF, D)) * DFF ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


def _probe(p, e):
    """The weights with every expert's w_down zeroed but expert e's."""
    wd = np.zeros_like(p["w_down"])
    wd[e] = p["w_down"][e]
    return {**p, "w_down": wd}


def _kept(outs):
    """(B * S, E) bool from the probe outputs [(B, S, d)] * E."""
    return np.stack([np.abs(np.asarray(o)).reshape(B * S, D).max(-1) > 0
                     for o in outs], -1)


# -- the reference ----------------------------------------------------------

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import AxisType, make_mesh, set_mesh
from repro.models import moe_ep
sys.path.insert(0, os.environ["MOE_EP_TEST_DIR"])
import test_torch_moe_ep as t

p, x = t._inputs()
res = {}
for name, shape in t.MESHES.items():
    mesh = make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with set_mesh(mesh):
        px = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        put = lambda q: {k: jax.device_put(v, NamedSharding(mesh, P()))
                         for k, v in q.items()}
        for cf in t.CFS:
            for chunk in t.CHUNKS:
                fn = jax.jit(lambda pp, xx, cf=cf, chunk=chunk:
                             moe_ep.moe_apply_ep(pp, xx, top_k=t.K,
                                                 capacity_factor=cf,
                                                 ep_axis="data",
                                                 seq_chunk=chunk)[0])
                key = f"{name}_{cf}_{chunk}"
                res["out_" + key] = np.asarray(fn(put(p), px))
                if cf == t.DROPS:
                    res["kept_" + key] = t._kept(
                        [fn(put(t._probe(p, e)), px) for e in range(t.E)])
np.savez(sys.argv[1], **res)
print("PASS reference")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["MOE_EP_TEST_DIR"] = HERE
    return env


# -- the rank side ----------------------------------------------------------

def rank_main(out_dir, world, rank):
    """One rank of a `world` ("2x1" or "2x2"): its rows of x through
    moe_apply_ep at every capacity factor and chunk, and the probes at
    DROPS; saves them with the collectives' counts."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import serve_batch_spec
    from repro_torch.launch.mesh import CollectiveSpy, make_mesh
    from repro_torch.models.moe_ep import moe_apply_ep

    torch.set_num_threads(1)
    shape = MESHES[world]
    n = shape[0] * shape[1]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, f"{world}.store"),
                                     n), rank=rank, world_size=n)
    res = {}
    try:
        mesh = make_mesh(shape)
        ep = mesh.subgroup(mesh.partition(("data",)))
        tp = mesh.subgroup(mesh.partition(("model",)))
        rows = serve_batch_spec(mesh, 3, B)
        p, x = _inputs()
        x = rows.take(torch.tensor(x))

        def run(q, cf, chunk):
            tq = {k: torch.tensor(v) for k, v in q.items()}
            return moe_apply_ep(tq, x, top_k=K, capacity_factor=cf,
                                ep_group=ep, tp_group=tp,
                                seq_chunk=chunk)[0]

        with torch.no_grad():
            for cf in CFS:
                for chunk in CHUNKS:
                    key = f"{cf}_{chunk}"
                    with CollectiveSpy() as spy:
                        res["out_" + key] = run(p, cf, chunk)
                    res["calls_" + key] = spy.seen
                    if cf == DROPS:
                        res["probes_" + key] = [run(_probe(p, e), cf, chunk)
                                                for e in range(E)]
    finally:
        dist.destroy_process_group()
    res.update(rows=(rows.start, rows.stop), coords=mesh.coords())
    torch.save(res, os.path.join(out_dir, f"{world}.{rank}.pt"))


# -- the test side ----------------------------------------------------------

def _wait(procs, what):
    deadline = time.time() + TIMEOUT
    errs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(deadline - time.time(), 1))
            if p.returncode:
                errs.append(o[-2000:] + e[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errs, f"{what}: " + "\n".join(errs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and both rank worlds, started together
    when the module starts; a test that reads one waits for it."""
    out = tmp_path_factory.mktemp("moe_ep")
    script = out / "reference.py"
    script.write_text(REFERENCE)
    procs = {"reference": [subprocess.Popen(
        [sys.executable, str(script), str(out / "reference.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]}
    for w in WORLDS:
        procs[w] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out), w, str(r)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(int(np.prod(MESHES[w])))]
    done = {}

    def wait(what):
        if what not in done:
            ps = procs.pop(what)
            _wait(ps, what)
            if what == "reference":
                done[what] = dict(np.load(out / "reference.npz"))
            else:
                done[what] = [torch.load(out / f"{what}.{r}.pt")
                              for r in range(len(ps))]
        return done[what]

    yield wait
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(runs):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(q, x, cf, chunk):
    from repro_torch.models.moe_ep import moe_apply_ep

    tq = {k: torch.tensor(v) for k, v in q.items()}
    with torch.no_grad():
        return moe_apply_ep(tq, torch.tensor(x), top_k=K, capacity_factor=cf,
                            seq_chunk=chunk)[0].numpy()


def _dense(cf, chunk):
    from repro_torch.models.moe import moe_apply

    p, x = _inputs()
    with torch.no_grad():
        return moe_apply({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x), top_k=K, capacity_factor=cf,
                         seq_chunk=chunk)[0].numpy()


def _whole(res, key):
    """The ranks' rows of `key` put back into the whole batch; the ranks
    that hold the same rows (replicas along model) must agree bit for
    bit."""
    whole = np.full((B, S, D), np.nan, np.float32)
    seen = {}
    for r in res:
        lo, hi = r["rows"]
        got = r[key]
        if lo in seen:
            assert torch.equal(seen[lo], got), (key, r["coords"])
            continue
        seen[lo] = got
        whole[lo:hi] = got.numpy()
    assert not np.isnan(whole).any()
    return whole


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("cf", CFS)
def test_one_process_matches_reference(runs, cf, chunk):
    """No groups: the reference on a (1, 1) mesh, within 1e-5; where
    nothing drops, the dense moe_apply too."""
    ref = runs("reference")
    p, x = _inputs()
    got = _port(p, x, cf, chunk)
    assert _gap(got, ref[f"out_1x1_{cf}_{chunk}"]) < ATOL
    if cf == 8.0:
        assert _gap(got, _dense(cf, chunk)) < ATOL


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_reference(runs, world, cf, chunk):
    """Each rank's rows, put together, within 1e-5 of the reference on the
    same mesh; replicas along model bit for bit; where nothing drops, the
    dense moe_apply's within 1e-5."""
    ref = runs("reference")
    got = _whole(runs(world), f"out_{cf}_{chunk}")
    assert _gap(got, ref[f"out_{world}_{cf}_{chunk}"]) < ATOL
    if cf == 8.0:
        assert _gap(got, _dense(cf, chunk)) < ATOL


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_kept_pairs_match_reference(runs, mesh, chunk):
    """At capacity factor 0.5 the port keeps exactly the reference's
    (token, expert) pairs on each mesh, and some pairs are dropped; the
    probes' outputs sum to the reference's output within 1e-5."""
    ref = runs("reference")
    want = ref[f"kept_{mesh}_{DROPS}_{chunk}"]
    p, x = _inputs()
    if mesh == "1x1":
        probes = [_port(_probe(p, e), x, DROPS, chunk) for e in range(E)]
    else:
        res = runs(mesh)
        probes = [_whole([{**r, "probe": r[f"probes_{DROPS}_{chunk}"][e]}
                          for r in res], "probe") for e in range(E)]
    got = _kept(probes)
    routed = B * S * K
    assert got.sum() == want.sum() and (got == want).all(), \
        (int(got.sum()), int(want.sum()))
    assert 0 < want.sum() < routed
    full = ref[f"out_{mesh}_{DROPS}_{chunk}"]
    assert _gap(sum(probes), full) < ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_move_tokens_by_all_to_all(runs, world):
    """Per chunk: hop 1 is three all_to_all_single calls over ep (tokens,
    expert ids, valid flags), hop 2 one, each of the fixed (ep, C_s, ...)
    buffers; two more over tp for the Ulysses transposes of the (E_loc,
    C_e, ...) buffer and one all-reduce of the (T, E) router logits; per
    call one all-gather of the output's d / tp columns.  A one-rank tp
    group (mesh (2, 1)) makes the same calls.  The tokens are never
    all-gathered whole."""
    nsh, ntp = MESHES[world]
    E_loc, d_loc = E // nsh, D // ntp
    for r in runs(world):
        for cf in CFS:
            for chunk in CHUNKS:
                n_chunks = S // chunk if chunk else 1
                T = (B // nsh) * (S // n_chunks)
                C_s = max(ntp, int(cf * T * K / nsh) // ntp * ntp)
                C_e = max(ntp, int(cf * nsh * C_s / E_loc) // ntp * ntp)
                hop = nsh * C_s
                want = {"all_to_all_single": [
                    3 + 1 + 2, hop * (4 * d_loc + 8 + 4 + 4 * d_loc)
                    + 2 * E_loc * C_e * d_loc * 4],
                    "all_reduce": [1, T * E * 4],
                    "all_gather": [1, B // nsh * S * d_loc * 4]}
                seen = r[f"calls_{cf}_{chunk}"]
                want = {k: [v[0] * n_chunks, v[1] * n_chunks]
                        if k != "all_gather" else v for k, v in want.items()}
                assert seen == want, (world, cf, chunk, r["coords"])


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
