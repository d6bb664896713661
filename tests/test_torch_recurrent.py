"""The port's recurrent mixers (src/repro_torch/models/recurrent.py) against
the JAX reference's (src/repro/models/recurrent.py), on the CPU.

Weights from the reference's init (mLSTM's ``out_ln``, sLSTM's ``ffn_ln``
and RG-LRU's ``lam`` perturbed, so those paths carry non-trivial values),
inputs numpy from a seed.  Each forward within 1e-5 relative (max |port -
ref| over max |ref|), the gradients of a fixed random projection of the
output with respect to every weight and the input within 1e-4.  The
mLSTM runs several chunks (S = 64, chunk 16: the inter-chunk carry and the
stabiliser across four chunks) and a chunk that shrinks until it divides S
(S = 60, chunk 16 -> 15); the RG-LRU's scan is a log-depth Hillis-Steele
scan in the port and XLA's associative scan in the reference: they sum in
other orders, within the same bounds.

    PYTHONPATH=src python -m pytest -q tests/test_torch_recurrent.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jax_rec
from repro_torch.models import recurrent

RTOL = 1e-5
GRAD_RTOL = 1e-4
D, NH, B = 64, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(np.abs(want).max(), 1e-30)


def _params(init, perturb, seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))
    for k in perturb:
        p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)) \
            .astype(np.float32)
    return p


MIXERS = {
    # name: (reference init, its forward, the port's forward, S, perturbed)
    "mlstm_chunks": (lambda k: jax_rec.mlstm_init(k, D, NH),
                     lambda p, x: jax_rec.mlstm_forward(p, x, NH, chunk=16),
                     lambda p, x: recurrent.mlstm_forward(p, x, NH, chunk=16),
                     64, ("out_ln",)),
    "mlstm_shrunk_chunk": (lambda k: jax_rec.mlstm_init(k, D, NH),
                           lambda p, x: jax_rec.mlstm_forward(p, x, NH,
                                                              chunk=16),
                           lambda p, x: recurrent.mlstm_forward(p, x, NH,
                                                                chunk=16),
                           60, ("out_ln",)),
    "slstm": (lambda k: jax_rec.slstm_init(k, D, NH),
              lambda p, x: jax_rec.slstm_forward(p, x, NH),
              lambda p, x: recurrent.slstm_forward(p, x, NH),
              32, ("ffn_ln", "b")),
    "rglru": (lambda k: jax_rec.rglru_init(k, D),
              jax_rec.rglru_forward, recurrent.rglru_forward,
              64, ("lam",)),
}


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_forward_and_grads_match_reference(name):
    init, jfwd, tfwd, S, perturb = MIXERS[name]
    p = _params(init, perturb)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    proj = rng.standard_normal((B, S, D)).astype(np.float32)

    def jloss(pp, xx):
        out = jfwd(pp, xx)
        return jnp.sum(out * proj), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))

    names = sorted(p)
    tp = {k: torch.tensor(p[k], requires_grad=True) for k in names}
    tx = torch.tensor(x, requires_grad=True)
    out = tfwd(tp, tx)
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(proj)),
                                [tp[k] for k in names] + [tx])
    assert out.shape == jout.shape and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), jout) < RTOL
    for k, g in zip(names, grads):
        assert g.shape == jg[0][k].shape, k
        assert _rel(g.numpy(), jg[0][k]) < GRAD_RTOL, k
    assert _rel(grads[-1].numpy(), jg[1]) < GRAD_RTOL


def test_mlstm_chunk_shrinks_until_it_divides():
    """S = 60, chunk 16: G shrinks to 15 (four chunks), as the reference's
    ``while S % G: G -= 1``; the chunked result equals one chunk's."""
    p = _params(lambda k: jax_rec.mlstm_init(k, D, NH), ("out_ln",))
    x = torch.tensor(np.random.default_rng(2).standard_normal((B, 60, D))
                     .astype(np.float32))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    with torch.no_grad():
        whole = recurrent.mlstm_forward(tp, x, NH, chunk=60)
        chunked = recurrent.mlstm_forward(tp, x, NH, chunk=16)
    assert _rel(chunked.numpy(), whole.numpy()) < RTOL


def test_linear_scan_equals_the_sequential_recurrence():
    """The Hillis-Steele scan is h_t = a_t h_{t-1} + b_t from h = 0, at
    lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(0)
    for S in (1, 2, 7, 64, 100):
        a = torch.rand((B, S, 8), generator=g, dtype=torch.float64)
        b = torch.randn((B, S, 8), generator=g, dtype=torch.float64)
        h = torch.zeros((B, 8), dtype=torch.float64)
        want = []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = recurrent.linear_scan(a, b)
        assert torch.allclose(got, torch.stack(want, 1), rtol=1e-12,
                              atol=1e-12), S


def test_init_shapes_match_reference():
    """The same keys and leaf shapes as the reference's init, the same
    fixed leaves (b_if, sLSTM's b, the norms), and lam within the range
    that keeps a in [0.9, 0.999]."""
    gen = torch.Generator().manual_seed(0)
    pairs = [(jax_rec.mlstm_init(jax.random.PRNGKey(0), D, NH),
              recurrent.mlstm_init(gen, D, NH, torch.device("cpu"))),
             (jax_rec.slstm_init(jax.random.PRNGKey(0), D, NH),
              recurrent.slstm_init(gen, D, NH, torch.device("cpu"))),
             (jax_rec.rglru_init(jax.random.PRNGKey(0), D),
              recurrent.rglru_init(gen, D, torch.device("cpu")))]
    for jp, tp in pairs:
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            if k in ("b_if", "b", "out_ln", "ffn_ln"):
                assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    lam = pairs[2][1]["lam"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))   # r = 1
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_mlstm_chunk_stabiliser_breaks_down_in_both_packages():
    """A reference caveat the port keeps: within one chunk the stabiliser
    is the chunk-wide max of i_s - cum_s, so under strongly negative
    forget pre-activations (w_if 100x its init) the early rows' weights
    underflow, |l| and exp(-m) are both 0, and h = 0 / 0: the reference's
    mlstm_forward and the port's both return NaN for most outputs of a
    128-long chunk (at 1x, neither).  This is why xLSTM at SGD eta 0.03
    turns NaN in chip_smoke.py's recurrent_at_scale (ROADMAP.md, queue
    3)."""
    p = jax.tree_util.tree_map(np.asarray,
                               jax_rec.mlstm_init(jax.random.PRNGKey(0), D,
                                                  NH))
    x = np.random.default_rng(1).standard_normal((B, 128, D)) \
        .astype(np.float32)
    for mult, broken in ((1.0, False), (100.0, True)):
        q = dict(p, w_if=(p["w_if"] * mult).astype(np.float32))
        want = np.asarray(jax_rec.mlstm_forward(q, x, NH))
        got = recurrent.mlstm_forward(
            {k: torch.tensor(v) for k, v in q.items()}, torch.tensor(x),
            NH).numpy()
        for out in (want, got):
            share = float(np.isnan(out).mean())
            assert (share > 0.5) if broken else (share == 0.0), (mult, share)
