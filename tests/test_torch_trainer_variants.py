"""Parity of the port's trainer with the JAX reference trainer on the knobs
of the reference's perf_variants case and on its two diffusion-family
engines, on the CPU: NIDS with two microbatches, NIDS with bfloat16 state
and compute, and CEDAS and C-GT on the 2-bit p=inf wire (C-GT's two wires
each with the reference's ``fold_in`` draws).

The method is tests/test_torch_trainer.py's (its helpers are imported):
the reference's ``make_train_step`` runs in subprocesses on a (4, 1) mesh
of 4 placeholder devices and exports its states, batches, metrics and
draws.  Microbatches: 3 free steps within 1e-5 of the state's scale.
CEDAS and C-GT: each step from the reference's state before it, with the
reference's draws injected through ``trainer.leaf_draws``; fewer than 1e-5
of the elements deviate by more than 1e-4 of the scale.  Bits and
grad_norm as in the other files.

bfloat16: each step from the reference's state before it, every element of
every state field within one bfloat16 ulp at the state's scale (2^-8 of
its largest |x|), every leaf bfloat16, grad_norm within 1e-5.  The 1e-5
bound of the float32 runs is below one rounding of the format: XLA and
torch round the bfloat16 forward and backward differently in a few
elements (at the first step ~470 of 5.2e6 iterates and ~1e5 duals differ,
each by at most 2^-10 of the scale), and run free those differences
spread like any other.  The grad_norm bound is what tells bfloat16 compute
from float32 compute.
"""
import pytest
import torch

from test_torch_trainer import (DEVIATE_FRAC, EXACT_RTOL, _fields, _scale,
                                check_metrics, deviating_share, exact_gap,
                                inject_draws, run_port, run_reference)

CASES = {
    "nids_microbatches2": {"algorithm": "nids", "microbatches": 2},
    "nids_bf16": {"algorithm": "nids", "state_dtype": "bfloat16",
                  "compute_dtype": "bfloat16"},
    "cedas_2bit": {"algorithm": "cedas"},
    "cgt_2bit": {"algorithm": "cgt"},
}
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("trainer_variants_ref"),
                         CASES)


def test_microbatches_match_reference(reference):
    """Two microbatches (the gradient accumulated over two chunks of each
    agent's batch and averaged): 3 free steps within 1e-5 relative."""
    ref = reference["nids_microbatches2"]
    runs = run_port(ref, CASES["nids_microbatches2"])
    assert exact_gap(ref, runs) < EXACT_RTOL
    check_metrics(ref, runs)


def test_bfloat16_state_and_compute_match_reference(reference):
    """bfloat16 state and compute: every step from the reference's state
    within one bfloat16 ulp at the state's scale, the leaves bfloat16."""
    ref = reference["nids_bf16"]
    runs = run_port(ref, CASES["nids_bf16"], restart=True)
    for i, (state, _) in enumerate(runs):
        scale = _scale(ref, i)
        for f, leaves in _fields(state):
            for j, l in enumerate(leaves):
                assert l.dtype == torch.bfloat16, (f, j)
                want = torch.from_numpy(ref[f"s{i}/{f}/{j}"]).double()
                gap = (l.double() - want).abs().max().item()
                assert gap <= BF16_ULP * scale, (i, f, j, gap / scale)
    check_metrics(ref, runs)


@pytest.mark.parametrize("name", ["cedas_2bit", "cgt_2bit"])
def test_diffusion_engines_match_reference(reference, name, monkeypatch):
    """CEDAS (one wire) and C-GT (an iterate wire and a tracker wire, each
    leaf's wire j drawn from the reference's fold_in(leaf_key, j)), with the
    reference's draws injected, each step from the reference's state: fewer
    than 1e-5 of the elements deviate; C-GT's bits are twice CEDAS's."""
    ref = reference[name]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES[name], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
    assert float(reference["cgt_2bit"]["s0/metric/bits_per_agent"]) \
        == 2 * float(reference["cedas_2bit"]["s0/metric/bits_per_agent"])


def test_multiwire_dither_comes_from_leaf_draws(reference, monkeypatch):
    """Without the swap, C-GT draws each leaf's two wires through
    trainer.leaf_draws, wire j as fast_uniform of (A, d_leaf) seeded
    wire_seed(sub_seed(sub_seed(seed, step), leaf), j): the function the
    parity test above replaces, called once per (step, leaf, wire)."""
    from repro_torch.core.compression import fast_uniform, sub_seed, wire_seed
    from repro_torch.dist import trainer
    from repro_torch.utils.tree import tree_leaves

    calls = []
    real = trainer.leaf_draws

    def spy(comp, seed, step, leaf, wire, n, dim, device):
        out = real(comp, seed, step, leaf, wire, n, dim, device)
        calls.append((step, leaf, wire))
        want = fast_uniform(
            (n, dim), wire_seed(sub_seed(sub_seed(seed, step), leaf), wire),
            device)
        assert torch.equal(out["u"], want)
        return out

    monkeypatch.setattr(trainer, "leaf_draws", spy)
    runs = run_port(reference["cgt_2bit"], CASES["cgt_2bit"], steps=2)
    n_leaves = len(tree_leaves(runs[0][0].params))
    assert calls == [(i, j, w) for i in range(2) for j in range(n_leaves)
                     for w in (0, 1)]
