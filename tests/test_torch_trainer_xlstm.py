"""Parity of the port's trainer with the JAX reference trainer on the xLSTM
tree, on the CPU: xlstm-1.3b at 6 layers (five mLSTM blocks and an sLSTM
block, 60 leaves, several below one 512-block such as ``b_if`` (8,)), 4
agents, by tests/test_torch_trainer.py's method (its helpers are
imported).

Every step starts from the reference's state before it; 2-bit LEAD also
takes the reference's draws.  A free run is not a fair check here: at eta
0.03 (grad_norm ~210) the xLSTM's training step amplifies a rounding
difference 15-90x a step - the port against itself, with only the
summation order changed (1 against 4 torch threads), parts by 4e-8, 6e-7
and 5.5e-5 of the state's scale over 3 allreduce steps (the MoE and audio
trees: below 1.2e-7, so tests/test_torch_trainer_families.py runs them
free).

Bounds: the iterates (x, and LEAD's h and hw) within 1e-5 of the state's
scale; LEAD's dual d within 1e-4 of the larger of the state's scale and
its own.  The dual is (gamma / 2 eta) (I - W) of a message that moves with
the gradient, and the xLSTM gradient itself agrees with the reference's to
~3e-5 of each leaf's scale (tests/test_torch_families.py's bound is 1e-4;
in one mLSTM, port and reference are each within ~2e-6 of a float64 run of
the same function, so the rest is the stacked model's conditioning).
2-bit LEAD: fewer than 1e-5 of the elements deviate by more than 1e-4 of
the scale, the dual sum below 1e-3.  Bits exactly (the sub-block leaves
one block each) and grad_norm within 1e-5 throughout.

    PYTHONPATH=src python -m pytest -q tests/test_torch_trainer_xlstm.py
"""
import numpy as np
import pytest
import torch

from test_torch_trainer import (DEVIATE_FRAC, DUAL_SUM, EXACT_RTOL, _fields,
                                _scale, check_metrics, deviating_share,
                                dual_sum, inject_draws, run_port,
                                run_reference)

DUAL_RTOL = 1e-4
MODEL = {"arch": "xlstm-1.3b", "reduced": {"n_layers": 6}}
CASES = {"allreduce": {**MODEL, "algorithm": "allreduce"},
         "lead_uncompressed": {**MODEL, "algorithm": "lead",
                               "compressor": "identity"},
         "lead_2bit": {**MODEL, "algorithm": "lead"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("trainer_xlstm_ref"),
                         CASES, per_process=1)


def field_gaps(ref, runs):
    """{field: max over steps and leaves of |port - ref| over the field's
    scale}: the state's scale (its largest |x|) for the iterates, the
    larger of it and the field's own largest |value| for the dual d."""
    worst = {}
    for i, (state, _) in enumerate(runs):
        scale = _scale(ref, i)
        for f, leaves in _fields(state):
            want = [ref[f"s{i}/{f}/{j}"].astype(np.float64)
                    for j in range(len(leaves))]
            s = scale if f != "d" else max(scale, max(np.abs(w).max()
                                                      for w in want))
            gap = max(np.abs(l.detach().double().numpy() - w).max()
                      for l, w in zip(leaves, want)) / s
            worst[f] = max(worst.get(f, 0.0), gap)
    return worst


@pytest.mark.parametrize("run", ["allreduce", "lead_uncompressed"])
def test_exact_runs_match_reference(reference, run):
    """Allreduce and LEAD on an uncompressed 32-bit wire, each of 3 steps
    from the reference's state: the iterates within 1e-5, the dual within
    1e-4, bits and grad_norm the reference's."""
    ref = reference[run]
    runs = run_port(ref, CASES[run], restart=True)
    gaps = field_gaps(ref, runs)
    assert all(g < (DUAL_RTOL if f == "d" else EXACT_RTOL)
               for f, g in gaps.items()), gaps
    check_metrics(ref, runs)


def test_lead_2bit_matches_reference(reference, monkeypatch):
    """2-bit LEAD (K4, K2, K3 per leaf on the card) with the reference's
    draws: fewer than 1e-5 of the elements deviate, the bits are the
    reference's exactly (five leaves below one block), the dual sum stays
    below 1e-3."""
    ref = reference["lead_2bit"]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES["lead_2bit"], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
    assert dual_sum(runs[-1][0]) < DUAL_SUM
