"""Parity of the port's trainer with the JAX reference trainer on the
registry algorithms tests/test_torch_trainer.py does not run, on the CPU:
the exact DGD, EXTRA and D2, and DeepSqueeze, QDGD and DCD-SGD on the
2-bit p=inf wire, each at the trainer's defaults (eta 0.03, the engine's
other hypers) on ring(4).

The method and bounds are tests/test_torch_trainer.py's (its helpers are
imported): the exact algorithms within 1e-5 of the state's scale over 3
free steps; the compressed ones each step from the reference's state
before it, with the reference's draws injected through
``trainer.leaf_draws``, fewer than 1e-5 of the elements deviating by more
than 1e-4 of the scale; bits exactly, grad_norm within 1e-5.
"""
import pytest
import torch

from test_torch_trainer import (DEVIATE_FRAC, EXACT_RTOL, check_metrics,
                                deviating_share, exact_gap, inject_draws,
                                run_port, run_reference)

EXACT = ("dgd", "extra", "d2")
COMPRESSED = ("deepsqueeze", "qdgd", "dcd")
CASES = {name: {"algorithm": name} for name in EXACT + COMPRESSED}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("trainer_algorithms_ref"),
                         CASES)


@pytest.mark.parametrize("name", EXACT)
def test_exact_registry_algorithms_match_reference(reference, name):
    ref = reference[name]
    runs = run_port(ref, CASES[name])
    assert exact_gap(ref, runs) < EXACT_RTOL
    check_metrics(ref, runs)


@pytest.mark.parametrize("name", COMPRESSED)
def test_compressed_registry_algorithms_match_reference(reference, name,
                                                        monkeypatch):
    ref = reference[name]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES[name], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
