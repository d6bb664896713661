"""Parity of the port's trainer with the JAX reference trainer on the graph
forms and wire options, on the CPU: LEAD on the one-peer exponential bank,
on ``ring(4).with_interval(2)``, under 10% link drops, on
``hierarchical(ring(2), 2)`` and with ``wire_pack=True``, and CHOCO on a
RandK(0.5) wire.

The method is tests/test_torch_trainer.py's (its helpers are imported): one
module-scoped subprocess runs the reference's ``make_train_step`` on 4
placeholder devices - a (4, 1) mesh, and for the hier graph a (2, 2, 1)
mesh whose trailing data axis is the node - and exports its states,
batches, metrics and draws; the port takes every step from the
reference's state before it, with the reference's draws injected through
``trainer.leaf_draws``.  Fewer than 1e-5 of the state's elements deviate
by more than 1e-4 of its scale; the bits and dropped links equal the
reference's exactly (the hier run's are the node payload's over 2, the
interval's are 0.0 on its skipped step 1); LEAD's dual sum stays below
1e-3.
"""
import numpy as np
import pytest
import torch

from test_torch_trainer import (A, DEVIATE_FRAC, DUAL_SUM, check_metrics,
                                deviating_share, dual_sum, inject_draws,
                                run_port, run_reference)

CASES = {
    "lead_onepeer": {"algorithm": "lead", "topology": "onepeer"},
    "lead_interval2": {"algorithm": "lead", "topology": "interval2"},
    "lead_drops": {"algorithm": "lead", "faults": 0.1},
    "lead_hier": {"algorithm": "lead", "topology": "hier",
                  "mesh": [2, 2, 1]},
    "lead_wire_pack": {"algorithm": "lead", "wire_pack": True},
    "choco_randk": {"algorithm": "choco", "compressor": "randk",
                    "hyper": {"eta": 0.03, "gamma": 0.3}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("trainer_graphs_ref"), CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_forms_match_reference(reference, name, monkeypatch):
    ref = reference[name]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES[name], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
    if CASES[name]["algorithm"] == "lead":
        assert dual_sum(runs[-1][0]) < DUAL_SUM


def test_interval_skips_and_hier_halves_the_bits(reference):
    """The interval's step 1 ships nothing; the hier run ships the node
    payload over node_size = 2: half the ring's bits (the same leaves on
    the same 2-bit wire)."""
    bits = {n: [float(reference[n][f"s{i}/metric/bits_per_agent"])
                for i in range(3)] for n in ("lead_interval2", "lead_hier",
                                             "lead_onepeer")}
    assert bits["lead_interval2"][1] == 0.0
    assert bits["lead_interval2"][0] == bits["lead_onepeer"][0]
    assert bits["lead_hier"][0] * 2 == bits["lead_onepeer"][0]
    drops = [float(reference["lead_drops"][f"s{i}/metric/dropped_links"])
             for i in range(3)]
    assert all(np.isfinite(drops)) and A * 2 * 3 >= sum(drops)
