"""Parity of the port's trainer with the JAX reference trainer on the model
families beyond the dense ones, on the CPU: the MoE tree
(granite-moe-1b-a400m reduced: 4 experts top-2, stacked (L, E, d, f)
expert leaves) and the audio tree (whisper-tiny reduced: the encoder, its
frame memory, and the decoder cross-attention's stacked 0-d gates, (A, 2)
through the trainer); tests/test_torch_trainer_xlstm.py holds the xLSTM
tree the same way (a file of its own: its reference runs take a minute).

The method is tests/test_torch_trainer.py's (its helpers are imported):
one module-scoped run of the reference's ``make_train_step`` on 4
placeholder CPU devices exports its states, batches (with the stub memory
for whisper), metrics and draws.  Allreduce and uncompressed LEAD run free
over 3 steps within 1e-5 of the state's scale; 2-bit LEAD takes every step
from the reference's state before it with the reference's draws injected,
fewer than 1e-5 of the elements deviating by more than 1e-4 of the scale,
and its dual sum below 1e-3.  Bits exactly (3 bits an element and 32 a
512-block, the sub-block leaves one block each); grad_norm within 1e-5.
Each agent's MoE capacity counts its own tokens, as under the reference's
vmap.

    PYTHONPATH=src python -m pytest -q tests/test_torch_trainer_families.py
"""
import pytest
import torch

from test_torch_trainer import (DEVIATE_FRAC, DUAL_SUM, EXACT_RTOL,
                                check_metrics, deviating_share, dual_sum,
                                exact_gap, inject_draws, run_port,
                                run_reference)

MODELS = {"moe": {"arch": "granite-moe-1b-a400m"},
          "audio": {"arch": "whisper-tiny"}}
RUNS = {"allreduce": {"algorithm": "allreduce"},
        "lead_uncompressed": {"algorithm": "lead", "compressor": "identity"},
        "lead_2bit": {"algorithm": "lead"}}
CASES = {f"{m}/{r}": {**ms, **rs} for m, ms in MODELS.items()
         for r, rs in RUNS.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this file runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {n.replace("/", "__"): spec for n, spec in CASES.items()}
    refs = run_reference(tmp_path_factory.mktemp("trainer_families_ref"),
                         cases, per_process=1)
    return {n.replace("__", "/"): r for n, r in refs.items()}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("run", ["allreduce", "lead_uncompressed"])
def test_exact_runs_match_reference(reference, model, run):
    """Allreduce and LEAD on an uncompressed 32-bit wire (K3 on the card):
    3 free steps within 1e-5 of the state's scale, bits and grad_norm the
    reference's."""
    name = f"{model}/{run}"
    ref = reference[name]
    runs = run_port(ref, CASES[name])
    assert exact_gap(ref, runs) < EXACT_RTOL
    check_metrics(ref, runs)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_lead_2bit_matches_reference(reference, model, monkeypatch):
    """2-bit LEAD (K4, K2, K3 per leaf on the card), each step from the
    reference's state with its draws: fewer than 1e-5 of the elements
    deviate, the bits are the reference's exactly, the dual sum stays
    below 1e-3."""
    name = f"{model}/lead_2bit"
    ref = reference[name]
    inject_draws(monkeypatch, ref)
    runs = run_port(ref, CASES[name], restart=True)
    bad, total = deviating_share(ref, runs)
    assert bad < DEVIATE_FRAC * total, (bad, total)
    check_metrics(ref, runs)
    assert dual_sum(runs[-1][0]) < DUAL_SUM


def test_memory_follows_each_agent_and_microbatch():
    """The audio model's frame memory is sliced with the tokens: per agent
    (each agent's loss sees its own frames - a memory handed to the wrong
    agent changes the step) and per microbatch (two microbatches give the
    one-batch step: the loss is a mean over equal chunks)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import (LMStreamConfig, lm_batch,
                                            stub_memory)
    from repro_torch.dist.trainer import (DistConfig, init_train_state,
                                          make_train_step)
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("whisper-tiny").reduced()
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=16, batch_per_agent=2,
                        n_agents=4)
    batch = lm_batch(ds, 0, device="cpu")
    batch["memory"] = stub_memory("audio", (4, 2), cfg, device="cpu")
    out = {}
    for name, dc, mem in (
            ("one", DistConfig(algorithm="nids"), batch["memory"]),
            ("two", DistConfig(algorithm="nids", microbatches=2),
             batch["memory"]),
            ("swapped", DistConfig(algorithm="nids"),
             batch["memory"].flip(0))):
        st = init_train_state(cfg, 4, dc, torch.Generator().manual_seed(0),
                              "cpu")
        out[name] = make_train_step(cfg, 4, dc, "cpu")(
            st, {**batch, "memory": mem}, 0, step=0)
    g1 = float(out["one"][1]["grad_norm"])
    assert abs(float(out["two"][1]["grad_norm"]) - g1) <= 1e-5 * g1
    for a, b in zip(tree_leaves(out["one"][0].params),
                    tree_leaves(out["two"][0].params)):
        assert (a - b).abs().max() <= 1e-6 * max(a.abs().max(), 1.0)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(out["one"][0].params),
        tree_leaves(out["swapped"][0].params)))


@pytest.mark.parametrize("arch,kw", [
    ("granite-moe-1b-a400m", {}), ("xlstm-1.3b", {"n_layers": 6}),
    ("recurrentgemma-2b", {"n_layers": 3}), ("llama-3.2-vision-11b", {}),
    ("whisper-tiny", {})])
def test_bf16_compute_runs_every_family(arch, kw):
    """compute_dtype="bfloat16" casts the weights, not the f32 memory or
    the recurrent states: the models promote the mixed operands as JAX
    does, so one NIDS step runs and its grad_norm is the f32 step's within
    5% (bf16 keeps ~3 digits; xLSTM's step amplifies them, 2.3% here)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import (LMStreamConfig, lm_batch,
                                            stub_memory)
    from repro_torch.dist.trainer import (DistConfig, init_train_state,
                                          make_train_step)

    cfg = get_config(arch).reduced(**kw)
    ds = LMStreamConfig(vocab=cfg.vocab, seq_len=16, batch_per_agent=2,
                        n_agents=4)
    batch = lm_batch(ds, 0, device="cpu")
    memory = stub_memory(cfg.family, (4, 2), cfg, device="cpu")
    if memory is not None:
        batch["memory"] = memory
    norms = {}
    for cdt in ("float32", "bfloat16"):
        dc = DistConfig(algorithm="nids", compute_dtype=cdt)
        st = init_train_state(cfg, 4, dc, torch.Generator().manual_seed(0),
                              "cpu")
        _, m = make_train_step(cfg, 4, dc, "cpu")(st, batch, 0, step=0)
        norms[cdt] = float(m["grad_norm"])
    assert abs(norms["bfloat16"] - norms["float32"]) \
        <= 0.05 * norms["float32"], norms
