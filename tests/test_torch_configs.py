"""The port's configs (src/repro_torch/configs) against the JAX reference's
(src/repro/configs), on the CPU, in the style of tests/test_configs.py:
every registered architecture's fields, its ``reduced()`` variant, the
input shapes and the long-context transform equal the reference's, and
``param_count`` - which counts the port's own ``init_params`` on the meta
device - equals the reference's (``jax.eval_shape`` of its init) for every
architecture, full size and reduced: the dense ones, and the MoE,
recurrent, vlm and audio families."""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro_torch.configs import base
from repro_torch.configs.registry import (get_config, get_shape, list_archs,
                                          list_shapes)

DENSE = ("deepseek-67b", "gemma3-12b", "granite-3-2b", "qwen2-7b")


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_registry_and_shapes_match_reference():
    assert list_archs() == jax_registry.list_archs()
    assert len(list_archs()) == 10
    assert list_shapes() == jax_registry.list_shapes()
    for name in list_shapes():
        assert dataclasses.asdict(get_shape(name)) \
            == dataclasses.asdict(jax_registry.get_shape(name))


@pytest.mark.parametrize("arch", jax_registry.list_archs())
def test_config_and_reduced_match_reference(arch):
    """The same fields (names, order and values), source string included,
    and the same reduced variant, the same layer types and scan period."""
    cfg, ref = get_config(arch), jax_registry.get_config(arch)
    assert list(_fields(cfg)) == list(_fields(ref))
    assert _fields(cfg) == _fields(ref) and cfg.source
    for kw in ({}, {"n_layers": 6, "d_model": 128}):
        r, rr = cfg.reduced(**kw), ref.reduced(**kw)
        assert _fields(r) == _fields(rr)
        assert r.layer_types() == rr.layer_types()
        assert r.scan_period() == rr.scan_period()
    assert _fields(base.with_long_context(cfg)) \
        == _fields(jax_base.with_long_context(ref))
    assert cfg.is_recurrent == ref.is_recurrent


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference(arch):
    """Exact, at full size and reduced: the port's meta-device init has the
    reference's leaves."""
    cfg, ref = get_config(arch), jax_registry.get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.reduced().param_count() == ref.reduced().param_count()


@pytest.mark.parametrize("arch", sorted(set(jax_registry.list_archs())
                                        - set(DENSE)))
def test_unported_families_raise(arch):
    """MoE, recurrent, vlm and audio, once unported, are modelled now: the
    port's param_count and active_param_count equal the reference's, at
    full size and at ``.reduced()``.  (The name is kept for the test ID.)"""
    cfg, ref = get_config(arch), jax_registry.get_config(arch)
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()


def test_granite_at_two_layers_is_the_chip_phase_size():
    """granite-3-2b at its published width cut to 2 layers: 12 leaves,
    322,983,936 parameters per agent, every leaf a multiple of 512 (the
    size chip_smoke.py's train_at_scale runs)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    leaves = tree_leaves(init_params(cfg, device="meta"))
    assert len(leaves) == 12
    assert sum(l.numel() for l in leaves) == 322_983_936 \
        == cfg.param_count()
    assert all(l.numel() % 512 == 0 for l in leaves)
