"""PyTorch port vs JAX package: the architecture registry and parameter
counts.  Every config, reduced config and dry-run cell is the reference's;
for all ten architectures the port's abstract tree counts the reference's
parameters (and active parameters) at full and reduced size, leaf by leaf
at full size."""

import dataclasses
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as J  # noqa: E402
from repro.configs.base import LM_SHAPES as J_SHAPES  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import is_spec  # noqa: E402

import repro_torch.configs as T  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _ref_leaves(cfg) -> Counter:
    """(shape, init, scale, dtype) of every reference leaf, the scanned
    super-blocks' leaves counted once per super-block without their
    leading ``layers`` axis."""
    tree = dict(JM.abstract_params(cfg))
    blocks = tree.pop("blocks")
    n_super = JT.plan(cfg).n_super
    out = Counter()
    for part, stacked in ((tree, False), (blocks["head"], False),
                          (blocks["tail"], False), (blocks["scan"], True)):
        for leaf in jax.tree.leaves(part, is_leaf=is_spec):
            shape = leaf.shape[1:] if stacked else leaf.shape
            out[(shape, leaf.init, leaf.scale, jnp.dtype(leaf.dtype).name)] += \
                n_super if stacked else 1
    return out


def _port_leaves(cfg) -> Counter:
    return Counter((leaf.shape, leaf.init, leaf.scale,
                    str(leaf.dtype).removeprefix("torch."))
                   for leaf in tree_leaves(TM.abstract_params(cfg)))


@pytest.mark.parametrize("arch", J.ARCHS)
def test_configs_equal_reference(arch):
    assert T.ARCHS == J.ARCHS
    assert _fields(T.get_config(arch)) == _fields(J.get_config(arch))
    assert _fields(T.get_reduced(arch)) == _fields(J.get_reduced(arch))
    assert T.get_config(arch).resolved_head_dim == J.get_config(arch).resolved_head_dim
    for shape in LM_SHAPES:
        assert T.shape_applicable(arch, shape) == J.shape_applicable(arch, shape)


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for skipped in (False, True):
        assert T.cells(include_skipped=skipped) == J.cells(include_skipped=skipped)
    with pytest.raises(ValueError, match="unknown arch"):
        T.get_config("no-such-arch")


@pytest.mark.parametrize("arch", J.ARCHS)
def test_param_count_equals_reference_at_full_width(arch):
    cfg = T.get_config(arch)
    assert cfg.param_count() == J.get_config(arch).param_count()
    assert cfg.active_param_count() == J.get_config(arch).active_param_count()
    # Leaf by leaf: the same shapes, dtypes and initializers, unstacked.
    assert _port_leaves(cfg) == _ref_leaves(J.get_config(arch))


@pytest.mark.parametrize("arch", J.ARCHS)
def test_reduced_param_count_equals_reference(arch):
    cfg, ref = T.get_reduced(arch), J.get_reduced(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert _port_leaves(cfg) == _ref_leaves(ref)


def test_chip_smoke_mixer_counts_are_the_reference_s():
    """``chip_smoke.py`` phase 11 holds each served model's parameter count
    to ``MIXER_PARAMS``: the reference's ``param_count`` of the same
    configuration (deepseek-v3 cut to 4 layers)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfgs = smoke.mixer_cfgs()
    assert sorted(cfgs) == sorted(smoke.MIXER_PARAMS)
    for name, cfg in cfgs.items():
        ref = dataclasses.replace(J.get_config(name), n_layers=cfg.n_layers)
        assert _fields(cfg) == _fields(ref)
        assert smoke.MIXER_PARAMS[name] == ref.param_count() == cfg.param_count()
