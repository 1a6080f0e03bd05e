"""PyTorch port vs JAX package: the architecture registry and parameter
counts.  Every config, reduced config and dry-run cell is the reference's;
the port's abstract tree counts the reference's parameters for the dense
architectures, and the others raise ``NotImplementedError`` naming
ROADMAP.md until their mixers are ported."""

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

DENSE = ["qwen2-1.5b", "gemma2-2b", "phi3-medium-14b", "starcoder2-15b"]


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


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_equals_reference_at_full_width(arch):
    cfg = T.get_config(arch)
    assert cfg.param_count() == J.get_config(arch).param_count()
    assert cfg.active_param_count() == J.get_config(arch).active_param_count()
    # Leaf by leaf: the same shapes, dtypes and initializers, unstacked.
    assert _port_leaves(cfg) == _ref_leaves(J.get_config(arch))


@pytest.mark.parametrize("arch", ["hubert-xlarge"] + DENSE)
def test_reduced_param_count_equals_reference(arch):
    assert T.get_reduced(arch).param_count() == J.get_reduced(arch).param_count()


@pytest.mark.parametrize("arch", sorted(set(J.ARCHS) - set(DENSE)
                                        - {"hubert-xlarge"}))
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.get_config(arch).param_count()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.get_config(arch).active_param_count()
