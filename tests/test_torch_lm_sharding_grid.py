"""The port's LM on a 2 x 2 ``data x model`` grid of four gloo CPU ranks,
and the JAX package's own sharded forward against it.

The same cases as ``test_torch_lm_sharding_worlds.py`` (which holds the
2 x 1 and 1 x 2 worlds), run in one four-rank world and held against the
single-device port at the same tolerances.  One subprocess runs the
reference's prefill of reduced qwen2-1.5b (float32) on four forced host
devices as its 2 x 2 ``make_host_mesh(model_axis=2)``, under its default
rules; the world runs the port's prefill on those parameters on the 2 x 2
grid, and the two logits agree within 1e-4.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_lm_sharding_worlds import (  # noqa: E402
    ARCHS, SHAPES, check_arch, check_meshes, check_moe, check_trainer,
    get_world)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return get_world("2x2", tmp_path_factory)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_equals_single_device(grid, arch):
    check_arch(grid, arch)


def test_moe_dispatch_exact_and_experts_close(grid):
    check_moe(grid)


def test_norm_compression_and_trainer_on_the_mesh(grid):
    check_trainer(grid)


def test_restore_onto_another_mesh_and_world_meshes(grid):
    check_meshes(grid, SHAPES["2x2"])


def test_reference_sharded_forward(grid):
    """The JAX package's prefill on its 2 x 2 host mesh against the port's
    on the 2 x 2 grid, from the same float32 parameters."""
    assert grid["reference"]["reference_prefill_logits"] < 1e-4
