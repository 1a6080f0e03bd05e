"""The port's LM on a ``model`` axis that does not divide its kv heads,
held against the single-device port.

On the production mesh (``data 16 x model 16``) most configs' heads or kv
heads do not divide ``model``.  The rules replicate such a dim, but DTensor
may still split the flattened width of its projection (kv heads x head
dim) over ``model`` when the weight is split over ``data`` (FSDP), and
that width cannot be unflattened: ``layers._matmul`` and ``flat`` then
replicate it (``_unflattenable``), in the product and in its gradient.
``test_torch_mesh16.py`` runs those steps at full width under
``FakeTensorMode``, which computes no values; here the same code runs on
real numbers.  One world of eight gloo CPU ranks as a 2 x 4 mesh runs
``test_torch_lm_sharding_worlds.py``'s per-architecture cases on the
reduced configs whose kv heads (2, or 1 for recurrentgemma-2b) do not
divide 4 while their flattened width does.  Held: prefill logits and
caches, two decode steps' logits and caches, ``loss_fn`` and every
gradient, at that file's tolerances, and that ``_unflattenable``
redistributed in each (on a 1 x 4 mesh, with the weights whole on every
rank, DTensor never splits the width and the repair does nothing).
Greedy serving is not held here: its bfloat16 cache turns the sharded
sums' last bits into a flip where two logits nearly tie (reduced
qwen2-1.5b's third token of row 2 has a top-two margin of 4.1e-4).
"""

import json
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_lm_sharding_worlds import TOL, _WORLD, _env  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.multihost import launch_cluster  # noqa: E402

SHAPE = (2, 4)
ARCHS = ["qwen2-1.5b", "gemma2-2b", "recurrentgemma-2b",
         "llama-3.2-vision-11b"]

# The world's definitions, then only the per-architecture cases (its
# trainer and mesh cases assume a world of two or four), with every
# redistribution that the repair makes counted.
_CASES = _WORLD.split('\nout = {arch: arch_cases(arch)')[0] + r"""
from repro_torch.models import layers as LY

redistributed = [0]
_unflattenable = LY._unflattenable


def counted(y, lead, dim):
    out = _unflattenable(y, lead, dim)
    redistributed[0] += out is not y
    return out


LY._unflattenable = counted
out = {}
for arch in spec["archs"]:
    before = redistributed[0]
    out[arch] = arch_cases(arch)
    out[arch]["redistributed"] = redistributed[0] - before
if dist.get_rank() == 0:
    with open(spec["out"], "w") as f:
        json.dump(out, f)
exit_rank(0)
"""


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("uneven")
    path = str(tmp / "2x4.json")
    spec = {"shape": SHAPE, "out": path, "archs": ARCHS}
    launch_cluster([sys.executable, "-c", _CASES, json.dumps(spec)],
                   SHAPE[0] * SHAPE[1], base_env=_env(), timeout=600)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_heads_do_not_divide_the_model_axis(arch):
    """The premise: the rules replicate the kv heads, while their
    flattened width would split evenly."""
    cfg = get_reduced(arch)
    kv, width = cfg.n_kv_heads, cfg.n_kv_heads * cfg.resolved_head_dim
    assert kv % SHAPE[1] and not width % SHAPE[1], (kv, width)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_equals_single_device(uneven, arch):
    got = uneven[arch]
    assert got["redistributed"] > 0
    for key, tol in TOL.items():
        assert got[key] < tol, (key, got[key])
