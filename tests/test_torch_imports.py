"""The PyTorch port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, the port's entry points
refuse to drop quietly to the CPU, and every port module offers its JAX
counterpart's public names."""

import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.miner import FrequentItemsetMiner  # noqa: E402
from repro_torch.core.runtime.engine import MapReduceEngine  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner, make_runner  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or m == "repro" or m.startswith("repro."))
subs = sorted({n.split(".")[1] for n in names})
print(f"{len(names)}|{','.join(bad)}|{','.join(subs)}")
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad, subs = out.stdout.strip().split("|")
    assert int(n_modules) >= 70  # every module: a dropped one shows
    assert bad == "", f"port pulled in: {bad}"
    # The LM's subpackages, its pipeline and engine are among them.
    assert {"analytics", "configs", "models", "serve", "data"} <= set(subs.split(","))


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    top = {m.split(".")[0] for m in mods}
    assert "jax" not in top and "repro" not in top and "repro_torch" in top


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (this box) or without the repository beside it, the
    script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(lone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=tmp_path)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_default_device_is_cuda_and_never_falls_back():
    """Every entry point defaults to the card and raises without one; the
    mesh constructors, ``ShardedRunner`` and the multi-host init too (none
    makes a CPU group unless asked for the CPU).  A CPU mesh is taken only
    when asked for, and the sharded runner then counts on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core.runtime.runners import ShardedRunner
    from repro_torch.distributed.ctx import MultihostSpec, initialize_multihost
    from repro_torch.launch.mesh import make_data_cand_mesh, make_data_mesh

    import torch.distributed as dist

    for build in (MapReduceEngine, TorchRunner, FrequentItemsetMiner,
                  make_runner, lambda: MapReduceEngine(device="cuda"),
                  ShardedRunner, make_data_mesh, make_data_cand_mesh,
                  lambda: make_runner(cand_axes=("cand",)),
                  lambda: initialize_multihost(
                      MultihostSpec("127.0.0.1:1", 1, 0))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert not dist.is_initialized()
    assert MapReduceEngine(device="cpu").device.type == "cpu"
    mesh = make_data_mesh(device="cpu")
    try:
        runner = make_runner(mesh=mesh)
        assert isinstance(runner, ShardedRunner)
        assert runner.engine.device.type == "cpu"
        with pytest.raises(ValueError, match="disagrees"):
            make_runner(mesh=mesh, device="cuda")
    finally:
        dist.destroy_process_group()


# Reference names a port module may lack, each with its reason.
_UNPORTED = {
    "JaxRunner": "the device runner is ported as TorchRunner",
    "compat_make_mesh": "jax.make_mesh across jax versions: the port builds "
                        "torch DeviceMeshes (launch/mesh.py)",
    "make_production_mesh": "the LM's meshes are not ported",
    "make_host_mesh": "the LM's meshes are not ported",
    "use_sharding": "activation sharding of the LM is not ported",
    "constrain": "activation sharding of the LM is not ported",
    "elastic_mesh": "the LM's elastic mesh is not ported",
    "resume": "the LM's elastic restore is not ported",
    "mk_shardings": "the LM's parameter shardings are not ported",
    "ShardingRules": "mesh sharding rules of the LM are not ported",
    "default_rules": "mesh sharding rules of the LM are not ported",
    "act_pspec": "mesh sharding rules of the LM are not ported",
    "batch_pspec": "mesh sharding rules of the LM are not ported",
    "packed_support_count_pallas": "the Pallas kernel is ported as the CUDA "
                                   "kernel packed_support_count",
    "support_count_pallas": "the Pallas kernel is ported as the CUDA kernel "
                            "support_count",
    "logical_to_pspec": "the LM's parameter shardings belong to the LM "
                        "sharding slice",
    "shardings": "the LM's parameter shardings belong to the LM sharding "
                 "slice",
    "shape_structs": "sharded ShapeDtypeStructs of the LM belong to the LM "
                     "sharding slice",
    "loss_fn": "the LM's loss belongs to the training slice",
    "mla_abstract": "MLA waits for the remaining mixers' slice",
    "mla_latent": "MLA waits for the remaining mixers' slice",
    "mla_queries": "MLA waits for the remaining mixers' slice",
    "mla_attention": "MLA waits for the remaining mixers' slice",
    "mla_decode": "MLA waits for the remaining mixers' slice",
}
# Names a reference module imports for its own use (not part of its API):
# (port module, name).
_IMPORTED_ONLY = {
    ("repro_torch.core.runtime.device_loop", "MapReduceEngine"),
    ("repro_torch.core.runtime.engine", "ITEM_PAD"),
    # The reference stacks specs for its scanned super-blocks; the port
    # holds one tree per layer.
    ("repro_torch.models.transformer", "ParamSpec"),
    ("repro_torch.models.transformer", "is_spec"),
    ("repro_torch.models.transformer", "spec"),
}


def _public(mod, pkg):
    """``__all__``, else the module's non-underscore names that are neither
    modules nor functions and classes imported from outside ``pkg``."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        origin = getattr(value, "__module__", None)
        if (origin is not None and callable(value)
                and not (origin == pkg or origin.startswith(pkg + "."))):
            continue
        out.add(name)
    return out


def test_port_offers_the_reference_public_names():
    pytest.importorskip("jax")
    import repro_torch

    checked = 0
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        ref_name = "repro" + info.name[len("repro_torch"):]
        try:
            ref = importlib.import_module(ref_name)
        except ImportError:
            continue  # port-only module (e.g. the kernel build)
        port = importlib.import_module(info.name)
        missing = {n for n in _public(ref, "repro") - _public(port, "repro_torch")
                   if n not in _UNPORTED
                   and (info.name, n) not in _IMPORTED_ONLY}
        assert not missing, f"{info.name} lacks {sorted(missing)}"
        checked += 1
    assert checked >= 40
