"""The PyTorch port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the port's entry
points refuse to drop quietly to the CPU."""

import ast
import os
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
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(f"{len(names)}|{','.join(bad)}")
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().split("|")
    assert int(n_modules) >= 31  # every module: a dropped one shows
    assert bad == "", f"port pulled in: {bad}"


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
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for build in (MapReduceEngine, TorchRunner, FrequentItemsetMiner,
                  make_runner, lambda: MapReduceEngine(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    assert MapReduceEngine(device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError):
        make_runner(mesh=object(), device="cpu")
