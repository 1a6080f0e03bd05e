"""The LM on a model axis wider than its heads: the production meshes.

The production mesh is ``data 16 x model 16`` (``pod 2 x data 16 x model
16`` across pods).  Most configs' heads or kv heads do not divide a 16-wide
``model`` axis (qwen2-1.5b: 12 and 2, gemma2-2b: 8 and 4,
recurrentgemma-2b: 10 and 1); the rules replicate such a dim, and every
flatten and unflatten around it must then be legal for DTensor, which
refuses to split a dim unevenly where XLA pads it.  Each case runs
``make_step``'s steps at full width (depth cut to the head and one pattern
period, attention in 8,192-token tiles) on a ``fake`` process group of
256 (512) ranks under ``FakeTensorMode``, in a subprocess (the group is
process-wide), and holds each rank's flops below the same step's count on
one device.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_SCRIPT = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import make_step
from repro_torch.models.transformer import plan

arch, multi_pod, shapes = sys.argv[1], sys.argv[2] == "1", sys.argv[3:]
cfg = get_config(arch)
pl = plan(cfg)
cfg = dataclasses.replace(cfg, n_layers=len(pl.head) + max(1, len(pl.pattern)),
                          attn_chunk=8192)
mesh = D.production_mesh(multi_pod, "cpu")
rules = default_rules(multi_pod=multi_pod)
out = {}
for shape in shapes:
    sharded = D._measure(*make_step(cfg, shape, mesh, rules), mesh)
    whole = D._measure(*make_step(cfg, shape, None, rules), None, "cpu")
    out[shape] = {"flops": sharded["flops"], "global_flops": whole["flops"],
                  "coll": sharded["coll"], "memory": sharded["memory"],
                  "global_args": whole["memory"]["argument_bytes"],
                  "n_chips": mesh.size()}
print(json.dumps(out))
"""

CASES = [
    ("qwen2-1.5b", False, ["prefill_32k", "decode_32k", "train_4k"]),
    ("qwen2-1.5b", True, ["prefill_32k", "decode_32k"]),
    ("gemma2-2b", False, ["prefill_32k", "decode_32k"]),
    ("recurrentgemma-2b", False, ["prefill_32k", "decode_32k"]),
    ("mamba2-2.7b", False, ["prefill_32k", "decode_32k"]),
    ("deepseek-v3-671b", False, ["prefill_32k", "decode_32k"]),
]


@pytest.mark.parametrize("arch,multi_pod,shapes", CASES,
                         ids=[f"{a}-{'pod2' if m else 'pod1'}"
                              for a, m, _ in CASES])
def test_full_width_steps_run_on_the_production_mesh(arch, multi_pod, shapes):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, arch, "1" if multi_pod else "0"]
        + shapes, env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == sorted(shapes)
    for shape, rec in out.items():
        assert rec["n_chips"] == (512 if multi_pod else 256)
        assert 0 < rec["flops"] < rec["global_flops"], shape
        # each rank holds a shard: at most the whole, and more than the
        # whole over the ranks (replicated dims), never less
        args = rec["memory"]["argument_bytes"]
        assert rec["global_args"] / rec["n_chips"] <= args < rec["global_args"]
        assert rec["coll"], shape  # a sharded step exchanges something
