"""PyTorch port vs JAX package: the sharded runner on a 2x2 ``data x cand``
grid of four gloo CPU ranks.

The same cases as ``test_torch_sharded.py`` (which holds the 2x1 and 1x2
worlds), run in one four-rank world and held against the reference's
one-device ``ShardedRunner``.  One subprocess runs the reference's trimmed
ladder on four forced host devices as a 2x2 mesh, so the shard-dependent
``n_pad``/``f_pad`` of every store's trimmed-ladder profile are compared
with the reference's on the same mesh shape.
"""

import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")

# db and c2_wave are that file's module-scoped fixtures, shared here.
from test_torch_sharded import (  # noqa: E402,F401
    CASES, STORES, _env, _key, c2_wave, check_case, db, run_worlds)

_REF_MESH_CHILD = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import FrequentItemsetMiner
from repro.core.runtime import ShardedRunner
from repro.data import quest_generator

db = quest_generator(n_transactions=300, avg_transaction_len=8, n_items=50,
                     n_patterns=30, seed=3)[:-1]
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "cand"))
runner = ShardedRunner(store="perfect_hash", mesh=mesh, cand_axes=("cand",))
res = FrequentItemsetMiner(min_support=0.05, runner=runner,
                           device_loop=True, trim=True).mine(db)
print("REF " + json.dumps([[p.k, p.n_candidates, p.n_frequent, p.n_pad,
                            p.f_pad] for p in res.levels]))
"""


@pytest.fixture(scope="module")
def grid(tmp_path_factory, c2_wave):
    return run_worlds(["2x2"], tmp_path_factory, c2_wave)["2x2"]


@pytest.fixture(scope="module")
def ref_grid_profile():
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REF_MESH_CHILD], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("REF "))
    return json.loads(line[4:])


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_grid_matches_reference(grid, db, c2_wave, case):
    check_case(grid[_key(case)], db, c2_wave, "2x2", case)


@pytest.mark.parametrize("store", STORES)
def test_trimmed_ladder_profile_matches_reference_grid(grid, ref_grid_profile,
                                                       store):
    """The trimmed ladder's n_pad (the live rows rounded to the data shards)
    and f_pad equal the reference's on its own 2x2 mesh."""
    got = grid[_key(("ladder", store, True))]["levels"]
    assert got == ref_grid_profile
    assert any(a[3] > b[3] for a, b in zip(got[1:], got[2:])), \
        "the trim never shrank the rows"
