"""PyTorch port vs JAX package: the sharded runner over ``torch.distributed``.

A module-scoped fixture launches one gloo world of CPU ranks per mesh shape
(here 2x1 ``data`` and 1x2 ``data x cand``; the 2x2 grid is in
``test_torch_sharded_grid.py``) through the port's own ``launch_cluster``;
every rank runs every case inside its world, and rank 0 writes the
results.  The parametrised tests below then hold each case
against the JAX package's ``ShardedRunner`` on a one-device mesh in this
process, exactly (counts are integers): itemsets AND supports of SPC
through all five stores (the kernel stores also in their kernel layout,
whose wrappers count with the plain versions on CPU tensors), FPC, DPC and
auto-sized queue depths; the Job1 histogram; the C2 wave's count vector
(candidate row order included, in chunks smaller than the wave); and the
ladder with and without trim.  Profile fields that depend on the data-shard
count (``n_pad``, and so ``f_pad`` through the trim) are compared where
the data axis has one shard, and on the 2x2 grid against the reference's
own 2x2 mesh.

The database is the reference suites' Quest twin
(``quest_generator(n_transactions=300, avg_transaction_len=8, n_items=50,
n_patterns=30, seed=3)``) less its last row, so a two-shard data axis pads
a row at the tail.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import itemsets as J  # noqa: E402
from repro.core.miner import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.core.runtime import ShardedRunner as JSharded  # noqa: E402
from repro.core.runtime.engine import MapReduceEngine as JEngine  # noqa: E402
from repro.core.stores import encode_db as j_encode_db  # noqa: E402
from repro.data import quest_generator  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402

from repro_torch.launch.multihost import launch_cluster  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SUPPORT = 0.05
STORES = ["perfect_hash", "sorted_prefix", "hash_bucket", "bitmap",
          "packed_bitmap"]
SHAPES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
HERE = ["2x1", "1x2"]

# Cases every world runs: (kind, store, option).
CASES = ([("spc", s, None) for s in STORES]
         + [("spc", s, True) for s in ("perfect_hash", "bitmap",
                                       "packed_bitmap")]
         + [("ladder", s, trim) for s in STORES for trim in (False, True)]
         + [("c2", s, None) for s in STORES]
         + [("strategy", "packed_bitmap", "fpc"),
            ("strategy", "packed_bitmap", "dpc"),
            ("inflight", "packed_bitmap", 0),
            ("inflight", "packed_bitmap", None),
            ("job1", None, None)])


def _key(case):
    return "/".join(str(x) for x in case)


_WORLD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import ctx
ctx.initialize_multihost(device="cpu", timeout=120)
from repro_torch.core.miner import FrequentItemsetMiner
from repro_torch.core.runtime import ShardedRunner
from repro_torch.core.runtime.engine import MapReduceEngine
from repro_torch.core.stores import ARRAY_STORES, encode_db
from repro_torch.data import quest_generator
from repro_torch.launch.mesh import make_data_cand_mesh, make_data_mesh

spec = json.loads(sys.argv[1])
n_data, n_cand = spec["shape"]
if n_cand > 1:
    mesh = make_data_cand_mesh(n_data, n_cand, device="cpu")
    cand_axes = ("cand",)
else:
    mesh = make_data_mesh(n_data, device="cpu")
    cand_axes = ()
db = quest_generator(n_transactions=300, avg_transaction_len=8, n_items=50,
                     n_patterns=30, seed=3)[:-1]
dense, n_items = spec["dense"], spec["n_items"]
mat = np.asarray(spec["c2"], np.int32)


def rows(res):
    return [[p.k, p.n_candidates, p.n_frequent, p.n_pad, p.f_pad]
            for p in res.levels]


def mine(store, **kw):
    runner = ShardedRunner(store=store, mesh=mesh, cand_axes=cand_axes,
                           cand_block=kw.pop("cand_block", 32768),
                           inflight=kw.pop("inflight", 1))
    res = FrequentItemsetMiner(min_support=spec["min_support"],
                               runner=runner, **kw).mine(db)
    return {"itemsets": sorted([list(s), c] for s, c in res.itemsets.items()),
            "levels": rows(res)}


out = {}
for kind, store, opt in spec["cases"]:
    cls = ARRAY_STORES.get(store)
    saved = getattr(cls, "use_kernel", None)
    if kind == "spc":
        if opt is not None:
            cls.use_kernel = opt
        got = mine(store)
    elif kind == "ladder":
        got = mine(store, device_loop=True, trim=opt)
    elif kind == "strategy":
        got = mine(store, strategy=opt)
    elif kind == "inflight":
        got = mine(store, inflight=opt, cand_block=64)
    elif kind == "c2":
        eng = MapReduceEngine(store=store, mesh=mesh, cand_axes=cand_axes,
                              cand_block=100)
        eng.place(encode_db(dense, n_items=n_items))
        got = eng.count_candidates(mat).tolist()
    else:
        runner = ShardedRunner(store="perfect_hash", mesh=mesh,
                               cand_axes=cand_axes)
        runner.ingest(db)
        hist, _ = runner.job1()
        got = hist.tolist()
    if cls is not None:
        cls.use_kernel = saved
    out["/".join(str(x) for x in (kind, store, opt))] = got
if ctx.process_index() == 0:
    with open(spec["out"], "w") as f:
        json.dump(out, f)
from repro_torch.launch.multihost import exit_rank
exit_rank()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def db():
    return quest_generator(n_transactions=300, avg_transaction_len=8,
                           n_items=50, n_patterns=30, seed=3)[:-1]


@pytest.fixture(scope="module")
def c2_wave(db):
    """The dense re-encoded DB over the frequent items and its C2 matrix."""
    min_count = int(np.ceil(MIN_SUPPORT * len(db)))
    hist = np.bincount(np.concatenate([np.unique(t) for t in db]))
    item_map = np.nonzero(hist >= min_count)[0]
    remap = {int(o): d for d, o in enumerate(item_map)}
    dense = [sorted(remap[i] for i in set(t) if i in remap) for t in db]
    mat = J.apriori_gen_matrix(
        np.arange(len(item_map), dtype=np.int32).reshape(-1, 1))
    return dense, len(item_map), mat


def run_worlds(names, tmp_path_factory, c2_wave):
    """Every case, run in one gloo world per mesh shape in ``names``."""
    dense, n_items, mat = c2_wave
    out = {}
    for name in names:
        shape = SHAPES[name]
        path = str(tmp_path_factory.mktemp("world") / f"{name}.json")
        spec = {"shape": shape, "out": path, "cases": CASES,
                "min_support": MIN_SUPPORT, "dense": dense,
                "n_items": n_items, "c2": mat.tolist()}
        launch_cluster([sys.executable, "-c", _WORLD, json.dumps(spec)],
                       shape[0] * shape[1], base_env=_env(), timeout=300)
        with open(path) as f:
            out[name] = json.load(f)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, c2_wave):
    return run_worlds(HERE, tmp_path_factory, c2_wave)


_REF = {}


def _reference(db, kind, option):
    """The JAX package's ShardedRunner on a one-device mesh (perfect_hash:
    the reference's own suites hold every store to the same answer)."""
    key = (kind, option)
    if key not in _REF:
        mesh = compat_make_mesh((1,), ("data",))
        runner = JSharded(store="perfect_hash", mesh=mesh,
                          inflight=option if kind == "inflight" else 1,
                          cand_block=64 if kind == "inflight" else 32_768)
        kw = {}
        if kind == "ladder":
            kw = {"device_loop": True, "trim": option}
        elif kind == "strategy":
            kw = {"strategy": option}
        res = JMiner(min_support=MIN_SUPPORT, runner=runner, **kw).mine(db)
        _REF[key] = {
            "itemsets": sorted([list(s), c] for s, c in res.itemsets.items()),
            "levels": [[p.k, p.n_candidates, p.n_frequent, p.n_pad, p.f_pad]
                       for p in res.levels]}
    return _REF[key]


def check_case(got, db, c2_wave, world, case):
    """One world's result of ``case`` against the reference's one-device
    ShardedRunner."""
    kind, store, option = case
    if kind == "job1":
        hist = np.bincount(np.concatenate([np.unique(t) for t in db]))
        runner = JSharded(store="perfect_hash",
                          mesh=compat_make_mesh((1,), ("data",)))
        runner.ingest(db)
        want, _ = runner.job1()
        np.testing.assert_array_equal(want, hist)
        assert got == want.tolist()
        return
    if kind == "c2":
        dense, n_items, mat = c2_wave
        eng = JEngine(store="perfect_hash",
                      mesh=compat_make_mesh((1,), ("data",)))
        eng.place(j_encode_db(dense, n_items=n_items))
        assert got == np.asarray(eng.count_candidates(mat)).tolist()
        return
    want = _reference(db, kind, option)
    assert got["itemsets"] == want["itemsets"]
    # k, n_candidates, n_frequent always; n_pad / f_pad where they do not
    # depend on the data-shard count (one data shard; the 2x2 grid's are
    # held against the reference's own 2x2 mesh).
    width = 5 if SHAPES[world][0] == 1 else 3
    assert [r[:width] for r in got["levels"]] == \
        [r[:width] for r in want["levels"]]


@pytest.mark.parametrize("world", HERE)
@pytest.mark.parametrize("case", CASES, ids=_key)
def test_world_matches_reference(worlds, db, c2_wave, world, case):
    check_case(worlds[world][_key(case)], db, c2_wave, world, case)
