"""PyTorch port vs JAX package: multi-host launch, the killed-worker
relaunch, elastic recovery from device loss, and the sharded service.

The env trio, ``worker_env``, ``launch_cluster`` and ``supervise`` are
held to the reference's own cases.  Real clusters are CPU gloo processes
launched through the port's ``launch_cluster``:

* a 2-process mine whose worker 1 dies (``os._exit(137)``) at the k = 3
  dispatch; the supervisor relaunches one process from the shared
  checkpoint directory, and the resumed mine equals the reference's clean
  mine, itemsets AND supports and counting jobs (the twin of
  ``test_faults.py::test_multihost_killed_worker_recovery``);
* ``device_loss(k=3, lost=2)`` on a 4-rank 2x2 ``data x cand`` world: the
  two tail ranks leave with ``DeviceLostError``, the survivors rebuild a
  2-rank mesh, restore the level checkpoint and equal the clean mine (the
  twin of ``test_faults.py``'s ``_ELASTIC_CHILD``);
* ``MiningService(mesh=)`` on a 2-rank data mesh against the reference's
  ``MiningService`` on a one-device mesh over the same batches (the twin of
  ``test_serve.py::test_midstream_parity_sharded``), host-SPC and ladder
  refreshes.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FrequentItemsetMiner as JMiner  # noqa: E402
from repro.core.runtime import ShardedRunner as JSharded  # noqa: E402
from repro.core.runtime import SimRunner as JSim  # noqa: E402
from repro.data import get_dataset as j_get_dataset  # noqa: E402
from repro.data import quest_generator  # noqa: E402
from repro.distributed import ctx as j_ctx  # noqa: E402
from repro.launch import multihost as j_mh  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro.serve import MiningService as JService  # noqa: E402

from test_torch_sharded import _env  # noqa: E402

from repro_torch.distributed import ctx as t_ctx  # noqa: E402
from repro_torch.launch import multihost as mh  # noqa: E402


# -- the env trio and the launcher, against the reference's cases -----------

ENVS = [
    {},
    {"REPRO_COORDINATOR": "127.0.0.1:9999", "REPRO_NUM_PROCESSES": "2",
     "REPRO_PROCESS_ID": "1"},
    {"REPRO_COORDINATOR": "127.0.0.1:9999"},  # partial: a launch bug
    {"REPRO_COORDINATOR": "c:1", "REPRO_NUM_PROCESSES": "two",
     "REPRO_PROCESS_ID": "0"},
    {"REPRO_COORDINATOR": "c:1", "REPRO_NUM_PROCESSES": "2",
     "REPRO_PROCESS_ID": "2"},  # pid out of [0, num)
    {"REPRO_COORDINATOR": "c:1", "REPRO_NUM_PROCESSES": "0",
     "REPRO_PROCESS_ID": "0"},
]


def _parse(ctx, env):
    try:
        spec = ctx.multihost_env(env=env)
    except ValueError as e:
        return "ValueError", "REPRO_" in str(e)
    return None if spec is None else (spec.coordinator, spec.num_processes,
                                      spec.process_id)


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_multihost_env_parsing_matches_reference(env):
    assert _parse(t_ctx, env) == _parse(j_ctx, env)


def test_worker_env_trio():
    env = mh.worker_env("127.0.0.1:5555", 3, 2, base={"FOO": "1"})
    assert env["REPRO_COORDINATOR"] == "127.0.0.1:5555"
    assert env["REPRO_NUM_PROCESSES"] == "3"
    assert env["REPRO_PROCESS_ID"] == "2"
    assert env["FOO"] == "1" and env["PYTHONUNBUFFERED"] == "1"
    assert t_ctx.multihost_env(env=env) == t_ctx.MultihostSpec(
        "127.0.0.1:5555", 3, 2)
    want = j_mh.worker_env("127.0.0.1:5555", 3, 2, local_devices=0,
                           base={"FOO": "1"})
    assert env == want


class _FakeProc:
    """Scripted worker: returns its exit code after ``alive_polls`` polls."""

    def __init__(self, rc, alive_polls=0):
        self.rc = rc
        self.alive_polls = alive_polls
        self.killed = False

    def poll(self):
        if self.alive_polls > 0:
            self.alive_polls -= 1
            return None
        return self.rc

    def kill(self):
        self.killed = True
        self.alive_polls = 0

    def wait(self, timeout=None):
        return self.rc


def test_launch_cluster_success_and_failure():
    spawned = []

    def fake_popen(script):
        def popen(argv, env):
            p = _FakeProc(*script[len(spawned)])
            spawned.append((argv, env, p))
            return p
        return popen

    coord = mh.launch_cluster(["prog"], 2, coordinator="127.0.0.1:7000",
                              popen=fake_popen([(0, 1), (0, 1)]))
    assert coord == "127.0.0.1:7000"
    assert [e["REPRO_PROCESS_ID"] for _, e, _ in spawned] == ["0", "1"]
    assert not any(p.killed for _, _, p in spawned)

    # Worker 1 dies rc=137 while worker 0 hangs: 0 is killed, failure names 1.
    spawned.clear()
    with pytest.raises(mh.ClusterFailure) as ei:
        mh.launch_cluster(["prog"], 2,
                          popen=fake_popen([(0, 10**9), (137, 1)]))
    assert (ei.value.process_id, ei.value.returncode) == (1, 137)
    assert spawned[0][2].killed and not spawned[1][2].killed

    # Nobody finishes: the timeout kills the cluster loudly.
    spawned.clear()
    with pytest.raises(TimeoutError):
        mh.launch_cluster(["prog"], 2, timeout=0.0, poll_interval=0.0,
                          popen=fake_popen([(0, 10**9), (0, 10**9)]))
    assert all(p.killed for _, _, p in spawned)


def test_supervise_relaunches_smaller_without_fault(tmp_path, monkeypatch):
    out = str(tmp_path / "result.json")
    args = mh._parse(["--processes", "2", "--kill-k", "3", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "ck"),
                      "--out", out, "--elastic", "1"])
    calls = []

    def fake_launch(argv, n, timeout=None):
        calls.append((list(argv), n))
        if len(calls) == 1:
            assert "--kill-k" in argv
            raise mh.ClusterFailure(1, 137)
        assert "--kill-k" not in argv  # relaunches run clean
        with open(out, "w") as f:
            f.write('{"itemsets": [], "restored_step": 3}')

    monkeypatch.setattr(mh, "launch_cluster", fake_launch)
    summary = mh.supervise(args)
    assert [n for _, n in calls] == [2, 1]
    assert summary["relaunches"] == 1
    assert summary["failures"] == [(1, 137)]
    assert summary["final_processes"] == 1
    assert summary["result"]["restored_step"] == 3
    for argv, _ in calls:
        assert argv[1:3] == ["-m", "repro_torch.launch.multihost"]
        assert str(tmp_path / "ck") in argv
        assert argv[argv.index("--device") + 1] == "cpu"

    args2 = mh._parse(["--processes", "2", "--checkpoint-dir",
                       str(tmp_path / "ck2"), "--out", out, "--elastic", "0"])

    def always_fail(argv, n, timeout=None):
        raise mh.ClusterFailure(0, 1)

    monkeypatch.setattr(mh, "launch_cluster", always_fail)
    with pytest.raises(mh.ClusterFailure):
        mh.supervise(args2)


_INIT_CHILD = r"""
import torch.distributed as dist
from repro_torch.distributed import ctx
from repro_torch.launch.mesh import make_data_cand_mesh, make_data_mesh
from repro_torch.launch.multihost import find_free_port

assert ctx.initialize_multihost(env={}) is None  # trio unset: no-op
assert not dist.is_initialized()
spec = ctx.MultihostSpec(f"127.0.0.1:{find_free_port()}", 1, 0)
assert ctx.initialize_multihost(spec, device="cpu") == spec
assert ctx.initialize_multihost(spec, device="cpu") == spec  # idempotent
try:
    ctx.initialize_multihost(ctx.MultihostSpec("127.0.0.1:1", 1, 0))
    raise SystemExit("re-initialized as another spec")
except RuntimeError:
    pass
assert dist.get_backend() == "gloo"
assert (ctx.process_index(), ctx.process_count()) == (0, 1)
try:
    make_data_cand_mesh(2, 2, device="cpu")
    raise SystemExit("oversubscribed mesh accepted")
except ValueError as e:
    assert "2x2" in str(e) and "4 ranks" in str(e), e
mesh = make_data_cand_mesh(device="cpu")
assert mesh.mesh_dim_names == ("data", "cand") and mesh.mesh.tolist() == [[0]]
assert make_data_mesh(device="cpu").mesh.tolist() == [0]
try:
    ctx.init_group("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    raise SystemExit("NCCL accepted for CPU tensors")
except ValueError:
    pass
dist.destroy_process_group()
print("INIT_OK")
"""


def test_initialize_multihost_is_idempotent_and_meshes_check_the_world():
    proc = subprocess.run([sys.executable, "-c", _INIT_CHILD], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout
    assert "INIT_OK" in proc.stdout


# -- the killed-worker relaunch ---------------------------------------------

def test_multihost_killed_worker_recovery(tmp_path):
    """A 2-process gloo cluster loses worker 1 to os._exit(137) at the k=3
    dispatch; the supervisor kills the hung survivor and relaunches one
    process from the shared checkpoint dir, and the resumed mine equals a
    clean reference mine, itemsets AND supports."""
    out = str(tmp_path / "result.json")
    argv = ["--processes", "2", "--device", "cpu", "--backend", "gloo",
            "--kill-k", "3", "--kill-process", "1",
            "--min-support", "0.015", "--scale", "0.002",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--out", out,
            "--timeout", "240"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost"] + argv,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("MULTIHOST_OK "))
    summary = json.loads(line[len("MULTIHOST_OK "):])
    assert summary["relaunches"] == 1
    # Which nonzero exit the supervisor sees first is a race: the killed
    # worker's 137, or the survivor failing its collective on the vanished
    # peer.  Exactly one launch failed either way.
    assert len(summary["failures"]) == 1
    assert summary["final_processes"] == 1
    result = summary["result"]
    assert result["restored_step"] is not None and result["restored_step"] >= 2
    assert result["processes"] == 1
    clean = JMiner(min_support=0.015, max_k=6).mine(
        j_get_dataset("T10I4D100K", scale=0.002, seed=0))
    assert result["itemsets"] == sorted(
        [list(s), int(c)] for s, c in clean.itemsets.items())
    assert result["n_transactions"] == clean.n_transactions
    assert result["min_count"] == clean.min_count
    assert result["counting_jobs"] == sum(1 for p in clean.levels if p.k >= 2)


# -- elastic recovery on a 2x2 grid -------------------------------------------

_ELASTIC_CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.distributed import ctx
ctx.initialize_multihost(device="cpu", timeout=120)
from repro_torch.core import FrequentItemsetMiner
from repro_torch.core.runtime import DeviceLostError, FaultPlan, ShardedRunner
from repro_torch.core.runtime import faults as F
from repro_torch.data import quest_generator
from repro_torch.launch.mesh import make_data_cand_mesh

ckpt_dir, out = sys.argv[1], sys.argv[2]
db = quest_generator(n_transactions=300, avg_transaction_len=8,
                     n_items=50, n_patterns=30, seed=3)
mesh = make_data_cand_mesh(device="cpu")
assert mesh.mesh.tolist() == [[0, 1], [2, 3]], mesh.mesh.tolist()
plan = FaultPlan(F.device_loss(k=3, lost=2))
runner = ShardedRunner(store="packed_bitmap", mesh=mesh, cand_axes=("cand",),
                       fault_plan=plan)
miner = FrequentItemsetMiner(min_support=0.05, runner=runner,
                             checkpoint_dir=ckpt_dir)
rank = ctx.process_index()
try:
    res = miner.mine(db)
    rec = {"itemsets": sorted([list(s), c] for s, c in res.itemsets.items()),
           "mesh": miner.active_runner.engine.mesh.mesh.tolist(),
           "describe": miner.active_runner.describe(),
           "levels": [p.k for p in res.levels]}
except DeviceLostError as err:
    rec = {"lost": True, "k": err.k}
rec["injected"] = [kind for kind, _ in plan.injected]
with open(f"{out}.{rank}", "w") as f:
    json.dump(rec, f)
from repro_torch.launch.multihost import exit_rank
exit_rank()
"""


def test_elastic_device_loss_on_a_2x2_grid(tmp_path):
    """Two of four ranks are lost at the k=3 dispatch: the tail ranks leave
    ``mine()`` with ``DeviceLostError``; the survivors rebuild a 2x1 grid,
    restore the level checkpoint and equal the clean mine."""
    out = str(tmp_path / "rank")
    mh.launch_cluster([sys.executable, "-c", _ELASTIC_CHILD,
                       str(tmp_path / "ckpt"), out], 4, base_env=_env(),
                      timeout=240)
    recs = [json.load(open(f"{out}.{r}")) for r in range(4)]
    db = quest_generator(n_transactions=300, avg_transaction_len=8,
                         n_items=50, n_patterns=30, seed=3)
    clean = JMiner(min_support=0.05, runner=JSim(structure="trie")).mine(db)
    want = sorted([list(s), int(c)] for s, c in clean.itemsets.items())
    for rec in recs:
        assert rec["injected"] == ["device_loss"]
    assert recs[2] == {"lost": True, "k": 3, "injected": ["device_loss"]}
    assert recs[3] == recs[2]
    for rec in recs[:2]:
        assert rec["itemsets"] == want
        # Two survivors: cand keeps the largest power of two <= sqrt(2)
        # that divides 2, which is 1, so the grid is 2x1.
        assert rec["mesh"] == [[0], [1]]
        assert rec["describe"] == "sharded/packed_bitmap/c1"
        assert rec["levels"] == [p.k for p in clean.levels]


# -- the sharded service ---------------------------------------------------------

PROGRAMS = {"host": {"store": "perfect_hash"},
            "ladder": {"store": "packed_bitmap", "device_loop": True}}

_SERVE_CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import ctx
ctx.initialize_multihost(device="cpu", timeout=120)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.serve import MiningService

spec = json.loads(sys.argv[1])
svc = MiningService(min_support=0.06, mesh=make_data_mesh(device="cpu"),
                    n_slots=4, slot_size=32, staleness=0.5, max_k=6,
                    compact_churn=0, **spec["options"])
answers = []
for batch in spec["batches"]:
    svc.ingest(batch)
    res = svc.query()
    answers.append([sorted([list(s), c] for s, c in res.itemsets.items()),
                    res.n_transactions, res.refreshed, res.stale_reason])
st = svc.stats()
svc.close()
if ctx.process_index() == 0:
    with open(spec["out"], "w") as f:
        json.dump({"answers": answers, "describe": svc.runner.describe(),
                   "refreshes": st["refreshes"],
                   "delta_jobs": st["delta_jobs"]}, f)
from repro_torch.launch.multihost import exit_rank
exit_rank()
"""


def _batches(rng, n_batches, size, n_items=36, max_len=7):
    """Seeded arrival batches of unique-sorted baskets (``test_serve.py``)."""
    return [[sorted(set(rng.integers(0, n_items,
                                     size=rng.integers(2, max_len)).tolist()))
             for _ in range(size)] for _ in range(n_batches)]


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_sharded_service_matches_reference(tmp_path, program):
    batches = _batches(np.random.default_rng(5), 5, 48)
    options = PROGRAMS[program]
    path = str(tmp_path / "serve.json")
    spec = {"batches": batches, "out": path, "options": options}
    mh.launch_cluster([sys.executable, "-c", _SERVE_CHILD, json.dumps(spec)],
                      2, base_env=_env(), timeout=240)
    got = json.load(open(path))
    runner = JSharded(store=options["store"],
                      mesh=compat_make_mesh((1,), ("data",)))
    svc = JService(min_support=0.06, runner=runner, n_slots=4, slot_size=32,
                   staleness=0.5, max_k=6, compact_churn=0,
                   device_loop=options.get("device_loop", False))
    want = []
    for batch in batches:
        svc.ingest(batch)
        res = svc.query()
        want.append([sorted([list(s), int(c)] for s, c in res.itemsets.items()),
                     res.n_transactions, res.refreshed, res.stale_reason])
    st = svc.stats()
    svc.close()
    assert got["answers"] == want
    assert got["describe"] == f"sharded/{options['store']}"
    assert (got["refreshes"], got["delta_jobs"]) == (st["refreshes"],
                                                     st["delta_jobs"])
