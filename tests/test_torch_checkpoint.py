"""PyTorch port vs JAX package: the crash-safe snapshot store under the
level checkpoints.

The corruption sweep, bit rot, torn writes, stale ``.tmp`` sweeping, an
unpointed snapshot and the kill -9 cases of ``test_faults.py`` run through
both packages with identical outcomes; a snapshot written by either package
loads in the other, and so do the miner's level checkpoints.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
from repro.distributed import checkpoint as j_ckpt  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner  # noqa: E402
from repro_torch.distributed import checkpoint as t_ckpt  # noqa: E402
from test_torch_faults import (  # noqa: E402,F401
    MIN_SUPPORT,
    PKGS,
    _counting,
    _same,
    clean,
    db,
)


# -- crash-safe self-validating checkpoints ---------------------------------

def _two_snapshots(ckpt, d):
    ckpt.save(str(d), 1, {"x": np.arange(4, dtype=np.int64)},
              extra={"tag": "one"})
    ckpt.save(str(d), 2, {"x": np.arange(8, dtype=np.int64)},
              extra={"tag": "two"})


def _flip_mid_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _truncate_half(path):
    with open(path, "r+b") as f:
        f.truncate(max(0, os.path.getsize(path) // 2))


CORRUPTIONS = {
    "tensor-flip": ("step_00000002/t00000.npy", _flip_mid_byte),
    "tensor-truncate": ("step_00000002/t00000.npy", _truncate_half),
    "manifest-truncate": ("step_00000002/manifest.json", _truncate_half),
    "manifest-flip": ("step_00000002/manifest.json", _flip_mid_byte),
    "latest-dangling": ("LATEST",
                        lambda p: open(p, "w").write("step_99999999")),
    "latest-truncate": ("LATEST", _truncate_half),
}


def _load_outcome(ckpt, d):
    try:
        out = ckpt.load(str(d))
    except ckpt.CheckpointCorruptError:
        return "corrupt", sorted(os.listdir(d))
    tensors, step, extra = out
    return (step, extra["tag"], tensors["x"].tolist(), sorted(os.listdir(d)))


@pytest.mark.parametrize("mode", list(CORRUPTIONS))
def test_corruption_falls_back_or_fails_loud(tmp_path, mode):
    """Damage every file class of a snapshot, then restore: the same
    fallback (or the same loud failure) in both packages, whichever package
    wrote the snapshots."""
    rel, mutate = CORRUPTIONS[mode]
    outcomes = {}
    for writer in PKGS:
        for reader in PKGS:
            d = tmp_path / f"{writer}-{reader}"
            _two_snapshots(PKGS[writer].ckpt, d)
            mutate(str(d / rel))
            outcomes[writer, reader] = _load_outcome(PKGS[reader].ckpt, d)
    assert len(set(map(repr, outcomes.values()))) == 1, outcomes
    out = outcomes["repro", "repro"]
    if mode.startswith(("tensor", "manifest")):
        assert out[:3] == (1, "one", list(range(4)))  # fell back
        assert "step_00000002.corrupt" in out[3]


def test_all_snapshots_corrupt_raises(tmp_path):
    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        _two_snapshots(p.ckpt, d)
        _flip_mid_byte(str(d / "step_00000001/t00000.npy"))
        _flip_mid_byte(str(d / "step_00000002/t00000.npy"))
        with pytest.raises(p.ckpt.CheckpointCorruptError):
            p.ckpt.load(str(d))
        return sorted(os.listdir(d))

    _same(program)


def test_bitrot_injection_detected_on_restore(tmp_path):
    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        plan = p.FaultPlan(p.F.bitrot(step=2, tensor=0))
        p.ckpt.save(str(d), 1, {"x": np.arange(4)}, extra={"tag": "one"})
        p.ckpt.save(str(d), 2, {"x": np.arange(8)}, extra={"tag": "two"},
                    fault_plan=plan)
        _, step, extra = p.ckpt.load(str(d))
        return step, extra["tag"], (d / "step_00000002.corrupt").exists()

    assert _same(program) == (1, "one", True)


def test_torn_write_never_commits(tmp_path):
    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        p.ckpt.save(str(d), 1, {"x": np.arange(4)}, extra={"tag": "one"})
        plan = p.FaultPlan(p.F.torn_write(step=2, tensor=0))
        with pytest.raises(p.ckpt.TornWriteError):
            p.ckpt.save(str(d), 2, {"x": np.arange(8)}, fault_plan=plan)
        torn = ((d / "step_00000002").exists(),
                (d / "step_00000002.tmp").exists())
        step = p.ckpt.latest_valid_step(str(d))
        return torn, step, (d / "step_00000002.tmp").exists()

    assert _same(program) == ((False, True), 1, False)


def test_stale_tmp_gc_on_restore(tmp_path):
    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        _two_snapshots(p.ckpt, d)
        (d / "step_00000099.tmp").mkdir()
        (d / "step_00000001.corrupt").mkdir()
        return p.ckpt.latest_valid_step(str(d)), sorted(os.listdir(d))

    step, left = _same(program)
    assert step == 2 and not any(n.endswith((".tmp", ".corrupt"))
                                 for n in left)


def test_unpointed_snapshot_counts_as_restorable(tmp_path):
    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        _two_snapshots(p.ckpt, d)
        p.ckpt.save(str(d), 3, {"x": np.arange(2)}, extra={"tag": "three"})
        (d / "LATEST").write_text("step_00000002")  # rewind the pointer
        pointed = p.ckpt.latest_valid_step(str(d))
        (d / "LATEST").unlink()
        return pointed, p.ckpt.latest_valid_step(str(d)), p.ckpt.latest_step(
            str(d))

    assert _same(program) == (2, 3, None)


def test_snapshots_cross_packages(tmp_path):
    """A snapshot written by either package loads through the other's
    ``load``, byte-identical layout included; the port's ``restore`` gives
    torch tensors in the tree's structure."""
    tree = {"b": [np.arange(3, dtype=np.int32), np.ones((2, 2), np.float32)],
            "a": {"z": np.int64(7), "y": np.arange(6, dtype=np.int64)}}
    j_ckpt.save(str(tmp_path / "j"), 4, tree, extra={"tag": "jax"})
    t_ckpt.save(str(tmp_path / "t"), 4, tree, extra={"tag": "torch"})
    for d, tag in (("j", "jax"), ("t", "torch")):
        for ckpt in (j_ckpt, t_ckpt):
            arrays, step, extra = ckpt.load(str(tmp_path / d))
            assert step == 4 and extra["tag"] == tag
            assert sorted(arrays) == ["a/y", "a/z", "b/0", "b/1"]
            np.testing.assert_array_equal(arrays["b/1"], tree["b"][1])
    names = sorted(os.listdir(tmp_path / "j" / "step_00000004"))
    assert names == sorted(os.listdir(tmp_path / "t" / "step_00000004"))
    for name in names:
        if name.endswith(".npy"):
            assert (tmp_path / "j" / "step_00000004" / name).read_bytes() == \
                (tmp_path / "t" / "step_00000004" / name).read_bytes()
    like = {"a": {"y": torch.zeros(6, dtype=torch.int64),
                  "z": torch.zeros((), dtype=torch.int64)},
            "b": [torch.zeros(3, dtype=torch.int32),
                  torch.zeros((2, 2), dtype=torch.float32)]}
    got, step, _ = t_ckpt.restore(str(tmp_path / "j"), like, device="cpu")
    assert step == 4 and list(got) == ["a", "b"]
    assert isinstance(got["b"][1], torch.Tensor)
    assert got["b"][1].dtype == torch.float32
    assert got["a"]["y"].tolist() == list(range(6)) and int(got["a"]["z"]) == 7
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.restore(str(tmp_path / "j"),
                       {"a": {"y": torch.zeros(5), "z": torch.zeros(())},
                        "b": like["b"]}, device="cpu")
    # Tensors on the way in, bfloat16 included: a torch tree saves and
    # restores exactly, and the reference reads the same values.
    tree_t = {"w": torch.linspace(-3, 3, 7).to(torch.bfloat16),
              "b": [torch.arange(5, dtype=torch.int32)]}
    t_ckpt.save(str(tmp_path / "tt"), 1, tree_t, extra={})
    back, _, _ = t_ckpt.restore(str(tmp_path / "tt"), tree_t, device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tree_t["w"])
    assert torch.equal(back["b"][0], tree_t["b"][0])
    ref = j_ckpt.load(str(tmp_path / "tt"))[0]
    np.testing.assert_array_equal(ref["w"].astype(np.float32),
                                  tree_t["w"].float().numpy())


def test_miner_checkpoints_resume_across_packages(tmp_path, db, clean):
    """The miner's level snapshots (a ``sim/trie`` stamp in both packages)
    written by one package resume a mine in the other with no job re-run."""
    for writer, reader in (("repro", "repro_torch"), ("repro_torch", "repro")):
        d = str(tmp_path / writer)
        w, r = PKGS[writer], PKGS[reader]
        w.Miner(min_support=MIN_SUPPORT, runner=w.SimRunner(structure="trie"),
                checkpoint_dir=d).mine(db)
        runner = _counting(r)(structure="trie")
        res = r.Miner(min_support=MIN_SUPPORT, runner=runner,
                      checkpoint_dir=d).mine(db)
        assert res.itemsets == clean.itemsets
        assert runner.jobs_run == 0
        assert [dataclasses.astuple(p)[:3] for p in res.levels] == \
            [dataclasses.astuple(p)[:3] for p in clean.levels]


# -- kill -9 mid-save and process exit: the real process-death tests --------

_KILL_CHILD = """
import sys
from repro_torch.core import FrequentItemsetMiner
from repro_torch.core.runtime import FaultPlan, SimRunner, TorchRunner
from repro_torch.core.runtime import faults as F
from repro_torch.data import quest_generator

ckpt_dir, kind, step = sys.argv[1], sys.argv[2], int(sys.argv[3])
db = quest_generator(n_transactions=300, avg_transaction_len=8,
                     n_items=50, n_patterns=30, seed=3)
if kind == "process_exit":
    runner = TorchRunner(store="perfect_hash", device="cpu",
                         fault_plan=FaultPlan(F.process_exit(k=step)))
else:
    spec = F.kill_write(step=step) if kind == "kill_write" else \\
        F.kill_commit(step=step)
    runner = SimRunner(structure="trie", fault_plan=FaultPlan(spec))
FrequentItemsetMiner(min_support=0.05, runner=runner,
                     checkpoint_dir=ckpt_dir).mine(db)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "repro.")) or m == "repro")
print("FINISHED", loaded)
"""


def _port_env():
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    return dict(os.environ, PYTHONPATH=src)


@pytest.mark.parametrize("kind", ["kill_write", "kill_commit", "process_exit"])
def test_kill9_mid_save_leaves_restorable_state(tmp_path, db, clean, kind):
    """A child importing only ``repro_torch`` dies with ``os._exit(137)``:
    while writing a tensor, after the snapshot rename but before the
    pointer update, or (``process_exit``) at the level-5 job dispatch.  The
    parent restores from what is on disk and finishes with the fault-free
    itemsets AND supports, running fewer jobs than a fresh mine."""
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path), kind, "5"],
        env=_port_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 137, proc.stdout[-2000:] + proc.stderr[-2000:]
    if kind == "kill_write":
        assert (tmp_path / "step_00000005.tmp").exists()
        assert not (tmp_path / "step_00000005").exists()
    elif kind == "kill_commit":
        assert (tmp_path / "step_00000005").exists()
        assert (tmp_path / "LATEST").read_text().strip() != "step_00000005"
    else:
        assert (tmp_path / "LATEST").read_text().strip() == "step_00000005"
    if kind == "process_exit":
        runner = TorchRunner(store="perfect_hash", device="cpu")
        jobs = []
        runner.job1 = lambda orig=runner.job1: jobs.append(1) or orig()
        runner.count_async = (lambda job, orig=runner.count_async:
                              jobs.append(job.k) or orig(job))
    else:
        runner = _counting(PKGS["repro_torch"])(structure="trie")
    res = t_core.FrequentItemsetMiner(
        min_support=MIN_SUPPORT, runner=runner,
        checkpoint_dir=str(tmp_path)).mine(db)
    assert res.itemsets == clean.itemsets
    n_jobs = len(jobs) if kind == "process_exit" else runner.jobs_run
    assert 0 < n_jobs < len(clean.levels)
