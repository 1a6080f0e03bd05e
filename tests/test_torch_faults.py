"""PyTorch port vs JAX package: fault injection, Hadoop-style task recovery
and device-loss resume from level checkpoints.

Each program of ``test_faults.py`` runs through both packages; the outcomes
(itemsets AND supports, which faults fired, the recovery telemetry, the
snapshots left behind, the error raised) must be identical.  The one oracle
everywhere: a faulted run's itemsets AND supports equal the fault-free
run's.  The snapshot store's own programs are in ``test_torch_checkpoint.py``.
"""

import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as j_core  # noqa: E402
import repro.core.runtime as j_rt  # noqa: E402
from repro.core.runtime import faults as j_faults  # noqa: E402
from repro.data import quest_generator  # noqa: E402
from repro.distributed import checkpoint as j_ckpt  # noqa: E402

import repro_torch.core as t_core  # noqa: E402
import repro_torch.core.runtime as t_rt  # noqa: E402
from repro_torch.core.runtime import faults as t_faults  # noqa: E402
from repro_torch.core.runtime.runners import TorchRunner  # noqa: E402
from repro_torch.distributed import checkpoint as t_ckpt  # noqa: E402
from test_torch_stores import cpu_mesh  # noqa: E402,F401

MIN_SUPPORT = 0.05


def _pkg(core, rt, faults, ckpt, device_runner):
    return types.SimpleNamespace(
        Miner=core.FrequentItemsetMiner, SimRunner=rt.SimRunner,
        FaultPlan=rt.FaultPlan, FaultSpec=rt.FaultSpec,
        RetryPolicy=rt.RetryPolicy, JobFailedError=rt.JobFailedError,
        DeviceLostError=rt.DeviceLostError, F=faults, ckpt=ckpt,
        device_runner=device_runner)


PKGS = {
    "repro": _pkg(j_core, j_rt, j_faults, j_ckpt,
                  lambda **kw: j_rt.JaxRunner(**kw)),
    "repro_torch": _pkg(t_core, t_rt, t_faults, t_ckpt,
                        lambda **kw: TorchRunner(device="cpu", **kw)),
}


@pytest.fixture(scope="module")
def db():
    """Mines to k=6: enough levels for multi-snapshot fallback stories."""
    return quest_generator(n_transactions=300, avg_transaction_len=8,
                           n_items=50, n_patterns=30, seed=3)


@pytest.fixture(scope="module")
def clean(db):
    return j_core.FrequentItemsetMiner(
        min_support=MIN_SUPPORT,
        runner=j_rt.SimRunner(structure="trie")).mine(db)


def _both(program):
    """``program(pkg)`` through each package -> {package name: outcome}."""
    return {name: program(pkg) for name, pkg in PKGS.items()}


def _same(program):
    out = _both(program)
    assert out["repro_torch"] == out["repro"], out
    return out["repro"]


def _counting(pkg):
    class JobCountingRunner(pkg.SimRunner):
        """SimRunner that counts how many Job1/Job2 executions ran — the
        observable difference between a resumed and a from-scratch mine."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.jobs_run = 0

        def job1(self):
            self.jobs_run += 1
            return super().job1()

        def count(self, job):
            self.jobs_run += 1
            return super().count(job)

    return JobCountingRunner


# -- FaultPlan: deterministic, addressable, consumable ----------------------

def test_fault_plan_addressing_and_consumption():
    def program(p):
        plan = p.FaultPlan(p.F.crash(k=2, slot=1),
                           p.F.corrupt(k=3, slot=0, times=2))
        calls = [(2, 0, 0), (2, 1, 1), (2, 1, 0), (2, 1, 0),
                 (3, 0, 0), (3, 0, 0), (3, 0, 0)]
        acts = [plan.mapper_action(k=k, slot=s, attempt=a)
                for k, s, a in calls]
        return ([None if a is None else dataclasses.astuple(a) for a in acts],
                plan.exhausted, plan.injected)

    acts, exhausted, injected = _same(program)
    assert [a and a[0] for a in acts] == [None, None, "crash", None, "corrupt",
                                          "corrupt", None]
    assert exhausted and len(injected) == 3


def test_fault_plan_wildcards_match_any_address():
    def program(p):
        plan = p.FaultPlan(p.F.crash(attempt=None, times=3))
        return [plan.mapper_action(k=k, slot=s, attempt=a) is not None
                for k, s, a in [(1, 0, 0), (5, 3, 2), (2, 1, 1), (1, 0, 0)]]

    assert _same(program) == [True, True, True, False]


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_chaos_is_reproducible_across_packages(seed):
    def program(p):
        plan = p.FaultPlan.chaos(n_faults=5, seed=seed)
        again = p.FaultPlan.chaos(n_faults=5, seed=seed)
        assert plan.specs == again.specs
        assert all(s.k is not None and s.slot is not None and s.attempt == 0
                   for s in plan.specs)
        return [dataclasses.astuple(s) for s in plan.specs]

    specs = _same(program)
    assert specs != _same(lambda p: [dataclasses.astuple(s) for s in
                                     p.FaultPlan.chaos(5, seed=seed + 1).specs])


def test_fault_spec_rejects_unknown_kind_and_stages():
    def program(p):
        with pytest.raises(ValueError, match="unknown fault kind"):
            p.FaultSpec("meteor")
        plan = p.FaultPlan(p.F.torn_write(step=2, tensor=0),
                           p.F.kill_commit(step=3), p.F.bitrot(step=4, tensor=1),
                           p.F.process_exit(k=3, process=1))
        out = [plan.checkpoint_action(step=1, tensor=0, stage="tensor"),
               plan.checkpoint_action(step=2, tensor=0, stage="tensor"),
               plan.checkpoint_action(step=3, stage="commit"),
               plan.checkpoint_action(step=4, stage="committed"),
               plan.process_exit(k=2, process=1),
               plan.process_exit(k=3, process=0),
               plan.process_exit(k=3, process=1),
               plan.process_exit(k=3, process=1)]
        with pytest.raises(ValueError):
            plan.checkpoint_action(step=1, stage="meteor")
        return [None if s is None else dataclasses.astuple(s) for s in out]

    out = _same(program)
    assert [s and s[0] for s in out] == [None, "torn_write", "kill_commit",
                                         "bitrot", None, None, "process_exit",
                                         None]


def test_digests_and_corruption_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 40):
        partial = {tuple(sorted(rng.choice(30, 2, replace=False).tolist())):
                   int(rng.integers(1, 50)) for _ in range(n)}
        assert t_faults.partial_digest(partial) == \
            j_faults.partial_digest(partial)
        for seed in (0, 3):
            assert t_faults.corrupt_partial(partial, seed) == \
                j_faults.corrupt_partial(partial, seed)
    assert dataclasses.astuple(t_faults.RetryPolicy()) == \
        dataclasses.astuple(j_faults.RetryPolicy())
    assert t_faults.process_rank() == 0  # no process group


# -- task recovery: retry parity across executors ---------------------------

def _mine_faulted(p, db, plan_of, retry, strategy="spc", max_k=16,
                  **runner_kw):
    plan = plan_of(p)
    with p.SimRunner(fault_plan=plan, retry=retry(p), **runner_kw) as runner:
        res = p.Miner(min_support=MIN_SUPPORT, strategy=strategy,
                      max_k=max_k, runner=runner).mine(db)
    return res, plan


def _fast(p):
    return p.RetryPolicy(backoff=0.001)


@pytest.mark.parametrize("executor", [None, "thread", "process"])
def test_crash_and_corruption_retry_parity(db, clean, executor):
    def program(p):
        res, plan = _mine_faulted(
            p, db, lambda p: p.FaultPlan(p.F.crash(k=2, slot=0),
                                         p.F.corrupt(k=3, slot=1),
                                         p.F.crash(k=1, slot=2)),
            _fast, structure="trie", executor=executor)
        assert sum(q.backoff_seconds for q in res.levels) > 0
        return (res.itemsets, sorted(map(str, plan.injected)),
                [q.retries for q in res.levels])

    itemsets, injected, retries = _same(program)
    assert itemsets == clean.itemsets
    assert len(injected) == 3 and sum(retries) == 3


@pytest.mark.parametrize("strategy", ["fpc", "dpc"])
def test_retry_parity_through_combined_strategies(db, clean, strategy):
    """Combined (multi-wave) jobs aggregate retry telemetry and stay exact.
    Cut at k = 4: uncut, one DPC wave builds a 284,240-row hash tree."""
    def program(p):
        res, plan = _mine_faulted(
            p, db, lambda p: p.FaultPlan(p.F.crash(k=2, slot=0),
                                         p.F.corrupt(k=3, slot=0)),
            _fast, structure="hash_tree", executor="thread",
            strategy=strategy, max_k=4)
        return res.itemsets, len(plan.injected), sum(
            q.retries for q in res.levels)

    itemsets, injected, retries = _same(program)
    assert itemsets == {s: c for s, c in clean.itemsets.items()
                        if len(s) <= 4}
    assert retries == injected >= 1


def test_chaos_plan_parity(db, clean):
    def program(p):
        res, plan = _mine_faulted(
            p, db, lambda p: p.FaultPlan.chaos(n_faults=5, seed=11, max_k=4),
            _fast, structure="trie", executor="thread")
        return res.itemsets, sorted(map(str, plan.injected))

    itemsets, _ = _same(program)
    assert itemsets == clean.itemsets


# -- speculative execution of stragglers ------------------------------------

@pytest.mark.parametrize("executor", [None, "thread"])
def test_straggler_speculation(db, clean, executor):
    """Pooled: a hung attempt is raced by a backup whose result wins.
    Sequential: the simulated cluster waits out the timeout window instead
    of the full hang.  Either way counts stay exact."""
    delay, timeout = (5.0, 0.05) if executor is None else (2.0, 0.15)

    def program(p):
        res, plan = _mine_faulted(
            p, db, lambda p: p.FaultPlan(p.F.hang(delay=delay, k=2, slot=1)),
            lambda p: p.RetryPolicy(backoff=0.001, timeout=timeout),
            structure="trie", executor=executor)
        k2 = next(q for q in res.levels if q.k == 2)
        assert k2.seconds < delay
        return (res.itemsets,
                sum(q.speculative_launches for q in res.levels) >= 1,
                sum(q.speculative_wins for q in res.levels) >= 1)

    assert _same(program) == (clean.itemsets, True, True)


# -- retry exhaustion and pool lifecycle ------------------------------------

@pytest.mark.parametrize("executor", [None, "thread"])
def test_retry_exhaustion_raises_job_failed(db, executor):
    def program(p):
        runner = p.SimRunner(
            structure="trie", executor=executor,
            fault_plan=p.FaultPlan(p.F.crash(k=2, slot=0, attempt=None,
                                             times=10)),
            retry=p.RetryPolicy(max_attempts=2, backoff=0.001))
        with pytest.raises(p.JobFailedError, match="slot 0") as err:
            p.Miner(min_support=MIN_SUPPORT, runner=runner).mine(db)
        return str(err.value), runner._pool is None

    assert _same(program)[1]


def test_retry_disabled_fast_path_propagates_crash(db):
    def program(p):
        runner = p.SimRunner(structure="trie", executor="thread",
                             fault_plan=p.FaultPlan(p.F.crash(k=2, slot=0)),
                             retry=None)
        with pytest.raises(p.F.MapperCrashError):
            p.Miner(min_support=MIN_SUPPORT, runner=runner).mine(db)
        return runner._pool is None

    assert _same(program)


def test_context_manager_closes_pool(db):
    def program(p):
        with p.SimRunner(structure="trie", executor="thread") as runner:
            p.Miner(min_support=MIN_SUPPORT, runner=runner).mine(db)
            opened = runner._pool is not None
        return opened, runner._pool is None

    assert _same(program) == (True, True)


# -- device loss on the engine-backed runners -------------------------------

@pytest.mark.parametrize("device_loop", [False, True])
def test_device_loss_then_resume(tmp_path, db, clean, device_loop):
    """``device_loss`` at the level-3 dispatch (``count_async`` on the host
    loop, ``_check_fault`` on the ladder) abandons the engine's work and
    propagates: one device has no smaller mesh.  The level-2 snapshot
    (step 3: a snapshot is keyed by the next level) exists in both
    packages; a fault-free runner on the same directory resumes without
    Job1 and finishes with the clean answer."""
    store = "bitmap" if device_loop else "packed_bitmap"

    def program(p):
        d = tmp_path / p.Miner.__module__.split(".")[0]
        plan = p.FaultPlan(p.F.device_loss(k=3))
        runner = p.device_runner(store=store, fault_plan=plan)
        with pytest.raises(p.DeviceLostError) as err:
            p.Miner(min_support=MIN_SUPPORT, runner=runner,
                    device_loop=device_loop, checkpoint_dir=str(d)).mine(db)
        assert not runner.engine._queue  # abandoned
        snaps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        fresh = p.device_runner(store=store)
        res = p.Miner(min_support=MIN_SUPPORT, runner=fresh,
                      device_loop=device_loop,
                      checkpoint_dir=str(d)).mine(db)
        return (err.value.k, err.value.lost, plan.injected, snaps,
                res.itemsets, [(q.k, q.n_candidates, q.n_frequent)
                               for q in res.levels])

    k, lost, injected, snaps, itemsets, _ = _same(program)
    assert (k, lost) == (3, 1) and len(injected) == 1
    assert snaps == ["step_00000003"]  # keyed by the next level
    assert itemsets == clean.itemsets


def test_torch_resume_skips_job1_and_counts_from_the_loss(tmp_path, db,
                                                          clean):
    plan = t_faults.FaultPlan(t_faults.device_loss(k=4))
    with pytest.raises(t_rt.DeviceLostError):
        t_core.FrequentItemsetMiner(
            min_support=MIN_SUPPORT, checkpoint_dir=str(tmp_path),
            runner=TorchRunner(store="packed_bitmap", device="cpu",
                               fault_plan=plan)).mine(db)
    runner = TorchRunner(store="packed_bitmap", device="cpu")
    seen = []
    runner.job1 = lambda: seen.append(1) or pytest.fail("job1 re-ran")
    runner.count_async = (lambda job, orig=runner.count_async:
                          seen.append(job.k) or orig(job))
    res = t_core.FrequentItemsetMiner(
        min_support=MIN_SUPPORT, runner=runner,
        checkpoint_dir=str(tmp_path)).mine(db)
    assert res.itemsets == clean.itemsets
    assert seen[0] == 4 and min(seen) == 4
    assert [p.k for p in res.levels] == [p.k for p in clean.levels]


def test_device_loss_budget_and_make_runner(db, cpu_mesh):
    """More losses than the budget allows, or a budget of 0: the run dies
    loudly in both packages; ``make_runner`` takes the plan."""
    def program(p):
        runner = p.device_runner(store="perfect_hash",
                                 fault_plan=p.FaultPlan(
                                     p.F.device_loss(k=2, times=10)))
        with pytest.raises(p.DeviceLostError):
            p.Miner(min_support=MIN_SUPPORT, runner=runner,
                    elastic_restarts=0).mine(db)
        return True

    assert _same(program)
    plan = t_faults.FaultPlan(t_faults.device_loss(k=2))
    assert t_rt.make_runner(fault_plan=plan, device="cpu").fault_plan is plan
    # Candidate axes mean the sharded runner, on a data x cand mesh it
    # builds over the world (one rank here), and it takes the plan too.
    sharded = t_rt.make_runner(cand_axes=("cand",), device="cpu",
                               fault_plan=plan)
    assert isinstance(sharded, t_rt.ShardedRunner)
    assert sharded.fault_plan is plan
    assert sharded.describe() == "sharded/perfect_hash/c1"
    assert sharded.engine.mesh.mesh_dim_names == ("data", "cand")


# -- checkpoint config stamping ---------------------------------------------

def test_config_signature_excludes_elastic_geometry():
    def program(p):
        sim = p.SimRunner(structure="trie").config_signature()
        assert sim == p.SimRunner(structure="trie", n_mappers=8,
                                  executor="thread").config_signature()
        assert sim != p.SimRunner(structure="hash_tree").config_signature()
        a = p.device_runner(store="perfect_hash").config_signature()
        b = p.device_runner(store="packed_bitmap").config_signature()
        assert a != b and a != sim
        assert a == p.device_runner(store="perfect_hash", block_n=64,
                                    cand_block=128).config_signature()
        return sim

    assert _same(program) == "sim/trie"
    assert TorchRunner(store="bitmap", block_n=64,
                       device="cpu").config_signature() == "torch/bitmap"


def test_miner_resumes_across_mapper_count_change(tmp_path, db, clean):
    def program(p):
        d = str(tmp_path / p.Miner.__module__.split(".")[0])
        p.Miner(min_support=MIN_SUPPORT,
                runner=p.SimRunner(structure="trie", n_mappers=3),
                checkpoint_dir=d).mine(db)
        runner = _counting(p)(structure="trie", n_mappers=6)
        res = p.Miner(min_support=MIN_SUPPORT, runner=runner,
                      checkpoint_dir=d).mine(db)
        return res.itemsets, runner.jobs_run

    assert _same(program) == (clean.itemsets, 0)


def test_miner_rejects_cross_structure_resume(tmp_path, db, clean):
    def program(p):
        d = str(tmp_path / p.Miner.__module__.split(".")[0])
        p.Miner(min_support=MIN_SUPPORT, runner=p.SimRunner(structure="trie"),
                checkpoint_dir=d).mine(db)
        runner = _counting(p)(structure="hash_tree")
        res = p.Miner(min_support=MIN_SUPPORT, runner=runner,
                      checkpoint_dir=d).mine(db)
        return res.itemsets, runner.jobs_run

    assert _same(program) == (clean.itemsets, len(clean.levels))


def test_miner_rejects_mixed_backend_config():
    def program(p):
        with pytest.raises(ValueError, match="not both"):
            p.Miner(runner=p.SimRunner(), store="bitmap")
        with pytest.raises(ValueError, match="not both"):
            p.Miner(runner=p.SimRunner(), inflight=2)
        return True

    assert _same(program)
