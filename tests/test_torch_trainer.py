"""The port's fault-tolerant trainer on the CPU: resume, NaN rollback,
preemption snapshot and straggler flags (``tests/test_trainer.py`` on
``repro_torch``), the launcher, the refusals, and a 3-step loss curve held
to the reference ``Trainer`` from the same float32 state (relative error
< 1e-4 per step)."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import materialize as j_materialize  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_reference, params_from_reference)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    StragglerMonitor, Trainer, TrainerConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("qwen2-1.5b")
    pipe = SyntheticLM(cfg.vocab_size, 2, 32, seed=1)
    return cfg, pipe


def make(cfg, pipe, ocfg, **tkw):
    return Trainer(cfg, ocfg, TrainerConfig(**tkw), pipe.iterator,
                   device="cpu")


def test_resume_from_checkpoint(tmp_path, setup):
    cfg, pipe = setup
    d = str(tmp_path)
    ocfg = OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    r1 = make(cfg, pipe, ocfg, total_steps=4, ckpt_every=2, ckpt_dir=d).run()
    assert r1["final_step"] == 4
    assert ckpt.latest_step(d) == 4
    t2 = make(cfg, pipe, ocfg, total_steps=8, ckpt_every=2, ckpt_dir=d)
    assert t2.try_restore() and t2.step == 4
    # restored leaves are armed again: the next step takes gradients
    assert all(p.requires_grad for p in tree_leaves(t2.params))
    r2 = t2.run()
    assert r2["final_step"] == 8
    assert [rec["step"] for rec in r2["log"]] == [5, 6, 7, 8]
    # training actually progressed (loss decreasing overall)
    assert r2["final_loss"] < r1["log"][0]["loss"]


def test_resumed_run_equals_uninterrupted_run(tmp_path, setup):
    """4 steps, a restart, 4 more: the same losses as 8 steps in one go."""
    cfg, pipe = setup
    ocfg = OptConfig(lr=1e-3, total_steps=8, warmup_steps=2)
    whole = make(cfg, pipe, ocfg, total_steps=8, ckpt_every=4).run()
    d = str(tmp_path)
    make(cfg, pipe, ocfg, total_steps=4, ckpt_every=4, ckpt_dir=d).run()
    rest = make(cfg, pipe, ocfg, total_steps=8, ckpt_every=4, ckpt_dir=d).run()
    assert [r["loss"] for r in rest["log"]] == [r["loss"]
                                                 for r in whole["log"][4:]]


def test_nan_rollback(tmp_path, setup):
    cfg, pipe = setup
    d = str(tmp_path)
    ocfg = OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    trainer = make(cfg, pipe, ocfg, total_steps=4, ckpt_every=1, ckpt_dir=d)
    real_step = trainer.train_step
    poisoned = {"n": 0}

    def evil_step(p, o, b, s):
        p2, o2, m = real_step(p, o, b, s)  # updates p and o in place
        if int(s) == 2 and poisoned["n"] == 0:
            poisoned["n"] += 1
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
        return p2, o2, m

    trainer.train_step = evil_step
    real_factory = trainer.data_iter_factory
    after = {}

    def factory(start):
        if start == 3:  # called right after the rollback: step 2 + 1 skip
            snap, _, _ = ckpt.restore(d, trainer._state_tree(), device="cpu")
            after["same"] = all(
                torch.equal(a.detach(), b) for a, b in zip(
                    tree_leaves(trainer._state_tree()), tree_leaves(snap)))
            after["armed"] = all(p.requires_grad
                                 for p in tree_leaves(trainer.params))
        return real_factory(start)

    trainer.data_iter_factory = factory
    res = trainer.run()
    assert res["final_step"] == 4
    assert np.isfinite(res["final_loss"])
    assert poisoned["n"] == 1  # the bad step was retried past
    # the poisoned step's in-place update left no trace
    assert after == {"same": True, "armed": True}


def test_nan_without_snapshots_raises(setup):
    cfg, pipe = setup
    trainer = make(cfg, pipe, OptConfig(total_steps=4), total_steps=4)
    real_step = trainer.train_step

    def evil_step(p, o, b, s):
        p2, o2, m = real_step(p, o, b, s)
        return p2, o2, dict(m, loss=torch.tensor(float("inf")))

    trainer.train_step = evil_step
    with pytest.raises(FloatingPointError, match="step 0"):
        trainer.run()


def test_preemption_snapshot(tmp_path, setup):
    cfg, pipe = setup
    d = str(tmp_path)
    ocfg = OptConfig(lr=1e-3, total_steps=100, warmup_steps=2)
    res = make(cfg, pipe, ocfg, total_steps=100, ckpt_every=50, ckpt_dir=d,
               max_seconds=1e-9).run()  # preempt immediately after 1 step
    assert res["final_step"] == 1
    assert ckpt.latest_step(d) == res["final_step"]


def test_zero_max_seconds_never_preempts(tmp_path, setup):
    """``max_seconds`` is tested for truth, as in the reference: 0 runs
    every step."""
    cfg, pipe = setup
    d = str(tmp_path)
    ocfg = OptConfig(lr=1e-3, total_steps=3, warmup_steps=1)
    res = make(cfg, pipe, ocfg, total_steps=3, ckpt_every=50, ckpt_dir=d,
               max_seconds=0.0).run()
    assert res["final_step"] == 3
    assert ckpt.latest_step(d) == 3


def test_straggler_monitor():
    mon = StragglerMonitor(factor=2.0, window=10)
    for _ in range(8):
        assert not mon.record(1.0)
    assert mon.record(5.0)       # 5x median flagged
    assert mon.flags == 1


def test_compressed_microbatched_trainer_runs(setup):
    cfg, pipe = setup
    pipe4 = SyntheticLM(cfg.vocab_size, 4, 32, seed=1)
    res = make(cfg, pipe4, OptConfig(lr=1e-3, total_steps=3),
               total_steps=3, microbatches=2, compress_grads=True).run()
    assert res["final_step"] == 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in res["log"])


# -- refusals and defaults ---------------------------------------------------------

def test_mesh_and_multi_pod_raise(setup):
    cfg, pipe = setup
    with pytest.raises(ValueError, match="mesh= and rules="):
        Trainer(cfg, OptConfig(), TrainerConfig(), pipe.iterator,
                mesh=object(), device="cpu")
    # One process is a world of one rank: the 2 x 16 x 16 grid fails.
    with pytest.raises(ValueError, match="pod 2 x data 16 x model 16 needs "
                                         "512 ranks but only 1 exist"):
        launch_train.main(["--arch", "qwen2-1.5b", "--multi-pod",
                           "--device", "cpu"])


def test_default_device_is_cuda(setup):
    """Without a card the trainer and the launcher raise; they never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg, pipe = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, OptConfig(), TrainerConfig(), pipe.iterator)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen2-1.5b", "--steps", "1"])


def test_launcher_runs_reduced_on_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", "gemma2-2b", "--device", "cpu",
                           "--reduced", "--steps", "3", "--batch", "2",
                           "--seq", "32", "--ckpt-dir", str(tmp_path),
                           "--ckpt-every", "2", "--compress-grads"])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["final_step"] == 3 and "log" not in summary
    assert np.isfinite(summary["final_loss"])
    assert summary["straggler_flags"] == 0
    assert ckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b",
                                  "recurrentgemma-2b", "mamba2-2.7b",
                                  "llama-3.2-vision-11b"])
def test_launcher_trains_every_mixer_arch_on_cpu(arch):
    """MLA, MoE, RG-LRU, SSD and cross-attention train through the
    launcher (the vision config on zero patch embeddings)."""
    out = io.StringIO()
    with redirect_stdout(out):
        launch_train.main(["--arch", arch, "--device", "cpu", "--reduced",
                           "--steps", "2", "--batch", "2", "--seq", "32"])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["final_step"] == 2 and np.isfinite(summary["final_loss"])


def test_example_runs_on_cpu(tmp_path, monkeypatch):
    """``examples/train_lm_torch.py``: gated, then mine, train with
    snapshots, generate."""
    import runpy

    path = os.path.join(ROOT, "examples", "train_lm_torch.py")
    monkeypatch.delenv("REPRO_LM", raising=False)
    monkeypatch.setattr(sys, "argv", [path])
    with pytest.raises(SystemExit) as gate:
        runpy.run_path(path, run_name="__main__")
    assert gate.value.code == 0
    monkeypatch.setenv("REPRO_LM", "1")
    if not torch.cuda.is_available():  # the default device is the card
        monkeypatch.setattr(sys, "argv", [path, "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runpy.run_path(path, run_name="__main__")
    monkeypatch.setattr(sys, "argv", [
        path, "--steps", "4", "--layers", "2", "--width", "64",
        "--vocab", "512", "--batch", "4", "--seq", "32",
        "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    text = out.getvalue()
    assert "frequent token-sets" in text and "trained 4 steps" in text
    assert "sample continuation:" in text
    assert ckpt.latest_step(str(tmp_path)) == 4


# -- against the reference Trainer ---------------------------------------------------

def test_loss_curve_matches_reference_trainer(tmp_path):
    """3 steps of both trainers from the same float32 parameters and
    optimizer state, on the same stream: every logged loss within 1e-4.
    The state and AdamW's eps are ``test_torch_train``'s, for its reasons
    (attention rescaled, eps 1e-5): from the reference's own init with
    eps 1e-8 the third losses differ by 1.7e-4."""
    from test_torch_train import EPS, rescale_attention

    jcfg, tcfg = j_reduced("qwen2-1.5b"), get_reduced("qwen2-1.5b")
    okw = dict(lr=1e-3, total_steps=3, warmup_steps=1, eps=EPS)
    tkw = dict(total_steps=3, ckpt_every=10)
    params = rescale_attention(jax.tree.map(np.array, j_materialize(
        jax.random.PRNGKey(0), JM.abstract_params(jcfg),
        dtype_override=jnp.float32)), jcfg)
    opt = jax.tree.map(np.zeros_like, {"m": params, "v": params})

    jt = JTrainer(jcfg, JOptConfig(**okw), JTrainerConfig(**tkw),
                  JSyntheticLM(jcfg.vocab_size, 2, 32, seed=3).iterator)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jax.tree.map(jnp.asarray, opt)
    want = [r["loss"] for r in jt.run()["log"]]

    tt = Trainer(tcfg, OptConfig(**okw), TrainerConfig(**tkw),
                 SyntheticLM(tcfg.vocab_size, 2, 32, seed=3).iterator,
                 device="cpu")
    tt.params = TM.trainable(params_from_reference(params, tcfg, "cpu"))
    tt.opt_state = opt_state_from_reference(opt, tcfg, "cpu")
    got = [r["loss"] for r in tt.run()["log"]]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)
    assert got[-1] < got[0]

