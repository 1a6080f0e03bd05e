"""Fault-tolerant training loop (PyTorch port of the JAX package's
``train/trainer.py``).

Behaviours, as in the reference:
  - resume-from-latest on start
  - periodic atomic snapshots (``repro_torch.distributed.checkpoint``)
    incl. the data-iterator position
  - NaN/inf loss guard: roll back to the last snapshot and skip the
    offending data window (the classic "bad batch" recovery); with no
    snapshot directory a non-finite loss raises ``FloatingPointError``
  - straggler monitor: per-step host wall times; steps slower than
    ``straggler_factor`` x median over a window are flagged
  - preemption hook: ``max_seconds`` triggers a final snapshot before exit,
    so restart loses at most one step.  The value is tested for truth, as
    in the reference: ``None`` and ``0`` never preempt

The train step updates the parameter and optimizer trees in place, so a
step whose loss is not finite has already written its update; the
rollback replaces both trees with the snapshot's, which leaves no trace of
it.  ``checkpoint.restore`` returns leaves that take no gradient:
``_adopt`` arms the parameters again after every resume and rollback.
Runs on ``device`` (default ``"cuda"``; raises without a card unless the
caller asks for ``"cpu"``).

On a mesh (``mesh=``, a ``DeviceMesh`` of ranks, and ``rules=``, a
``ShardingRules``) every rank builds the same trees from the same seed and
keeps its shards: parameters and optimizer state are DTensors placed by
``shardings``, the step runs under ``use_sharding``, snapshots gather the
trees whole (rank 0 writes) and resume and rollback place the snapshot
onto the current mesh, whatever mesh saved it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.ctx import use_sharding, whole
from repro_torch.models import model as M
from repro_torch.models.params import materialize, place
from repro_torch.models.params import shardings as mk_shardings
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step, opt_abstract_with_ef


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    compress_grads: bool = False
    straggler_factor: float = 2.0
    straggler_window: int = 20
    max_seconds: Optional[float] = None
    seed: int = 0


class StragglerMonitor:
    """Tracks per-step wall time; flags outliers vs the rolling median."""

    def __init__(self, factor: float, window: int):
        self.factor = factor
        self.window = window
        self.times: list = []
        self.flags = 0

    def record(self, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window :]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if seconds > self.factor * med:
                self.flags += 1
                return True
        return False


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        ocfg: OptConfig,
        tcfg: TrainerConfig,
        data_iter_factory: Callable[[int], Iterator[Dict]],
        mesh=None,
        rules=None,
        device="cuda",
    ):
        if (mesh is None) != (rules is None):
            raise ValueError("Trainer needs both mesh= and rules=, or neither")
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        self.data_iter_factory = data_iter_factory
        self.monitor = StragglerMonitor(tcfg.straggler_factor, tcfg.straggler_window)
        self.metrics_log: list = []

        abstract = M.abstract_params(cfg)
        opt_abstract = opt_abstract_with_ef(abstract, ocfg, tcfg.compress_grads)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.params = M.trainable(materialize(gen, abstract))
        self.opt_state = materialize(None, opt_abstract, device=self.device)
        self.placements = None
        if mesh is not None:
            self.placements = {
                "params": mk_shardings(abstract, mesh, rules.rules),
                "opt": mk_shardings(opt_abstract, mesh, rules.rules)}
            tree = place(self._state_tree(), mesh, self.placements)
            self.params = M.trainable(tree["params"])
            self.opt_state = tree["opt"]
        step_fn = make_train_step(cfg, ocfg, tcfg.microbatches,
                                  tcfg.compress_grads)

        def train_step(*args):
            with self._sharded():
                return step_fn(*args)

        self.train_step = train_step
        self.step = 0

    def _sharded(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_sharding(self.mesh, self.rules)

    # -- checkpointing ----------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self) -> None:
        if self.tcfg.ckpt_dir is None:
            return
        ckpt.save(self.tcfg.ckpt_dir, self.step, self._state_tree(),
                  extra={"data_pos": self.step})
        if self.mesh is not None:  # rank 0 wrote: no rank reads before it
            torch.distributed.barrier()

    def _restore(self):
        """The newest valid snapshot as (tree, step, extra), or None."""
        if self.tcfg.ckpt_dir is None:
            return None
        return ckpt.restore(self.tcfg.ckpt_dir, self._state_tree(),
                            device=self.device, shardings=self.placements,
                            mesh=self.mesh)

    def _adopt(self, tree) -> None:
        self.params = M.trainable(tree["params"])
        self.opt_state = tree["opt"]

    def try_restore(self) -> bool:
        restored = self._restore()
        if restored is None:
            return False
        tree, step, _ = restored
        self._adopt(tree)
        self.step = step
        return True

    # -- loop ---------------------------------------------------------------
    def run(self) -> Dict:
        t_start = time.time()
        self.try_restore()
        data = self.data_iter_factory(self.step)
        rollback_skip = 0

        while self.step < self.tcfg.total_steps:
            batch = next(data)
            t0 = time.time()
            params, opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch, self.step)
            loss = float(whole(metrics["loss"]))
            dt = time.time() - t0

            if not np.isfinite(loss):
                # Bad-batch recovery: roll back and skip past this window.
                restored = self._restore()
                if restored is not None:
                    self._adopt(restored[0])
                    rollback_skip += 1
                    data = self.data_iter_factory(self.step + rollback_skip)
                    continue
                raise FloatingPointError(f"non-finite loss at step {self.step}")

            self.params, self.opt_state = params, opt_state
            straggled = self.monitor.record(dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "sec": dt,
                   "straggler_flag": straggled,
                   "grad_norm": float(whole(metrics["grad_norm"]))}
            self.metrics_log.append(rec)

            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if self.tcfg.max_seconds and \
                    time.time() - t_start > self.tcfg.max_seconds:
                self.save()  # preemption: snapshot and leave
                break
        else:
            self.save()

        return {
            "final_step": self.step,
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "straggler_flags": self.monitor.flags,
            "log": self.metrics_log,
        }
