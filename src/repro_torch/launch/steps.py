"""Step functions measured by the dry run and used by the real launchers
(PyTorch port of the JAX package's ``launch/steps.py``).

``make_step`` returns ``(fn, example_args, donate)`` with the reference's
rules.  The arguments are ``launch/specs.py``'s stand-ins (meta tensors,
or ``ShapeStruct`` leaves on a mesh); ``launch/dryrun.py`` turns them into
fake tensors and runs ``fn`` on them.  With ``mesh=None`` ``fn`` runs on
real tensors of the same tree.  ``donate`` names the arguments a step
overwrites: the port's train step updates the parameters and optimizer
state in place and prefill and decode write the cache in place, where the
reference's jitted steps donate those buffers.  Prefill and decode run
without autograd; the train step arms the parameter leaves it is given
(``models.model.trainable``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import LM_SHAPES, ModelConfig
from repro_torch.distributed.ctx import use_sharding
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import specs as S
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import shape_structs
from repro_torch.train import OptConfig
from repro_torch.train.train_step import make_train_step, opt_abstract_with_ef


def _with_ctx(fn, mesh, rules):
    """Activate the activation-sharding context while the step runs."""
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with use_sharding(mesh, rules):
            return fn(*a, **kw)

    return wrapped


def make_step(cfg: ModelConfig, shape_name: str, mesh, rules: ShardingRules,
              ocfg: OptConfig | None = None, microbatches: int = 1):
    """Returns (fn, example_args: tuple, donate: tuple[int, ...])."""
    sh = LM_SHAPES[shape_name]
    if ocfg is None:
        # >100B-param archs: bf16 moments, or optimizer state alone outgrows HBM.
        big = cfg.param_count() > 100e9
        ocfg = OptConfig(moments_dtype="bfloat16" if big else "float32")
    if sh.kind != "train":
        # Remat only pays for a backward pass; inference keeps no residuals.
        if cfg.remat != "none":
            cfg = dataclasses.replace(cfg, remat="none")
        # Decode: row-parallel weights, the FSDP (d_model input) dim of every
        # matrix on the model axis, as the reference maps it: weights fully
        # sharded with no per-step gather, at the price of a sum over the
        # one-token activations.  MoE giants keep ZeRO sharding (their
        # experts take the model axis).
        if (rules is not None and sh.kind == "decode"
                and cfg.param_count() < 100e9):
            rules = rules.with_overrides(fsdp="model")
    params = S.param_specs(cfg, mesh, rules)

    if sh.kind == "train":
        opt = shape_structs(opt_abstract_with_ef(M.abstract_params(cfg), ocfg),
                            mesh, rules.rules if mesh is not None else None)
        inner = make_train_step(cfg, ocfg, microbatches=microbatches)

        def train_fn(params, opt_state, batch, step):
            return inner(M.trainable(params), opt_state, batch, step)

        batch = S.batch_specs(cfg, sh, mesh, rules)
        step = S.scalar(0)
        return (_with_ctx(train_fn, mesh, rules), (params, opt, batch, step),
                (0, 1))

    if sh.kind == "prefill":
        if cfg.encoder_only:
            # Encoder arch: "prefill" is one full encoder forward + frame logits.
            @torch.no_grad()
            def encode_fn(params, batch):
                x, _ = M.forward(params, batch, cfg)
                x = L.rmsnorm(params["final_norm"], x)
                return M._logits(params, x, cfg).to(torch.bfloat16)

            batch = S.batch_specs(cfg, sh, mesh, rules)
            return _with_ctx(encode_fn, mesh, rules), (params, batch), ()

        @torch.no_grad()
        def prefill_fn(params, batch, cache):
            return M.prefill(params, batch, cfg, cache)

        batch = S.batch_specs(cfg, sh, mesh, rules)
        cache = S.cache_specs(cfg, sh, mesh, rules)
        return _with_ctx(prefill_fn, mesh, rules), (params, batch, cache), (2,)

    @torch.no_grad()
    def decode_fn(params, tokens_or_frames, cache, cache_len):
        if cfg.frontend == "audio_frames":
            raise NotImplementedError("encoder-only arch has no decode")
        return M.decode_step(params, tokens_or_frames, cache, int(cache_len),
                             cfg)

    batch = S.batch_specs(cfg, sh, mesh, rules)
    cache = S.cache_specs(cfg, sh, mesh, rules)
    # the cache is full: the new token lands in its last slot
    cache_len = S.scalar(sh.seq_len)
    return (_with_ctx(decode_fn, mesh, rules),
            (params, batch["tokens"], cache, cache_len), (2,))
