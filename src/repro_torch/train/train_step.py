"""The train step (PyTorch port of the JAX package's
``train/train_step.py``): microbatched gradient accumulation, clipping,
AdamW, optional int8 gradient compression with error feedback.

Eager, no ``torch.compile``.  Gradients come from ``torch.autograd.grad``
with respect to the parameter leaves, which must take gradients
(``models.model.trainable``); the optimizer then updates the leaves and
the moments in place.  A leaf the loss does not reach (``final_norm``,
which the reference's loss skips) gets a zero gradient, as ``jax.grad``
gives it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import OptConfig, decay_mask, opt_update


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):  # tree_leaves order: sorted keys
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def _grads(params, batch, cfg: ModelConfig):
    leaves = tree_leaves(params)
    frozen = sum(1 for p in leaves if not p.requires_grad)
    if frozen:
        raise ValueError(f"{frozen} parameter leaves take no gradient: arm "
                         "the tree with models.model.trainable")
    loss, metrics = M.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatch_grads(params, batch, cfg: ModelConfig, microbatches: int):
    """Mean loss/grads over ``microbatches`` sequential slices of the
    batch, accumulated in float32 and cast to each parameter's dtype."""
    if microbatches <= 1:
        loss, metrics, grads = _grads(params, batch, cfg)
        return loss, metrics, _unflatten(params, grads)

    leaves = tree_leaves(params)
    # zeros_like: on a mesh each accumulator is placed as its leaf is.
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         "microbatches")
    size = b // microbatches
    for i in range(microbatches):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        loss, _, grads = _grads(params, mb, cfg)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss_sum = loss_sum + loss
        del grads
    grads = [(a / microbatches).to(p.dtype) for a, p in zip(acc, leaves)]
    loss = loss_sum / microbatches
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, \
        _unflatten(params, grads)


def make_train_step(
    cfg: ModelConfig,
    ocfg: OptConfig,
    microbatches: int = 1,
    compress: bool = False,   # int8 grad compression + error feedback
):
    """Returns train_step(params, opt_state, batch, step) -> (params, opt,
    metrics).

    ``batch`` is a dict with "tokens"/"labels" (or "frames"), moved to the
    parameters' device; ``step`` an int or a 0-d tensor.  With
    ``compress=True`` the optimizer state additionally carries the
    error-feedback residual tree under key "ef" (see
    ``opt_abstract_with_ef``).  ``params`` and ``opt_state`` are updated in
    place and returned; ``metrics`` holds "loss", "ce", "aux",
    "grad_norm" and "lr" as 0-d tensors.
    """
    from repro_torch.distributed.compression import compress_grads

    decay = decay_mask(cfg)

    def train_step(params, opt_state, batch, step):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = _microbatch_grads(params, batch, cfg,
                                                 microbatches)
        if compress:
            grads, new_ef = compress_grads(grads, opt_state["ef"], cfg)
        params, new_opt, opt_metrics = opt_update(
            params, grads, opt_state, step, ocfg, decay=decay)
        if compress:
            new_opt["ef"] = new_ef
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, new_opt, metrics

    return train_step


def opt_abstract_with_ef(params_abstract, ocfg: OptConfig,
                         compress: bool = False):
    from repro_torch.distributed.compression import ef_abstract
    from repro_torch.train.optimizer import opt_abstract

    state = opt_abstract(params_abstract, ocfg)
    if compress:
        state["ef"] = ef_abstract(params_abstract)
    return state
