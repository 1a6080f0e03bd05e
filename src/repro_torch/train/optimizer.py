"""AdamW (PyTorch port of the JAX package's ``train/optimizer.py``): the
warm-up + cosine schedule, global-norm clipping and bias corrections in
float32, moments in float32 or bfloat16 (``moments_dtype``).

The update runs in place under ``torch.no_grad``: each leaf's float32
result is cast back to the leaf's dtype and copied into it, so a step holds
one leaf's float32 temporaries at a time, not a second tree.

Weight decay follows the reference's rank rule, ``p.ndim >= 2`` on *its*
tree, where every leaf of a scanned super-block carries a leading layer
axis: a scanned layer's norm scales and QKV biases are decayed, the same
leaves of a head or tail layer and ``final_norm`` are not.  The port holds
one tree per layer, so ``decay_mask(cfg)`` derives that rule from
``transformer.stacked_layers(cfg)`` and ``opt_update`` takes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, spec, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moments_dtype: str = "float32"   # "bfloat16" to halve optimizer memory


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32
    scalar computed as the reference computes it."""
    step = _step_f32(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def opt_abstract(params_abstract, cfg: OptConfig):
    dt = torch.bfloat16 if cfg.moments_dtype == "bfloat16" else torch.float32

    def mom(s: ParamSpec):
        return spec(s.shape, s.axes, dtype=dt, init="zeros")

    return {"m": tree_map(mom, params_abstract),
            "v": tree_map(mom, params_abstract)}


def decay_mask(cfg: ModelConfig):
    """The port's parameter tree of ``cfg`` with a bool at each leaf: True
    where the reference decays it (rank >= 2 on the reference's tree, in
    which a leaf of a scanned layer has one axis more)."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    abstract = M.abstract_params(cfg)
    tree = tree_map(lambda s: len(s.shape) >= 2, abstract)
    for group in T.stacked_layers(cfg):
        for i in group:
            tree["blocks"][str(i)] = tree_map(lambda s: len(s.shape) + 1 >= 2,
                                              abstract["blocks"][str(i)])
    return tree


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def opt_update(params, grads, opt_state, step, cfg: OptConfig, decay):
    """One AdamW step, in place.  ``decay``: a tree of bools like
    ``params``, True where the leaf decays (``decay_mask``).  Returns
    (params, opt_state, metrics), the same trees updated."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    lr = lr_at(step, cfg).to(dev)
    gnorm = global_norm(grads)
    scale = 1.0
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    step_f = _step_f32(step).to(dev)
    bc1 = 1 - torch.pow(b1, step_f + 1)
    bc2 = 1 - torch.pow(b2, step_f + 1)
    for p, g, m, v, d in zip(leaves, tree_leaves(grads),
                             tree_leaves(opt_state["m"]),
                             tree_leaves(opt_state["v"]), tree_leaves(decay)):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.float()
        if d:
            update = update + cfg.weight_decay * p32
        p.copy_(p32 - lr * update)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
