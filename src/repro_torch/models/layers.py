"""Base layers: norms, embeddings, rope, MLP (PyTorch port of the JAX
package's ``models/layers.py``, with its numerics: rmsnorm in float32 inside,
the tanh GELU that ``jax.nn.gelu`` defaults to, rope over split halves, and
the unembedding multiplied in the parameter dtype before the cast to
float32)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import constrain
from repro_torch.models.params import spec


def _matmul(x, w):
    """``einsum("...d,d...->...", x, w)``: x's last axis against w's first.

    On a mesh DTensor may shard the product's flattened width ``w.shape[1]
    * ...`` over a mesh axis that ``w.shape[1]`` (12 heads on a 16-wide
    ``model`` axis) does not divide, and that width cannot be unflattened:
    the product then replicates along that axis first, as the rules
    replicate the unflattened dim; so does the flattened weight's
    gradient (``flat``)."""
    w2 = flat(w, 1) if w.ndim > 2 else w
    y = x @ w2
    if w.ndim > 2 and _is_dtensor(y):
        y = _unflattenable(y, w.shape[1], y.ndim - 1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def flat(t, dim: int):
    """``t`` with dims ``dim`` and ``dim + 1`` merged (for 3-D weights and
    head outputs: dim + 1 is the last but for ``wo``'s (h, hd, d)).  On a
    mesh the gradient that comes back is made legal to unflatten into
    ``t.shape[dim]`` (``_unflattenable``), whatever DTensor split."""
    out = t.flatten(dim, dim + 1)
    if _is_dtensor(out) and out.requires_grad:
        lead = t.shape[dim]
        out = _GradFix.apply(out, lambda g: _unflattenable(g, lead, dim))
    return out


def placed_grad(w):
    """``w``, whose gradient comes back placed as ``w`` is (a pending sum
    reduced onto ``w``'s shards).  A weight used twice (the tied
    embedding: the lookup and the logits) then adds its two gradients in
    one placement; DTensor cannot always move one of them to the other's
    (torch 2.11 refuses a split to a pending sum)."""
    if not (_is_dtensor(w) and w.requires_grad):
        return w
    mesh, placements = w.device_mesh, w.placements
    return _GradFix.apply(w, lambda g: g.redistribute(mesh, placements))


class _GradFix(torch.autograd.Function):
    """The identity, whose backward applies ``fix`` to the gradient."""

    @staticmethod
    def forward(ctx, t, fix):
        ctx.fix = fix
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fix(g), None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _unflattenable(y, lead: int, dim: int):
    """``y`` with dim ``dim`` replicated on each mesh axis that shards it
    but does not divide ``lead``, the leading size it unflattens into."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    split = 1
    want = list(y.placements)
    for i, p in enumerate(want):
        if isinstance(p, Shard) and p.dim == dim:
            if lead % (split * mesh.size(i)):
                want[i] = Replicate()
            else:
                split *= mesh.size(i)
    if want == list(y.placements):
        return y
    return y.redistribute(mesh, want)


# -- rmsnorm ---------------------------------------------------------------

def rmsnorm_abstract(dim: int):
    return {"scale": spec((dim,), ("embed",), dtype=torch.float32, init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dt)


# -- embedding ---------------------------------------------------------------

def embedding_abstract(cfg: ModelConfig):
    return {"table": spec((cfg.vocab_size, cfg.d_model), ("vocab", "fsdp"),
                          init="embed", scale=0.02)}


def embed(params, tokens):
    table = placed_grad(params["table"])
    return constrain(F.embedding(tokens, table), "batch", None, None)


def unembed(params, x, softcap: Optional[float] = None):
    logits = (x @ placed_grad(params["table"]).T).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# -- rope --------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None, None].float() * freq  # (..., S,1,half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mlp -----------------------------------------------------------------------

def mlp_abstract(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": spec((d, f), ("fsdp", "mlp")),
        "w_down": spec((f, d), ("mlp", "fsdp")),
    }
    if cfg.mlp_gated:
        p["w_gate"] = spec((d, f), ("fsdp", "mlp"))
    if cfg.mlp_bias:
        p["b_up"] = spec((f,), ("mlp",), init="zeros")
        p["b_down"] = spec((d,), ("embed",), init="zeros")
    return p


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(params, x, cfg: ModelConfig):
    up = x @ params["w_up"]
    if "b_up" in params:
        up = up + params["b_up"]
    act = _act(cfg.mlp_act)
    h = act(up) * (x @ params["w_gate"]) if cfg.mlp_gated else act(up)
    h = constrain(h, "batch", *(None,) * (h.ndim - 2), "mlp")
    out = h @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out
