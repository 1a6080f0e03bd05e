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
from repro_torch.models.params import spec


def _matmul(x, w):
    """``einsum("...d,d...->...", x, w)``: x's last axis against w's first."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


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
    return params["table"][tokens]


def unembed(params, x, softcap: Optional[float] = None):
    logits = (x @ params["table"].T).float()
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
    out = h @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out
