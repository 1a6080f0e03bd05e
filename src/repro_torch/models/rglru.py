"""RG-LRU recurrent block (Griffin / RecurrentGemma), PyTorch port of the JAX
package's ``models/rglru.py``.

Temporal mixer: x -> {gate branch: GeLU(W_y x)} ⊙ {recurrent branch:
causal-conv -> RG-LRU} -> W_out.  The RG-LRU diagonal recurrence
  r_t = σ(W_a x_t),  i_t = σ(W_x x_t)
  log a_t = -c · softplus(Λ) · r_t
  h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)
runs over the sequence as a log-depth scan of (log a, b) pairs in float32
(``scan``: Hillis-Steele doubling, the reference's
``jax.lax.associative_scan`` with the same combine), and as an O(1) state
update for decode.  The y-gate is the tanh GELU (``jax.nn.gelu``'s
default); ``lam`` and the ``h`` state are float32, ``conv_buf`` bfloat16,
as in the reference's specs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.params import spec

_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.width or cfg.d_model


def rglru_abstract(cfg: ModelConfig):
    d, w = cfg.d_model, _width(cfg)
    k = cfg.rglru.d_conv
    return {
        "w_y": spec((d, w), ("fsdp", "state")),
        "w_x": spec((d, w), ("fsdp", "state")),
        "conv_w": spec((k, w), (None, "state")),
        "conv_b": spec((w,), ("state",), init="zeros"),
        "w_a": spec((w, w), (None, "state")),
        "b_a": spec((w,), ("state",), init="zeros"),
        "w_i": spec((w, w), (None, "state")),
        "b_i": spec((w,), ("state",), init="zeros"),
        "lam": spec((w,), ("state",), dtype=torch.float32, init="ones"),
        "w_out": spec((w, d), ("state", "fsdp")),
    }


def _gates(params, xr):
    r = torch.sigmoid((xr @ params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((xr @ params["w_i"]).float() + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r             # (.., W) f32
    gated_x = i * xr.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, beta * gated_x


def causal_conv(xr, conv_w, conv_b):
    """Depthwise causal conv over the sequence. xr: (B, S, W)."""
    k, s = conv_w.shape[0], xr.shape[1]
    pad = F.pad(xr, (0, 0, k - 1, 0))
    return sum(pad[:, i : i + s] * conv_w[i] for i in range(k)) + conv_b


def scan(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 from h = 0, for every t:
    the inclusive scan of (log_a, b) under (la1, b1) ∘ (la2, b2) = (la1 +
    la2, b1 exp(la2) + b2) in ceil(log2 S) doubling steps."""
    s, d = log_a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * torch.exp(log_a[:, d:]) + b[:, d:]],
                      dim=1)
        log_a = torch.cat([log_a[:, :d], log_a[:, :-d] + log_a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_states(params, x, cfg: ModelConfig):
    """The layer's output, every position's float32 state h (B, S, W) and
    the projection ``W_x x`` before the conv (what ``conv_buf`` holds)."""
    y_gate = _act("gelu")(x @ params["w_y"])
    xr_in = x @ params["w_x"]
    xr = causal_conv(xr_in, params["conv_w"], params["conv_b"])
    h = scan(*_gates(params, xr))                           # (B,S,W) f32
    out = (h.to(x.dtype) * y_gate) @ params["w_out"]
    return out, h, xr_in


def rglru_layer(params, x, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    return rglru_states(params, x, cfg)[0]


def rglru_decode_state_abstract(cfg: ModelConfig, batch: int):
    w = _width(cfg)
    k = cfg.rglru.d_conv
    return {
        "h": spec((batch, w), ("batch", "state"), dtype=torch.float32,
                  init="zeros"),
        "conv_buf": spec((batch, k - 1, w), ("batch", None, "state"),
                         dtype=torch.bfloat16, init="zeros"),
    }


def rglru_decode(params, x, cache, cfg: ModelConfig):
    """x: (B, 1, D) -> (out, new_cache)."""
    k = cfg.rglru.d_conv
    y_gate = _act("gelu")(x @ params["w_y"])
    xr = x @ params["w_x"]                                  # (B,1,W)
    buf = torch.cat([cache["conv_buf"], xr.to(cache["conv_buf"].dtype)], dim=1)
    xr = sum(buf[:, i : i + 1] * params["conv_w"][i] for i in range(k))
    xr = xr + params["conv_b"]
    log_a, b = _gates(params, xr[:, 0])                     # (B,W)
    h = cache["h"] * torch.exp(log_a) + b
    out = h[:, None].to(x.dtype) * y_gate
    return out @ params["w_out"], {"h": h, "conv_buf": buf[:, 1:]}
