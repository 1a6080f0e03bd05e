"""Single-layer assembly: norm → temporal mixer → norm → channel mixer
(PyTorch port of the JAX package's ``models/blocks.py``).

A layer is described by (temporal, channel) kind strings resolved from the
config's cyclic ``pattern`` and MoE dense-head rules:

  temporal ∈ {"attn", "local", "cross", "mla", "rglru", "ssd"}
  channel  ∈ {"mlp", "moe", "dense_head", "none"}

The port has the dense kinds: temporal ``attn`` and ``local``, channel
``mlp`` and ``dense_head``, with ``post_norms``.  ``cross``, ``mla``,
``rglru``, ``ssd`` and ``moe`` raise ``NotImplementedError`` (ROADMAP.md);
no kind ever falls back to another.  Caches are preallocated and written in
place: the reference's ``dynamic_update_slice_in_dim`` is a slice copy.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.params import spec

_UNPORTED = ("cross", "mla", "rglru", "ssd", "moe")


def _unported(kind: str):
    if kind in _UNPORTED:
        raise NotImplementedError(
            f"the {kind!r} mixer is not ported to repro_torch yet "
            "(ROADMAP.md, Open items §1: the remaining mixers)")
    raise ValueError(kind)


def layer_kinds(cfg: ModelConfig):
    """Resolve (temporal, channel) for every layer index."""
    kinds = []
    for i in range(cfg.n_layers):
        temporal = cfg.pattern[i % len(cfg.pattern)]
        if temporal == "ssd":
            channel = "none" if cfg.d_ff == 0 else "mlp"
        elif cfg.moe is not None:
            channel = "dense_head" if i < cfg.moe.n_dense_layers else "moe"
        else:
            channel = "mlp"
        kinds.append((temporal, channel))
    return kinds


# -- abstract ----------------------------------------------------------------

def layer_abstract(cfg: ModelConfig, temporal: str, channel: str):
    d = cfg.d_model
    p = {"ln1": L.rmsnorm_abstract(d)}
    if temporal in ("attn", "local"):
        p["attn"] = attn.gqa_abstract(cfg)
    else:
        _unported(temporal)

    if channel != "none":
        p["ln2"] = L.rmsnorm_abstract(d)
    if channel == "mlp":
        p["mlp"] = L.mlp_abstract(cfg)
    elif channel == "dense_head":
        p["mlp"] = L.mlp_abstract(cfg, d_ff=cfg.moe.dense_ff or cfg.d_ff)
    elif channel != "none":
        _unported(channel)

    if cfg.post_norms:
        p["post_ln1"] = L.rmsnorm_abstract(d)
        if channel != "none":
            p["post_ln2"] = L.rmsnorm_abstract(d)
    return p


def _attend(lp, h, temporal, cfg, positions):
    """Full-sequence self-attention of an ``attn``/``local`` layer: the
    output projection and the (k, v) it attended over."""
    q, k, v = attn.gqa_project_qkv(lp["attn"], h, positions=positions, cfg=cfg)
    window = cfg.window if temporal == "local" else None
    o = attn.flash_attention(
        q, k, v, causal=cfg.causal, window=window,
        softcap=cfg.attn_softcap, q_chunk=cfg.attn_chunk,
        kv_chunk=cfg.attn_chunk,
        score_dtype=torch.float32 if cfg.attn_scores_f32 else torch.bfloat16,
    )
    return attn.gqa_output(lp["attn"], o), k, v


def _channel(lp, x, t_out, channel, cfg):
    """Residual add of the temporal output, then the channel mixer's."""
    if cfg.post_norms:
        t_out = L.rmsnorm(lp["post_ln1"], t_out)
    x = x + t_out
    if channel != "none":
        h = L.rmsnorm(lp["ln2"], x)
        if channel in ("mlp", "dense_head"):
            c_out = L.mlp(lp["mlp"], h, cfg)
        else:
            _unported(channel)
        if cfg.post_norms:
            c_out = L.rmsnorm(lp["post_ln2"], c_out)
        x = x + c_out
    return x


# -- full-sequence apply -------------------------------------------------------

def layer_apply(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    positions, vis_embeds=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(lp["ln1"], x)
    if temporal not in ("attn", "local"):
        _unported(temporal)
    t_out, _, _ = _attend(lp, h, temporal, cfg, positions)
    return _channel(lp, x, t_out, channel, cfg), aux


# -- caches --------------------------------------------------------------------

def cache_abstract(cfg: ModelConfig, temporal: str, batch: int, max_len: int):
    hd = cfg.resolved_head_dim
    if temporal in ("attn", "local"):
        return {
            "k": spec((batch, max_len, cfg.n_kv_heads, hd),
                      ("batch", "cache_seq", "kv_heads", None), init="zeros"),
            "v": spec((batch, max_len, cfg.n_kv_heads, hd),
                      ("batch", "cache_seq", "kv_heads", None), init="zeros"),
        }
    _unported(temporal)


def layer_prefill(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    positions, cache, vis_embeds=None,
):
    """Full-sequence forward that also fills this layer's cache slots
    [0, S) in place.  Returns (x, cache).  The prefill length S may be
    shorter than the cache allocation; remaining slots stay zero and are
    masked by cache_len."""
    h = L.rmsnorm(lp["ln1"], x)
    s = x.shape[1]
    if temporal not in ("attn", "local"):
        _unported(temporal)
    t_out, k, v = _attend(lp, h, temporal, cfg, positions)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return _channel(lp, x, t_out, channel, cfg), cache


# -- decode step -----------------------------------------------------------------

def layer_decode(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    cache, cache_len: int, positions,
):
    """x: (B,1,D) -> (x, cache). cache_len counts tokens incl. current; the
    new token's k/v land at cache_len - 1 in place."""
    h = L.rmsnorm(lp["ln1"], x)
    if temporal not in ("attn", "local"):
        _unported(temporal)
    q, k, v = attn.gqa_project_qkv(lp["attn"], h, positions=positions, cfg=cfg)
    idx = cache_len - 1
    cache["k"][:, idx : idx + 1] = k.to(cache["k"].dtype)
    cache["v"][:, idx : idx + 1] = v.to(cache["v"].dtype)
    window = cfg.window if temporal == "local" else None
    o = attn.decode_attention(q, cache["k"], cache["v"], cache_len,
                              window=window, softcap=cfg.attn_softcap)
    t_out = attn.gqa_output(lp["attn"], o)
    return _channel(lp, x, t_out, channel, cfg), cache
