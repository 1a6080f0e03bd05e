"""Single-layer assembly: norm → temporal mixer → norm → channel mixer
(PyTorch port of the JAX package's ``models/blocks.py``).

A layer is described by (temporal, channel) kind strings resolved from the
config's cyclic ``pattern`` and MoE dense-head rules:

  temporal ∈ {"attn", "local", "cross", "mla", "rglru", "ssd"}
  channel  ∈ {"mlp", "moe", "dense_head", "none"}

Every kind provides abstract params, a full-sequence apply, and a decode-step
apply over its piece of the cache.  Attention caches (``attn``/``local``
k/v, ``mla``'s latent) are preallocated and written in place: the
reference's ``dynamic_update_slice_in_dim`` is a slice copy.  The state
caches (``rglru``, ``ssd``) are replaced by the new state, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import constrain, write_seq
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.params import spec


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
    if temporal in ("attn", "local", "cross"):
        p["attn"] = attn.gqa_abstract(cfg)
        if temporal == "cross":
            p["attn_gate"] = spec((), (), dtype=torch.float32, init="zeros")
            p["kv_ln"] = L.rmsnorm_abstract(d)
    elif temporal == "mla":
        p["attn"] = attn.mla_abstract(cfg)
    elif temporal == "rglru":
        p["rec"] = rglru_mod.rglru_abstract(cfg)
    elif temporal == "ssd":
        p["ssd"] = ssm_mod.ssd_abstract(cfg)
    else:
        raise ValueError(temporal)

    if channel != "none":
        p["ln2"] = L.rmsnorm_abstract(d)
    if channel == "mlp":
        p["mlp"] = L.mlp_abstract(cfg)
    elif channel == "dense_head":
        p["mlp"] = L.mlp_abstract(cfg, d_ff=cfg.moe.dense_ff or cfg.d_ff)
    elif channel == "moe":
        p["moe"] = moe_mod.moe_abstract(cfg)
    elif channel != "none":
        raise ValueError(channel)

    if cfg.post_norms:
        p["post_ln1"] = L.rmsnorm_abstract(d)
        if channel != "none":
            p["post_ln2"] = L.rmsnorm_abstract(d)
    return p


def _score_dtype(cfg):
    return torch.float32 if cfg.attn_scores_f32 else torch.bfloat16


def _attend(lp, h, temporal, cfg, positions):
    """Full-sequence self-attention of an ``attn``/``local`` layer: the
    output projection and the (k, v) it attended over."""
    q, k, v = attn.gqa_project_qkv(lp["attn"], h, positions=positions, cfg=cfg)
    window = cfg.window if temporal == "local" else None
    o = attn.flash_attention(
        q, k, v, causal=cfg.causal, window=window,
        softcap=cfg.attn_softcap, q_chunk=cfg.attn_chunk,
        kv_chunk=cfg.attn_chunk, score_dtype=_score_dtype(cfg),
    )
    return attn.gqa_output(lp["attn"], o), k, v


def _cross(lp, h, cfg, vis_embeds):
    """Gated cross-attention over the normed vision embeddings (no RoPE,
    not causal): the gated output and the (k, v) it attended over."""
    kv = L.rmsnorm(lp["kv_ln"], vis_embeds)
    q, k, v = attn.gqa_project_qkv(lp["attn"], h, kv_x=kv, cfg=cfg,
                                   use_rope=False)
    o = attn.flash_attention(q, k, v, causal=False, q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk,
                             score_dtype=_score_dtype(cfg))
    return _gated(lp, attn.gqa_output(lp["attn"], o)), k, v


def _gated(lp, t_out):
    return t_out * torch.tanh(lp["attn_gate"]).to(t_out.dtype)


def _channel(lp, x, t_out, channel, cfg):
    """Residual add of the temporal output, then the channel mixer's.
    Returns (x, the MoE aux loss or None).  On a mesh each output is whole
    rows before it joins the residual stream (a row-parallel product's
    pending sum is all-reduced there): a stream or gradient split along the
    sequence could not be flattened by the next product."""
    t_out = constrain(t_out, "batch", None, None)
    if cfg.post_norms:
        t_out = L.rmsnorm(lp["post_ln1"], t_out)
    x = x + t_out
    aux = None
    if channel != "none":
        h = L.rmsnorm(lp["ln2"], x)
        if channel in ("mlp", "dense_head"):
            c_out = L.mlp(lp["mlp"], h, cfg)
        else:
            c_out, aux = moe_mod.moe_layer(lp["moe"], h, cfg)
        c_out = constrain(c_out, "batch", None, None)
        if cfg.post_norms:
            c_out = L.rmsnorm(lp["post_ln2"], c_out)
        x = x + c_out
    return x, aux


# -- full-sequence apply -------------------------------------------------------

def layer_apply(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    positions, vis_embeds=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (x, aux_loss)."""
    x = constrain(x, "batch", None, None)
    h = L.rmsnorm(lp["ln1"], x)
    if temporal in ("attn", "local"):
        t_out = _attend(lp, h, temporal, cfg, positions)[0]
    elif temporal == "cross":
        t_out = _cross(lp, h, cfg, vis_embeds)[0]
    elif temporal == "mla":
        t_out = attn.mla_attention(lp["attn"], h, positions, cfg,
                                   q_chunk=cfg.attn_chunk,
                                   kv_chunk=cfg.attn_chunk)
    elif temporal == "rglru":
        t_out = rglru_mod.rglru_layer(lp["rec"], h, cfg)
    elif temporal == "ssd":
        t_out = ssm_mod.ssd_layer(lp["ssd"], h, cfg)
    else:
        raise ValueError(temporal)
    x, aux = _channel(lp, x, t_out, channel, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# -- caches --------------------------------------------------------------------

def cache_abstract(cfg: ModelConfig, temporal: str, batch: int, max_len: int):
    hd = cfg.resolved_head_dim
    if temporal in ("attn", "local", "cross"):
        length = cfg.n_vis_tokens if temporal == "cross" else max_len
        seq = None if temporal == "cross" else "cache_seq"
        return {
            "k": spec((batch, length, cfg.n_kv_heads, hd),
                      ("batch", seq, "kv_heads", None), init="zeros"),
            "v": spec((batch, length, cfg.n_kv_heads, hd),
                      ("batch", seq, "kv_heads", None), init="zeros"),
        }
    if temporal == "mla":
        m = cfg.mla
        return {
            "c": spec((batch, max_len, m.kv_lora_rank),
                      ("batch", "cache_seq", None), init="zeros"),
            "krope": spec((batch, max_len, m.rope_head_dim),
                          ("batch", "cache_seq", None), init="zeros"),
        }
    if temporal == "rglru":
        return rglru_mod.rglru_decode_state_abstract(cfg, batch)
    if temporal == "ssd":
        return ssm_mod.ssd_decode_state_abstract(cfg, batch)
    raise ValueError(temporal)


def layer_prefill(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    positions, cache, vis_embeds=None,
):
    """Full-sequence forward that also fills this layer's cache: slots
    [0, S) of an attention cache in place, or the state after position
    S - 1.  Returns (x, cache).  The prefill length S may be shorter than
    the cache allocation; remaining slots stay zero and are masked by
    cache_len."""
    h = L.rmsnorm(lp["ln1"], x)
    s = x.shape[1]
    if temporal in ("attn", "local", "cross"):
        if temporal == "cross":
            t_out, k, v = _cross(lp, h, cfg, vis_embeds)
        else:
            t_out, k, v = _attend(lp, h, temporal, cfg, positions)
        write_seq(cache["k"], 0, k.to(cache["k"].dtype))
        write_seq(cache["v"], 0, v.to(cache["v"].dtype))
    elif temporal == "mla":
        t_out = attn.mla_attention(lp["attn"], h, positions, cfg,
                                   q_chunk=cfg.attn_chunk,
                                   kv_chunk=cfg.attn_chunk)
        c_kv, k_rope = attn.mla_latent(lp["attn"], h, positions, cfg)
        write_seq(cache["c"], 0, c_kv.to(cache["c"].dtype))
        write_seq(cache["krope"], 0, k_rope.to(cache["krope"].dtype))
    elif temporal == "rglru":
        t_out, cache = _rglru_prefill(lp["rec"], h, cfg, cache)
    elif temporal == "ssd":
        t_out, cache = _ssd_prefill(lp["ssd"], h, cfg, cache)
    else:
        raise ValueError(temporal)
    return _channel(lp, x, t_out, channel, cfg)[0], cache


def _conv_tail(x, k: int):
    """The last k - 1 rows of x (B, S, W) as the causal conv sees them:
    zero-padded on the left when S < k - 1."""
    return torch.nn.functional.pad(x, (0, 0, k - 1, 0))[:, x.shape[1]:]


def _rglru_prefill(params, h, cfg, old_cache):
    """The layer's output and its cache after the prompt: the scan's last
    state (the reference reruns the same scan for it) and the last k - 1
    projected inputs before the conv."""
    out, hs, xr = rglru_mod.rglru_states(params, h, cfg)
    conv_tail = _conv_tail(xr, cfg.rglru.d_conv)
    return out, {"h": hs[:, -1],
                 "conv_buf": conv_tail.to(old_cache["conv_buf"].dtype)}


def _ssd_prefill(params, h, cfg, cache):
    """The layer's output and its cache: the final state of the same chunk
    pass (the reference's ``_ssd_final_state`` pass) and the last
    d_conv - 1 in-projected xbc rows before the conv.  A prompt shorter
    than d_conv - 1 is zero-padded on the left, as the conv pads it (the
    reference keeps fewer rows there, and its next decode step fails)."""
    out, state, xbc = ssm_mod.ssd_scan(params, h, cfg)
    conv_tail = _conv_tail(xbc, cfg.ssm.d_conv).to(cache["conv_buf"].dtype)
    return out, {"state": state, "conv_buf": conv_tail}


# -- decode step -----------------------------------------------------------------

def layer_decode(
    lp, x, temporal: str, channel: str, cfg: ModelConfig, *,
    cache, cache_len: int, positions,
):
    """x: (B,1,D) -> (x, cache). cache_len counts tokens incl. current; the
    new token's k/v (or latent) land at cache_len - 1 in place."""
    h = L.rmsnorm(lp["ln1"], x)
    if temporal in ("attn", "local"):
        q, k, v = attn.gqa_project_qkv(lp["attn"], h, positions=positions, cfg=cfg)
        write_seq(cache["k"], cache_len - 1, k.to(cache["k"].dtype))
        write_seq(cache["v"], cache_len - 1, v.to(cache["v"].dtype))
        window = cfg.window if temporal == "local" else None
        o = attn.decode_attention(q, cache["k"], cache["v"], cache_len,
                                  window=window, softcap=cfg.attn_softcap)
        t_out = attn.gqa_output(lp["attn"], o)
    elif temporal == "cross":
        q = L._matmul(h, lp["attn"]["wq"])
        if "bq" in lp["attn"]:
            q = q + lp["attn"]["bq"]
        o = attn.decode_attention(q, cache["k"], cache["v"], cfg.n_vis_tokens)
        t_out = _gated(lp, attn.gqa_output(lp["attn"], o))
    elif temporal == "mla":
        t_out, _, _ = attn.mla_decode(lp["attn"], h, cache["c"], cache["krope"],
                                      cache_len, positions, cfg)
    elif temporal == "rglru":
        t_out, cache = rglru_mod.rglru_decode(lp["rec"], h, cache, cfg)
    elif temporal == "ssd":
        t_out, cache = ssm_mod.ssd_decode(lp["ssd"], h, cache, cfg)
    else:
        raise ValueError(temporal)
    return _channel(lp, x, t_out, channel, cfg)[0], cache
