"""Attention: GQA / MQA / sliding-window / cross / MLA, with a memory-bounded
chunked flash implementation (online softmax over KV blocks).  PyTorch port of the JAX
package's ``models/attention.py`` in plain torch ops and the reference's
numerics: scores in float32 (``score_dtype``), the ``NEG_INF`` mask, the
guard for fully masked rows, ``p`` cast to ``v``'s dtype before the PV
product, a float32 accumulator and the output cast to ``q``'s dtype; the
decode softmax in float32, then cast.

Causality is exploited *structurally*: the query axis is split into chunks,
and chunk i only issues matmuls against kv[: (i+1)·Qc] (or the sliding
window slice) — upper-triangular blocks are never computed.  Within each
(q-chunk, kv-slice) pair a Python loop over KV blocks (the reference's
``lax.scan``) keeps the score tile at (Qc, Kc) regardless of sequence length.

Multi-head latent attention (MLA, DeepSeek-V3) runs its prefill in the
absorbed form through ``flash_attention`` (one latent KV head, the latent as
the value) and decodes against the latent cache; its decode scores are
summed in the cache's dtype and cast to float32 after, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import (
    active_sharding, as_dtensor, constrain, local_offset, local_region,
    write_seq)
from repro_torch.models.layers import _matmul, flat, rope
from repro_torch.models.params import spec

NEG_INF = -2.0**30


def _einsum(eq, a, b):
    """``jnp.einsum`` with its type promotion (a float32 query against a
    bfloat16 cache computes in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# flash core
# ---------------------------------------------------------------------------

def _flash_block(q, k, v, q_pos, k_pos, causal, window, softcap, scale, carry,
                 score_dtype=torch.float32):
    """One (Qc, Kc) tile of online softmax. q: (B,Qc,H,D); k,v: (B,Kc,KV,D)."""
    m_prev, l_prev, acc_prev = carry
    groups = q.shape[2] // k.shape[2]
    qg = q.reshape(*q.shape[:2], k.shape[2], groups, q.shape[3])
    # preferred_element_type=float32: the product of two bf16 values is exact
    # in float32, so the operands are widened and the sum runs in float32.
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k.float()).to(score_dtype) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = s.masked_fill(~mask, NEG_INF)
    m = torch.maximum(m_prev, s.amax(dim=-1).float())  # (B,KV,G,Qc)
    # Guard fully-masked rows (m still NEG_INF): their p must be 0, not e^0.
    p = torch.where(s <= NEG_INF / 2, 0.0,
                    torch.exp(s - m[..., None].to(s.dtype)))
    alpha = torch.exp(m_prev - m)
    l = l_prev * alpha + p.sum(dim=-1, dtype=torch.float32)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v).float()
    acc = acc_prev * alpha[..., None] + pv
    return m, l, acc


def flash_attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, KV, D)
    v: torch.Tensor,            # (B, T, KV, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,          # absolute position of q[0] (prefill continuation)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    score_dtype=torch.float32,  # bf16: halves score-tile traffic
) -> torch.Tensor:
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk,
              score_dtype=score_dtype)
    if active_sharding() is not None:
        return _local_heads(_flash, q, k, v, kw)
    return _flash(q, k, v, **kw)


def _local_heads(fn, q, k, v, kw):
    """``fn`` (attention over plain tensors) on each rank's own batch rows
    and kv-head groups: k and v placed ("batch", None, "kv_heads", None),
    q split as k (its heads dim in whole groups; replicated where the kv
    heads do not divide the model axis), the output placed as q.  Heads
    and rows attend independently, so this needs no collective and gives
    the single-device numbers; the score tiles are never DTensors."""
    from torch.distributed.tensor import DTensor

    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    mesh, pl = k.device_mesh, k.placements
    q = as_dtensor(q, mesh).redistribute(mesh, pl)
    with local_region():
        out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _flash(q, k, v, *, causal, window, softcap, q_offset, q_chunk, kv_chunk,
           score_dtype):
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    scale = d ** -0.5
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    groups = h // kvh
    dev = q.device

    outs = []
    for i in range(0, s, q_chunk):
        qc = q[:, i : i + q_chunk]
        qlen = qc.shape[1]
        q_pos = q_offset + i + torch.arange(qlen, device=dev)
        # Structural skip: only the kv prefix (causal) / window slice is read.
        if causal:
            hi = min(t, i + qlen + q_offset)
        else:
            hi = t
        lo = 0
        if window is not None:
            lo = max(0, hi - window - qlen)
        lo = (lo // kv_chunk) * kv_chunk               # align for even blocks
        hi_pad = min(t, ((hi + kv_chunk - 1) // kv_chunk) * kv_chunk)
        ks, vs = k[:, lo:hi_pad], v[:, lo:hi_pad]
        nkv = ks.shape[1] // kv_chunk if ks.shape[1] % kv_chunk == 0 else None

        carry = (torch.full((b, kvh, groups, qlen), NEG_INF,
                            dtype=torch.float32, device=dev),
                 torch.zeros((b, kvh, groups, qlen), dtype=torch.float32,
                             device=dev),
                 torch.zeros((b, kvh, groups, qlen, dv), dtype=torch.float32,
                             device=dev))
        if nkv is not None and nkv > 1:
            for j in range(nkv):
                blk = slice(j * kv_chunk, (j + 1) * kv_chunk)
                k_pos = lo + j * kv_chunk + torch.arange(kv_chunk, device=dev)
                carry = _flash_block(qc, ks[:, blk], vs[:, blk], q_pos, k_pos,
                                     causal, window, softcap, scale, carry,
                                     score_dtype=score_dtype)
        else:
            k_pos = lo + torch.arange(ks.shape[1], device=dev)
            carry = _flash_block(qc, ks, vs, q_pos, k_pos, causal, window,
                                 softcap, scale, carry,
                                 score_dtype=score_dtype)
        _, l, acc = carry
        out = acc / torch.clamp(l[..., None], min=1e-30)          # (B,KV,G,Qc,Dv)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, qlen, h, dv)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None, softcap=None):
    """Single-token attention against a static-size cache.

    q: (B, 1, H, D); caches: (B, T, KV, D); cache_len: current length (the
    new token's k/v must already be written at cache_len - 1).
    """
    if active_sharding() is not None:
        return _decode_sharded(q, k_cache, v_cache, cache_len, window, softcap)
    return _decode(q, k_cache, v_cache, cache_len, window, softcap)


def _decode_scores(q, k_cache, cache_len, start, window, softcap):
    """(B, KV, G, T) float32 scores of one token against the cache rows
    that hold positions start .. start + T - 1, masked."""
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    s = _einsum("bkgd,bskd->bkgs", qg, k_cache).float() * (d ** -0.5)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    pos = start + torch.arange(t, device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= cache_len - window
    return s.masked_fill(~valid, NEG_INF)


def _decode(q, k_cache, v_cache, cache_len, window, softcap):
    s = _decode_scores(q, k_cache, cache_len, 0, window, softcap)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    b, _, h, _ = q.shape
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


def _decode_sharded(q, k_cache, v_cache, cache_len, window, softcap):
    """Decode attention on each rank's own shard of a placed cache: its
    batch rows, its kv-head groups and, where ``cache_seq`` shards the
    cache, its positions.  Without a position split each rank finishes
    the softmax alone.  With one, each rank keeps its partial max, sum and
    product with v (flash-decoding partials) and the combine is one max
    and two sums over the position shards: the reference's "one small
    psum for the softmax"."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_cache.device_mesh
    cpl = k_cache.placements
    qpl = tuple(Replicate() if p == Shard(1) else p for p in cpl)
    q = as_dtensor(q, mesh).redistribute(mesh, qpl)
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    with local_region():
        if Shard(1) not in cpl:
            out = _decode(ql, kl, vl, cache_len, window, softcap)
            return DTensor.from_local(out, mesh, qpl, run_check=False)
        s = _decode_scores(ql, kl, cache_len, local_offset(k_cache)[1],
                           window, softcap)
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        parts = (m, e.sum(dim=-1),
                 torch.einsum("bkgs,bskd->bkgd", e.to(vl.dtype), vl).float())
    # (B, KV, G, *) partials on a leading axis sharded like the positions
    ppl = [{Shard(0): Shard(1), Shard(1): Shard(0), Shard(2): Shard(2)}.get(
        p, Replicate()) for p in cpl]
    m, l, o = (DTensor.from_local(x[None], mesh, ppl, run_check=False)
               for x in parts)
    w = torch.exp(m - m.amax(dim=0))
    o = (o * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    o = o.redistribute(mesh, [{Shard(0): Shard(0), Shard(2): Shard(1)}.get(
        p, Replicate()) for p in cpl]).to_local()
    b, _, h, _ = ql.shape
    out = o.reshape(b, 1, h, o.shape[-1]).to(q.dtype)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


# ---------------------------------------------------------------------------
# GQA projections
# ---------------------------------------------------------------------------

def gqa_abstract(cfg: ModelConfig, cross: bool = False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": spec((d, h, hd), ("fsdp", "heads", None)),
        "wk": spec((d, kv, hd), ("fsdp", "kv_heads", None)),
        "wv": spec((d, kv, hd), ("fsdp", "kv_heads", None)),
        "wo": spec((h, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((h, hd), ("heads", None), init="zeros")
        p["bk"] = spec((kv, hd), ("kv_heads", None), init="zeros")
        p["bv"] = spec((kv, hd), ("kv_heads", None), init="zeros")
    return p


def gqa_project_qkv(params, x, kv_x=None, positions=None, cfg: ModelConfig = None,
                    use_rope: bool = True):
    kv_x = x if kv_x is None else kv_x
    q = constrain(_matmul(x, params["wq"]), "batch", None, "heads", None)
    k = constrain(_matmul(kv_x, params["wk"]), "batch", None, "kv_heads", None)
    v = constrain(_matmul(kv_x, params["wv"]), "batch", None, "kv_heads", None)
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_output(params, attn_out):
    """(..., h, hd) heads through ``wo`` (h, hd, d); both flattens give
    gradients that unflatten on a mesh (``layers.flat``)."""
    return flat(attn_out, attn_out.ndim - 2) @ flat(params["wo"], 0)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_abstract(cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = m.q_lora_rank, m.kv_lora_rank
    return {
        "wq_a": spec((d, qr), ("fsdp", None)),
        "q_norm": spec((qr,), (None,), dtype=torch.float32, init="ones"),
        "wq_b": spec((qr, h, m.nope_head_dim + m.rope_head_dim), (None, "heads", None)),
        "wkv_a": spec((d, kr + m.rope_head_dim), ("fsdp", None)),
        "kv_norm": spec((kr,), (None,), dtype=torch.float32, init="ones"),
        "wk_b": spec((kr, h, m.nope_head_dim), (None, "heads", None)),
        "wv_b": spec((kr, h, m.v_head_dim), (None, "heads", None)),
        "wo": spec((h, m.v_head_dim, d), ("heads", None, "fsdp")),
    }


def _norm(x, scale, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * scale
    return out.to(x.dtype)


def mla_latent(params, x, positions, cfg: ModelConfig):
    """Project to the compressed latent (what the KV cache stores)."""
    m = cfg.mla
    kv_a = x @ params["wkv_a"]
    c_kv, k_rope = kv_a[..., : m.kv_lora_rank], kv_a[..., m.kv_lora_rank :]
    c_kv = _norm(c_kv, params["kv_norm"])
    k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_queries(params, x, positions, cfg: ModelConfig):
    m = cfg.mla
    # whole rows into the norm: DTensor would split the product's columns
    # over ``model``, and the norm's backward would then split the sequence
    q_a = _norm(constrain(x @ params["wq_a"], "batch", None, None),
                params["q_norm"])
    q = constrain(_matmul(q_a, params["wq_b"]), "batch", None, "heads", None)
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_output(params, o_lat):
    """(B, S, H, kr) latent outputs through W_vb, then W_o."""
    o = _einsum("...hr,rhv->...hv", o_lat, params["wv_b"])
    return _einsum("...hv,hvd->...d", o, params["wo"])


def mla_attention(params, x, positions, cfg: ModelConfig, q_chunk=1024, kv_chunk=1024):
    """Prefill/train path: absorbed attention over the latent (no per-head KV).

    Scores: q_nope·W_kbᵀ gives a query in latent space; rope part adds a
    shared-key term. Attention then runs over (latent ⊕ rope-key) of width
    kv_lora_rank + rope_head_dim — the MLA cache economy — and the output is
    re-expanded through W_vb.
    """
    m = cfg.mla
    c_kv, k_rope = mla_latent(params, x, positions, cfg)      # (B,S,kr), (B,S,rd)
    q_nope, q_rope = mla_queries(params, x, positions, cfg)   # (B,S,H,*)
    # Absorb W_kb into the query: q_lat (B,S,H,kr)
    q_lat = constrain(torch.einsum("...hk,rhk->...hr", q_nope, params["wk_b"]),
                      "batch", None, "heads", None)
    q_eff = torch.cat([q_lat, q_rope], dim=-1)
    k_eff = torch.cat([c_kv, k_rope], dim=-1)[..., None, :]  # KV=1 head
    scale_fix = (m.nope_head_dim + m.rope_head_dim) ** -0.5 / (
        (m.kv_lora_rank + m.rope_head_dim) ** -0.5
    )
    o_lat = flash_attention(
        q_eff * scale_fix, k_eff, c_kv[..., None, :],
        causal=cfg.causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
    )  # (B,S,H,kr) — the value *is* the latent
    return _mla_output(params, o_lat)


def mla_decode(params, x, c_cache, krope_cache, cache_len, positions, cfg):
    """Decode against the latent cache. x: (B,1,D).  The new token's latent
    lands at cache_len - 1 in place."""
    m = cfg.mla
    c_new, kr_new = mla_latent(params, x, positions, cfg)
    write_seq(c_cache, cache_len - 1, c_new.to(c_cache.dtype))
    write_seq(krope_cache, cache_len - 1, kr_new.to(krope_cache.dtype))
    q_nope, q_rope = mla_queries(params, x, positions, cfg)
    q_lat = torch.einsum("...hk,rhk->...hr", q_nope, params["wk_b"])
    t = c_cache.shape[1]
    # Summed in the promoted (cache) dtype, then cast: the reference's
    # rounding point.
    s = (
        _einsum("bqhr,btr->bhqt", q_lat, c_cache)
        + _einsum("bqhr,btr->bhqt", q_rope, krope_cache)
    ).float() * ((m.nope_head_dim + m.rope_head_dim) ** -0.5)
    valid = torch.arange(t, device=x.device) < cache_len
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqt,btr->bqhr", p.to(c_cache.dtype), c_cache)
    return _mla_output(params, o_lat), c_cache, krope_cache
