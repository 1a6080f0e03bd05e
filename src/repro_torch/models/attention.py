"""Attention: GQA / MQA / sliding-window, with a memory-bounded chunked flash
implementation (online softmax over KV blocks).  PyTorch port of the JAX
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

Multi-head latent attention (MLA) waits for its slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _matmul, rope
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
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    groups = h // kvh
    qg = q.reshape(b, kvh, groups, d)
    s = _einsum("bkgd,bskd->bkgs", qg, k_cache).float() * (d ** -0.5)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(t, device=q.device)
    valid = pos < cache_len
    if window is not None:
        valid &= pos >= cache_len - window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(b, 1, h, dv).to(q.dtype)


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
    q = _matmul(x, params["wq"])
    k = _matmul(kv_x, params["wk"])
    v = _matmul(kv_x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_output(params, attn_out):
    wo = params["wo"]
    return attn_out.reshape(*attn_out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])
