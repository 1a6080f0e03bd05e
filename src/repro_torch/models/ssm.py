"""Mamba-2 SSD (state-space duality) mixer, PyTorch port of the JAX package's
``models/ssm.py``.

Chunked algorithm (Dao & Gu 2024): within-chunk outputs are block matmuls,
chunk-boundary states are carried by a linear recurrence over chunks (a
Python loop here, the reference's ``lax.scan``) on a (B, H, P, N) float32
state.  A prompt that is not a multiple of the chunk is right-padded, then
cut back.  Decode is the O(1) recurrent update on that state.

``ssd_scan`` also returns the final state: at padded positions dt is 0
(unit decay, no input), as the reference's separate final-state pass
(``blocks._ssd_final_state``) has it; outputs at real positions do not
change, since the within-chunk decay matrix is causal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import (
    active_sharding, as_dtensor, constrain, local_region)
from repro_torch.models.params import spec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = cfg.d_model * s.expand
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.d_state


def ssd_abstract(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, h, p, n = _dims(cfg)
    conv_dim = d_inner + 2 * n  # x, B, C all pass the causal conv
    return {
        # fused in-proj: [z, x, B, C, dt]
        "w_in": spec((d, 2 * d_inner + 2 * n + h), ("fsdp", "state")),
        "conv_w": spec((s.d_conv, conv_dim), (None, "state")),
        "conv_b": spec((conv_dim,), ("state",), init="zeros"),
        "a_log": spec((h,), ("state",), dtype=torch.float32, init="ones"),
        "d_skip": spec((h,), ("state",), dtype=torch.float32, init="ones"),
        "dt_bias": spec((h,), ("state",), dtype=torch.float32, init="zeros"),
        "norm_scale": spec((d_inner,), ("state",), dtype=torch.float32,
                           init="ones"),
        "w_out": spec((d_inner, d), ("state", "fsdp")),
    }


def _split_proj(params, u, cfg):
    d_inner, h, p, n = _dims(cfg)
    # split from whole rows: slicing the ``state``-split width gathers it
    # anyway, and a sliced gradient could come back split along the sequence
    zxbcdt = constrain(u @ params["w_in"], "batch", None, None)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner : 2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n :]
    dt = F.softplus(dt.float() + params["dt_bias"])
    return z, xbc, dt


def _causal_conv(params, xbc, cfg):
    """Depthwise causal conv over sequence. xbc: (B, S, conv_dim)."""
    k = cfg.ssm.d_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + xbc.shape[1]] * params["conv_w"][i]
              for i in range(k))
    return F.silu(out + params["conv_b"])


def _segsum(a):
    """log-space cumulative decay matrix: out[i,j] = sum_{j<k<=i} a[k],
    lower-tri, -inf above (exp gives 0 there, and gradient 0, not NaN)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, float("-inf"))


def _gated_norm(params, y, z):
    """gated RMSNorm (Mamba-2): norm(y * silu(z)), eps 1e-6, float32."""
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return y * params["norm_scale"]


def ssd_scan(params, u, cfg: ModelConfig):
    """u: (B, S, D) -> (out (B, S, D), final state (B, H, P, N) f32, the
    in-projection's xbc (B, S, conv_dim) before the conv)."""
    b, true_len, _ = u.shape
    d_inner, h, p, n = _dims(cfg)
    q = min(cfg.ssm.chunk, true_len)
    if true_len % q:  # causal: right-padding cannot affect earlier outputs
        u = F.pad(u, (0, 0, 0, q - true_len % q))
    seqlen = u.shape[1]

    z, xbc_in, dt = _split_proj(params, u, cfg)        # dt: (B,S,H) f32
    if seqlen > true_len:  # padded positions: unit decay, no input
        dt = dt * (torch.arange(seqlen, device=u.device) < true_len)[:, None]
    xbc = constrain(_causal_conv(params, xbc_in, cfg), "batch", None, "state")
    x = xbc[..., :d_inner].reshape(b, seqlen, h, p)
    bmat = xbc[..., d_inner : d_inner + n].float()     # (B,S,N)
    cmat = xbc[..., d_inner + n :].float()             # (B,S,N)

    a = -torch.exp(params["a_log"])                    # (H,) negative
    da = dt * a                                        # (B,S,H) log-decay
    dx = (x * dt[..., None].to(x.dtype)).float()

    y, state = _chunks(da, dx, bmat, cmat, q)
    y = y + params["d_skip"][:, None] * x.float()
    y = y.reshape(b, seqlen, d_inner)[:, :true_len]
    y = _gated_norm(params, y, z[:, :true_len])
    out = y.to(u.dtype) @ params["w_out"]
    return out, state, xbc_in[:, :true_len]


def _chunks(da, dx, bmat, cmat, q: int):
    """The chunked scan: (y (B, S, H, P) f32, final state (B, H, P, N)).
    On a mesh each rank scans its own batch rows and heads (every head and
    row is independent) on plain tensors, so the scan itself issues no
    collective: DTensor's einsums would flatten (B, H) split over two mesh
    axes."""
    if active_sharding() is None:
        return _scan(da, dx, bmat, cmat, q)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dx = constrain(dx, "batch", None, "state", None)
    mesh, pl = dx.device_mesh, dx.placements
    rows = [p if p == Shard(0) else Replicate() for p in pl]
    da = as_dtensor(da, mesh).redistribute(mesh, pl)
    # B and C are shared by every head: where the heads are split, each
    # rank's gradient of them is its heads' share of a sum
    shared = [Partial() if p == Shard(2) else r for p, r in zip(pl, rows)]
    bmat, cmat = (as_dtensor(t, mesh).redistribute(mesh, rows).to_local(
        grad_placements=shared) for t in (bmat, cmat))
    with local_region():
        y, state = _scan(da.to_local(), dx.to_local(), bmat, cmat, q)
    spl = [Shard(1) if p == Shard(2) else p for p in pl]
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(state, mesh, spl, run_check=False))


def _scan(da, dx, bmat, cmat, q: int):
    b, seqlen, h, p = dx.shape
    n = bmat.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dx.device)
    ys = []
    for c in range(seqlen // q):
        sl = slice(c * q, (c + 1) * q)
        dac, xc, bc, cc = da[:, sl], dx[:, sl], bmat[:, sl], cmat[:, sl]
        cum = torch.cumsum(dac, dim=1)                 # (B,Q,H)
        dsum = cum[:, -1]                              # (B,H)
        # within-chunk: scores shared over heads (n_groups = 1)
        l = torch.exp(_segsum(dac.transpose(1, 2)))    # (B,H,Q,Q)
        scores = torch.einsum("bln,bsn->bls", cc, bc)  # (B,Q,Q)
        y_diag = torch.einsum("bhls,bshp->blhp", scores[:, None] * l, xc)
        # contribution of the incoming state
        y_off = torch.einsum("bln,bhpn->blhp", cc, state) \
            * torch.exp(cum)[..., None]
        # state update
        decay_states = torch.exp(dsum[:, None, :] - cum)   # (B,Q,H)
        state = state * torch.exp(dsum)[..., None, None] + torch.einsum(
            "bsn,bshp->bhpn", bc, xc * decay_states[..., None])
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state                 # (B,S,H,P)


def ssd_layer(params, u, cfg: ModelConfig) -> torch.Tensor:
    """u: (B, S, D) -> (B, S, D)."""
    return ssd_scan(params, u, cfg)[0]


def ssd_decode_state_abstract(cfg: ModelConfig, batch: int):
    d_inner, h, p, n = _dims(cfg)
    k = cfg.ssm.d_conv
    conv_dim = d_inner + 2 * n
    return {
        "state": spec((batch, h, p, n), ("batch", "state", None, None),
                      dtype=torch.float32, init="zeros"),
        "conv_buf": spec((batch, k - 1, conv_dim), ("batch", None, "state"),
                         dtype=torch.bfloat16, init="zeros"),
    }


def ssd_decode(params, u, cache, cfg: ModelConfig):
    """u: (B, 1, D); cache: {"state": (B,H,P,N) f32, "conv_buf": (B,k-1,conv)}."""
    d_inner, h, p, n = _dims(cfg)
    z, xbc, dt = _split_proj(params, u, cfg)           # xbc: (B,1,conv)
    buf = torch.cat([cache["conv_buf"], xbc.to(cache["conv_buf"].dtype)], dim=1)
    conv = sum(buf[:, i : i + 1] * params["conv_w"][i]
               for i in range(cfg.ssm.d_conv))
    xbc_t = F.silu(conv + params["conv_b"])            # (B,1,conv)
    x = xbc_t[..., :d_inner].reshape(-1, 1, h, p)
    bvec = xbc_t[:, 0, d_inner : d_inner + n].float()
    cvec = xbc_t[:, 0, d_inner + n :].float()

    a = -torch.exp(params["a_log"])
    da = (dt[:, 0] * a).float()                        # (B,H)
    dx = (x * dt[..., None].to(x.dtype))[:, 0].float()  # (B,H,P)
    state = cache["state"] * torch.exp(da)[..., None, None] \
        + dx[..., None] * bvec[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cvec, state)
    y = y + params["d_skip"][None, :, None] * x[:, 0].float()
    y = _gated_norm(params, y.reshape(-1, 1, d_inner), z)
    out = y.to(u.dtype) @ params["w_out"]
    return out, {"state": state, "conv_buf": buf[:, 1:]}
