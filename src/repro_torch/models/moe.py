"""Mixture-of-Experts with GShard-style capacity dispatch, PyTorch port of the
JAX package's ``models/moe.py``.

Tokens are cut into groups (the largest divisor of B·S that is at most
``moe.group_size``); each expert takes at most ``_capacity`` tokens of a
group.  Slots are assigned by an iterative top-k with a per-expert cumsum in
token order; a token past an expert's capacity is dropped (combine weight
0), the standard GShard trade, and the kept gates are renormalised.
Dispatch and combine are the reference's dense (G, S, E, C) one-hot
einsums, the expert FFN a batched product over (E, G, C, D).  The router
runs in float32 and a load-balance aux loss is returned.  ``moe_layer`` is
``group``, ``router_probs``, ``route`` and ``experts`` in turn, so a caller
can feed one device's routing to another's experts.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import active_sharding, constrain
from repro_torch.models.layers import _act, mlp, mlp_abstract
from repro_torch.models.params import spec


def moe_abstract(cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": spec((d, e), ("fsdp", "experts"), dtype=torch.float32),
        "w_up": spec((e, d, f), ("experts", "fsdp", None)),
        "w_gate": spec((e, d, f), ("experts", "fsdp", None)),
        "w_down": spec((e, f, d), ("experts", None, "fsdp")),
    }
    if m.n_shared:
        p["shared"] = mlp_abstract(cfg, d_ff=m.d_ff_expert * m.n_shared)
    return p


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(probs, top_k: int, cap: int, dtype):
    """Iterative top-k slot assignment over (G, S, E) router probabilities:
    (dispatch (G,S,E,C) one-hot in ``dtype``, combine (G,S,E,C) float32
    with the kept gates renormalised)."""
    g, s, e = probs.shape
    remaining = probs
    dispatch = torch.zeros((g, s, e, cap), dtype=dtype, device=probs.device)
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=probs.device)
    position_in_expert = torch.zeros((g, e), dtype=torch.int32,
                                     device=probs.device)
    weight_sum = torch.zeros((g, s), dtype=torch.float32, device=probs.device)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # (G,S)
        onehot = F.one_hot(idx, e).float()                       # (G,S,E)
        gate = (remaining * onehot).sum(-1)                      # (G,S)
        remaining = remaining * (1.0 - onehot)
        pos = position_in_expert[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        pos = (pos * onehot).sum(-1).to(torch.int32)             # (G,S) slot idx
        fits = pos < cap
        # jax.nn.one_hot gives a zero row past the last class; so does the
        # clamp times ``fits``.
        pos_oh = F.one_hot(pos.clamp(max=cap - 1).long(), cap).float()
        contrib = onehot[..., None] * pos_oh[:, :, None, :] * fits[..., None, None]
        dispatch = dispatch + contrib.to(dtype)
        combine = combine + contrib * gate[..., None, None]
        position_in_expert = position_in_expert + (
            onehot * fits[..., None]).sum(dim=1).to(torch.int32)
        weight_sum = weight_sum + gate * fits

    # Renormalize kept top-k gates (DeepSeek-style normalized routing).
    combine = combine / torch.clamp(weight_sum[..., None, None], min=1e-9)
    return dispatch, combine


def group(x, cfg: ModelConfig):
    """x (B, S, D) as (G, S_g, D): S_g the largest divisor of the token
    count that is at most ``moe.group_size``."""
    b, s0, d = x.shape
    tokens = b * s0
    sg = min(cfg.moe.group_size, tokens)
    while tokens % sg:
        sg -= 1
    return x.reshape(tokens // sg, sg, d)


def router_probs(params, xg):
    """(G, S, E) float32 softmax of the float32 router logits."""
    logits = constrain(xg.float() @ params["router"].float(), "batch", None,
                       None)
    return torch.softmax(logits, dim=-1)


def _routed(xg, dispatch, combine, w_up, w_gate, w_down, act):
    """The routed experts' FFN over (E, G, C, D) and the combine."""
    xin = torch.einsum("gsec,gsd->egcd", dispatch, xg)           # all-to-all in
    h = act(torch.einsum("egcd,edf->egcf", xin, w_up))
    if w_gate is not None:
        h = h * torch.einsum("egcd,edf->egcf", xin, w_gate)
    hout = torch.einsum("egcf,efd->egcd", h, w_down)             # expert FFN
    return torch.einsum("egcd,gsec->gsd", hout, combine.to(xg.dtype))


def _routed_sharded(xg, dispatch, combine, ws, act):
    """``_routed`` with experts on the model axis (expert parallelism):
    dispatch and combine are placed ("batch", None, "experts", None), the
    expert weights ("experts", None, None) (their FSDP dims gathered),
    the tokens ("batch", None, None); each rank runs its own experts on
    its own groups, so (E, G, C, *) stays ("experts", "batch", None, None)
    as the reference constrains it.  Each rank's combine is a partial sum
    over its experts: the partials stand on a leading axis sharded like
    the experts, and their sum is the all-reduce."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dispatch = constrain(dispatch, "batch", None, "experts", None)
    combine = constrain(combine, "batch", None, "experts", None)
    xg = constrain(xg, "batch", None, None)
    ws = [None if w is None else constrain(w, "experts", None, None)
          for w in ws]
    # The tokens are whole along the experts' mesh axes, but each rank's
    # gradient of them covers its own experts only: a partial sum there.
    ep = [p == Shard(2) for p in dispatch.placements]
    x_local = xg.to_local(grad_placements=[
        Partial() if e else p for e, p in zip(ep, xg.placements)])
    local = _routed(x_local, dispatch.to_local(), combine.to_local(),
                    *(None if w is None else w.to_local() for w in ws), act)
    parts = [Shard(0) if e else Shard(1) if p == Shard(0) else Replicate()
             for e, p in zip(ep, dispatch.placements)]
    parts = DTensor.from_local(local[None], dispatch.device_mesh, parts,
                               run_check=False)
    return constrain(parts.sum(0), "batch", None, None)


def experts(params, xg, dispatch, combine, cfg: ModelConfig):
    """The routed experts' FFN over (E, G, C, D) and the combine, plus the
    shared expert: (G, S, D)."""
    ws = (params["w_up"], params.get("w_gate"), params["w_down"])
    act = _act(cfg.mlp_act)
    if active_sharding() is None:
        out = _routed(xg, dispatch, combine, *ws, act)
    else:
        out = _routed_sharded(xg, dispatch, combine, ws, act)
    if "shared" in params:
        out = out + mlp(params["shared"], xg, cfg)
    return out


def moe_layer(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    m = cfg.moe
    xg = group(x, cfg)
    s = xg.shape[1]
    probs = router_probs(params, xg)                             # (G,S,E)
    dispatch, combine = route(probs, m.top_k, _capacity(s, cfg), x.dtype)
    out = experts(params, xg, dispatch, combine, cfg)

    # Load-balance aux: E * mean_e(fraction_dispatched_e * mean_prob_e).
    frac = dispatch.sum(dim=(1, 3)) / max(1, s * m.top_k)       # (G,E)
    mean_prob = probs.mean(dim=1)                                # (G,E)
    aux = m.n_experts * torch.mean(torch.sum(frac.float() * mean_prob, dim=-1))
    return out.reshape(x.shape), aux
