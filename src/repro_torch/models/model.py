"""User-facing model API: abstract params, forward, prefill, decode (PyTorch
port of the JAX package's ``models/model.py``).

Works for every architecture of ``configs``: token LMs, the audio encoder
(frame embeddings in, frame classes out) and the vision-text model
(precomputed patch embeddings, ``batch["vis_embeds"]``, consumed by
interleaved cross-attention layers).

``loss_fn`` is the reference's: mean next-token cross-entropy over
``seq_chunk`` slices of the sequence (labels < 0 masked), the MoE aux term
and, with ``cfg.mtp``, the multi-token-prediction loss.  Like the
reference, it scores the last layer's hidden state without ``final_norm``.

``LM`` holds a parameter tree as an ``nn.Module`` (``state_dict`` keys are
the tree's paths); ``ServeEngine`` and ``convert.params_from_reference``
take one.  Its leaves are frozen; ``trainable`` arms a tree's leaves (a
plain tree's or ``LM.params``) for ``torch.autograd.grad``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import (
    active_sharding, constrain, recompute_context)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import spec, tree_map


# -- parameters -----------------------------------------------------------------

def abstract_params(cfg: ModelConfig):
    p: Dict = {"blocks": T.stack_abstract(cfg), "final_norm": L.rmsnorm_abstract(cfg.d_model)}
    if cfg.frontend != "audio_frames":
        p["embed"] = L.embedding_abstract(cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": spec((cfg.d_model, cfg.vocab_size), ("fsdp", "vocab"))}
    if cfg.mtp:
        from repro_torch.models import blocks as B

        kinds = B.layer_kinds(cfg)[-1]
        p["mtp"] = {
            "h_norm": L.rmsnorm_abstract(cfg.d_model),
            "e_norm": L.rmsnorm_abstract(cfg.d_model),
            "proj": {"w": spec((2 * cfg.d_model, cfg.d_model), (None, "fsdp"))},
            "block": B.layer_abstract(cfg, *kinds),
        }
    return p


def _embed_in(params, batch, cfg: ModelConfig):
    if cfg.frontend == "audio_frames":
        x = batch["frames"]
    else:
        x = L.embed(params["embed"], batch["tokens"])
        if cfg.post_norms:  # gemma-family convention: scale embeddings
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg.final_softcap)
    logits = (x @ params["lm_head"]["w"]).float()
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _positions(b: int, s: int, device, start: int = 0):
    return (start + torch.arange(s, device=device)).expand(b, s)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence hidden states. Returns (x, aux)."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    return T.stack_apply(
        params["blocks"], x, cfg, positions=_positions(b, s, x.device),
        vis_embeds=batch.get("vis_embeds"),
    )


def _ce_chunk(params, x_chunk, labels_chunk, cfg):
    """(sum of the masked token losses, count of unmasked labels)."""
    logits = _logits(params, x_chunk, cfg)              # (B, c, V) f32
    logits = constrain(logits, "batch", None, "vocab")
    lse = torch.logsumexp(logits, dim=-1)
    # A masked label gathers column 0 (the reference wraps it to V - 1):
    # either way the product with the mask is 0.
    idx = labels_chunk.clamp(min=0).long()[..., None]
    if active_sharding() is None:
        ll = torch.gather(logits, -1, idx)[..., 0]
    else:  # a masked sum over the sharded vocab: one term, the same value
        hit = torch.arange(logits.shape[-1], device=idx.device) == idx
        ll = torch.where(hit, logits, 0.0).sum(dim=-1)
    mask = labels_chunk >= 0
    return torch.sum((lse - ll) * mask), torch.sum(mask).float()


def loss_fn(params, batch, cfg: ModelConfig, aux_coef: float = 0.01,
            seq_chunk: int = 512):
    """Mean next-token CE (labels < 0 are masked) + MoE aux loss.

    The unembedding is evaluated in sequence chunks so the (B, S, V) logits
    tensor is never materialized (V up to 256k).  Unless
    ``cfg.unroll_loops``, each whole chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scan body), so backward holds one chunk's float32 logits at a time; the
    remainder past ``n_chunks * seq_chunk`` runs unwrapped, as there.
    Returns (total, {"ce", "aux"}).
    """
    x, aux = forward(params, batch, cfg)
    # On a mesh the last layer may leave x split along the sequence, which
    # the chunks' flatten cannot carry: whole rows, as each layer starts.
    x = constrain(x, "batch", None, None)
    labels = batch["labels"]
    s = x.shape[1]
    seq_chunk = min(seq_chunk, s)
    n_chunks = s // seq_chunk
    usable = n_chunks * seq_chunk

    wrap = not cfg.unroll_loops and torch.is_grad_enabled()
    context_fn = recompute_context()
    kw = {} if context_fn is None else {"context_fn": context_fn}
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * seq_chunk, (c + 1) * seq_chunk)
        args = (params, x[:, sl], labels[:, sl], cfg)
        t, n = (checkpoint(_ce_chunk, *args, use_reentrant=False, **kw)
                if wrap else _ce_chunk(*args))
        tot, cnt = tot + t, cnt + n
    if usable < s:
        t2, c2 = _ce_chunk(params, x[:, usable:], labels[:, usable:], cfg)
        tot, cnt = tot + t2, cnt + c2
    loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + aux_coef * aux
    metrics = {"ce": loss, "aux": aux}

    if cfg.mtp and "mtp" in params:
        total = total + cfg.mtp_lambda * _mtp_loss(params, x, batch, cfg)
    return total, metrics


def _mtp_loss(params, h, batch, cfg: ModelConfig):
    """DeepSeek-V3 multi-token prediction: one extra block consumes the trunk
    hidden state at t fused with the embedding of token t+1 and predicts the
    label at t+1 (i.e. token t+2). Positions without a t+2 label are masked.
    """
    from repro_torch.models import blocks as B

    mp = params["mtp"]
    labels = batch["labels"]
    b, s = labels.shape
    # embedding of the next input token = the label at t (token t+1)
    nxt = torch.clamp(labels, 0, cfg.vocab_size - 1)
    e_next = L.embed(params["embed"], nxt)
    fused = torch.cat(
        [L.rmsnorm(mp["h_norm"], h), L.rmsnorm(mp["e_norm"], e_next)], dim=-1)
    x = fused @ mp["proj"]["w"]
    kinds = B.layer_kinds(cfg)[-1]
    x, _ = B.layer_apply(mp["block"], x, *kinds, cfg,
                         positions=_positions(b, s, x.device),
                         vis_embeds=batch.get("vis_embeds"))
    # predict token t+2: label for position t is labels[t+1]
    mtp_labels = torch.cat(
        [labels[:, 1:], torch.full((b, 1), -1, dtype=labels.dtype,
                                   device=labels.device)], dim=1)
    tot, cnt = _ce_chunk(params, x, mtp_labels, cfg)
    return tot / torch.clamp(cnt, min=1.0)


# -- serving ----------------------------------------------------------------------

def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return T.cache_abstract(cfg, batch, max_len)


def prefill(params, batch, cfg: ModelConfig, cache):
    """Returns (last-position logits (B, V), filled cache)."""
    x = _embed_in(params, batch, cfg)
    b, s = x.shape[:2]
    x, cache = T.stack_prefill(
        params["blocks"], x, cfg, cache, positions=_positions(b, s, x.device),
        vis_embeds=batch.get("vis_embeds"),
    )
    x = L.rmsnorm(params["final_norm"], x[:, -1:])
    return _logits(params, x, cfg)[:, 0], cache


def decode_step(params, tokens, cache, cache_len: int, cfg: ModelConfig):
    """tokens: (B, 1) int32; cache_len: length incl. this token.

    Returns (logits (B, V), cache) with the cache written in place.
    """
    cache_len = int(cache_len)
    x = _embed_in(params, {"tokens": tokens}, cfg)
    positions = _positions(x.shape[0], 1, x.device, start=cache_len - 1)
    x, cache = T.stack_decode(
        params["blocks"], x, cfg, cache, cache_len, positions=positions
    )
    x = L.rmsnorm(params["final_norm"], x)
    return _logits(params, x, cfg)[:, 0], cache


# -- module -----------------------------------------------------------------------

def trainable(tree):
    """``tree`` with every leaf set, in place, to take gradients: what
    ``materialize``, ``convert`` and ``checkpoint.restore`` return takes
    none, and the train step differentiates with respect to the leaves."""
    return tree_map(lambda t: t.requires_grad_(True), tree)


class _Tree(nn.Module):
    """One dict level of a parameter tree: sub-dicts become submodules,
    tensors frozen parameters (sharing their storage)."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def as_tree(self):
        out = {k: m.as_tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LM(nn.Module):
    """The parameter tree of ``cfg`` as an ``nn.Module``; ``params`` gives
    the tree back for the functions of this module.  Serving takes it
    frozen; ``trainable(lm.params)`` arms its leaves for training."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @property
    def params(self):
        return self.tree.as_tree()

    def forward(self, batch):
        return forward(self.params, batch, self.cfg)
