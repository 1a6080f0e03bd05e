"""User-facing model API: abstract params, forward, prefill, decode (PyTorch
port of the JAX package's ``models/model.py``).

Token LMs and the audio encoder (frame embeddings in) run through the dense
layer kinds the port has; architectures with an unported mixer raise
``NotImplementedError`` when their tree is built (ROADMAP.md).  ``loss_fn``
and the multi-token-prediction loss belong to the training slice.

``LM`` holds a parameter tree as an ``nn.Module`` (``state_dict`` keys are
the tree's paths); ``ServeEngine`` and ``convert.params_from_reference``
take one.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import spec


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
    the tree back for the functions of this module."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @property
    def params(self):
        return self.tree.as_tree()

    def forward(self, batch):
        return forward(self.params, batch, self.cfg)
