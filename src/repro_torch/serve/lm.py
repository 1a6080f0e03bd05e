"""LM serving engine: prefill + decode over a preallocated KV cache (PyTorch
port of the JAX package's ``serve/lm.py``).

The serving layer's first-class surface is the streaming frequent-itemset
``MiningService`` (``repro_torch.serve.engine``); this LM engine serves the
model stack, and the ``launch/serve.py`` LM path is gated behind
``REPRO_LM=1`` as in the reference.

Batched requests, greedy or temperature sampling, and the reference's stop
handling: every row goes on until all rows have produced ``stop_token``,
and the output keeps the tokens a row produced after its stop.  Runs under
``torch.inference_mode()`` (on a mesh ``torch.no_grad()``) on ``device`` (default ``"cuda"``; a CUDA-less
machine raises unless the caller asks for ``"cpu"``).

On a mesh (``mesh=``, a ``DeviceMesh`` of ranks with ``data`` and
``model`` axes, and ``rules=``, a ``ShardingRules``) every rank runs the
same engine on the same prompts: the parameters (whole on every rank, as
from the same seed) and the cache are placed by ``shardings``, prefill and
decode run under ``use_sharding``, and each step's logits are gathered
whole before sampling, so every rank draws the same tokens.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.distributed.ctx import use_sharding, whole
from repro_torch.models import model as M
from repro_torch.models.params import materialize, place, shardings, tree_map


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 1024,
                 mesh=None, rules=None, device="cuda"):
        if (mesh is None) != (rules is None):
            raise ValueError("ServeEngine needs both mesh= and rules=, or "
                             "neither")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules
        if isinstance(params, nn.Module):  # an models.model.LM
            params = params.params
        self.params = tree_map(lambda t: t.to(self.device), params)
        if mesh is not None:
            self.params = place(self.params, mesh, shardings(
                M.abstract_params(cfg), mesh, rules.rules))
        self.max_len = max_len

    def _mode(self):
        """``inference_mode``, or on a mesh ``no_grad`` under
        ``use_sharding`` (DTensor cannot take views of parameters made
        outside inference mode inside it)."""
        if self.mesh is None:
            return torch.inference_mode()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(use_sharding(self.mesh, self.rules))
        return stack

    def generate(
        self,
        prompts: np.ndarray,          # (B, S_prompt) int32
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        stop_token: Optional[int] = None,
        rng: Optional[torch.Generator] = None,
        vis_embeds=None,
    ) -> np.ndarray:
        """``rng``: the ``torch.Generator`` (on ``device``) that sampling
        draws from; default seeded 0, like the reference's ``PRNGKey(0)``.
        ``vis_embeds``: (B, n_vis_tokens, d_model) patch embeddings for a
        vision config's cross layers (a tensor or an array, moved to the
        engine's device as it is)."""
        b, s_prompt = prompts.shape
        if s_prompt + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {s_prompt} + {max_new_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        if rng is None and temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(0)
        with self._mode():
            abstract = M.abstract_cache(self.cfg, b, self.max_len)
            cache = materialize(None, abstract, device=self.device)
            if self.mesh is not None:
                cache = place(cache, self.mesh, shardings(
                    abstract, self.mesh, self.rules.rules))
            batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                               device=self.device)}
            if vis_embeds is not None:
                batch["vis_embeds"] = torch.as_tensor(vis_embeds,
                                                      device=self.device)
            logits, cache = M.prefill(self.params, batch, self.cfg, cache)

            out = []
            done = np.zeros((b,), bool)
            tok = self._sample(logits, temperature, rng)
            for i in range(max_new_tokens):
                out.append(tok)
                if stop_token is not None:
                    done |= tok[:, 0].cpu().numpy() == stop_token
                    if done.all():
                        break
                if i + 1 == max_new_tokens:
                    break  # the next token would be dropped: no decode
                logits, cache = M.decode_step(
                    self.params, tok, cache, s_prompt + i + 1, self.cfg)
                tok = self._sample(logits, temperature, rng)
            return torch.cat(out, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits, temperature, rng):
        logits = whole(logits)
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng).to(torch.int32)
