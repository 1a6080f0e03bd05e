"""Deterministic, resumable LM data pipeline (synthetic corpus), PyTorch
port of the JAX package's ``data/pipeline.py``.

Sequence-packed token batches from a seeded Zipf-Markov synthetic corpus.
The generation is numpy with the reference's seed scheme
(``default_rng((seed, step))``), so ``batch_at(step)`` gives the
reference's token values exactly, as int32 torch tensors on the CPU, and is
a pure function of (seed, step): a restart resumes mid-stream exactly.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 n_states: int = 64):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Markov chain over latent states, each emitting a Zipf slice of vocab.
        self.trans = rng.dirichlet(np.ones(n_states) * 0.2, size=n_states)
        self.state_offsets = rng.integers(0, max(1, vocab_size - 256), n_states)

    def _tokens_at(self, step: int) -> np.ndarray:
        """(batch, seq_len + 1) int32: inputs and their shifted labels."""
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq_len
        states = np.zeros((b,), np.int64)
        toks = np.zeros((b, s + 1), np.int32)
        ranks = rng.zipf(1.5, size=(b, s + 1)).clip(1, 256) - 1
        u = rng.random((b, s + 1))
        for t in range(s + 1):
            cum = np.cumsum(self.trans[states], axis=1)
            states = (u[:, t : t + 1] < cum).argmax(axis=1)
            toks[:, t] = (self.state_offsets[states] + ranks[:, t]) % self.vocab_size
        return toks

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        toks = self._tokens_at(step)
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
        }

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def transactions_at(self, step: int, window: int = 32):
        """Expose the same stream as itemset transactions for token-set mining
        (``repro_torch.analytics``): each whole window of tokens is one
        transaction, row by row."""
        toks = self._tokens_at(step)[:, :-1]
        n = toks.shape[1] // window
        wins = toks[:, : n * window].reshape(-1, window)
        return [sorted(set(w)) for w in wins.tolist()]
