"""Frequent token-set mining over the LM training stream (PyTorch port of
the JAX package's ``analytics/token_miner.py``).

Windows of training tokens are transactions, token ids are items, and the
port's ``FrequentItemsetMiner`` mines frequent token co-occurrence sets.
Every candidate store works; the default, ``bitmap``, counts through the
hand-written tensor-core kernel on the card and ``packed_bitmap`` through
the popcount kernel.  ``device`` and ``mesh`` pass through to the miner
(default device: the mesh's, else ``"cuda"``).
"""

from __future__ import annotations

from repro_torch.core.miner import FrequentItemsetMiner, MiningResult
from repro_torch.data.pipeline import SyntheticLM


class TokenSetMiner:
    def __init__(
        self,
        min_support: float = 0.05,
        store: str = "bitmap",
        window: int = 32,
        max_k: int = 4,
        mesh=None,
        device=None,
    ):
        self.window = window
        self.miner = FrequentItemsetMiner(
            min_support=min_support, store=store, max_k=max_k, mesh=mesh,
            device=device)

    def mine_steps(self, pipeline: SyntheticLM, steps) -> MiningResult:
        """Mine frequent token-sets from the given training steps' batches."""
        transactions = []
        for s in steps:
            transactions.extend(pipeline.transactions_at(s, self.window))
        return self.miner.mine(transactions)

    @staticmethod
    def report(result: MiningResult, top: int = 10) -> str:
        rows = sorted(result.itemsets.items(), key=lambda kv: -kv[1])[:top]
        lines = [f"frequent token-sets (min_count={result.min_count}, "
                 f"{result.n_transactions} windows):"]
        for s, c in rows:
            lines.append(f"  {list(s)} -> {c}")
        return "\n".join(lines)
