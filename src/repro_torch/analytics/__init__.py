from repro_torch.analytics.token_miner import TokenSetMiner

__all__ = ["TokenSetMiner"]
