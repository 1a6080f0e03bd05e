"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,               # dense-head FFN width
    vocab_size=163_840,
    attention="gqa",
    pattern=("attn",),
    moe=MoEConfig(
        n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
        n_dense_layers=1, dense_ff=18432,
    ),
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      n_dense_layers=1, dense_ff=128, group_size=64),
    )
