"""StarCoder2 15B — GQA + RoPE, non-gated GELU MLP with biases [arXiv:2402.19173]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49_152,
    qkv_bias=True,
    mlp_bias=True,
    mlp_act="gelu",
    mlp_gated=False,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256,
    )
