"""RecurrentGemma 2B (Griffin) — RG-LRU : RG-LRU : local-attn blocks
[arXiv:2402.19427]. Sub-quadratic: runs the long_500k shape."""

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    post_norms=False,
    mlp_act="gelu",
    tie_embeddings=True,
    rglru=RGLRUConfig(width=2560, d_conv=4),
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, window=32, rglru=RGLRUConfig(width=64, d_conv=4),
    )
