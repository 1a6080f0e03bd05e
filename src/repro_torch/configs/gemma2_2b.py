"""Gemma-2 2B — local/global alternating attention, logit softcaps, GeGLU,
pre+post norms, tied embeddings [arXiv:2408.00118]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    mlp_act="gelu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, window=64,
    )
