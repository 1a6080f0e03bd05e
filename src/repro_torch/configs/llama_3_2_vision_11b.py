"""Llama-3.2-Vision 11B — text decoder with interleaved gated cross-attention
image layers [hf:meta-llama/Llama-3.2-11B-Vision].

The vision tower is a stub: ``input_specs`` supplies precomputed patch
embeddings (B, n_vis_tokens, d_model) consumed by every 5th layer's
cross-attention (tanh-gated, zero-init).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    pattern=("attn", "attn", "attn", "cross", "attn"),
    frontend="vision_patches",
    n_vis_tokens=1600,
    rope_theta=500_000.0,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, n_vis_tokens=16,
    )
