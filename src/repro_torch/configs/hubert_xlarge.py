"""HuBERT X-Large — encoder-only audio transformer [arXiv:2106.07447].

The conv waveform frontend is a stub: ``input_specs`` supplies precomputed
frame embeddings (B, S, 1280); the "vocab" (504) is the k-means target
codebook for masked-frame classification. No decode shapes (encoder-only).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    frontend="audio_frames",
    mlp_act="gelu",
    mlp_gated=False,
    mlp_bias=True,
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=32,
    )
