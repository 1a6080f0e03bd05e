"""Mamba-2 2.7B — attention-free SSD [arXiv:2405.21060].

Sub-quadratic: runs the long_500k shape with an O(1) recurrent decode state.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # no separate MLP: the SSD block is the layer
    vocab_size=50_280,
    attention="none",
    pattern=("ssd",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, head_dim=8, expand=2, d_conv=4, chunk=32),
    )
