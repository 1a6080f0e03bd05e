"""DeepSeek-V3 671B — MLA + 1 shared/256 routed top-8 MoE [arXiv:2412.19437].

MTP (multi-token prediction) is an optional extra head of the training
step (off by default).  The port builds, serves and trains this config:
MLA (``models/attention.py``), the MoE (``models/moe.py``) and MTP
(``models/model.py``).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129_280,
    attention="mla",
    pattern=("mla",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
        n_dense_layers=3, dense_ff=18432,
    ),
)


def reduced() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      n_dense_layers=1, dense_ff=128, group_size=64),
    )
