"""Architecture and shape configuration dataclasses (PyTorch port of the
JAX package's ``configs/base.py``: the same fields and defaults).

``param_count`` and ``active_param_count`` count the port's abstract tree,
one tree per layer; for all ten architectures they equal the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    n_dense_layers: int = 0       # leading layers that use a dense FFN instead
    dense_ff: int = 0             # width of those dense FFNs
    capacity_factor: float = 1.25
    group_size: int = 1024        # GShard token-group size (bounds dispatch mem)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0                # 0 -> d_model
    d_conv: int = 4
    block_width: int = 0          # diagonal-block size for the gate projections


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention behaviour
    attention: str = "gqa"        # gqa | mla | none
    causal: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None          # sliding-window size for local layers
    rope_theta: float = 10_000.0
    # per-layer pattern, cycled over layers: entries are temporal-mixer kinds
    #   "attn" (global), "local", "rglru", "ssd", "cross"
    pattern: Tuple[str, ...] = ("attn",)
    post_norms: bool = False      # gemma2-style post-sublayer norms
    mlp_act: str = "silu"
    mlp_gated: bool = True
    tie_embeddings: bool = False
    # mixers
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # multi-token prediction (DeepSeek-V3 MTP: one extra block predicts t+2)
    mtp: bool = False
    mtp_lambda: float = 0.3
    # modality frontends (stub: precomputed embeddings arrive as inputs)
    frontend: Optional[str] = None        # audio_frames | vision_patches
    n_vis_tokens: int = 1600
    d_vis: int = 0                        # 0 -> d_model
    encoder_only: bool = False
    # numerics / memory knobs (hillclimbing targets)
    remat: str = "full"           # full | dots | none
    scan_layers: bool = True
    unroll_loops: bool = False    # cost probes: python loops instead of lax.scan
    attn_chunk: int = 1024        # flash-attention KV block
    attn_scores_f32: bool = True  # False: bf16 score tiles (TPU-fusion proxy)
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def param_count(self) -> int:
        from repro_torch.models.model import abstract_params
        from repro_torch.models.params import count_params

        return count_params(abstract_params(self))

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE rooflines.  The reference
        tests each ``experts`` leaf of a scanned layer at its stacked size
        (n_super layers), so a scanned layer's router counts as routed
        too; the port keeps that rule through ``stacked_layers``."""
        from repro_torch.models.model import abstract_params
        from repro_torch.models.params import count_params, tree_leaves
        from repro_torch.models.transformer import stacked_layers

        tree = abstract_params(self)
        if self.moe is None:
            return count_params(tree)
        stacked = {str(i): len(g) for g in stacked_layers(self) for i in g}
        parts = [(1, v) for k, v in tree.items() if k != "blocks"]
        parts += [(stacked.get(i, 1), v) for i, v in tree["blocks"].items()]
        total = 0
        for depth, part in parts:
            for leaf in tree_leaves(part):
                n = 1
                for s in leaf.shape:
                    n *= s
                if ("experts" in leaf.axes
                        and depth * n > self.moe.n_experts * self.d_model):
                    n = n // self.moe.n_experts * self.moe.top_k  # routed experts
                total += n
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode
    microbatches: int = 1         # grad-accumulation steps (train only)


LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
