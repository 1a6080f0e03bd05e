"""Architecture registry: ``get_config(name)`` / ``get_reduced(name)``
(PyTorch port of the JAX package's registry; the same ten architectures).

Cell skips: long_500k only for sub-quadratic archs
(mamba2, recurrentgemma); encoder-only archs (hubert) have no decode shapes.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
}

ARCHS = list(_MODULES)

_SUBQUADRATIC = {"mamba2-2.7b", "recurrentgemma-2b"}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; pick from {ARCHS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return importlib.import_module(_MODULES[name]).reduced()


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    cfg = get_config(arch)
    sh = LM_SHAPES[shape]
    if sh.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "long-context decode needs sub-quadratic attention"
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells."""
    out = []
    for a in ARCHS:
        for s in LM_SHAPES:
            ok, why = shape_applicable(a, s)
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out
