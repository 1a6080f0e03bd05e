"""The LM of the PyTorch port: parameter trees (``params``), layers,
chunked flash attention and MLA, the other mixers (``rglru``, ``ssm``,
``moe``), blocks, the layer stack and the model API (``model``), plus
``convert``, which carries the JAX package's weights across.  Plain torch
ops on ``device=`` tensors; no JAX, no ``repro``."""

from repro_torch.models.convert import cache_from_reference, params_from_reference
from repro_torch.models.model import LM
from repro_torch.models.params import materialize

__all__ = ["LM", "cache_from_reference", "materialize", "params_from_reference"]
