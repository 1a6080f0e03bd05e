"""Seeded transaction databases for the port (no JAX, no ``repro``)."""

from repro_torch.data.datasets import (
    DATASETS,
    get_dataset,
    parse_quest_name,
    quest_from_name,
)
from repro_torch.data.transactions import bms_webview_twin, quest_generator

__all__ = [
    "DATASETS",
    "bms_webview_twin",
    "get_dataset",
    "parse_quest_name",
    "quest_from_name",
    "quest_generator",
]
