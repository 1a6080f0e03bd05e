"""Seeded transaction databases, ``.dat`` IO and out-of-core streaming for
the port (no JAX, no ``repro``)."""

from repro_torch.data.transactions import (
    quest_generator,
    bms_webview_twin,
    paper_datasets,
    encode_padded,
    encode_bitmap,
)
from repro_torch.data.datasets import (
    DATASETS,
    DatasetSpec,
    dense_to_transactions,
    get_dataset,
    list_datasets,
    load_dense,
    long_tail_db,
    near_duplicate_db,
    parse_quest_name,
    quest_from_name,
    read_dat,
    register_dataset,
    wide_sparse_db,
    write_dat,
)
from repro_torch.data.chunked import ChunkedDatasetReader
from repro_torch.data.stream import ArrivalBatch, basket_stream

__all__ = [
    "ArrivalBatch",
    "basket_stream",
    "ChunkedDatasetReader",
    "quest_generator",
    "bms_webview_twin",
    "paper_datasets",
    "encode_padded",
    "encode_bitmap",
    "DATASETS",
    "DatasetSpec",
    "dense_to_transactions",
    "get_dataset",
    "list_datasets",
    "load_dense",
    "long_tail_db",
    "near_duplicate_db",
    "parse_quest_name",
    "quest_from_name",
    "read_dat",
    "register_dataset",
    "wide_sparse_db",
    "write_dat",
]
