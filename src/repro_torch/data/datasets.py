"""Dataset subsystem: Quest-style names, a registry, ``.dat`` IO, skew knobs
(copied from the JAX package's ``data/datasets.py``; the same name, scale
and seed give the same baskets, and the ``.dense.npz`` sidecar has the same
keys, so either package reads the other's).

``parse_quest_name`` / ``quest_from_name``
    Decode a ``T<avg_len>I<avg_pattern_len>D<n_txns>`` code into generator
    parameters and build the database (seeded, offline).

``DATASETS`` registry (``get_dataset`` / ``list_datasets`` / ``register_dataset``)
    Named, seeded builders: the paper's three workloads, T40I10D100K, and
    the adversarial scenarios below.  Every builder takes ``(scale, seed)``.

``write_dat`` / ``read_dat`` / ``load_dense``
    The space-separated basket format (one transaction per line, ascending
    item ids), gzip-aware by ``.gz`` suffix.  ``load_dense`` decodes to the
    padded ``(N, L)`` int32 matrix and caches the decode in a ``.dense.npz``
    sidecar keyed on the source file's (size, mtime_ns) and the pad value.

Adversarial generators (``long_tail_db``, ``near_duplicate_db``,
``wide_sparse_db``)
    Skew/density shapes the Quest generator does not produce: a Zipf-heavy
    long tail with a hot head, near-duplicate baskets (tiny lattice, huge
    supports), and a wide sparse vocabulary (Job1/encode-bound).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import re
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.data.transactions import (
    Transactions,
    bms_webview_twin,
    encode_padded,
    quest_generator,
)

# -- Quest T/I/D names -------------------------------------------------------

_QUEST_RE = re.compile(r"^T(\d+)I(\d+)D(\d+)([KM]?)$", re.IGNORECASE)
_SUFFIX = {"": 1, "K": 1_000, "M": 1_000_000}


def parse_quest_name(name: str) -> Dict[str, int]:
    """``T10I4D100K`` -> generator parameters.

    T = average transaction length, I = average size of the potentially
    frequent patterns, D = number of transactions (K/M suffix = 1e3/1e6) —
    the IBM Quest naming the paper (and the whole FIM literature) uses.
    """
    m = _QUEST_RE.match(name.strip())
    if not m:
        raise ValueError(
            f"not a Quest dataset code: {name!r} (expected T<int>I<int>D<int>[K|M])"
        )
    t, i, d, suffix = m.groups()
    return {
        "avg_transaction_len": int(t),
        "avg_pattern_len": int(i),
        "n_transactions": int(d) * _SUFFIX[suffix.upper()],
    }


def quest_from_name(name: str, scale: float = 1.0, seed: int = 0,
                    n_items: int = 1000) -> Transactions:
    """Generate the database a Quest code names, optionally scaled down.

    ``scale`` multiplies D only (the paper scales workloads by transaction
    count; T and I are the shape of the data, not its size).
    """
    p = parse_quest_name(name)
    n = max(64, int(p["n_transactions"] * scale))
    return quest_generator(
        n_transactions=n,
        avg_transaction_len=p["avg_transaction_len"],
        avg_pattern_len=p["avg_pattern_len"],
        n_items=n_items,
        seed=seed,
    )


# -- adversarial skew/density generators -------------------------------------

def long_tail_db(n_transactions: int, n_items: int = 500, zipf_a: float = 2.2,
                 head_items: int = 4, head_prob: float = 0.85,
                 avg_len: float = 8.0, seed: int = 0) -> Transactions:
    """Long-tail item popularity with a forced hot head: ``head_items``
    appear in ~``head_prob`` of all baskets while the tail follows a steep
    Zipf, so supports span four orders of magnitude."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = ranks ** (-zipf_a)
    pop /= pop.sum()
    lens = np.maximum(1, rng.poisson(avg_len, n_transactions))
    out: Transactions = []
    for tlen in lens:
        tlen = int(min(tlen, n_items))
        items = set(int(x) for x in
                    rng.choice(n_items, size=tlen, replace=False, p=pop))
        for h in range(min(head_items, n_items)):
            if rng.random() < head_prob:
                items.add(h)
        out.append(sorted(items))
    return out


def near_duplicate_db(n_transactions: int, n_templates: int = 8,
                      n_items: int = 200, template_len: int = 12,
                      flip_prob: float = 0.05, seed: int = 0) -> Transactions:
    """Baskets cloned from a few templates with rare single-item edits: a
    tiny frequent lattice whose every survivor has enormous support."""
    rng = np.random.default_rng(seed)
    templates = [
        sorted(int(x) for x in
               rng.choice(n_items, size=template_len, replace=False))
        for _ in range(n_templates)
    ]
    out: Transactions = []
    for _ in range(n_transactions):
        base = list(templates[int(rng.integers(n_templates))])
        if rng.random() < flip_prob:
            base[int(rng.integers(len(base)))] = int(rng.integers(n_items))
        out.append(sorted(set(base)))
    return out


def wide_sparse_db(n_transactions: int, n_items: int = 20_000,
                   avg_len: float = 3.0, seed: int = 0) -> Transactions:
    """Huge item vocabulary, short baskets (density ~ avg_len / n_items):
    Job1's histogram and the dense re-encode sweep a wide vocabulary."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, rng.poisson(avg_len, n_transactions))
    out: Transactions = []
    for tlen in lens:
        tlen = int(min(tlen, n_items))
        out.append(sorted(int(x) for x in
                          rng.choice(n_items, size=tlen, replace=False)))
    return out


# -- registry ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """A named, seeded workload: ``build(scale, seed)`` -> transactions."""

    name: str
    build: Callable[[float, int], Transactions]
    kind: str          # "quest" | "twin" | "adversarial"
    description: str

    def __call__(self, scale: float = 1.0, seed: int = 0) -> Transactions:
        return self.build(scale, seed)


DATASETS: Dict[str, DatasetSpec] = {}


def register_dataset(spec: DatasetSpec) -> DatasetSpec:
    if spec.name in DATASETS:
        raise ValueError(f"dataset {spec.name!r} already registered")
    DATASETS[spec.name] = spec
    return spec


def get_dataset(name: str, scale: float = 1.0, seed: int = 0) -> Transactions:
    """Build a registered workload; unregistered Quest codes work too."""
    spec = DATASETS.get(name)
    if spec is not None:
        return spec(scale, seed)
    if _QUEST_RE.match(name.strip()):
        return quest_from_name(name, scale=scale, seed=seed)
    raise KeyError(
        f"unknown dataset {name!r}; registered: {sorted(DATASETS)} "
        "(any T<..>I<..>D<..> Quest code also works)"
    )


def list_datasets() -> List[DatasetSpec]:
    return [DATASETS[k] for k in sorted(DATASETS)]


def _scaled(n: int, scale: float) -> int:
    return max(64, int(n * scale))


register_dataset(DatasetSpec(
    "T10I4D100K",
    lambda scale, seed: quest_from_name("T10I4D100K", scale=scale, seed=seed),
    "quest", "the paper's synthetic workload (avg len 10, patterns 4, 100k txns)"))
register_dataset(DatasetSpec(
    "T40I10D100K",
    lambda scale, seed: quest_from_name("T40I10D100K", scale=scale, seed=seed),
    "quest", "denser Quest point used by the follow-up studies (avg len 40)"))
register_dataset(DatasetSpec(
    "BMS_WebView_1",
    lambda scale, seed: bms_webview_twin(_scaled(59_602, scale), 497,
                                         avg_len=2.5, seed=seed),
    "twin", "KDD-Cup-2000 click-stream statistical twin (59k txns, 497 items)"))
register_dataset(DatasetSpec(
    "BMS_WebView_2",
    lambda scale, seed: bms_webview_twin(_scaled(77_512, scale), 3340,
                                         avg_len=4.6, seed=seed),
    "twin", "KDD-Cup-2000 click-stream statistical twin (77k txns, 3340 items)"))
register_dataset(DatasetSpec(
    "long_tail",
    lambda scale, seed: long_tail_db(_scaled(100_000, scale), seed=seed),
    "adversarial", "Zipf tail + hot head: supports span 4 orders of magnitude"))
register_dataset(DatasetSpec(
    "near_duplicate",
    lambda scale, seed: near_duplicate_db(_scaled(100_000, scale), seed=seed),
    "adversarial", "template clones: tiny lattice, huge supports, reducer-bound"))
register_dataset(DatasetSpec(
    "wide_sparse",
    lambda scale, seed: wide_sparse_db(_scaled(100_000, scale), seed=seed),
    "adversarial", "20k-item vocabulary, 3-item baskets: Job1/encode-bound"))


# -- .dat basket format ------------------------------------------------------

def _opener(path: str):
    return gzip.open if str(path).endswith(".gz") else open


def write_dat(path: str, transactions: Sequence[Sequence[int]]) -> str:
    """Write space-separated basket format (one transaction per line, item
    ids ascending); gzip if ``.gz``."""
    with _opener(path)(path, "wt") as f:
        for t in transactions:
            f.write(" ".join(str(int(x)) for x in sorted(set(int(i) for i in t))))
            f.write("\n")
    return path


def read_dat(path: str) -> Transactions:
    """Read basket format; rows come back unique-sorted.  A blank line is an
    *empty transaction* and is kept: dropping it would change N, and with it
    every ``min_count = ceil(support * N)``."""
    out: Transactions = []
    with _opener(path)(path, "rt") as f:
        for line in f:
            out.append(sorted(set(int(x) for x in line.split())))
    return out


def _sidecar(path: str) -> str:
    return path + ".dense.npz"


def load_dense(path: str, pad: int = -1, cache: bool = True) -> np.ndarray:
    """Decode a ``.dat``(.gz) file to the padded ``(N, L)`` int32 matrix
    (rows unique-sorted ascending, ``pad``-filled).

    With ``cache=True`` the decode is kept in ``<path>.dense.npz`` (keys
    ``dense``, ``key`` = (size, mtime_ns) of the source, ``pad``); a matching
    sidecar skips the text parse, and an edited source invalidates it.
    """
    st = os.stat(path)
    key = np.array([st.st_size, int(st.st_mtime_ns)], dtype=np.int64)
    side = _sidecar(path)
    if cache and os.path.exists(side):
        with np.load(side) as z:
            if "key" in z.files and np.array_equal(z["key"], key) \
                    and int(z["pad"]) == pad:
                return z["dense"]
    dense = encode_padded(read_dat(path), pad=pad)
    if cache:
        tmp = side + ".tmp.npz"
        np.savez_compressed(tmp, dense=dense, key=key, pad=np.int64(pad))
        os.replace(tmp, side)
    return dense


def dense_to_transactions(dense: np.ndarray, pad: int = -1) -> Transactions:
    """Inverse of :func:`load_dense`: padded matrix -> transaction lists."""
    return [[int(x) for x in row[row != pad]] for row in np.asarray(dense)]
