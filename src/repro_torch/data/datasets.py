"""Named workloads: Quest ``T<avg_len>I<avg_pattern_len>D<n_txns>`` codes and
a registry of the paper's datasets (copied from the JAX package's
``data/datasets.py``; the same name, scale and seed give the same baskets).

Registered: ``T10I4D100K``, ``T40I10D100K``, ``BMS_WebView_1`` and
``BMS_WebView_2``; any other Quest code also works.  The adversarial
generators and the ``.dat`` IO are not ported yet.
"""

from __future__ import annotations

import re
from typing import Callable, Dict

from repro_torch.data.transactions import (
    Transactions,
    bms_webview_twin,
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


# -- registry ----------------------------------------------------------------

def _scaled(n: int, scale: float) -> int:
    return max(64, int(n * scale))


DATASETS: Dict[str, Callable[[float, int], Transactions]] = {
    "T10I4D100K": lambda scale, seed: quest_from_name(
        "T10I4D100K", scale=scale, seed=seed),
    "T40I10D100K": lambda scale, seed: quest_from_name(
        "T40I10D100K", scale=scale, seed=seed),
    "BMS_WebView_1": lambda scale, seed: bms_webview_twin(
        _scaled(59_602, scale), 497, avg_len=2.5, seed=seed),
    "BMS_WebView_2": lambda scale, seed: bms_webview_twin(
        _scaled(77_512, scale), 3340, avg_len=4.6, seed=seed),
}


def get_dataset(name: str, scale: float = 1.0, seed: int = 0) -> Transactions:
    """Build a registered workload; unregistered Quest codes work too."""
    build = DATASETS.get(name)
    if build is not None:
        return build(scale, seed)
    if _QUEST_RE.match(name.strip()):
        return quest_from_name(name, scale=scale, seed=seed)
    raise KeyError(
        f"unknown dataset {name!r}; registered: {sorted(DATASETS)} "
        "(any T<..>I<..>D<..> Quest code also works)"
    )
