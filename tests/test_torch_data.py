"""PyTorch port vs JAX package: the seeded dataset generators give the same
baskets for the same name, scale and seed."""

import pytest

pytest.importorskip("torch")

from repro.data import datasets as J  # noqa: E402
from repro.data import transactions as J_tx  # noqa: E402

from repro_torch.data import datasets as T  # noqa: E402
from repro_torch.data import transactions as T_tx  # noqa: E402


@pytest.mark.parametrize("name", sorted(T.DATASETS) + ["T5I2D10K"])
@pytest.mark.parametrize("seed", [0, 3])
def test_registry_same_baskets(name, seed):
    assert T.get_dataset(name, scale=0.01, seed=seed) == \
        J.get_dataset(name, scale=0.01, seed=seed)


def test_generators_same_baskets():
    kw = dict(n_transactions=300, avg_transaction_len=6, avg_pattern_len=3,
              n_items=80, n_patterns=40, seed=11)
    assert T_tx.quest_generator(**kw) == J_tx.quest_generator(**kw)
    assert T_tx.bms_webview_twin(500, 120, avg_len=3.1, seed=2) == \
        J_tx.bms_webview_twin(500, 120, avg_len=3.1, seed=2)


def test_quest_names():
    for name in ("T10I4D100K", "t40i10d1M", "T8I4D2K"):
        assert T.parse_quest_name(name) == J.parse_quest_name(name)
    with pytest.raises(ValueError):
        T.parse_quest_name("BMS")
    with pytest.raises(KeyError):
        T.get_dataset("no_such_dataset")
