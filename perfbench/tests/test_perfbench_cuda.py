"""The benchmark on a card: small cells through the harness on the card,
the control on the card, and the device trace's readers (``cuda``: each
test skips without a card)."""

from __future__ import annotations

import pytest
import torch

from perfbench import control, generator
from perfbench.tests.conftest import run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_the_generator_on_the_card_repeats(card):
    a = generator.quest(5000, 10, 4, seed=3, device=card)
    b = generator.quest(5000, 10, 4, seed=3, device=card)
    assert (a.items == b.items).all() and (a.offsets == b.offsets).all()
    assert 10 <= a.lengths().mean() <= 11


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap",
                                   "perfect_hash"])
def test_small_cells_on_the_card(card, tiny_root, store):
    for job in ("tiny-c2", "tiny-c3"):
        rc, line = run_cell(tiny_root, f"{job}-{store}", device="cuda")
        assert rc == 0 and line["correct"], line
        assert line["device"]["platform"] == "gpu"
        rc, line = run_cell(tiny_root, f"{job}-{store}", device="cuda",
                            trace=1)
        assert rc == 0 and line["correct"], line
        assert line["device"]["busy_s"] > 0
        metrics = line["metrics"]
        assert 0 < metrics["idle_pct"]["value"] < 100
        for name in ("k1_roofline_pct", "k2_roofline_pct"):
            if name in metrics:
                assert 0 < metrics[name]["value"] <= 105


def test_the_control_on_the_card_is_not_correct(card, tiny_root):
    for seed in (1, 2, 3):
        line = control.readings(tiny_root, "tiny-c3-bitmap", seed, "cuda")
        assert not line["correct"], line
