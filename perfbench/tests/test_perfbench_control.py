"""The control and the faults: each must make a run come out as not
correct (CPU, at a small size)."""

from __future__ import annotations

import pytest
import torch

from perfbench import control
from perfbench.tests.conftest import run_cell


@pytest.mark.parametrize("cell", ["tiny-c2-packed_bitmap",
                                  "tiny-c3-bitmap"])
def test_the_bfloat16_control_is_not_correct(tiny_root, cell):
    for seed in (1, 2, 3):
        line = control.readings(tiny_root, cell, seed, "cpu")
        assert not line["correct"], line
        assert line["checks"]["hist_diff"] > 0


def test_the_float32_reference_in_the_controls_place_is_correct(tiny_root):
    line = control.readings(tiny_root, "tiny-c3-bitmap", 1, "cpu",
                            dtype=torch.float32)
    assert line["correct"], line


def _unchanged(orig):
    # the step hands back counts it never made: every support stays 0
    return lambda trans, cands: torch.zeros_like(orig(trans, cands))


def _half(orig):
    # half of the block's rows left out, the rest counted twice
    def half(trans, cands):
        n = next(iter(trans.values())).shape[0]
        kept = {k: v[:n // 2] for k, v in trans.items()}
        return orig(kept, cands) * 2
    return half


def _altered(orig):
    # one answer changed where it is produced
    def altered(trans, cands):
        out = orig(trans, cands).clone()
        out[0] += 1
        return out
    return altered


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap",
                                   "perfect_hash"])
def test_a_broken_count_is_not_correct(tiny_root, monkeypatch, fault, store):
    from repro_torch.core.stores import ARRAY_STORES

    cls = ARRAY_STORES[store]
    monkeypatch.setattr(cls, "count_block", staticmethod(
        fault(cls.count_block)))
    for job in ("tiny-c2", "tiny-c3"):
        rc, line = run_cell(tiny_root, f"{job}-{store}")
        assert rc == 0 and not line["correct"], line
        assert line["failed"] == line["attempted"] or \
            line["checks"]["cand_diff"]["value"] > 0
