"""PyTorch port vs JAX package: the synthetic LM stream and frequent
token-set mining over it.  ``SyntheticLM``'s tokens and transactions equal
the reference's exactly; ``TokenSetMiner`` gives the reference's itemsets
AND supports through every store, and the same report."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analytics import TokenSetMiner as JTokenSetMiner  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402

from repro_torch.analytics import TokenSetMiner  # noqa: E402
from repro_torch.core.stores import ARRAY_STORES  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402


@pytest.mark.parametrize("seed,vocab,batch,seq", [
    (0, 1000, 2, 16), (3, 64, 4, 64), (7, 151_936, 3, 40)])
def test_batches_and_transactions_equal_reference(seed, vocab, batch, seq):
    ref, port = JSyntheticLM(vocab, batch, seq, seed=seed), \
        SyntheticLM(vocab, batch, seq, seed=seed)
    for step in (0, 1, 5):
        want, got = ref.batch_at(step), port.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].shape == (batch, seq)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        for window in (8, 16, 13):
            assert port.transactions_at(step, window) == \
                ref.transactions_at(step, window)


def test_iterator_resumes_mid_stream():
    port = SyntheticLM(500, 2, 8, seed=1)
    it = port.iterator(start_step=3)
    for step in (3, 4):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      port.batch_at(step)["tokens"].numpy())


@pytest.mark.parametrize("store", sorted(ARRAY_STORES))
def test_token_set_miner_equals_reference(store):
    ref_pipe, pipe = JSyntheticLM(64, 4, 64, seed=0), SyntheticLM(64, 4, 64, seed=0)
    kw = dict(min_support=0.2, store=store, window=16, max_k=3)
    want = JTokenSetMiner(**kw).mine_steps(ref_pipe, [0, 1])
    got = TokenSetMiner(**kw, device="cpu").mine_steps(pipe, [0, 1])
    assert got.itemsets == want.itemsets and got.itemsets
    assert (got.min_count, got.n_transactions) == (want.min_count,
                                                   want.n_transactions)
    assert max(len(s) for s in got.itemsets) >= 2
    assert TokenSetMiner.report(got) == JTokenSetMiner.report(want)
    assert TokenSetMiner.report(got, top=3) == JTokenSetMiner.report(want, top=3)


def test_token_set_miner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TokenSetMiner()
    assert TokenSetMiner(device="cpu").miner.store == "bitmap"
