"""The reference's stateful differential test of the streaming service
(``tests/test_serve_stateful.py``), against the PyTorch port.

The same random programs (the reference's batch generator, op mix and
hypothesis rules) drive ``repro.serve.MiningService`` (JAX, CPU) and the
port's ``MiningService(device="cpu")`` next to the reference's list mirror
of the window, through ``test_torch_serve.Pair``: after every step the
windows equal the mirror, exact answers equal each other and
``brute_force_frequent``, and stale answers are sound under their
certificates on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_serve_stateful import (  # noqa: E402
    HAVE_HYPOTHESIS, MAX_K, MS, N_ITEMS, N_SLOTS, SLOT_SIZE, _random_batch,
)
from test_torch_serve import Pair  # noqa: E402
from test_torch_stores import one_torch_thread  # noqa: E402,F401


def _stateful_pair():
    return Pair(False, mirror=True, min_support=MS, store="perfect_hash",
                n_slots=N_SLOTS, slot_size=SLOT_SIZE, eviction="basket",
                staleness=0.5, max_k=MAX_K)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stateful_fixed_seeds_against_reference(seed):
    """``test_serve_stateful.py``'s fixed-seed programs (same generator,
    same op mix), each step on both services and the list mirror."""
    rng = np.random.default_rng(seed)
    pair = _stateful_pair()
    try:
        ops = ("ingest", "evict", "query_exact", "query_stale", "refresh",
               "compact")
        probs = (0.35, 0.15, 0.15, 0.2, 0.1, 0.05)
        for _ in range(22):
            op = rng.choice(ops, p=probs)
            if op == "ingest":
                pair.ingest(_random_batch(rng))
            elif op == "evict":
                n = min(int(rng.integers(1, 5)), pair.t.window_size)
                if n:
                    pair.evict(n)
            elif op == "query_exact":
                pair.query()
            elif op == "query_stale":
                pair.stale(float(rng.choice([0.0, 0.4, 1.0])))
            elif op == "refresh":
                pair.refresh()
            else:
                pair.compact()
        pair.query()
    finally:
        pair.close()


if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck, settings
    from hypothesis import strategies as st
    from hypothesis.stateful import RuleBasedStateMachine, rule

    _basket = st.lists(st.integers(0, N_ITEMS - 1), min_size=1,
                       max_size=5).map(lambda b: sorted(set(b)))

    class PortServiceMachine(RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.pair = _stateful_pair()

        @rule(batch=st.lists(_basket, min_size=1, max_size=6))
        def ingest(self, batch):
            self.pair.ingest(batch)

        @rule(n=st.integers(1, 4))
        def evict(self, n):
            n = min(n, self.pair.t.window_size)
            if n:
                self.pair.evict(n)

        @rule()
        def query_exact(self):
            self.pair.query()

        @rule(s=st.sampled_from([0.0, 0.4, 1.0]))
        def query_stale(self, s):
            self.pair.stale(s)

        @rule()
        def refresh(self):
            self.pair.refresh()

        @rule()
        def compact(self):
            self.pair.compact()

        def teardown(self):
            self.pair.close()

    PortServiceMachine.TestCase.settings = settings(
        max_examples=3, stateful_step_count=8, deadline=None, derandomize=True,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large,
                               HealthCheck.filter_too_much])

    class TestPortServiceMachine(PortServiceMachine.TestCase):
        pass


