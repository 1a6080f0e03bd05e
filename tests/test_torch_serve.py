"""PyTorch port vs JAX package: the streaming ``MiningService`` and its CLI.

The same seeded programs (ingest / evict / exact and stale queries /
background refresh / compaction) drive ``repro.serve.MiningService`` (JAX on
the CPU, its stores' plain paths as its own tests run them) and the port's
``MiningService(device="cpu")`` side by side.  Counts are integers, so every
comparison is exact.  After every step:

* ``window()`` and the ``IngestReport``'s ``n_ingested``, ``n_evicted``,
  ``n_slots`` and ``window`` are equal;
* every exact answer's itemsets AND supports, ``min_count`` and
  ``n_transactions`` are equal, and equal ``brute_force_frequent`` over the
  window;
* every stale answer (``query(staleness=...)``) is sound under its
  ``ErrorCertificate`` against that recount: supports within
  ``max_drift``, misses below ``miss_bound``, L1 exact, and full equality
  when the certificate claims exactness.

What depends on when a device finishes a delta or a refresh unit (JAX's
``poll`` reads ``is_ready``; the port's CPU path has no events, so it never
waits) is compared only in the *strict* layer, whose programs start no
background refresh (no stale query, no ``refresh_async``) and run with
``compact_churn=0``: there the ``IngestReport``'s ``delta_jobs``, each
exact answer's ``refreshed``, ``stale_reason`` and certificate, and every
``stats()`` field (``pending_deltas`` and ``undrained`` only right after an
exact query, which joins every delta) must be equal too.  The other layer
compares only the timing-free fields above: ``refresh_in_flight``,
``stale_reason``, ``refreshes``, ``stale_served``, ``undrained`` and when
compaction fires stay on the strict side.

The reference's stateful machine (``tests/test_serve_stateful.py``) runs
against the port in ``tests/test_torch_serve_stateful.py`` through
``Pair``; this file also holds the delta primitives, the compaction mask
and the launcher to ``repro``'s.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import brute_force_frequent  # noqa: E402
from repro.core.itemsets import apriori_gen_matrix as j_apriori_gen_matrix  # noqa: E402
from repro.core.stores import ARRAY_STORES as J_STORES  # noqa: E402
from repro.core.stores import encode_db as j_encode_db  # noqa: E402
from repro.core.stores import pad_candidates as j_pad_candidates  # noqa: E402
from repro.core.stores.base import tracked_keep_mask as j_tracked_keep_mask  # noqa: E402
from repro.launch import serve as j_cli  # noqa: E402
from repro.serve import MiningService as JService  # noqa: E402
from test_torch_stores import cpu_mesh, one_torch_thread  # noqa: E402,F401

from repro_torch.core.stores import (  # noqa: E402
    ARRAY_STORES, encoded_db_from_numpy, pad_candidates, tracked_keep_mask)
from repro_torch.launch import serve as t_cli  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ErrorCertificate, IngestReport, MiningService, ServeResult)

STORES = list(ARRAY_STORES)
REPORT_FIELDS = ("n_ingested", "n_evicted", "n_slots", "window")
DRAIN_FIELDS = ("pending_deltas", "undrained")


def _support(window, itemset):
    s = set(itemset)
    return sum(1 for t in window if s <= set(t))


def _check_sound(window, res, max_k):
    """A (possibly stale) answer against the exact recount of its window."""
    cert = res.certificate
    oracle = brute_force_frequent(window, res.min_count, max_k=max_k)
    for itemset, c in res.itemsets.items():
        assert abs(c - _support(window, itemset)) <= cert.max_drift, (
            itemset, cert)
    for itemset, exact in oracle.items():
        if itemset not in res.itemsets:
            assert exact < cert.miss_bound, (itemset, exact, cert)
    assert ({s: c for s, c in res.itemsets.items() if len(s) == 1}
            == {s: c for s, c in oracle.items() if len(s) == 1})
    if cert.is_exact(res.min_count):
        assert res.itemsets == oracle


class Pair:
    """One reference service and one port service driven step by step; in
    basket mode also a plain list mirroring the window."""

    def __init__(self, strict, mirror=False, **kw):
        self.strict = strict
        self.max_k = kw.get("max_k", 16)
        if strict:
            kw["compact_churn"] = 0.0
        self.j = JService(**kw)
        self.t = MiningService(device="cpu", **kw)
        self.mirror = [] if mirror else None
        self.cap = kw["n_slots"] * kw["slot_size"]

    def close(self):
        self.j.close()
        self.t.close()

    def _stats(self, drained):
        sj, st = self.j.stats(), self.t.stats()
        if not drained:
            for name in DRAIN_FIELDS:
                sj.pop(name), st.pop(name)
        assert st == sj

    def _after(self, rj=None, rt=None):
        window = self.j.window()
        assert self.t.window() == window
        assert self.t.window_size == self.j.window_size == len(window)
        if self.mirror is not None:
            assert window == self.mirror
        if rj is not None:
            assert isinstance(rt, IngestReport)
            for name in REPORT_FIELDS:
                assert getattr(rt, name) == getattr(rj, name), name
            if self.strict:
                assert rt.delta_jobs == rj.delta_jobs
                self._stats(drained=False)
        return window

    def ingest(self, batch):
        batch = [sorted(set(b)) for b in batch]
        rj, rt = self.j.ingest(batch), self.t.ingest(batch)
        if self.mirror is not None:
            self.mirror = (self.mirror + batch)[-self.cap:]
        self._after(rj, rt)

    def evict(self, n):
        rj, rt = self.j.evict(n), self.t.evict(n)
        if self.mirror is not None:
            self.mirror = self.mirror[n:]
        self._after(rj, rt)

    def query(self, min_support=None):
        rj, rt = self.j.query(min_support), self.t.query(min_support)
        window = self._after()
        assert isinstance(rt, ServeResult)
        assert (rt.min_count, rt.n_transactions) == (rj.min_count,
                                                     rj.n_transactions)
        assert rt.itemsets == rj.itemsets
        assert rt.certificate.is_exact(rt.min_count)
        if window:
            assert rt.itemsets == brute_force_frequent(
                window, rt.min_count, max_k=self.max_k)
        else:
            assert rt.itemsets == {} and rt.n_transactions == 0
        if self.strict:
            assert (rt.refreshed, rt.stale_reason) == (rj.refreshed,
                                                       rj.stale_reason)
            assert (rt.certificate.max_drift, rt.certificate.miss_bound,
                    rt.certificate.churn) == (rj.certificate.max_drift,
                                              rj.certificate.miss_bound,
                                              rj.certificate.churn)
            self._stats(drained=bool(window))
        return rt

    def stale(self, staleness):
        rj = self.j.query(staleness=staleness)
        rt = self.t.query(staleness=staleness)
        window = self._after()
        assert rt.n_transactions == rj.n_transactions == len(window)
        for res in (rj, rt):
            if window:
                _check_sound(window, res, self.max_k)
            else:
                assert res.itemsets == {}
        assert isinstance(rt.certificate, ErrorCertificate)
        return rt

    def refresh(self):
        self.j.refresh_async()
        self.t.refresh_async()
        self._after()

    def compact(self):
        """Compaction driven directly (the churn heuristic fires at
        device-timing-dependent points), then an exact pin."""
        for svc in (self.j, self.t):
            svc._drain_deltas()
            if svc._levels and svc._refreshed_once:
                before = svc.compactions
                svc._compact()
                assert svc.compactions == before + 1
        self.query()


# -- the differential programs -------------------------------------------------

def _block(rng, n, n_items=12, base=0, max_len=6):
    return [sorted(set((base + rng.integers(0, n_items,
                                            size=rng.integers(1, max_len))
                        ).tolist())) for _ in range(n)]


def _program(seed, strict, n_steps=14):
    """A seeded op list: ordinary batches, one-row and multi-row evictions,
    an all-empty block, a block of entirely new items, an evict to empty
    and a refill, exact queries at, above and below the track threshold;
    the non-strict layer adds stale queries, background refreshes and
    compactions."""
    rng = np.random.default_rng(seed)
    ops = [("ingest", _block(rng, 20)), ("query", None)]
    kinds = ["ingest", "ingest", "evict1", "evict", "query", "query_lo",
             "query_hi"]
    if not strict:
        kinds += ["stale", "stale", "refresh", "compact"]
    for i in range(n_steps):
        kind = kinds[int(rng.integers(len(kinds)))]
        if i == n_steps // 3:
            ops += [("ingest", [[]] * 5), ("query", None),
                    ("ingest", _block(rng, 6, base=100)), ("query", None)]
        elif i == 2 * n_steps // 3:
            ops += [("evict_all", None), ("query", None),
                    ("ingest", _block(rng, 9)), ("query", None)]
        elif kind == "ingest":
            ops.append(("ingest", _block(rng, int(rng.integers(1, 14)))))
        elif kind == "evict1":
            ops.append(("evict", 1))
        elif kind == "evict":
            ops.append(("evict", int(rng.integers(2, 8))))
        elif kind == "query":
            ops.append(("query", None))
        elif kind == "query_lo":  # below the margin band: refresh there
            ops.append(("query", 0.1))
        elif kind == "query_hi":
            ops.append(("query", 0.4))
        elif kind == "stale":
            ops.append(("stale", float(rng.choice([0.0, 0.5, 2.0]))))
        else:
            ops.append((kind, None))
    return ops + [("query", None)]


def _run(pair, ops):
    try:
        for op, arg in ops:
            if op == "evict_all":
                pair.evict(pair.t.window_size)
            elif op in ("refresh", "compact"):
                getattr(pair, op)()
            else:
                getattr(pair, op)(arg)
    finally:
        pair.close()


KW = dict(min_support=0.25, n_slots=3, slot_size=6, staleness=0.5, max_k=5)


# Every store runs once per layer, with the eviction modes swapped between
# the layers, so each store meets both modes.
EVICTION = dict(zip(STORES, ["slot", "basket"] * 3))
OTHER = {"slot": "basket", "basket": "slot"}


@pytest.mark.parametrize("store", STORES)
def test_strict_programs_match_reference(store):
    """Host-wave refresh: every field, device-timing-dependent ones
    included (no background refresh)."""
    _run(Pair(True, store=store, eviction=EVICTION[store], **KW),
         _program(STORES.index(store), True))


@pytest.mark.parametrize("store,trim,eviction", [
    ("packed_bitmap", True, "basket"), ("sorted_prefix", False, "slot")])
def test_strict_ladder_programs_match_reference(store, trim, eviction):
    """Ladder-mode refresh (fused level loop + negative-border waves), trim
    on and off (short programs: each refresh compiles JAX ladder shapes)."""
    _run(Pair(True, store=store, eviction=eviction, device_loop=True,
              trim=trim, **KW), _program(20 + trim, True, n_steps=8))


@pytest.mark.parametrize("store", STORES)
def test_background_programs_match_reference(store):
    """Stale queries, background refreshes and compactions interleaved:
    exact answers equal, stale answers sound on both sides (the bitmap
    store's refreshes run the untrimmed ladder)."""
    ladder = store == "bitmap"
    _run(Pair(False, store=store, eviction=OTHER[EVICTION[store]],
              device_loop=ladder, trim=False, **KW),
         _program(30 + STORES.index(store), False, n_steps=8 if ladder else 14))


@pytest.mark.parametrize("store", ["packed_bitmap", "bitmap"])
def test_block_of_new_items_escapes_untracked(store):
    """A block whose items all lie outside the tracked item map grows the
    raw histogram; once they are frequent the exact walk escapes
    ("untracked") and refreshes, on both sides alike."""
    pair = Pair(True, store=store, min_support=0.25, n_slots=4, slot_size=8,
                staleness=1.0, max_k=4)
    try:
        pair.ingest([[0, 1], [1, 2], [0, 2], [0, 1, 2]] * 2)
        pair.query()
        pair.ingest([[100, 101], [101, 102], [100, 102], [100, 101, 102]] * 2)
        assert pair.query().stale_reason == "untracked"
        pair.query()
    finally:
        pair.close()


def test_stale_answers_and_background_handoff():
    """A staleness budget answers without blocking, sound under its
    certificate; the background refresh it starts hands off without a
    blocking query, after which exact queries are served from deltas."""
    rng = np.random.default_rng(7)
    pair = Pair(False, store="packed_bitmap", n_slots=6, slot_size=16,
                min_support=0.15, staleness=0.2, max_k=5)
    try:
        pair.ingest(_block(rng, 96))
        pair.query()
        saw_inflight = False
        for _ in range(4):
            pair.ingest(_block(rng, 16))
            res = pair.stale(4.0)
            assert not res.refreshed
            saw_inflight = saw_inflight or res.refresh_in_flight
        assert saw_inflight, "drift never started a background refresh"
        r0 = pair.t.refreshes
        for _ in range(50):
            if not pair.t.refresh_async():
                break
        assert pair.t.refreshes > r0 and not pair.t.stats()["refresh_in_flight"]
        pair.query()
    finally:
        pair.close()


# -- the delta primitives --------------------------------------------------------

@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_count_and_uncount_delta_match_reference(store, k):
    """``count_delta`` / ``uncount_delta`` over a one-row block and a
    multi-row block equal the reference's, and uncount inverts count."""
    rng = np.random.default_rng(k)
    n_items = 10
    db = [sorted(set(rng.integers(0, n_items, size=rng.integers(1, 8))
                     .tolist())) for _ in range(9)]
    db[0] = [0, 2, 4, 6, 8]  # the one-row block supports C(5, k) candidates
    items = np.arange(n_items, dtype=np.int32)
    cand = items.reshape(-1, 1)
    for _ in range(k - 1):
        cand = j_apriori_gen_matrix(cand)
    cls, jcls = ARRAY_STORES[store], J_STORES[store]
    base = rng.integers(0, 50, size=cand.shape[0]).astype(np.int64)
    for block in (db[:1], db):
        jenc = j_encode_db(block, n_items=n_items)
        enc = encoded_db_from_numpy(jenc.padded, jenc.bitmap, jenc.n_items)
        trans = {n: torch.from_numpy(np.ascontiguousarray(v))
                 for n, v in cls.transaction_inputs(enc).items()}
        cand_p = pad_candidates(cand, enc.f_pad)
        cands = cls.encode_candidates(torch.from_numpy(cand_p),
                                      f_pad=enc.f_pad)
        jtrans = {n: jnp.asarray(v)
                  for n, v in jcls.transaction_inputs(jenc).items()}
        jcands = jcls.encode_candidates(
            jnp.asarray(j_pad_candidates(cand, jenc.f_pad)), f_pad=jenc.f_pad)
        counts = np.zeros((cand_p.shape[0],), np.int64)
        counts[: len(base)] = base
        got = cls.count_delta(torch.from_numpy(counts), trans, cands)
        want = np.asarray(jcls.count_delta(jnp.asarray(counts), jtrans, jcands))
        np.testing.assert_array_equal(got.numpy(), want)
        back = cls.uncount_delta(got, trans, cands)
        np.testing.assert_array_equal(
            back.numpy(),
            np.asarray(jcls.uncount_delta(jnp.asarray(want), jtrans, jcands)))
        np.testing.assert_array_equal(back.numpy(), counts)
        assert (got.numpy() >= counts).all() and got.numpy().sum() > counts.sum()


@pytest.mark.parametrize("seed", range(6))
def test_tracked_keep_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    level = np.arange(int(rng.integers(3, 9)), dtype=np.int32).reshape(-1, 1)
    for _ in range(int(rng.integers(0, 3))):
        level = j_apriori_gen_matrix(level)
    cand = j_apriori_gen_matrix(level)
    prev = level[rng.random(level.shape[0]) < 0.7]
    for c, p in ((cand, prev), (cand, level), (cand, prev[:0]),
                 (cand[:0], prev)):
        want = j_tracked_keep_mask(c, p)
        got = tracked_keep_mask(c, p)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)


# -- the launcher and the entry points -------------------------------------------

CLI_ARGS = ["--dataset", "T10I4D100K", "--scale", "0.01", "--support", "0.05",
            "--store", "packed_bitmap", "--batch-size", "64", "--batches", "9",
            "--query-every", "2", "--n-slots", "4", "--slot-size", "64",
            "--max-k", "5", "--eviction", "basket"]


def _columns(out):
    """(batch, window, frequent) of every per-query line."""
    rows = []
    for line in out.splitlines():
        if line.startswith("  batch"):
            cells = [c.split() for c in line.split("|")]
            rows.append((int(cells[0][1]), int(cells[1][1]), int(cells[2][0])))
    return rows


def test_cli_columns_match_reference(monkeypatch):
    """Both launchers with the same arguments (no query staleness) print
    the same window and frequent-itemset count on every query line."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve"] + CLI_ARGS)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        j_cli.main()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        t_cli.main(CLI_ARGS + ["--device", "cpu"])
    assert got.getvalue().startswith("mining service: torch/packed_bitmap")
    assert len(_columns(want.getvalue())) == 4
    assert _columns(got.getvalue()) == _columns(want.getvalue())
    assert "queries delta-served" in got.getvalue().splitlines()[-1]


def test_cli_refuses_unported_paths(monkeypatch):
    """``--lm`` is gated on ``REPRO_LM=1`` as in the reference, and refuses
    an architecture whose mixer is not ported; ``--mesh`` serves through
    ``ShardedRunner`` on the data mesh (a one-rank gloo group here) with
    the reference CLI's per-query columns."""
    import torch.distributed as dist

    monkeypatch.delenv("REPRO_LM", raising=False)
    with pytest.raises(SystemExit) as gated:
        t_cli.main(["--lm", "--arch", "x"])
    assert gated.value.code == 0
    monkeypatch.setenv("REPRO_LM", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_cli.main(["--lm", "--arch", "mamba2-2.7b", "--device", "cpu"])
    monkeypatch.delenv("REPRO_LM")
    args = CLI_ARGS + ["--mesh"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve"] + args)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        j_cli.main()
    got = io.StringIO()
    try:
        with contextlib.redirect_stdout(got):
            t_cli.main(args + ["--device", "cpu"])
    finally:
        dist.destroy_process_group()
    assert got.getvalue().startswith("mining service: sharded/perfect_hash")
    assert len(_columns(want.getvalue())) == 4
    assert _columns(got.getvalue()) == _columns(want.getvalue())


def test_service_defaults_to_the_card_and_refuses_unported_backends(
        cpu_mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MiningService()
    # A mesh is ported: the service counts on the mesh's device.
    svc = MiningService(mesh=cpu_mesh)
    assert svc.runner.describe() == "sharded/perfect_hash"
    assert svc.runner.engine.device.type == "cpu"
    with pytest.raises(ValueError, match="not both"):
        MiningService(runner=svc.runner, mesh=cpu_mesh)
    with pytest.raises(ValueError, match="not both"):
        MiningService(runner=MiningService(device="cpu").runner,
                      store="perfect_hash")
    with pytest.raises(ValueError, match="engine-backed"):
        MiningService(runner=object.__new__(type(
            "NoEngine", (), {"describe": lambda self: "none"})))
    import repro_torch.serve as serve
    from repro_torch.serve.lm import ServeEngine

    # The LM engine resolves lazily, as in the reference; its sharding is
    # not ported.
    assert serve.ServeEngine is ServeEngine
    with pytest.raises(NotImplementedError, match="not ported"):
        serve.ServeEngine(None, {}, mesh=cpu_mesh)
    with pytest.raises(AttributeError):
        serve.NoSuchEngine
