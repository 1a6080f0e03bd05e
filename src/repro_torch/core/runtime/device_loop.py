"""Device-resident level ladder: fused gen -> encode -> count -> prune.

The host-loop schedule pays four host crossings per level (generate C_k on
the host, ship the (C, k) matrix, fetch counts, filter on the host).  The
ladder keeps the level loop on the device: the frequent level matrix, the
candidate join + prune, the store encode, the blocked count and the
min-support compaction all run there, and only the surviving rows, their
counts and a few scalars cross back per level.

* **Join and prune on the device.** ``_gen_prune`` re-expresses
  ``itemsets.apriori_gen_matrix`` as tensor ops: an all-pairs
  same-(k-1)-prefix mask over the level matrix, ``torch.nonzero`` pair
  extraction (row-major order == the candidates' lexicographic order, so
  the rows match the host generator's one for one), and per-column
  row-membership tests for the drop-one prune.  ``apriori_gen_device`` and
  ``filter_candidates_device`` wrap the same primitives for standalone use
  (the host loop's device-side SPC cut-back).
* **Host-exact pair count.** ``join_pair_count`` sizes ``c_pad`` on the
  host from the level's contiguous prefix groups; a level's candidates are
  the first ``n_pairs`` rows and the rest, with every pruned row, become
  the standard pad row (item ``f_pad - 1`` repeated), which every store
  counts as 0.

**Transaction trimming** (the authors' follow-up, arXiv:1807.06070): at the
top of each level the ladder drops items that fell out of the frequent level
(downward closure: no later candidate can hold them) and transactions with
fewer than k+1 surviving items (they can never support a (k+1)-set), then
re-compacts rows and columns on the device so ``N_pad``/``F_pad``/``L``
shrink as k grows.  Item ids are re-ranked densely after each trim;
``_cur_ids`` maps ladder ids back to the miner's dense ids (the map is
monotone, so lexicographic row order is preserved end to end).

**Faults**: with a ``FaultPlan``, a ``device_loss`` addressed to level k
fires at that level's dispatch (``_check_fault``): the engine abandons its
outstanding work and ``DeviceLostError`` propagates, so the miner's level
checkpoint is the resume point, exactly as on the host loop.

**Meshes.**  Each rank holds its own row block of the DB (the engine's
``place``) and every rank holds the whole level matrix, so candidate
generation is identical everywhere.  A level's count runs over the rank's
rows and, under candidate sharding, over its contiguous slice of the
``c_pad`` rows (``c_pad`` rounds to the cand-shard multiple), then goes
through the engine's ``reduce_counts`` (``all_reduce`` over data,
``all_gather`` over cand).  The reference compacts rows globally inside one
compiled step; here ranks compact their own rows, so the trim first makes
every rank's item state identical: the live-row count is summed, and the
width, the alive-item mask and the largest local live count are maxed, over
data.  Every rank then re-ranks items identically and compacts its rows
locally, padded to the largest local live count.  ``JobProfile.n_pad`` is
the reference's global formula (the live count rounded to the data-shard
multiple), so profiles compare one to one with the reference's on the same
mesh shape.  PyTorch runs eagerly: there is no compiled-step cache.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.runtime.engine import resolve_device
from repro_torch.core.runtime.faults import DeviceLostError, FaultPlan
from repro_torch.core.runtime.job import JobProfile
from repro_torch.core.stores.base import ITEM_PAD

# Pad quanta of the candidate and level row counts (the kernels mask a
# ragged candidate count, so nothing needs the 128 of ``pad_candidates``).
CAND_UNIT = 8
LEVEL_UNIT = 8

# Bound on every (rows, L) boolean intermediate: the prefix-pair mask and
# the membership tests go through in row chunks of at most this many cells.
_MAX_EQ_ELEMENTS = 1 << 26


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // int(m)) * int(m)


def join_pair_count(level_mat: np.ndarray) -> int:
    """Exact number of Agrawal-Srikant join pairs of a sorted level matrix.

    Rows sharing their (k-1)-prefix form contiguous groups; each group of
    size g contributes g*(g-1)/2 pairs.  Host-side and id-independent (group
    boundaries survive any monotone id remap), it sizes the level's ``c_pad``.
    """
    mat = np.asarray(level_mat)
    if mat.ndim != 2 or mat.shape[0] < 2:
        return 0
    c, k = mat.shape
    if k == 1:
        return c * (c - 1) // 2
    new_group = np.empty((c,), bool)
    new_group[0] = True
    new_group[1:] = ~(mat[1:, : k - 1] == mat[:-1, : k - 1]).all(axis=1)
    starts = np.flatnonzero(new_group)
    sizes = np.diff(np.append(starts, c))
    return int((sizes * (sizes - 1) // 2).sum())


# -- join / prune / filter primitives -----------------------------------------

def _same_prefix_pairs(lvl: torch.Tensor, n_valid: int, lo: int,
                       hi: int) -> torch.Tensor:
    """bool[hi - lo, l_pad]: valid rows a (in [lo, hi)) < b sharing their
    (k-1)-prefix."""
    l_pad, k = lvl.shape
    idx = torch.arange(l_pad, device=lvl.device)
    rows = idx[lo:hi]
    ok = (idx[None, :] < n_valid) & (rows[:, None] < idx[None, :])
    for j in range(k - 1):
        ok &= lvl[lo:hi, j][:, None] == lvl[:, j][None, :]
    return ok


def _rows_member_device(lvl: torch.Tensor, queries: torch.Tensor,
                        n_valid: int) -> torch.Tensor:
    """bool[Q]: is each query row among the first ``n_valid`` rows of
    ``lvl``?  Queries go through in chunks so the (Q, L) intermediate stays
    bounded whatever the wave's size."""
    l_pad = lvl.shape[0]
    valid = torch.arange(l_pad, device=lvl.device) < n_valid
    step = max(1, _MAX_EQ_ELEMENTS // max(1, l_pad))
    out = [torch.zeros((0,), dtype=torch.bool, device=lvl.device)]
    for i in range(0, queries.shape[0], step):
        q = queries[i:i + step]
        eq = valid[None, :] & (q[:, 0][:, None] == lvl[:, 0][None, :])
        for j in range(1, q.shape[1]):
            eq &= q[:, j][:, None] == lvl[:, j][None, :]
        out.append(torch.any(eq, dim=1))
    return torch.cat(out)


def _gen_prune(lvl: torch.Tensor, n_valid: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Join + prune on the device.

    Returns ``(cand, keep)``: the (n_pairs, k+1) join of the valid level
    rows, in lexicographic order (``torch.nonzero`` emits pair indices
    row-major — group by group, then by the two last items ascending —
    which IS the candidates' order), and the bool mask of the pairs that
    survive the drop-one prune.  ``cand[keep]`` equals
    ``apriori_gen_matrix`` of the level row for row.
    """
    l_pad, k = lvl.shape
    step = max(1, _MAX_EQ_ELEMENTS // max(1, l_pad))
    pairs = [torch.zeros((0, 2), dtype=torch.int64, device=lvl.device)]
    for lo in range(0, n_valid, step):
        nz = torch.nonzero(_same_prefix_pairs(lvl, n_valid, lo,
                                              min(lo + step, n_valid)))
        nz[:, 0] += lo
        pairs.append(nz)
    pairs = torch.cat(pairs)
    cand = torch.cat([lvl[pairs[:, 0]], lvl[pairs[:, 1], -1:]], dim=1)
    keep = torch.ones((cand.shape[0],), dtype=torch.bool, device=lvl.device)
    for drop in range(k - 1):  # dropping position k-1 or k gives a parent
        subset = torch.cat([cand[:, :drop], cand[:, drop + 1:]], dim=1)
        keep &= _rows_member_device(lvl, subset, n_valid)
    return cand, keep


def _filter_keep(cand: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """bool[C]: rows whose every (k1-1)-subset is a row of ``lvl``."""
    keep = torch.ones((cand.shape[0],), dtype=torch.bool, device=cand.device)
    for drop in range(cand.shape[1]):
        subset = torch.cat([cand[:, :drop], cand[:, drop + 1:]], dim=1)
        keep &= _rows_member_device(lvl, subset, lvl.shape[0])
    return keep


def apriori_gen_device(level_mat: np.ndarray, device="cuda") -> np.ndarray:
    """Device twin of ``itemsets.apriori_gen_matrix``: identical rows in the
    identical (lexicographic) order.  Standalone entry point; the ladder
    runs the same ``_gen_prune`` inside its level step.  Runs on the card
    unless ``device="cpu"``; raises without one."""
    device = resolve_device(device)
    mat = np.asarray(level_mat, dtype=np.int32)
    if mat.size == 0:
        return np.zeros(
            (0, (mat.shape[1] + 1) if mat.ndim == 2 else 0), np.int32)
    lvl = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    cand, keep = _gen_prune(lvl, mat.shape[0])
    return cand[keep].cpu().numpy()


def filter_candidates_device(cand: np.ndarray, level_mat: np.ndarray,
                             device="cuda") -> np.ndarray:
    """Device twin of ``itemsets.filter_candidates_matrix`` (order-preserving
    SPC cut-back): keep a candidate row iff every k-subset is a level row.
    Runs on the card unless ``device="cpu"``; raises without one."""
    device = resolve_device(device)
    cand = np.asarray(cand, dtype=np.int32)
    if cand.size == 0 or level_mat.size == 0:
        return np.zeros((0, cand.shape[1] if cand.ndim == 2 else 0), np.int32)
    lvl = torch.from_numpy(
        np.ascontiguousarray(level_mat, dtype=np.int32)).to(device)
    q = torch.from_numpy(np.ascontiguousarray(cand)).to(device)
    return cand[_filter_keep(q, lvl).cpu().numpy()]


# -- the fused device-resident loop -------------------------------------------

class LevelLadder:
    """Device-resident level loop over a placed ``MapReduceEngine``.

    ``run(level_mat, start_k, max_k)`` is a strategy-shaped generator (one
    ``(JobProfile, {itemset: count})`` per level, itemsets in the miner's
    dense id space); with ``trim=True`` each level first drops dead items
    and transactions on the device (see the module docstring).

    Each level counts its ``c_pad`` candidates in one pass over the row
    blocks when the store counts through a hand-written kernel (the kernel
    reduces in place, so its memory is O(C)), and in ``engine.cand_block``
    chunks otherwise, since the plain paths hold an (Nb, chunk) intermediate.
    """

    def __init__(self, engine, min_count: int, trim: bool = True,
                 fault_plan: Optional[FaultPlan] = None) -> None:
        self.engine = engine
        self.min_count = int(min_count)
        self.trim = bool(trim)
        self.fault_plan = fault_plan

    # -- state ----------------------------------------------------------------
    def _init_state(self, level_mat: np.ndarray) -> None:
        enc, local = self.engine._enc, self.engine._local_enc
        dev = self.engine.device
        # _n_pad is the global padded row count (what the profile reports);
        # _padded/_bitmap hold this rank's rows only.
        self._n_pad, self._width = enc.padded.shape
        self._f_pad = enc.f_pad
        self._padded, self._bitmap = self.engine._rows_to_device(local)
        self._trans = self._make_inputs()
        # ladder id -> miner dense id; trimming re-ranks ids densely, and
        # this (monotone) map translates results back at the yield boundary.
        self._cur_ids = np.arange(enc.n_items, dtype=np.int64)
        self._lvl_host = np.asarray(level_mat, dtype=np.int32)
        n = self._lvl_host.shape[0]
        self._set_level(torch.from_numpy(self._lvl_host).to(dev), n,
                        max(LEVEL_UNIT, _round_up(n, LEVEL_UNIT)))

    def _set_level(self, rows: torch.Tensor, n_valid: int, l_pad: int) -> None:
        """The device level matrix: ``rows`` then ITEM_PAD rows up to l_pad."""
        lvl = torch.full((l_pad, rows.shape[1]), int(ITEM_PAD),
                         dtype=torch.int32, device=rows.device)
        lvl[:n_valid] = rows
        self._lvl_dev, self._n_valid, self._l_pad = lvl, n_valid, l_pad

    def _make_inputs(self) -> dict:
        """(Re)build the store's transaction tensors from the device-resident
        padded/bitmap pair, on the device: a trim never round-trips the DB."""
        return self.engine.store.device_transaction_inputs(self._padded,
                                                           self._bitmap)

    # -- the per-level step ---------------------------------------------------
    def _count(self, cand_safe: torch.Tensor) -> torch.Tensor:
        """Counts of the level's ``c_pad`` rows: this rank's candidate slice
        over its rows, then the engine's collectives."""
        eng = self.engine
        store = eng.store
        lo, hi = eng.cand_slice(cand_safe.shape[0])
        mine = cand_safe[lo:hi]
        kernel_on = getattr(store, "kernel_on", None)
        c = mine.shape[0]
        chunk = c if kernel_on is not None and kernel_on(eng.device) \
            else eng.cand_block
        return eng.reduce_counts(torch.cat([
            eng._blocked_count(self._trans, store.encode_candidates(
                mine[i:i + chunk], f_pad=self._f_pad))
            for i in range(0, c, chunk)]))

    def _step(self, k1: int, c_pad: int, n_pairs: int):
        cand, keep = _gen_prune(self._lvl_dev, self._n_valid)
        if cand.shape[0] != n_pairs:
            raise RuntimeError(f"device join made {cand.shape[0]} pairs, the "
                               f"host count is {n_pairs}")
        # Pruned rows and the rows up to c_pad become standard pad rows (the
        # always-zero bitmap column repeated k1 times), so every store
        # counts them as 0 — the same trick as ``pad_candidates``.
        pad = self._f_pad - 1
        cand_safe = torch.full((c_pad, k1), pad, dtype=torch.int32,
                               device=cand.device)
        cand_safe[:n_pairs] = torch.where(keep[:, None], cand, pad)
        counts = self._count(cand_safe)[:n_pairs]
        freq_mask = keep & (counts >= self.min_count)
        # Boolean indexing keeps the order: surviving rows stay lex-sorted.
        return cand[freq_mask], counts[freq_mask], int(keep.sum())

    # -- trimming (arXiv:1807.06070, on the device) -----------------------------
    def _trim(self, k1: int) -> None:
        """Drop dead items/transactions and re-compact the device DB.

        ``alive`` = items of the current level (downward closure: exact);
        ``live`` = transactions with >= k1 alive items (a (k1)-candidate
        needs k1 of them: exact).  Rows, bitmap columns and item ids are
        re-compacted order-preservingly, so lex order and counts are
        untouched; if no padded dimension would shrink the trim is skipped.
        On a mesh the sizes and the alive mask are reduced over data first
        (see the module docstring), so every rank takes the same branch.
        """
        eng = self.engine
        n_pad, width = self._n_pad, self._width
        f_pad, l_pad = self._f_pad, self._l_pad
        lvl, padded = self._lvl_dev, self._padded
        dev = padded.device

        lvalid = (torch.arange(l_pad, device=dev) < self._n_valid)[:, None]
        ids = torch.where(lvalid & (lvl < f_pad), lvl, f_pad - 1)
        alive = torch.zeros((f_pad,), dtype=torch.bool, device=dev)
        alive[ids.reshape(-1).to(torch.int64)] = True
        alive[f_pad - 1] = False  # the dump slot
        safe = torch.where(padded < f_pad, padded, f_pad - 1).to(torch.int64)
        cnt = alive[safe].sum(dim=1)
        live = cnt >= k1
        local_live = live.sum()
        # One SUM (global live rows) and one MAX (alive mask, width, the
        # largest local live count) over data; no-ops without a mesh.
        n_live = int(eng.all_reduce_data(local_live.reshape(1).clone()))
        maxed = eng.all_reduce_data(torch.cat([
            alive.to(torch.int64),
            torch.stack([torch.where(live, cnt, 0).max(), local_live])]),
            op="max")
        alive = maxed[:f_pad].to(torch.bool)
        n_alive = int(alive.sum())
        max_len, rows = (int(x) for x in maxed[f_pad:].tolist())
        n_local = int(local_live)

        shards = eng.n_data_shards
        new_n_pad = min(n_pad, max(shards, _round_up(max(n_live, 1), shards)))
        new_f_pad = min(f_pad, ((n_alive // 128) + 1) * 128)
        # Every live row fits: it has <= max_len alive items, dead rows have
        # < k1 <= max_len; the floor of 2 keeps degenerate shapes sane.
        new_width = min(width, max(2, max_len))
        if (new_n_pad, new_f_pad, new_width) == (n_pad, f_pad, width):
            return  # nothing shrinks; skip the remap entirely

        # Dense re-rank of alive items; monotone, so sorted rows and the lex
        # order of the level matrix are preserved.
        new_of_old = torch.cumsum(alive.to(torch.int64), dim=0) - 1
        hit = (padded < f_pad) & alive[safe]
        remapped = torch.where(hit, new_of_old[safe], int(ITEM_PAD))
        remapped = torch.sort(remapped, dim=1).values[:, :new_width]
        ridx = torch.nonzero(live).squeeze(1)
        # This rank's rows: its live ones, padded to the largest local live
        # count (one device: exactly new_n_pad).
        rows = max(1, rows)
        new_padded = torch.full((rows, new_width), int(ITEM_PAD),
                                dtype=torch.int32, device=dev)
        new_padded[:n_local] = remapped[ridx].to(torch.int32)
        # Columns past the alive ones come from the always-zero column.
        cidx = torch.nonzero(alive).squeeze(1)
        cols = torch.full((new_f_pad,), f_pad - 1, dtype=torch.int64,
                          device=dev)
        cols[:n_alive] = cidx
        new_bitmap = torch.zeros((rows, new_f_pad), dtype=torch.uint8,
                                 device=dev)
        new_bitmap[:n_local] = self._bitmap[ridx][:, cols]
        lsafe = torch.where(lvl < f_pad, lvl, f_pad - 1).to(torch.int64)
        new_lvl = torch.where(lvalid, new_of_old[lsafe], int(ITEM_PAD))

        cidx_h = cidx.cpu().numpy()
        self._cur_ids = self._cur_ids[cidx_h]
        remap = np.zeros((f_pad,), np.int32)
        remap[cidx_h] = np.arange(n_alive, dtype=np.int32)
        self._lvl_host = remap[self._lvl_host]
        self._padded, self._bitmap = new_padded, new_bitmap
        self._lvl_dev = new_lvl.to(torch.int32)
        self._n_pad, self._f_pad, self._width = new_n_pad, new_f_pad, new_width
        self._trans = self._make_inputs()

    def _check_fault(self, k1: int) -> None:
        if self.fault_plan is None:
            return
        spec = self.fault_plan.device_loss(k=k1)
        if spec is not None:
            # Simulated device loss at level dispatch: outstanding state is
            # abandoned and the caller resumes from the level checkpoint.
            self.engine.abandon()
            raise DeviceLostError(lost=spec.lost, k=k1)

    # -- the generator ----------------------------------------------------------
    def run(self, level_mat: np.ndarray, start_k: int,
            max_k: int) -> Iterator[Tuple[JobProfile, dict]]:
        mat = np.asarray(level_mat, dtype=np.int32)
        if mat.size == 0 or start_k > max_k:
            return
        if mat.ndim != 2 or mat.shape[1] != start_k - 1:
            raise ValueError(
                f"level matrix width {mat.shape} does not match "
                f"start_k={start_k} (expected width {start_k - 1})")
        if self.engine._enc is None:
            raise RuntimeError("place() the database before running the ladder")
        if self.engine._enc.n_transactions == 0:
            return
        self._init_state(mat)
        k = start_k - 1  # current frequent-level width
        while k + 1 <= max_k:
            k1 = k + 1
            n_pairs = join_pair_count(self._lvl_host)
            if n_pairs == 0:
                return
            self._check_fault(k1)
            t0 = time.perf_counter()
            trim_s = 0.0
            if self.trim:
                self._trim(k1)
                trim_s = time.perf_counter() - t0
            c_pad = _round_up(
                n_pairs, CAND_UNIT * max(1, self.engine.n_cand_shards))
            freq_dev, counts_dev, n_cand = self._step(k1, c_pad, n_pairs)
            freq_l = freq_dev.cpu().numpy()
            counts = counts_dev.cpu().numpy().astype(np.int64)
            n_freq = freq_l.shape[0]
            wall = time.perf_counter() - t0
            prof = JobProfile(
                k=k1, n_candidates=n_cand, n_frequent=n_freq, seconds=wall,
                count_seconds=wall - trim_s, reduce_seconds=trim_s,
                n_pad=self._n_pad, f_pad=self._f_pad,
            )
            # Translate ladder ids -> miner dense ids at the yield boundary
            # (monotone map: rows stay lex-sorted for the miner).
            out = {}
            if n_freq:
                freq_miner = self._cur_ids[freq_l]
                out = {tuple(int(x) for x in freq_miner[i]): int(counts[i])
                       for i in range(n_freq)}
            yield prof, out
            if n_freq == 0:
                return
            # Advance: the surviving rows ARE the next level, already on the
            # device.
            self._lvl_host = freq_l.astype(np.int32)
            self._set_level(freq_dev, n_freq, min(
                c_pad, max(LEVEL_UNIT, _round_up(n_freq, LEVEL_UNIT))))
            k = k1


def ladder(runner, level, min_count: int, start_k: int, max_k: int,
           trim: bool = True) -> Iterator[Tuple[JobProfile, dict]]:
    """Strategy-compatible entry point for the device-resident ladder:
    a drop-in for ``strategies.spc`` on engine-backed runners."""
    engine = getattr(runner, "engine", None)
    if engine is None:
        raise ValueError(
            "device_loop requires an engine-backed runner (TorchRunner)")
    if getattr(runner, "_reader", None) is not None:
        raise ValueError(
            "device_loop=True needs the DB resident on the device; "
            "out-of-core chunked ingestion streams it instead: mine "
            "with device_loop=False (the host SPC loop)")
    lad = engine.level_ladder(min_count, trim=trim,
                              fault_plan=getattr(runner, "fault_plan", None))
    yield from lad.run(np.asarray(level, dtype=np.int32), start_k, max_k)
