#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Run from the repository root; it needs one card and imports neither JAX nor
the JAX package.  Phases, each of which fails the run (non-zero exit, no
result line) when it fails:

1. the card's name and power limit, and the build of both hand-written
   kernels from ``src/repro_torch/kernels/support_count/csrc``;
2. every kernel against its plain PyTorch version on the card, exactly
   (counts are integers), at the shapes the main path gives it on
   T10I4D100K (the host loop's 32,768-candidate C2 chunk and the level
   ladder's whole 127,264-row C2; for the bitmap kernel also
   BMS_WebView_2's C2: F_pad = 128; and phase 6's serving shapes: the
   first and last 32,768-candidate chunks of the tracked C2 at F_pad 640
   over a one-row delta block, a 1,077-row slot tail and a full row
   block) and at ragged shapes (C larger than a
   tile, mixed k with pad rows, N split across blocks, a W >= 128
   vocabulary, F % 16 != 0); kernel, plain and library times beside the
   least time the card could take;
3. small mines on the card against brute-force counting: SPC through every
   store (the kernel stores with the kernel on and off) and the level
   ladder (``device_loop=True``) through every store;
4. the main path: ``FrequentItemsetMiner.mine`` on T10I4D100K (scale 1.0,
   min_support 0.01) and the BMS_WebView_2 twin (scale 1.0, min_support
   0.002): SPC and the trimmed level ladder through all five stores, DPC
   through ``packed_bitmap``, ``bitmap`` and ``perfect_hash``, and FPC
   through the same three on BMS_WebView_2 only (on T10I4D100K its first
   job would generate a ~2.7e9-row C4).  The kernel stores run at their
   default switch (the kernel on CUDA tensors).  Every mine's itemsets AND
   supports must equal the ``perfect_hash`` SPC mine's; every kernel's
   launch count must equal what its path asks for (row blocks x candidate
   chunks of every counting wave on the host loop; row blocks of every
   level on the ladder, which counts a level in one pass), each kernel must
   launch on every path, and no bitmap count may take the wrapper's pad
   copy;
5. out-of-core mining: the same two workloads written to ``.dat`` files in a
   temporary directory (never inside the repository) and mined through
   ``ChunkedDatasetReader`` with SPC, every job streaming every chunk.
   T10I4D100K at ceil(N/4), ceil(N/16) and ceil(N/64) transactions per chunk
   through ``packed_bitmap`` and ``bitmap``, and at ceil(N/4) through
   ``perfect_hash``; BMS_WebView_2 at ceil(N/4) through the two kernel
   stores.  Each mine's itemsets AND supports must equal the phase-4
   ``perfect_hash`` SPC mine's, every level row must have streamed every
   chunk, no bitmap count may take the pad copy, and each kernel's launches
   must equal (candidate chunks of every wave) x (row blocks of every
   transaction chunk);
6. serving: ``MiningService`` on the card over seeded ``basket_stream``
   windows.  T10I4D100K (32 slots of 3,125, min_support 0.01, margin 0.8,
   max_k 8): 32 warm-up batches and a cold query, then 16 measured batches
   through ``perfect_hash``, ``packed_bitmap`` and ``bitmap`` with an exact
   query after each; the same stream with ``query(staleness=0.5)`` and
   ``refresh_async()`` between batches; and ``packed_bitmap`` and
   ``bitmap`` with per-basket eviction and the trimmed-ladder refresh,
   evicting 1, 7 and 3,124 baskets after each batch.  BMS_WebView_2 (32
   slots of 2,422, 0.002, max_k 16): 8 measured batches through
   ``perfect_hash`` and ``packed_bitmap``.  Every exact answer's itemsets
   AND supports must equal a ``perfect_hash`` ladder recount of
   ``svc.window()`` at that step (shared by every store whose window is the
   same), every stale answer must be sound under its certificate, each
   one-row eviction must launch the store's kernel once per candidate
   chunk, and each kernel's launches must equal what the service
   dispatched (``ServeLog``: candidate chunks x row blocks of every delta
   job and refresh wave, row blocks of every ladder level).  Then the
   launcher runs once with the README's arguments.

It prints a ``kernels`` JSON line, the ``nvidia-smi`` name/power-limit line
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
POPC_PER_CLK_PER_SM = 16     # 32-bit popcount issue rate, compute capability 9.0
# Dense int8 tensor-core operations per clock per SM on Hopper: the data
# sheet's 1,979 TOP/s is 8,192 x 132 SMs x 1,830 MHz.
INT8_OPS_PER_CLK_PER_SM = 8192
BLOCK_N, CAND_BLOCK = 2048, 32_768  # the miner's default row block / chunk
SLOT = 3125  # phase 6's T10I4D100K slot: 32 slots hold the 100,000 baskets
CAND_UNIT = 8  # the level ladder's candidate pad quantum
KERNEL_OF = {"packed_bitmap": "packed_support_count", "bitmap": "support_count"}
STORES = ["packed_bitmap", "bitmap", "perfect_hash", "sorted_prefix",
          "hash_bucket"]


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, kernel: str, reps: int = 20):
    """(device ms per launch of the hand-written kernel ``kernel``, from a
    ``torch.profiler`` trace; host ms per call, the enqueue time).  The
    device time is None where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            # Demangled or not, the name holds "<kernel>_kernel" right after
            # a non-name character ("::", a length digit), so "packed_..."
            # never passes for the other kernel.
            at = ev.key.find(f"{kernel}_kernel")
            if at > 0 and not (ev.key[at - 1].isalpha() or ev.key[at - 1] == "_"):
                total_us += getattr(ev, "device_time_total", None) \
                    or getattr(ev, "cuda_time_total", 0.0)
                count += ev.count
        device_ms = total_us / count / 1e3 if count and total_us else None
    except Exception as err:  # the numbers stay "not measured"
        print(f"profiler: no device time ({type(err).__name__}: {err})")
        device_ms = None
    return device_ms, host_ms


def encode(db, min_count):
    """Host encode of a DB over its frequent items (the runner's place())."""
    import numpy as np
    from repro_torch.core.stores import (
        dense_remap_padded, encode_db_from_padded, padded_from_transactions)

    padded, n_raw = padded_from_transactions(db)
    ids = padded[padded < n_raw].astype(np.int64)
    item_map = np.nonzero(np.bincount(ids, minlength=n_raw) >= min_count)[0]
    dense = dense_remap_padded(padded, item_map, n_raw=n_raw)
    return encode_db_from_padded(dense, n_items=len(item_map))


def time_bitmap_shape(a, b, kv, int8_rate):
    """Times of the bitmap kernel, its plain version and two library
    products (neither computes the compare or the sum) at one shape."""
    import torch
    from repro_torch.kernels.support_count import support_count, support_count_ref

    n, c, f = a.shape[0], b.shape[0], a.shape[1]
    ops_s = 2 * n * c * f / int8_rate
    bytes_s = (a.numel() + b.numel() + 2 * c * 4) / HBM_BYTES_PER_S
    a16, b16t = a.to(torch.bfloat16), b.to(torch.bfloat16).T
    try:  # int8 operands and int32 output, like the kernel's own types
        a8, b8t = a.view(torch.int8), b.view(torch.int8).T
        int8_ms = cuda_ms(lambda: torch._int_mm(a8, b8t), reps=20)
        int8_note = "ok"
    except RuntimeError as err:
        int8_ms, int8_note = None, f"refused: {str(err).splitlines()[0]}"
    row = {"n": n, "c": c, "width": f,
           "ms": cuda_ms(lambda: support_count(a, b, kv), reps=50),
           "plain_ms": cuda_ms(lambda: support_count_ref(a, b, kv), reps=3,
                               warmup=1),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes",
           "library_ms": cuda_ms(lambda: torch.matmul(a16, b16t), reps=20),
           "library_int8_ms": int8_ms}
    row["device_ms"], row["host_call_ms"] = profiled_ms(
        lambda: support_count(a, b, kv), "support_count")
    print(f"time support_count n={n} c={c} width={f}: kernel {row['ms']:.4f} ms "
          f"({100 * row['bound_ms'] / row['ms']:.1f} % of bound "
          f"{row['bound_ms']:.4f} ms, {row['bound_by']}), plain "
          f"{row['plain_ms']:.4f} ms, bf16 torch.matmul {row['library_ms']:.4f} "
          f"ms, int8 torch._int_mm " + (f"{int8_ms:.4f} ms" if int8_ms else int8_note)
          + " (library products only: no compare, no sum); profiler device "
          f"{row['device_ms']} ms per launch, host {row['host_call_ms']:.4f} ms "
          "per call")
    return row


def bitmap_sweep(enc, khot, kvec, int8_rate):
    """Time per call of the bitmap kernel (CUDA events; at these shapes the
    device, not the host, sets the pace) as N grows at the main path's C
    and F_pad, and at the last T10I4D100K C2 chunk's C: the slope is the
    main loop's rate, the intercept the fixed cost per launch."""
    import torch
    from repro_torch.kernels.support_count import support_count

    f, c = khot.shape[1], khot.shape[0]
    last = 29_056  # 127,260 - 3 x 32,768 candidates, padded to 128
    out = []
    for n, cc in ((BLOCK_N, c), (4 * BLOCK_N, c), (8 * BLOCK_N, c),
                  (BLOCK_N, last)):
        a = torch.from_numpy(enc.bitmap[:n]).to(khot.device)
        b, kv = khot[:cc], kvec[:cc]
        ms = cuda_ms(lambda: support_count(a, b, kv), reps=20)
        out.append({"n": n, "c": cc, "width": f, "ms": ms,
                    "share_of_bound": 2 * n * cc * f / int8_rate * 1e3 / ms})
    lo, hi = out[0], out[2]
    slope = (hi["ms"] - lo["ms"]) / (hi["n"] - lo["n"])
    print(f"sweep support_count c={c} width={f}: "
          + ", ".join(f"n={r['n']} {r['ms']:.4f} ms" for r in out[:3])
          + f"; main loop {2 * c * f / (slope * 1e-3) / 1e12:.0f} TOP/s "
          f"({2 * c * f / (slope * 1e-3) / int8_rate * 100:.1f} % of peak), "
          f"fixed {lo['ms'] - slope * lo['n']:.4f} ms per launch; "
          f"n={BLOCK_N} c={last}: {out[3]['ms']:.4f} ms")
    return out


def time_packed_shape(a, b, kv, sm_rate):
    """Times of the packed kernel and its plain version at one shape (no
    single PyTorch call computes the same function)."""
    from repro_torch.kernels.support_count import (
        packed_support_count, packed_support_count_ref)

    n, c, width = a.shape[0], b.shape[0], a.shape[1]
    io_bytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                + 2 * c * 4)
    ops_s = n * c * width / sm_rate
    bytes_s = io_bytes / HBM_BYTES_PER_S
    row = {"n": n, "c": c, "width": width,
           "ms": cuda_ms(lambda: packed_support_count(a, b, kv), reps=20),
           "plain_ms": cuda_ms(lambda: packed_support_count_ref(a, b, kv),
                               reps=3, warmup=1),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes",
           "library_ms": None}
    row["device_ms"], row["host_call_ms"] = profiled_ms(
        lambda: packed_support_count(a, b, kv), "packed_support_count")
    print(f"time packed_support_count n={n} c={c} width={width}: kernel "
          f"{row['ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f} % of "
          f"bound {row['bound_ms']:.4f} ms, {row['bound_by']}), plain "
          f"{row['plain_ms']:.4f} ms, library none; profiler device "
          f"{row['device_ms']} ms per launch, host {row['host_call_ms']:.4f} "
          "ms per call")
    return row


def kernel_phase(enc, enc_bms, enc_serve, rng, sm_rate, int8_rate):
    """Every kernel vs its plain version on the card; returns JSON rows."""
    import numpy as np
    import torch
    from repro_torch.core.itemsets import apriori_gen_matrix
    from repro_torch.core.stores import pack_bitmap, pad_candidates
    from repro_torch.core.stores.bitmap import BitmapMXUStore
    from repro_torch.core.stores.packed_bitmap import (
        PackedBitmapStore, pack_candidates_device)
    from repro_torch.kernels.support_count import (
        packed_support_count, packed_support_count_ref, support_count,
        support_count_ref)

    dev = torch.device("cuda")

    def c2_of(e):
        return apriori_gen_matrix(np.arange(e.n_items, dtype=np.int32)[:, None])

    def first_c2_chunk(e):
        """The host loop's first C2 chunk of an encoded DB, on the card."""
        return torch.from_numpy(pad_candidates(c2_of(e)[:CAND_BLOCK],
                                               e.f_pad)).to(dev)

    def ladder_c2(e):
        """The level ladder's C2 of an encoded DB: every pair in one pass,
        padded to CAND_UNIT rows with the always-zero column."""
        c2 = c2_of(e)
        out = np.full((-(-len(c2) // CAND_UNIT) * CAND_UNIT, 2), e.f_pad - 1,
                      np.int32)
        out[:len(c2)] = c2
        return torch.from_numpy(out).to(dev)

    # The main path's C2 chunks against its first row block.  On CUDA
    # tensors both stores encode for their kernels by default.
    cand, cand_l = first_c2_chunk(enc), ladder_c2(enc)
    packed = torch.from_numpy(enc.packed[:BLOCK_N]).to(dev)
    bitmap = torch.from_numpy(enc.bitmap[:BLOCK_N]).to(dev)
    bitmap_bms = torch.from_numpy(enc_bms.bitmap[:BLOCK_N]).to(dev)
    pc = PackedBitmapStore.encode_candidates(cand, f_pad=enc.f_pad)
    pc_l = PackedBitmapStore.encode_candidates(cand_l, f_pad=enc.f_pad)
    bc = BitmapMXUStore.encode_candidates(cand, f_pad=enc.f_pad)
    bc_l = BitmapMXUStore.encode_candidates(cand_l, f_pad=enc.f_pad)
    bc_bms = BitmapMXUStore.encode_candidates(first_c2_chunk(enc_bms),
                                              f_pad=enc_bms.f_pad)
    if "packed" not in pc or bc["khot"].dtype != torch.int8:
        raise AssertionError("default switch: CUDA tensors not encoded for "
                             "the kernels")
    # The serving path's shapes (phase 6): the tracked C2 of T10I4D100K at
    # the margin-lowered threshold (F_pad 640) in its first and last
    # candidate chunks, over a one-row delta block (per-basket eviction),
    # the ragged tail of a 3,125-row slot and a full row block.
    c2s = c2_of(enc_serve)
    fs = enc_serve.f_pad
    chunks_s = [torch.from_numpy(pad_candidates(part, fs)).to(dev) for part in
                (c2s[:CAND_BLOCK],
                 c2s[(len(c2s) - 1) // CAND_BLOCK * CAND_BLOCK:])]
    pcs = [PackedBitmapStore.encode_candidates(x, f_pad=fs) for x in chunks_s]
    bcs = [BitmapMXUStore.encode_candidates(x, f_pad=fs) for x in chunks_s]
    serve_rows = (1, SLOT - BLOCK_N, BLOCK_N)
    packed_s = {n: torch.from_numpy(enc_serve.packed[:n]).to(dev)
                for n in serve_rows}
    bitmap_s = {n: torch.from_numpy(enc_serve.bitmap[:n]).to(dev)
                for n in serve_rows}

    def packed_case(n, w, c, ks, pads):
        f = w * 32
        bm = np.zeros((n, f), np.uint8)
        bm[:, : f - 1] = rng.random((n, f - 1)) < 0.35
        rows = [np.sort(rng.choice(f - 1, ks[i % len(ks)], replace=False))
                for i in range(c)]
        cp = torch.cat([pack_candidates_device(
            torch.from_numpy(r.astype(np.int32)[None, :]).to(dev), w)
            for r in rows])
        kv = torch.tensor([len(r) for r in rows], dtype=torch.int32, device=dev)
        kv[c - pads:] = -1
        return torch.from_numpy(pack_bitmap(bm)).to(dev), cp, kv

    def bitmap_case(n, f, c, ks, pads):
        bm = (rng.random((n, f)) < 0.3).astype(np.uint8)
        khot = np.zeros((c, f), np.int8)
        kv = np.zeros(c, np.int32)
        for i in range(c):
            k = ks[i % len(ks)]
            khot[i, rng.choice(f, k, replace=False)] = 1
            kv[i] = k
        kv[c - pads:] = -1
        return (torch.from_numpy(bm).to(dev), torch.from_numpy(khot).to(dev),
                torch.from_numpy(kv).to(dev))

    specs = [
        {"name": "packed_support_count", "kernel": packed_support_count,
         "plain": packed_support_count_ref,
         "source": "src/repro_torch/kernels/support_count/csrc/packed_support_count.cu",
         "replaces": "src/repro/kernels/support_count/packed.py:65",
         "main": (packed, pc["packed"], pc["kvec"]),
         "ladder": (packed, pc_l["packed"], pc_l["kvec"]),
         "serve": [(packed_s[n], p["packed"], p["kvec"])
                   for n in serve_rows for p in pcs],
         "ragged": [packed_case(513, 9, 300, [5], 0),
                    packed_case(64, 16, 1024, [4], 0),
                    packed_case(100, 5, 70, [2, 3, 4], 7),
                    packed_case(256, 160, 300, [1, 2, 3, 6], 11)]},
        {"name": "support_count", "kernel": support_count,
         "plain": support_count_ref,
         "source": "src/repro_torch/kernels/support_count/csrc/support_count.cu",
         "replaces": "src/repro/kernels/support_count/kernel.py:51",
         "main": (bitmap, bc["khot"], bc["kvec"]),
         "ladder": (bitmap, bc_l["khot"], bc_l["kvec"]),
         "more": [(bitmap_bms, bc_bms["khot"], bc_bms["kvec"])],
         "serve": [(bitmap_s[n], b["khot"], b["kvec"])
                   for n in serve_rows for b in bcs],
         "ragged": [bitmap_case(513, 257, 300, [5], 0),
                    bitmap_case(100, 130, 70, [2], 0),
                    bitmap_case(64, 512, 1024, [4], 0),
                    bitmap_case(128, 64, 30, [2, 3, 4], 5),
                    bitmap_case(300, 4096, 200, [1, 2, 3, 6], 9),
                    bitmap_case(2048, 512, 1000, [2], 0),    # N split
                    bitmap_case(1, 64, 300, [1], 0),
                    bitmap_case(1000, 96, 600, [2, 3], 7)]},
    ]
    rows = []
    for spec in specs:
        err = 0
        for args in [spec["main"], spec["ladder"], *spec.get("more", []),
                     *spec["serve"], *spec["ragged"]]:
            got = spec["kernel"](*args)
            torch.cuda.synchronize()
            want = spec["plain"](*args)
            case_err = int((got.long() - want.long()).abs().max())
            err = max(err, case_err)
            print(f"compare {spec['name']} {[tuple(a.shape) for a in args]}: "
                  f"max_abs_err {case_err}, hits {int(want.sum())}")
            del got, want
        if err:
            raise AssertionError(f"{spec['name']} disagrees with its plain "
                                 f"version (max_abs_err {err})")
        row = {"name": spec["name"], "route": "cuda", "source": spec["source"],
               "replaces": spec["replaces"], "launches": 0, "max_abs_err": err}
        keys = ["ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "host_call_ms"]
        if spec["name"] == "support_count":
            def timed(args):
                return time_bitmap_shape(*args, int8_rate)
            keys.append("library_int8_ms")
        else:
            def timed(args):
                return time_packed_shape(*args, sm_rate)
        shapes = [timed(args) for args in [spec["main"], spec["ladder"],
                                           *spec.get("more", [])]]
        row.update({k: shapes[0][k] for k in keys})
        row["shape"] = {k: shapes[0][k] for k in ("n", "c", "width")}
        row["ladder_shape"] = shapes[1]
        # One-row delta and full row block against the first serving chunk.
        row["serve_shapes"] = [timed(spec["serve"][0]),
                               timed(spec["serve"][4])]
        if spec["name"] == "support_count":
            row["more_shapes"] = shapes[2:]
            row["sweep"] = bitmap_sweep(enc, spec["main"][1], spec["main"][2],
                                        int8_rate)
        rows.append(row)
    return rows


class WaveLog:
    """Records the candidate count of every counting wave asked for while it
    is active, so the expected launches of the host-loop paths follow from
    the waves (SPC: one per level; FPC/DPC: several per job).  A resident
    wave is one ``count_candidates_async`` call; an out-of-core wave is one
    chunked job (``TorchRunner._count_chunked_async``), logged once however
    many transaction chunks it streams."""

    def __enter__(self):
        from repro_torch.core.runtime.engine import MapReduceEngine
        from repro_torch.core.runtime.runners import TorchRunner

        self.sizes = []
        self._saved = []
        for cls, attr, cand_of in (
                (MapReduceEngine, "count_candidates_async", lambda a: a),
                (TorchRunner, "_count_chunked_async", lambda a: a.cand)):
            orig = getattr(cls, attr)
            self._saved.append((cls, attr, orig))
            setattr(cls, attr, self._logged(orig, cand_of))
        return self

    def _logged(self, orig, cand_of):
        def logged(obj, arg):
            self.sizes.append(len(cand_of(arg)))
            return orig(obj, arg)
        return logged

    def __exit__(self, *exc):
        for cls, attr, orig in self._saved:
            setattr(cls, attr, orig)


def mine(db, min_support, store, use_kernel=None, **options):
    """One mine on the card; ``use_kernel`` sets a kernel store's switch
    (None, its default, counts through the kernel on CUDA tensors)."""
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.stores import ARRAY_STORES

    cls = ARRAY_STORES[store]
    switch = hasattr(cls, "use_kernel")
    if switch:
        saved, cls.use_kernel = cls.use_kernel, use_kernel
    try:
        t0 = time.perf_counter()
        res = FrequentItemsetMiner(min_support=min_support, store=store,
                                   device="cuda", **options).mine(db)
        return res, time.perf_counter() - t0
    finally:
        if switch:
            cls.use_kernel = saved


def small_check(get_dataset, brute_force_frequent):
    """Small mines on the card vs brute force: SPC through every store (the
    kernel stores with the kernel on and off) and the ladder through every
    store."""
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    want = brute_force_frequent(db, math.ceil(0.02 * len(db)))
    runs = [(store, None, {}) for store in STORES]
    runs += [(store, False, {}) for store in KERNEL_OF]
    runs += [(store, None, {"device_loop": True}) for store in STORES]
    for store, uk, options in runs:
        res, _ = mine(db, 0.02, store, uk, **options)
        if res.itemsets != want:
            raise AssertionError(f"{store} (kernel={uk}, {options}) disagrees "
                                 "with brute force on T10I4D100K scale 0.002")
    print(f"small check: T10I4D100K scale 0.002 min_support 0.02, "
          f"{len(want)} itemsets, SPC (every store, kernels on and off) and "
          "device_loop=True (every store) == brute force")


def main_path(workloads):
    """Phase 4: every path and store on both workloads.  Launch counts are
    zeroed just before each mine and read just after it."""
    from repro_torch.kernels.support_count import (
        launches, pad_copies, reset_launches)

    runs = [("spc", {}, STORES), ("ladder", {"device_loop": True}, STORES),
            ("dpc", {"strategy": "dpc"}, STORES[:3]),
            ("fpc", {"strategy": "fpc"}, STORES[:3])]
    mines = []
    bases = {}
    by_path = {path: {k: 0 for k in launches} for path, _, _ in runs}
    for name, support, db in workloads:
        for path, options, stores in runs:
            if path == "fpc" and name == "T10I4D100K":
                continue
            for store in stores:
                with WaveLog() as waves:
                    reset_launches()
                    res, wall = mine(db, support, store, **options)
                    got = dict(launches)
                if pad_copies["support_count"]:
                    raise AssertionError(f"{store}: {pad_copies} pad copies "
                                         "on the main path")
                if path == "ladder":
                    expected = sum(math.ceil(p.n_pad / BLOCK_N)
                                   for p in res.levels[1:])
                else:
                    blocks = math.ceil(res.n_transactions / BLOCK_N)
                    expected = blocks * sum(math.ceil(c / CAND_BLOCK)
                                            for c in waves.sizes)
                want = {k: (expected if k == KERNEL_OF.get(store) else 0)
                        for k in got}
                print(f"mine {name} min_support={support} path={path} "
                      f"store={store}: {len(res.itemsets)} itemsets, wall "
                      f"{wall:.3f} s, launches {got} (expected {want})")
                for p in res.levels:
                    print(f"  level k={p.k} candidates={p.n_candidates} "
                          f"frequent={p.n_frequent} seconds={p.seconds:.4f} "
                          f"gen={p.gen_seconds:.4f} encode={p.encode_seconds:.4f} "
                          f"count={p.count_seconds:.4f} trim={p.reduce_seconds:.4f} "
                          f"n_pad={p.n_pad} f_pad={p.f_pad} "
                          f"inflight={p.inflight_depth}")
                if got != want:
                    raise AssertionError(f"{path} {store}: launches {got} != "
                                         f"{want}")
                for k in got:
                    by_path[path][k] += got[k]
                mines.append({"dataset": name, "min_support": support,
                              "path": path, "store": store, "wall_s": wall,
                              "n_itemsets": len(res.itemsets), "launches": got,
                              "waves": waves.sizes,
                              "levels": [[p.k, p.n_candidates, p.n_frequent,
                                          p.seconds, p.gen_seconds,
                                          p.encode_seconds, p.count_seconds,
                                          p.reduce_seconds, p.n_pad, p.f_pad]
                                         for p in res.levels],
                              "_itemsets": res.itemsets})
        this = [m for m in mines if m["dataset"] == name]
        base = next(m["_itemsets"] for m in this
                    if (m["path"], m["store"]) == ("spc", "perfect_hash"))
        if not base:
            raise AssertionError(f"{name}: no frequent itemsets")
        bases[name] = base
        for m in this:
            if m.pop("_itemsets") != base:
                raise AssertionError(f"{name}: {m['path']} {m['store']} "
                                     "itemsets/supports differ from the "
                                     "perfect_hash SPC mine")
        print(f"agree {name}: {len(base)} itemsets, max k "
              f"{max(len(s) for s in base)}, identical supports across "
              f"{len(this)} mines (every path and store)")
    for path, counts in by_path.items():
        for k, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{k} never launched on the {path} path")
    return mines, by_path, bases


def out_of_core(workloads, bases):
    """Phase 5: SPC mines of ``.dat`` files streamed through
    ``ChunkedDatasetReader``, held to the resident ``perfect_hash`` SPC mine
    of phase 4 (``bases``).  Launch counts are zeroed just before each mine
    and read just after it."""
    import shutil
    import tempfile

    from repro_torch.data import ChunkedDatasetReader, write_dat
    from repro_torch.kernels.support_count import (
        launches, pad_copies, reset_launches)

    plans = {"T10I4D100K": [(parts, store) for parts in (4, 16, 64)
                            for store in KERNEL_OF] + [(4, "perfect_hash")],
             "BMS_WebView_2": [(4, store) for store in KERNEL_OF]}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ooc_")
    mines, host = [], {}
    by_path = {k: 0 for k in launches}
    try:
        for name, support, db in workloads:
            n = len(db)
            path = os.path.join(tmp, f"{name}.dat")
            t0 = time.perf_counter()
            write_dat(path, db)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            probe = ChunkedDatasetReader(path,
                                         chunk_transactions=math.ceil(n / 4))
            scan_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in probe.chunks():
                pass
            parse_s = time.perf_counter() - t0
            host[name] = {"write_s": write_s, "scan_s": scan_s,
                          "parse_s": parse_s, "bytes": os.path.getsize(path)}
            print(f"ooc {name}: .dat of {os.path.getsize(path)} bytes written "
                  f"in {write_s:.3f} s, scan {scan_s:.3f} s, one parse pass "
                  f"{parse_s:.3f} s")
            for parts, store in plans[name]:
                reader = ChunkedDatasetReader(
                    path, chunk_transactions=math.ceil(n / parts))
                if len(reader) != n:
                    raise AssertionError(f"{name}: reader holds {len(reader)} "
                                         f"of {n} transactions")
                rows = [min(reader.chunk_transactions, n - i)
                        for i in range(0, n, reader.chunk_transactions)]
                with WaveLog() as waves:
                    reset_launches()
                    res, wall = mine(reader, support, store)
                    got = dict(launches)
                if pad_copies["support_count"]:
                    raise AssertionError(f"{store}: {pad_copies} pad copies "
                                         "out of core")
                expected = (sum(math.ceil(c / CAND_BLOCK) for c in waves.sizes)
                            * sum(math.ceil(r / BLOCK_N) for r in rows))
                want = {k: (expected if k == KERNEL_OF.get(store) else 0)
                        for k in got}
                p1 = res.levels[0]
                print(f"ooc {name} min_support={support} chunk="
                      f"{reader.chunk_transactions} ({reader.n_chunks} chunks, "
                      f"rows {rows[0]}..{rows[-1]}) store={store}: "
                      f"{len(res.itemsets)} itemsets, wall {wall:.3f} s, job1 "
                      f"{p1.seconds:.4f} s, levels "
                      + ", ".join(f"k={p.k} {p.seconds:.4f} s"
                                  for p in res.levels[1:])
                      + f", launches {got} (expected {want})")
                if got != want:
                    raise AssertionError(f"ooc {name} {store}: launches {got} "
                                         f"!= {want}")
                if any(p.chunks != reader.n_chunks for p in res.levels):
                    raise AssertionError(
                        f"ooc {name} {store}: level chunks "
                        f"{[p.chunks for p in res.levels]} != {reader.n_chunks}")
                if res.itemsets != bases[name]:
                    raise AssertionError(
                        f"ooc {name} {store} chunk={reader.chunk_transactions}:"
                        " itemsets/supports differ from the resident "
                        "perfect_hash SPC mine")
                for k in got:
                    by_path[k] += got[k]
                mines.append({"dataset": name, "min_support": support,
                              "path": "spc_out_of_core", "store": store,
                              "chunk_transactions": reader.chunk_transactions,
                              "n_chunks": reader.n_chunks, "wall_s": wall,
                              "n_itemsets": len(res.itemsets),
                              "launches": got, "waves": waves.sizes,
                              "levels": [[p.k, p.n_candidates, p.n_frequent,
                                          p.seconds, p.encode_seconds,
                                          p.count_seconds, p.chunks]
                                         for p in res.levels]})
            print(f"agree ooc {name}: {len(bases[name])} itemsets, identical "
                  f"supports across {len(plans[name])} out-of-core mines and "
                  "the resident perfect_hash SPC mine")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, count in by_path.items():
        if count <= 0:
            raise AssertionError(f"{k} never launched out of core")
    return mines, by_path, host


class ServeLog:
    """While active (and not ``paused``), logs every counting dispatch a
    service makes, so its expected launches follow from what it dispatched:
    each delta job (``TorchRunner.count_block_async``: block rows x
    candidates), each host-loop wave over the placed window
    (``MapReduceEngine.count_candidates_async``: placed rows x candidates)
    and each ladder level (``LevelLadder.run``: the level's ``n_pad``).  It
    also sums the host seconds of the serving layer's phases."""

    TIMED = [("runner", "encode_block"), ("runner", "count_block_async"),
             ("service", "_drain_deltas"), ("service", "_serve_from_tracked"),
             ("service", "_serve_stale"), ("service", "_refresh_blocking"),
             ("service", "_pump_refresh")]

    def __enter__(self):
        from repro_torch.core.runtime.device_loop import LevelLadder
        from repro_torch.core.runtime.engine import MapReduceEngine
        from repro_torch.core.runtime.runners import TorchRunner
        from repro_torch.serve.engine import MiningService

        self.deltas, self.waves, self.levels = [], [], []
        self.host = {name: 0.0 for _, name in self.TIMED}
        self.paused = False
        self._saved = []
        owners = {"runner": TorchRunner, "service": MiningService}
        for owner, name in self.TIMED:
            self._patch(owners[owner], name, self._timed(name))
        self._patch(TorchRunner, "count_block_async", self._delta)
        self._patch(MapReduceEngine, "count_candidates_async", self._wave)
        self._patch(LevelLadder, "run", self._ladder)
        return self

    def _patch(self, cls, name, wrap):
        orig = getattr(cls, name)
        self._saved.append((cls, name, orig))
        setattr(cls, name, wrap(orig))

    def _timed(self, name):
        def wrap(orig):
            def timed(obj, *args, **kw):
                t0 = time.perf_counter()
                try:
                    return orig(obj, *args, **kw)
                finally:
                    if not self.paused:
                        self.host[name] += time.perf_counter() - t0
            return timed
        return wrap

    def _delta(self, orig):
        def logged(runner, enc, cand):
            if not self.paused:
                self.deltas.append((enc.n_transactions, len(cand)))
            return orig(runner, enc, cand)
        return logged

    def _wave(self, orig):
        def logged(engine, cand):
            if not self.paused:
                self.waves.append((engine._enc.n_transactions, len(cand)))
            return orig(engine, cand)
        return logged

    def _ladder(self, orig):
        def logged(lad, *args):
            for prof, freq in orig(lad, *args):
                if not self.paused:
                    self.levels.append(prof.n_pad)
                yield prof, freq
        return logged

    def expected(self) -> int:
        """Kernel launches of everything logged: candidate chunks x row
        blocks of every delta job and wave (nothing for an empty side),
        row blocks of every ladder level (one pass a level)."""
        def job(n, c):
            return math.ceil(c / CAND_BLOCK) * math.ceil(n / BLOCK_N)
        return (sum(job(n, c) for n, c in self.deltas + self.waves)
                + sum(math.ceil(n / BLOCK_N) for n in self.levels))

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def window_digest(window):
    return len(window), hash(tuple(map(tuple, window)))


def exact_supports(window, itemsets):
    """Exact support of each itemset over the window, by intersecting the
    items' basket-index lists on the host."""
    import numpy as np

    if not itemsets:
        return {}
    rows = {}
    for i, t in enumerate(window):
        for x in t:
            rows.setdefault(x, []).append(i)
    out = {}
    for s in itemsets:
        hit = np.asarray(rows.get(s[0], []))
        for x in s[1:]:
            hit = np.intersect1d(hit, rows.get(x, []), assume_unique=True)
        out[s] = int(len(hit))
    return out


def check_sound(window, res, recount):
    """A stale answer against the exact recount of its window: supports
    within ``max_drift``, misses below ``miss_bound``, L1 exact, and full
    equality when the certificate claims exactness."""
    cert = res.certificate
    true = exact_supports(window, [s for s in res.itemsets
                                   if s not in recount])
    true.update({s: c for s, c in recount.items() if s in res.itemsets})
    drift = max((abs(c - true[s]) for s, c in res.itemsets.items()),
                default=0)
    missed = max((c for s, c in recount.items() if s not in res.itemsets),
                 default=-1)
    l1 = {s: c for s, c in res.itemsets.items() if len(s) == 1}
    if (drift > cert.max_drift or missed >= cert.miss_bound
            or l1 != {s: c for s, c in recount.items() if len(s) == 1}
            or (cert.is_exact(res.min_count) and res.itemsets != recount)):
        raise AssertionError(f"stale answer unsound: drift {drift}, missed "
                             f"support {missed}, certificate {cert}")
    return drift


def serve_run(name, batches, warm, cfg, store, program, refs, log_launches):
    """One service through one program on the card: warm the window with
    ``warm`` batches and a cold exact query, then one measured step per
    remaining batch.  ``program`` is ``"exact"`` (ingest, query),
    ``"stale"`` (ingest, ``query(staleness=0.5)``, ``refresh_async()``)
    or ``"basket"`` (ingest, evict 1, 7 and slot_size - 1 baskets, query).
    ``refs`` maps a step to ``(window digest, recount answer)``; a step
    missing there is recounted by the ``perfect_hash`` ladder miner
    (``device_loop=True``) over ``svc.window()``.  Every exact answer must
    equal the recount, every stale one be sound under its certificate, and
    the kernel's launches equal what the log saw dispatched."""
    import numpy as np
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.stores import ITEM_PAD
    from repro_torch.kernels.support_count import (
        launches, pad_copies, reset_launches)
    from repro_torch.serve import MiningService

    kernel = KERNEL_OF.get(store)
    steps, recount_s, one_row = [], [], []
    reset_launches()
    with ServeLog() as log:
        t0 = time.perf_counter()
        svc = MiningService(store=store, device="cuda", **cfg)
        for b in batches[:warm]:
            svc.ingest(b)
        cold = svc.query()
        warm_s = time.perf_counter() - t0
        host0 = dict(log.host)
        launches0 = dict(launches)
        jobs0 = svc.delta_jobs
        for i, b in enumerate([None] + batches[warm:]):
            st = {"step": i}
            if i == 0:
                res = cold
            else:
                rep = svc.ingest(b)
                st["ingest_ms"] = rep.seconds * 1e3
                st["delta_jobs"] = rep.delta_jobs
                if program == "basket":
                    st["evict_ms"] = 0.0
                    for n in (1, 7, cfg["slot_size"] - 1):
                        chunks = sum(math.ceil(len(tl.cand) / CAND_BLOCK)
                                     for tl in svc._levels.values()
                                     if tl.cand.size)
                        real = bool((svc._slots[0].padded[:n]
                                     < ITEM_PAD).any())
                        before = dict(launches)
                        st["evict_ms"] += svc.evict(n).seconds * 1e3
                        if n == 1 and kernel and real:
                            got = launches[kernel] - before[kernel]
                            if got != chunks or not chunks:
                                raise AssertionError(
                                    f"one-row eviction launched {kernel} "
                                    f"{got} times, expected {chunks}")
                            one_row.append(got)
                if program == "stale":
                    res = svc.query(staleness=0.5)
                else:
                    res = svc.query()
                st["query_ms"] = res.seconds * 1e3
            window = svc.window()
            digest = window_digest(window)
            if i not in refs:
                log.paused = True
                t1 = time.perf_counter()
                ref = FrequentItemsetMiner(
                    min_support=cfg["min_support"], store="perfect_hash",
                    device_loop=True, max_k=cfg["max_k"],
                    device="cuda").mine(window).itemsets
                recount_s.append(time.perf_counter() - t1)
                log.paused = False
                refs[i] = (digest, ref)
            if refs[i][0] != digest:
                raise AssertionError(f"{name} {store} step {i}: window differs "
                                     "from the reference run's")
            ref = refs[i][1]
            if res.stale_reason == "stale" or not res.certificate.is_exact(
                    res.min_count):
                st["drift"] = check_sound(window, res, ref)
            elif res.itemsets != ref:
                raise AssertionError(f"{name} {store} step {i}: itemsets/"
                                     "supports differ from the recount")
            st.update(refreshed=res.refreshed, reason=res.stale_reason,
                      window=len(window), n_itemsets=len(res.itemsets),
                      exact=res.certificate.is_exact(res.min_count))
            if program == "stale" and i:
                svc.refresh_async()
            st["launches"] = {k: launches[k] for k in launches}
            steps.append(st)
        stats = svc.stats()
        f_pad = (len(svc._item_map) // 128 + 1) * 128
        svc.close()
    got = dict(launches)
    expected = log.expected()
    want = {k: (expected if k == kernel else 0) for k in got}
    if got != want or len(log.deltas) != stats["delta_jobs"]:
        raise AssertionError(f"{name} {store}: launches {got} != {want} or "
                             f"{len(log.deltas)} logged delta jobs != "
                             f"{stats['delta_jobs']}")
    if pad_copies["support_count"]:
        raise AssertionError(f"{name} {store}: {pad_copies} pad copies")
    if kernel and not got[kernel]:
        raise AssertionError(f"{kernel} never launched on {name}")
    for k in got:
        log_launches[k] += got[k]
    measured = steps[1:]
    ing = np.array([st["ingest_ms"] for st in measured])
    qry = np.array([st["query_ms"] for st in measured])
    per_batch = ((got[kernel] - launches0[kernel]) / len(measured)
                 if kernel else 0.0)
    host = {k: (log.host[k] - host0[k]) * 1e3 / len(measured)
            for k in log.host}
    rec = {"workload": name, "store": store, "program": program,
           "window": steps[-1]["window"], "f_pad": f_pad, "warm_s": warm_s,
           "ingest_ms_mean": float(ing.mean()),
           "ingest_ms_p50": float(np.percentile(ing, 50)),
           "evict_ms_mean": (float(np.mean([st["evict_ms"] for st in measured]))
                             if program == "basket" else None),
           "query_ms_p50": float(np.percentile(qry, 50)),
           "query_ms_p95": float(np.percentile(qry, 95)),
           "delta_served": int(sum(not st["refreshed"] for st in measured)),
           "stale_served": stats["stale_served"],
           "measured": len(measured), "refreshes": stats["refreshes"],
           "delta_jobs": stats["delta_jobs"],
           "delta_jobs_measured": stats["delta_jobs"] - jobs0,
           "tracked_candidates": stats["tracked_candidates"],
           "launches": got, "launches_per_batch": per_batch,
           "host_ms_per_batch": host, "one_row_launches": one_row,
           "recount_ms": (float(np.mean(recount_s)) * 1e3 if recount_s
                          else None),
           "steps": steps}
    print(f"serve {name} {program} store={store}: window {rec['window']}, "
          f"F_pad {f_pad}, tracked {rec['tracked_candidates']} candidates; "
          f"per measured batch ingest mean {rec['ingest_ms_mean']:.2f} ms "
          f"(p50 {rec['ingest_ms_p50']:.2f})"
          + (f", evictions mean {rec['evict_ms_mean']:.2f} ms"
             if program == "basket" else "")
          + f", query p50 "
          f"{rec['query_ms_p50']:.2f} ms p95 {rec['query_ms_p95']:.2f} ms; "
          f"delta-served {rec['delta_served']}/{len(measured)} (stale "
          f"{rec['stale_served']}); refreshes {rec['refreshes']}, delta jobs "
          f"{rec['delta_jobs']} ({rec['delta_jobs_measured']} measured), "
          f"launches {got} = expected, {per_batch:.1f} per batch"
          + (f", one-row evictions {len(one_row)} x {one_row[0]} launches"
             if one_row else "")
          + (f"; recount {rec['recount_ms']:.1f} ms per query"
             if recount_s else "")
          + "; host ms per batch " + ", ".join(
              f"{k} {v:.2f}" for k, v in host.items()))
    return rec


def serve_plans():
    """Phase 6's workloads: (dataset, batch size, service config, measured
    batches, [(path, program, extra config, stores)]).  T10I4D100K: 32
    slots of 3,125 baskets hold the 100,000-basket window (``bench_serve.py``'s
    slot formula at scale 1.0) at min_support 0.01, a tracked lattice of
    F_pad 640; BMS_WebView_2: 32 slots of 2,422 (77,504 baskets), the deep
    lattice, at 0.002."""
    t10_cfg = dict(min_support=0.01, n_slots=32, slot_size=SLOT, margin=0.8,
                   staleness=0.5, max_k=8)
    bms_cfg = dict(min_support=0.002, n_slots=32, slot_size=2422, margin=0.8,
                   staleness=0.5, max_k=16)
    return [
        ("T10I4D100K", SLOT, t10_cfg, 16, [
            ("serve", "exact", {}, ["perfect_hash", "packed_bitmap", "bitmap"]),
            ("serve_stale", "stale", {},
             ["perfect_hash", "packed_bitmap", "bitmap"]),
            ("serve_basket", "basket",
             {"eviction": "basket", "device_loop": True, "trim": True},
             ["packed_bitmap", "bitmap"])]),
        ("BMS_WebView_2", 2422, bms_cfg, 8, [
            ("serve", "exact", {}, ["perfect_hash", "packed_bitmap"])]),
    ]


def serve_phase(plans, scale=1.0):
    """Phase 6: the streaming ``MiningService`` on the card, every delta and
    refresh through the kernel stores, held to ``perfect_hash`` recounts;
    then the launcher once with the README's arguments."""
    from repro_torch.data import basket_stream
    from repro_torch.kernels.support_count import launches
    from repro_torch.launch import serve as serve_cli

    by_path = {}
    runs = []
    for name, batch, cfg, measured, programs in plans:
        t0 = time.perf_counter()
        batches = [ab.transactions for ab in basket_stream(
            name, batch_size=batch, scale=scale, seed=0, repeat=True,
            max_batches=cfg["n_slots"] + measured)]
        print(f"serve {name}: {len(batches)} arrival batches "
              f"({sum(map(len, batches))} baskets) in "
              f"{time.perf_counter() - t0:.2f} s")
        refs_exact = {}
        for path, program, extra, stores in programs:
            counts = by_path.setdefault(path, {k: 0 for k in launches})
            refs = refs_exact if program != "basket" else {}
            for store in stores:
                runs.append(serve_run(
                    name, batches, cfg["n_slots"], dict(cfg, **extra), store,
                    program, refs, counts))
    for path, counts in by_path.items():
        for k, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{k} never launched on the {path} path")
    t0 = time.perf_counter()
    serve_cli.main(["--batches", "20", "--query-every", "4", "--eviction",
                    "basket", "--query-staleness", "0.5", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    print(f"launcher: python -m repro_torch.launch.serve with the README's "
          f"arguments in {cli_s:.2f} s")
    return runs, by_path, cli_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    from repro_torch.core.itemsets import brute_force_frequent
    from repro_torch.data import get_dataset
    from repro_torch.kernels.support_count import build

    t_start = time.perf_counter()
    card = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_rate = POPC_PER_CLK_PER_SM * props.multi_processor_count * max_sm_mhz * 1e6
    int8_rate = (INT8_OPS_PER_CLK_PER_SM * props.multi_processor_count
                 * max_sm_mhz * 1e6)
    print(f"card: {card}; {props.multi_processor_count} SMs, max SM clock "
          f"{max_sm_mhz:.0f} MHz; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain bitmap path: fp32

    # Phase 1: build both kernels from the checkout's sources.
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: both kernels in {build_s:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "arning", "wgmma")):
                print(f"ptxas {name}: {line.strip()}")

    # Data for the main path, made from the seed.
    t0 = time.perf_counter()
    workloads = [("T10I4D100K", 0.01, get_dataset("T10I4D100K", 1.0, seed=0)),
                 ("BMS_WebView_2", 0.002,
                  get_dataset("BMS_WebView_2", 1.0, seed=0))]
    print(f"data: {[(w[0], len(w[2])) for w in workloads]} in "
          f"{time.perf_counter() - t0:.2f} s")

    # Phase 2: kernels vs plain versions at the main path's shapes.
    t10 = workloads[0]
    enc = encode(t10[2], math.ceil(t10[1] * len(t10[2])))
    print(f"T10I4D100K encode: N={enc.n_transactions} F={enc.n_items} "
          f"F_pad={enc.f_pad} W={enc.n_words}")
    bms = workloads[1]
    enc_bms = encode(bms[2], math.ceil(bms[1] * len(bms[2])))
    print(f"BMS_WebView_2 encode: N={enc_bms.n_transactions} "
          f"F={enc_bms.n_items} F_pad={enc_bms.f_pad}")
    # The serving lattice's width: items at the margin-lowered threshold.
    enc_serve = encode(t10[2], math.ceil(0.8 * math.ceil(t10[1] * len(t10[2]))))
    print(f"T10I4D100K serving encode: F={enc_serve.n_items} "
          f"F_pad={enc_serve.f_pad}")
    rows = kernel_phase(enc, enc_bms, enc_serve, np.random.default_rng(0),
                        sm_rate, int8_rate)

    # Phase 3: small mines against brute force.
    small_check(get_dataset, brute_force_frequent)

    # Phase 4: the main path, counts read just after each mine.
    mines, by_path, bases = main_path(workloads)

    # Phase 5: out of core, held to phase 4's resident answers.
    ooc_mines, by_path["spc_out_of_core"], ooc_host = out_of_core(workloads,
                                                                  bases)
    # Phase 6: the streaming service, held to perfect_hash recounts.
    serve_runs, serve_paths, cli_s = serve_phase(serve_plans())
    by_path.update(serve_paths)
    # Host phases of the T10I4D100K mine that no JobProfile row holds: the
    # ingest pass and the speculative C3 generated while C2 counts.
    from repro_torch.core.itemsets import apriori_gen_matrix
    from repro_torch.core.stores import padded_from_transactions

    t0 = time.perf_counter()
    padded_from_transactions(t10[2])
    ingest_s = time.perf_counter() - t0
    c2 = apriori_gen_matrix(np.arange(enc.n_items, dtype=np.int32)[:, None])
    t0 = time.perf_counter()
    n_spec = apriori_gen_matrix(c2).shape[0]
    spec_s = time.perf_counter() - t0
    host = {"ingest_s": ingest_s, "spec_c3_rows": n_spec, "spec_c3_s": spec_s}
    print(f"host T10I4D100K: ingest {ingest_s:.3f} s, speculative C3 "
          f"{n_spec} rows in {spec_s:.3f} s")

    for row in rows:
        row["launches"] = sum(counts[row["name"]] for counts in by_path.values())
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "kernels": rows,
                       "mines": mines, "host": host,
                       "out_of_core": {"mines": ooc_mines, "host": ooc_host},
                       "serve": {"runs": serve_runs, "cli_s": cli_s},
                       "device": device,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
