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
   block, and for the packed kernel the whole tracked C2 as one chunk over
   a full row block, as the drift program counts it) and at ragged shapes
   (C larger than a
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
   job and refresh wave, row blocks of every ladder level).  A last
   T10I4D100K program (``packed_bitmap``, slots of 12,500 filling from 8
   of 11) reads ``query(staleness=0.5)`` right after each ingest, while
   that batch's delta job still runs: at least one answer must carry
   ``max_drift > 0``, every one must be sound, and the exact query after
   it equal the recount.  Then
   the launcher runs once with the README's arguments;
7. the paper's Hadoop model beside the card, faults and checkpoints:
   ``run_parity_cell`` on T10I4D100K (1.0, 0.01) over
   ``sim/hash_table_trie`` and ``sim/trie`` (4 mappers on a process pool)
   and ``TorchRunner`` (``packed_bitmap``, ``bitmap``, ``perfect_hash``) on
   the card; ``sim/hash_tree`` against ``packed_bitmap`` on T10I4D100K at
   scale 0.25 (its digest: that quarter's ``perfect_hash`` SPC mine on the
   card); on BMS_WebView_2 (1.0, 0.002)
   ``sim/hash_table_trie`` against
   ``packed_bitmap``.  Every digest must equal phase 4's ``perfect_hash``
   SPC mine's.  On BMS_WebView_2, ``device_loss`` at the k = 4 dispatch of
   the host loop (``packed_bitmap``) and of the ladder (``bitmap``) must
   raise, leave the snapshots of the completed levels, and a fault-free
   runner on the same directory must resume without Job1, launching its
   kernel exactly for the levels from k = 4 on, with phase 4's answer;
   bit rot of the newest snapshot must fall back one level, and a torn
   write must never commit.  ``FaultPlan.chaos`` on ``sim/trie``'s thread
   pool over BMS_WebView_2 at scale 0.25 must equal a fault-free mine;
8. the sharded runner over ``torch.distributed``, each cluster spawned
   through ``repro_torch.launch.multihost`` (ranks are this script in
   worker mode, ``--phase8-worker``, reading phase 4's data from a
   temporary file): (a) one NCCL rank on 1x1 meshes: T10I4D100K SPC
   through ``packed_bitmap`` and ``bitmap`` and BMS_WebView_2's trimmed
   ladder through ``bitmap``, each rank's launches equal to phase 4's, and
   BMS_WebView_2 SPC through ``TorchRunner`` and the 1x1 ``ShardedRunner``
   in turns; (e) on that rank, ``MiningService(mesh=make_data_mesh())`` over
   the first 4 measured batches of phase 6's T10I4D100K exact plan, every
   answer equal to a ``perfect_hash`` recount; (b) two gloo ranks sharing
   the card: T10I4D100K SPC (``packed_bitmap``) on 2x1 and 1x2 and
   BMS_WebView_2's ladder on 2x1; (d) then ``device_loss(k=4, lost=1)``:
   rank 1 leaves, rank 0 rebuilds a one-rank mesh and resumes from the
   level checkpoint; (c) ``python -m repro_torch.launch.multihost`` on two
   gloo ranks, BMS_WebView_2, ``--kill-k 3``: rank 1 exits with 137, one
   rank is relaunched from the checkpoint (``restored_step`` >= 2, the
   clean run's counting jobs).  Every answer must equal phase 4's
   ``perfect_hash`` SPC mine, and each rank's kernel launches what its
   waves ask for (its row blocks x candidate chunks) or its ladder levels
   (its rows);
9. the dense LM and frequent token-set mining over its stream: (a)
   qwen2-1.5b at its full published config, random bfloat16 weights from a
   seeded ``torch.Generator``: ``ServeEngine.generate`` with batch 4, a
   128-token prompt, 32 greedy tokens, max_len 256, twice (identical
   tokens, every logit finite), with prefill ms, decode ms a token, tok/s
   and peak memory; then in float32 (TF32 off) prefill(128) + decode(token
   128) against a full forward over 129 tokens, relative max error < 1e-3
   for every layer (teacher-forced) and for the logits through the first 3
   layers (the reference's reduced depth; through all 28 the random stack
   is chaotic, and that error is printed only);
   (b) gemma2-2b at full width, 4 of its 26 layers (two local, two
   global): batch 1, a 6,144-token prompt, 16 greedy tokens, max_len
   6,160, so the 4,096 window masks real positions, and the same float32
   check; (c) ``TokenSetMiner(min_support=0.01, window=32, max_k=4)`` over
   steps 0-3 of ``SyntheticLM(151,936, batch=256, seq_len=4096, seed=0)``
   (131,072 windows) through ``bitmap`` and ``packed_bitmap``, each equal to
   the ``perfect_hash`` mine (itemsets AND supports), each kernel's
   launches equal to row blocks x candidate chunks of every level
   (``token_miner`` in the ``kernels`` line).

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
    # Phase 6's drift program counts the whole tracked C2 as one chunk.
    pc_whole = PackedBitmapStore.encode_candidates(
        torch.from_numpy(pad_candidates(c2s, fs)).to(dev), f_pad=fs)
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
                   for n in serve_rows for p in pcs]
                  + [(packed_s[BLOCK_N], pc_whole["packed"], pc_whole["kvec"])],
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
    is active (and, in ``stores``, the store that counted it), so the
    expected launches of the host-loop paths follow from the waves (SPC:
    one per level; FPC/DPC: several per job).  A resident wave is one
    ``count_candidates_async`` call; an out-of-core wave is one chunked job
    (``TorchRunner._count_chunked_async``), logged once however many
    transaction chunks it streams."""

    def __enter__(self):
        from repro_torch.core.runtime.engine import MapReduceEngine
        from repro_torch.core.runtime.runners import TorchRunner

        self.sizes, self.stores = [], []
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
            self.stores.append(getattr(obj, "engine", obj).store_name)
            return orig(obj, arg)
        return logged

    def expected(self, store: str, n: int) -> int:
        """Launches of ``store``'s waves over ``n`` resident rows."""
        return math.ceil(n / BLOCK_N) * sum(
            math.ceil(c / CAND_BLOCK)
            for c, s in zip(self.sizes, self.stores) if s == store)

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
                self.deltas.append((enc.n_transactions, len(cand),
                                    runner.engine.cand_block))
            return orig(runner, enc, cand)
        return logged

    def _wave(self, orig):
        def logged(engine, cand):
            if not self.paused:
                self.waves.append((engine._enc.n_transactions, len(cand),
                                   engine.cand_block))
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
        def job(n, c, chunk):
            return math.ceil(c / chunk) * math.ceil(n / BLOCK_N)
        return (sum(job(*d) for d in self.deltas + self.waves)
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


def serve_run(name, batches, warm, cfg, store, program, refs, log_launches,
              mesh=None):
    """One service through one program on the card: warm the window with
    ``warm`` batches and a cold exact query, then one measured step per
    remaining batch.  ``program`` is ``"exact"`` (ingest, query),
    ``"stale"`` (ingest, ``query(staleness=0.5)``, ``refresh_async()``),
    ``"basket"`` (ingest, evict 1, 7 and slot_size - 1 baskets, query) or
    ``"drift"`` (ingest, then at once ``query(staleness=0.5)``, read while
    the last delta job's kernels still run, so its certificate must carry
    ``max_drift > 0`` at least once; then an exact ``query()``).  A
    ``cand_block`` key in ``cfg`` sets the runner's candidate chunk.  The
    first ``warm`` batches fill the window.
    ``refs`` maps a step to ``(window digest, recount answer)``; a step
    missing there is recounted by the ``perfect_hash`` ladder miner
    (``device_loop=True``) over ``svc.window()``.  Every exact answer must
    equal the recount, every stale one be sound under its certificate, and
    the kernel's launches equal what the log saw dispatched.  With ``mesh``
    the service counts through ``ShardedRunner`` on it."""
    import numpy as np
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.stores import ITEM_PAD
    from repro_torch.kernels.support_count import (
        launches, pad_copies, reset_launches)
    from repro_torch.serve import MiningService

    from repro_torch.core.runtime import make_runner

    kernel = KERNEL_OF.get(store)
    steps, recount_s, one_row = [], [], []
    cand_block = cfg.pop("cand_block", CAND_BLOCK)
    reset_launches()
    with ServeLog() as log:
        t0 = time.perf_counter()
        svc = MiningService(runner=make_runner(
            store=store, cand_block=cand_block, mesh=mesh, device="cuda"),
            **cfg)
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
                if program in ("stale", "drift"):
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
            if program == "drift" and i:
                st["max_drift"] = res.certificate.max_drift
                st["undrained"] = res.certificate.undrained
                if svc.query().itemsets != ref:
                    raise AssertionError(f"{name} {store} step {i}: exact "
                                         "answer after a stale one differs "
                                         "from the recount")
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
    drifts = [st["max_drift"] for st in steps if "max_drift" in st]
    if program == "drift" and not any(d > 0 for d in drifts):
        raise AssertionError(f"{name} {store}: no stale answer carried drift "
                             f"(max_drift {drifts}, reasons "
                             f"{[st['reason'] for st in steps]})")
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
          + (f"; stale answers' max_drift {drifts} (undrained "
             f"{[st['undrained'] for st in steps if 'undrained' in st]}, "
             f"measured drift {[st.get('drift') for st in steps[1:]]}), "
             "each sound against the recount" if drifts else "")
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
        # Batches of 7,500-12,500 baskets, one 12,500-row slot each.  Every
        # copy between host and card waits for the whole stream, so a delta
        # job can still run when the query after its ingest reads the
        # counts only if nothing is copied after it: the 8-batch warm-up
        # leaves 3 of 11 slots free, so a measured batch evicts nothing
        # (no older job for the FIFO to fetch behind it); max_k 2 leaves
        # one tracked level, so one job a block (L2 is empty at 0.01, so
        # the answers are the same); one candidate chunk for the whole
        # tracked C2 keeps that job on the card for ~18 ms.  The service's
        # own staleness of 0.1 makes each exact query refresh.
        ("T10I4D100K", 10_000,
         dict(t10_cfg, n_slots=11, slot_size=12_500, staleness=0.1,
              max_k=2, warm=8), 3,
         [("serve_drift", "drift", {"cand_block": 1 << 18},
           ["packed_bitmap"])]),
    ]


def serve_phase(plans, scale=1.0):
    """Phase 6: the streaming ``MiningService`` on the card, every delta and
    refresh through the kernel stores, held to ``perfect_hash`` recounts;
    then the launcher once with the README's arguments."""
    from repro_torch.data import basket_stream
    from repro_torch.kernels.support_count import launches
    from repro_torch.launch import serve as serve_cli

    by_path, kernels = {}, {}
    runs = []
    for name, batch, cfg, measured, programs in plans:
        cfg = dict(cfg)
        warm = cfg.pop("warm", cfg["n_slots"])
        t0 = time.perf_counter()
        batches = [ab.transactions for ab in basket_stream(
            name, batch_size=batch, scale=scale, seed=0, repeat=True,
            max_batches=warm + measured)]
        print(f"serve {name}: {len(batches)} arrival batches "
              f"({sum(map(len, batches))} baskets) in "
              f"{time.perf_counter() - t0:.2f} s")
        refs_exact = {}
        for path, program, extra, stores in programs:
            counts = by_path.setdefault(path, {k: 0 for k in launches})
            kernels.setdefault(path, set()).update(
                KERNEL_OF[s] for s in stores if s in KERNEL_OF)
            refs = refs_exact if program != "basket" else {}
            for store in stores:
                runs.append(serve_run(
                    name, batches, warm, dict(cfg, **extra), store,
                    program, refs, counts))
    for path, counts in by_path.items():
        for k in kernels[path]:
            if counts[k] <= 0:
                raise AssertionError(f"{k} never launched on the {path} path")
    t0 = time.perf_counter()
    serve_cli.main(["--batches", "20", "--query-every", "4", "--eviction",
                    "basket", "--query-staleness", "0.5", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    print(f"launcher: python -m repro_torch.launch.serve with the README's "
          f"arguments in {cli_s:.2f} s")
    return runs, by_path, cli_s


class CellLog:
    """While active, keeps the ``JobProfile`` rows and the host wall clock
    of every backend ``run_parity_cell`` mines, in factory order (the wall
    runs from the previous backend's end: construction, the mine, and a
    pool's shutdown)."""

    def __enter__(self):
        from repro_torch.core.runtime import sweep

        self.levels, self.walls = [], []
        self._sweep, self._orig = sweep, sweep.aggregate_profiles
        self._t = time.perf_counter()

        def logged(levels):
            now = time.perf_counter()
            self.walls.append(now - self._t)
            self._t = now
            self.levels.append(list(levels))
            return self._orig(levels)
        sweep.aggregate_profiles = logged
        return self

    def __exit__(self, *exc):
        self._sweep.aggregate_profiles = self._orig


def parity_cell(name, db, support, factories, base, stores):
    """One ``run_parity_cell`` on the card: its digest must equal the
    phase-4 ``perfect_hash`` SPC mine's (``base``), and each kernel's
    launches the row blocks x candidate chunks of its store's waves."""
    from repro_torch.core.runtime import itemset_digest, run_parity_cell
    from repro_torch.kernels.support_count import launches, reset_launches

    with WaveLog() as waves, CellLog() as cell_log:
        reset_launches()
        t0 = time.perf_counter()
        cell = run_parity_cell(db, support, factories)
        wall = time.perf_counter() - t0
        got = dict(launches)
    want = {k: 0 for k in got}
    for store in stores:
        if store in KERNEL_OF:
            want[KERNEL_OF[store]] = waves.expected(store, len(db))
    if cell.digest != itemset_digest(base):
        raise AssertionError(f"cell {name}: digest {cell.digest} != the "
                             f"perfect_hash SPC mine's {itemset_digest(base)}")
    if got != want or not all(want[KERNEL_OF[s]] for s in stores
                              if s in KERNEL_OF):
        raise AssertionError(f"cell {name}: launches {got} != {want}")
    rows = {}
    for (label, agg), levels, bwall in zip(cell.backends.items(),
                                           cell_log.levels, cell_log.walls):
        per_level = [{"k": p.k, "n_candidates": p.n_candidates,
                      "n_frequent": p.n_frequent, "seconds": p.seconds,
                      "gen": p.gen_seconds, "build": p.build_seconds,
                      "encode": p.encode_seconds, "count": p.count_seconds,
                      "reduce": p.reduce_seconds,
                      "parallel": p.parallel_seconds,
                      "mappers": len(p.mapper_seconds)} for p in levels]
        rows[label] = {"wall_s": bwall, "aggregate": agg, "levels": per_level}
        print(f"cell {name} min_support={support} {label}: host wall "
              f"{bwall:.3f} s, jobs {agg['seconds']:.3f} s, parallel model "
              f"{agg['parallel_seconds']:.3f} s, sequential "
              f"{agg['sequential_seconds']:.3f} s; per level (max over "
              "mappers) " + "; ".join(
                  f"k={r['k']} gen {r['gen']:.3f} build {r['build']:.3f} "
                  f"encode {r['encode']:.3f} count {r['count']:.3f} reduce "
                  f"{r['reduce']:.3f}" for r in per_level))
    print(f"cell {name}: {cell.n_itemsets} itemsets, digest {cell.digest} "
          f"== phase 4's perfect_hash SPC mine across {len(factories)} "
          f"backends in {wall:.1f} s, launches {got} (expected {want})")
    return {"dataset": name, "min_support": support, "digest": cell.digest,
            "n_itemsets": cell.n_itemsets, "wall_s": wall, "launches": got,
            "backends": rows}


def pool_startup_s() -> float:
    """Host seconds to start a 4-worker process pool (forked from this
    process, which holds a CUDA context) and run one empty Job1 wave."""
    from repro_torch.core.runtime import SimRunner
    from repro_torch.core.runtime.runners import _job1_mapper

    runner = SimRunner(n_mappers=4, executor="process")
    t0 = time.perf_counter()
    runner._map(_job1_mapper, [([],)] * 4)
    startup = time.perf_counter() - t0
    runner.close()
    return startup


def resume_program(name, db, base, store, device_loop, k_loss):
    """Device loss at the level-``k_loss`` dispatch, then a resume on a
    fresh runner from the same checkpoint directory (a temporary one, never
    inside the repository).  The faulted mine must raise with snapshots
    keyed by the levels it completed, the resume must equal phase 4's
    answer without running Job1, and its kernel must launch exactly for
    the levels from ``k_loss`` on."""
    import shutil
    import tempfile

    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.runtime import DeviceLostError, FaultPlan, TorchRunner
    from repro_torch.core.runtime import faults as F
    from repro_torch.kernels.support_count import launches, reset_launches

    kernel = KERNEL_OF[store]
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saves = []  # host seconds of each level snapshot the resume writes
    save = FrequentItemsetMiner._checkpoint

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        saves.append(time.perf_counter() - t0)
    try:
        plan = FaultPlan(F.device_loss(k=k_loss))
        lost = TorchRunner(store=store, fault_plan=plan, device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        try:
            FrequentItemsetMiner(min_support=base["support"], runner=lost,
                                 device_loop=device_loop,
                                 checkpoint_dir=d).mine(db)
            raise AssertionError(f"{name} {store}: device_loss(k={k_loss}) "
                                 "never fired")
        except DeviceLostError as err:
            if err.k != k_loss or lost.engine._queue:
                raise AssertionError(f"lost at k={err.k}, queue "
                                     f"{len(lost.engine._queue)}") from err
        lost_s = time.perf_counter() - t0
        before = launches[kernel]
        snaps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        want_snaps = [f"step_{k:08d}" for k in range(3, k_loss + 1)]
        if snaps != want_snaps:
            raise AssertionError(f"snapshots {snaps} != {want_snaps}")
        fresh = TorchRunner(store=store, device="cuda")
        job1 = []
        fresh.job1 = lambda orig=fresh.job1: job1.append(1) or orig()
        with WaveLog() as waves:
            reset_launches()
            FrequentItemsetMiner._checkpoint = timed_save
            t0 = time.perf_counter()
            try:
                res = FrequentItemsetMiner(
                    min_support=base["support"], runner=fresh,
                    device_loop=device_loop, checkpoint_dir=d).mine(db)
            finally:
                FrequentItemsetMiner._checkpoint = save
            resume_s = time.perf_counter() - t0
            got = dict(launches)
        new = [p for p in res.levels if p.k >= k_loss]
        if device_loop:
            expected = sum(math.ceil(p.n_pad / BLOCK_N) for p in new)
        else:
            if waves.sizes != [p.n_candidates for p in new]:
                raise AssertionError(f"resume waves {waves.sizes} != the "
                                     "levels from the loss on")
            expected = waves.expected(store, len(db))
        want = {k: (expected if k == kernel else 0) for k in got}
        if job1 or got != want or not expected or res.itemsets != base["itemsets"]:
            raise AssertionError(f"{name} {store} resume: job1 ran {len(job1)}"
                                 f" times, launches {got} != {want}, or the "
                                 "answer differs from phase 4's")
        print(f"fault {name} {'ladder' if device_loop else 'host loop'} "
              f"store={store}: device_loss(k={k_loss}) raised after {lost_s:.3f}"
              f" s ({before} launches), snapshots {snaps}; resume without "
              f"Job1 in {resume_s:.3f} s ({len(saves)} level snapshots "
              f"{sum(saves):.3f} s of it) over levels {[p.k for p in new]}, "
              f"launches {got} (expected {want}), answer == phase 4")
        return ({"dataset": name, "store": store, "device_loop": device_loop,
                 "k_loss": k_loss, "lost_s": lost_s, "lost_launches": before,
                 "snapshots": snaps, "resume_s": resume_s,
                 "snapshot_s": saves, "launches": got,
                 "levels": [p.k for p in new]},
                dict(want, **{kernel: before + got[kernel]}), res)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def snapshot_faults(name, db, base, last_k):
    """Bit rot in the newest level snapshot: restore quarantines it and
    resumes from the one before, recounting only the last level.  A torn
    write of a snapshot leaves its ``.tmp`` and never commits."""
    import shutil
    import tempfile

    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.runtime import FaultPlan, TorchRunner
    from repro_torch.core.runtime import faults as F
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels.support_count import launches, reset_launches

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        newest = last_k + 1  # a snapshot is keyed by the next level
        reset_launches()
        runner = TorchRunner(store="packed_bitmap", device="cuda",
                             fault_plan=FaultPlan(F.bitrot(step=newest)))
        FrequentItemsetMiner(min_support=base["support"], runner=runner,
                             checkpoint_dir=os.path.join(d, "rot")).mine(db)
        valid = ckpt.latest_valid_step(os.path.join(d, "rot"))
        quarantined = os.path.isdir(os.path.join(
            d, "rot", f"step_{newest:08d}.corrupt"))
        fresh = TorchRunner(store="packed_bitmap", device="cuda")
        ks = []
        fresh.count_async = (lambda job, orig=fresh.count_async:
                             ks.append(job.k) or orig(job))
        def no_job1():
            raise AssertionError("Job1 ran on resume")

        fresh.job1 = no_job1
        res = FrequentItemsetMiner(min_support=base["support"], runner=fresh,
                                   checkpoint_dir=os.path.join(d, "rot")
                                   ).mine(db)
        if (valid != newest - 1 or not quarantined or ks != [last_k]
                or res.itemsets != base["itemsets"]):
            raise AssertionError(f"bit rot: valid step {valid}, quarantined "
                                 f"{quarantined}, recounted {ks}")
        print(f"fault {name} bitrot(step={newest}): quarantined, restore "
              f"fell back to step {valid}, recounted level(s) {ks}, answer "
              "== phase 4")
        out["bitrot"] = {"newest": newest, "restored": valid, "recounted": ks}
        runner = TorchRunner(store="packed_bitmap", device="cuda",
                             fault_plan=FaultPlan(F.torn_write(step=4)))
        torn = os.path.join(d, "torn")
        try:
            FrequentItemsetMiner(min_support=base["support"], runner=runner,
                                 checkpoint_dir=torn).mine(db)
            raise AssertionError("torn_write never fired")
        except ckpt.TornWriteError:
            pass
        used = dict(launches)
        if not used["packed_support_count"] or used["support_count"]:
            raise AssertionError(f"snapshot faults: launches {used}")
        left = sorted(os.listdir(torn))
        with open(os.path.join(torn, "LATEST")) as f:
            pointed = f.read().strip()
        if ("step_00000004.tmp" not in left or "step_00000004" in left
                or pointed != "step_00000003"):
            raise AssertionError(f"torn write left {left}, LATEST {pointed}")
        print(f"fault {name} torn_write(step=4): left {left}, LATEST "
              f"{pointed}: never committed")
        out["torn_write"] = {"left": left, "latest": pointed}
        return out, used
    finally:
        shutil.rmtree(d, ignore_errors=True)


def chaos_program(get_dataset):
    """``FaultPlan.chaos`` on the sim's thread pool over BMS_WebView_2 at
    scale 0.25 must equal a fault-free sim mine of the same data."""
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.runtime import FaultPlan, RetryPolicy, SimRunner

    db = get_dataset("BMS_WebView_2", 0.25, seed=0)
    t0 = time.perf_counter()
    with SimRunner(structure="trie", executor="process") as runner:
        clean = FrequentItemsetMiner(min_support=0.002, runner=runner).mine(db)
    clean_s = time.perf_counter() - t0
    plan = FaultPlan.chaos(n_faults=3, seed=0)
    t0 = time.perf_counter()
    with SimRunner(structure="trie", executor="thread", fault_plan=plan,
                   retry=RetryPolicy(backoff=0.001)) as runner:
        res = FrequentItemsetMiner(min_support=0.002, runner=runner).mine(db)
    chaos_s = time.perf_counter() - t0
    tele = {f: sum(getattr(p, f) for p in res.levels)
            for f in ("retries", "speculative_launches", "speculative_wins",
                      "backoff_seconds")}
    addresses = {(s.k, s.slot) for s in plan.specs}  # attempt 0 each
    if res.itemsets != clean.itemsets or len(plan.injected) != len(addresses):
        raise AssertionError(f"chaos: injected {plan.injected} of "
                             f"{plan.specs}, answers equal: "
                             f"{res.itemsets == clean.itemsets}")
    print(f"chaos BMS_WebView_2 scale 0.25 ({len(db)} baskets): "
          f"{[(s.kind, s.k, s.slot) for s in plan.specs]} fired "
          f"{len(plan.injected)} times, "
          f"telemetry {tele}; {len(res.itemsets)} itemsets == the fault-free "
          f"sim/trie mine; thread pool {chaos_s:.2f} s, fault-free process "
          f"pool {clean_s:.2f} s")
    return {"specs": [(s.kind, s.k, s.slot) for s in plan.specs],
            "telemetry": tele, "chaos_s": chaos_s, "clean_s": clean_s,
            "n_itemsets": len(res.itemsets)}


def hadoop_phase(workloads, bases, get_dataset):
    """Phase 7: the paper's Hadoop model beside the card, fault injection
    and level checkpoints.  Returns (record, launches by path)."""
    from repro_torch.core.runtime import SimRunner, TorchRunner

    t_phase = time.perf_counter()
    by_path = {}
    rec = {"pool_startup_s": pool_startup_s()}
    print(f"sim: a 4-worker process pool starts in "
          f"{rec['pool_startup_s']:.3f} s (host)")

    def sim(structure):
        return lambda: SimRunner(structure=structure, n_mappers=4,
                                 executor="process")

    def card(store):
        return lambda: TorchRunner(store=store, device="cuda")

    data = {name: (support, db) for name, support, db in workloads}
    support, t10 = data["T10I4D100K"]
    stores = ["packed_bitmap", "bitmap", "perfect_hash"]
    factories = {f"sim/{s}": sim(s) for s in ("hash_table_trie", "trie")}
    factories.update({f"torch/{s}": card(s) for s in stores})
    rec["t10"] = parity_cell("T10I4D100K", t10, support, factories,
                             bases["T10I4D100K"], stores)
    by_path["cell_t10"] = rec["t10"]["launches"]
    # sim/hash_tree takes 46.7-89.5 s at full scale on the H100 (its leaf
    # scans): it runs on T10I4D100K at scale 0.25, against that quarter's
    # perfect_hash SPC mine on the card, to leave phase 8 its time.
    quarter = get_dataset("T10I4D100K", 0.25, seed=0)
    qbase, _ = mine(quarter, support, "perfect_hash")
    rec["t10_quarter"] = parity_cell(
        "T10I4D100K@0.25", quarter, support,
        {"sim/hash_tree": sim("hash_tree"),
         "torch/packed_bitmap": card("packed_bitmap")},
        qbase.itemsets, ["packed_bitmap"])
    by_path["cell_t10_quarter"] = rec["t10_quarter"]["launches"]
    support, bms = data["BMS_WebView_2"]
    rec["bms"] = parity_cell(
        "BMS_WebView_2", bms, support,
        {"sim/hash_table_trie": sim("hash_table_trie"),
         "torch/packed_bitmap": card("packed_bitmap")},
        bases["BMS_WebView_2"], ["packed_bitmap"])
    by_path["cell_bms"] = rec["bms"]["launches"]
    base = {"support": support, "itemsets": bases["BMS_WebView_2"]}
    rec["device_loss_host"], by_path["device_loss_host"], res = resume_program(
        "BMS_WebView_2", bms, base, "packed_bitmap", False, 4)
    rec["device_loss_ladder"], by_path["device_loss_ladder"], _ = \
        resume_program("BMS_WebView_2", bms, base, "bitmap", True, 4)
    last_k = max(p.k for p in res.levels)
    rec["snapshots"], by_path["snapshot_faults"] = snapshot_faults(
        "BMS_WebView_2", bms, base, last_k)
    rec["chaos"] = chaos_program(get_dataset)
    rec["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 7: {rec['wall_s']:.1f} s")
    return rec, by_path


# -- phase 8: the sharded runner on torch.distributed --------------------------

class LadderLog:
    """Records the rows this rank counts at every ladder level while it is
    active, so a sharded ladder's launches follow from them (one pass over
    the row blocks a level); on one rank they are each level's ``n_pad``."""

    def __enter__(self):
        from repro_torch.core.runtime.device_loop import LevelLadder

        self.rows = []
        self._orig = orig = LevelLadder._count

        def count(lad, cand_safe):
            self.rows.append(int(lad._padded.shape[0]))
            return orig(lad, cand_safe)

        LevelLadder._count = count
        return self

    def expected(self) -> int:
        return sum(math.ceil(r / BLOCK_N) for r in self.rows)

    def __exit__(self, *exc):
        from repro_torch.core.runtime.device_loop import LevelLadder

        LevelLadder._count = self._orig


def sharded_mine(db, support, store, shape, ladder=False, runner=None,
                 split=None, **options):
    """One mine of this rank through ``ShardedRunner`` on a ``shape`` =
    (n_data, n_cand) mesh (n_cand 0: the 1-D data mesh), or through
    ``runner``.  Launch counts are zeroed just before the mine and read
    just after; the expected count follows from the waves (host loop:
    this rank's row blocks x candidate chunks of every wave) or from the
    rows counted at every ladder level.  ``split`` = (waves, rows): the
    first ``waves`` waves counted ``rows`` rows a rank (before an elastic
    rebuild), the rest the final runner's."""
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.runtime import ShardedRunner
    from repro_torch.kernels.support_count import launches, reset_launches
    from repro_torch.launch.mesh import make_data_cand_mesh, make_data_mesh

    if runner is None:
        n_data, n_cand = shape
        mesh = (make_data_cand_mesh(n_data, n_cand) if n_cand
                else make_data_mesh(n_data))
        runner = ShardedRunner(store=store, mesh=mesh,
                               cand_axes=("cand",) if n_cand else ())
    with WaveLog() as waves, LadderLog() as levels:
        reset_launches()
        t0 = time.perf_counter()
        miner = FrequentItemsetMiner(min_support=support, runner=runner,
                                     device_loop=ladder, **options)
        res = miner.mine(db)
        wall = time.perf_counter() - t0
        got = dict(launches)
    eng = miner.active_runner.engine
    if ladder:
        expected = levels.expected()
    else:
        before, rows = split or (0, 0)
        expected = sum(
            math.ceil((rows if i < before else eng._local_enc.n_transactions)
                      / BLOCK_N) * math.ceil(c / CAND_BLOCK)
            for i, c in enumerate(waves.sizes))
    kernel = KERNEL_OF.get(store)
    want = {k: (expected if k == kernel else 0) for k in got}
    if got != want:
        raise AssertionError(f"sharded {store} {shape} ladder={ladder}: "
                             f"launches {got} != {want}")
    n_waves = len(levels.rows) if ladder else len(waves.sizes)
    return res, {"store": store, "shape": shape and list(shape),
                 "ladder": ladder,
                 "wall_s": wall, "launches": got,
                 "local_rows": eng._local_enc.n_transactions,
                 "waves": waves.sizes, "level_rows": levels.rows,
                 "collectives": eng.collectives,
                 "collective_ms": eng.collective_seconds * 1e3,
                 "collective_ms_per_wave": (eng.collective_seconds * 1e3
                                            / max(1, n_waves)),
                 "describe": miner.active_runner.describe()}


def phase8_worker(spec_path: str) -> int:
    """One rank of a phase-8 cluster (``launch_cluster`` sets the env trio):
    joins the group, runs the spec's programs, writes its records and
    leaves through ``exit_rank``."""
    import pickle

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.distributed import ctx

    with open(spec_path) as f:
        spec = json.load(f)
    ctx.initialize_multihost(device="cuda", backend=spec["backend"],
                             timeout=600)
    from repro_torch.core.runtime import DeviceLostError, FaultPlan, TorchRunner
    from repro_torch.core.runtime import faults as F
    from repro_torch.kernels.support_count import build

    build.build_all()  # phase 1 built them: this only loads
    rank = ctx.process_index()
    with open(spec["data"], "rb") as f:
        data = pickle.load(f)  # written by this script's parent process
    recs = []
    for prog in spec["programs"]:
        name, kind = prog["dataset"], prog["kind"]
        support, db = data[name]
        rec = {"kind": kind, "dataset": name}
        if kind == "mine":
            res, info = sharded_mine(db, support, prog["store"],
                                     prog["shape"], prog.get("ladder", False))
            rec.update(info)
        elif kind == "walls":
            # TorchRunner and the 1x1 sharded runner in turns (torch,
            # sharded, sharded, torch): the collectives' cost at world 1.
            rec["walls"] = []
            for which in ("torch", "sharded", "sharded", "torch"):
                runner = (TorchRunner(store=prog["store"], device="cuda")
                          if which == "torch" else None)
                res, info = sharded_mine(db, support, prog["store"],
                                         prog["shape"], runner=runner)
                rec["walls"].append([which, info["wall_s"],
                                     info["collective_ms"]])
                if which == "sharded":
                    rec.update(info)
        elif kind == "elastic":
            plan = FaultPlan(F.device_loss(k=prog["k"], lost=prog["lost"]))
            from repro_torch.core.runtime import ShardedRunner
            from repro_torch.launch.mesh import make_data_mesh

            runner = ShardedRunner(store=prog["store"], mesh=make_data_mesh(),
                                   fault_plan=plan)
            try:
                world = ctx.process_count()
                res, info = sharded_mine(
                    db, support, prog["store"], None, runner=runner,
                    split=(prog["k"] - 2, -(-len(db) // world)),
                    checkpoint_dir=spec["ckpt"])
                rec.update(info)
            except DeviceLostError as err:
                res = None
                rec.update(lost=True, k=err.k)
            rec["injected"] = [kind for kind, _ in plan.injected]
        else:  # serve
            from repro_torch.data import basket_stream
            from repro_torch.kernels.support_count import launches
            from repro_torch.launch.mesh import make_data_mesh

            cfg = dict(prog["cfg"])
            batches = [ab.transactions for ab in basket_stream(
                name, batch_size=prog["batch"], scale=prog["scale"], seed=0,
                repeat=True, max_batches=cfg["n_slots"] + prog["measured"])]
            counts = {k: 0 for k in launches}
            rec.update(serve_run(name, batches, cfg["n_slots"], cfg,
                                 prog["store"], "exact", {}, counts,
                                 mesh=make_data_mesh()))
            res = None
        if res is not None:
            rec["itemsets"] = sorted([list(s), int(c)]
                                     for s, c in res.itemsets.items())
            rec["counting_jobs"] = sum(1 for p in res.levels if p.k >= 2)
        rec["rank"] = rank
        recs.append(rec)
        print(f"phase 8 rank {rank}: {kind} {name} "
              + " ".join(f"{k}={rec[k]}" for k in (
                  "store", "shape", "ladder", "wall_s", "launches",
                  "collectives", "collective_ms_per_wave", "lost")
                  if k in rec), flush=True)
        if rec.get("lost"):
            break  # a lost rank leaves the cluster's remaining programs
    with open(f"{spec['out']}.{rank}", "w") as f:
        json.dump(recs, f)
    from repro_torch.launch.multihost import exit_rank

    exit_rank()


def run_cluster(tmp, tag, n, backend, programs, ckpt=None):
    """Launch ``n`` ranks of this script in worker mode; returns each rank's
    records."""
    from repro_torch.launch.multihost import launch_cluster

    spec = {"backend": backend, "programs": programs,
            "data": os.path.join(tmp, "data.pkl"),
            "out": os.path.join(tmp, tag), "ckpt": ckpt}
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    launch_cluster([sys.executable, os.path.abspath(__file__),
                    "--phase8-worker", path], n, base_env=env, timeout=600)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(n):
        with open(f"{spec['out']}.{r}") as f:
            recs.append(json.load(f))
    print(f"phase 8 cluster {tag}: {n} rank(s), {backend}, {wall:.1f} s")
    return recs, wall


def sharded_phase(workloads, bases, mines, scale=1.0, serve=None):
    """Phase 8: ``ShardedRunner`` over ``torch.distributed`` on the card.
    (a) one NCCL rank, 1x1 meshes, full width; (e) the service on that
    rank's data mesh; (b) two gloo ranks on this card, 2x1 and 1x2;
    (d) a device loss on them; (c) the multi-host supervisor relaunching
    one rank after a killed worker.  Every answer must equal phase 4's
    ``perfect_hash`` SPC mine, every rank's kernel launches what its waves
    or ladder rows ask for.  ``scale`` is the workloads' (the supervisor
    generates its own BMS_WebView_2 at it, the service its stream), and
    ``serve`` = (batch size, service config), phase 6's T10I4D100K exact
    plan by default.  Returns (record, launches by path)."""
    import pickle
    import shutil
    import tempfile

    from repro_torch.core.runtime import itemset_digest
    from repro_torch.kernels.support_count import launches

    t_phase = time.perf_counter()
    name, batch, cfg = serve_plans()[0][:3] if serve is None else (
        "T10I4D100K", *serve)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump({name: (support, db) for name, support, db
                         in workloads}, f)
        phase4 = {(m["dataset"], m["path"], m["store"]): m for m in mines}

        def check(rec, what):
            name = rec["dataset"]
            got = {tuple(s): c for s, c in rec["itemsets"]}
            if got != bases[name]:
                raise AssertionError(f"phase 8 {what}: itemsets/supports "
                                     f"differ from phase 4's {name} mine")
            return itemset_digest(got)

        t10 = [("T10I4D100K", "packed_bitmap", [1, 1], False),
               ("T10I4D100K", "bitmap", [1, 0], False),
               ("BMS_WebView_2", "bitmap", [1, 1], True)]
        a, a_s = run_cluster(tmp, "nccl", 1, "nccl", [
            {"kind": "mine", "dataset": d, "store": s, "shape": sh,
             "ladder": lad} for d, s, sh, lad in t10] + [
            {"kind": "walls", "dataset": "BMS_WebView_2",
             "store": "packed_bitmap", "shape": [1, 1]},
            {"kind": "serve", "dataset": name, "store": "packed_bitmap",
             "measured": 4, "batch": batch, "cfg": cfg, "scale": scale}])
        b_progs = [("T10I4D100K", "packed_bitmap", [2, 0], False),
                   ("T10I4D100K", "packed_bitmap", [1, 2], False),
                   ("BMS_WebView_2", "packed_bitmap", [2, 0], True)]
        ckpt = os.path.join(tmp, "elastic_ckpt")
        b, b_s = run_cluster(tmp, "gloo", 2, "gloo", [
            {"kind": "mine", "dataset": d, "store": s, "shape": sh,
             "ladder": lad} for d, s, sh, lad in b_progs] + [
            {"kind": "elastic", "dataset": "BMS_WebView_2",
             "store": "packed_bitmap", "k": 4, "lost": 1}], ckpt=ckpt)
        by_path = {}
        out = {"nccl_s": a_s, "gloo_s": b_s, "runs": []}
        for rank_recs, tag in ((a, "nccl"), (b, "gloo")):
            for rec in [r for recs in rank_recs for r in recs]:
                counts = by_path.setdefault(f"sharded_{tag}",
                                            {k: 0 for k in launches})
                for k, v in rec.get("launches", {}).items():
                    counts[k] += v
                if "itemsets" in rec:
                    rec["digest"] = check(rec, f"{tag} {rec['kind']} "
                                          f"{rec.get('store')} "
                                          f"{rec.get('shape')}")
                    rec.pop("itemsets")
                out["runs"].append(dict(rec, cluster=tag))
        # (a): one rank's launches equal TorchRunner's in phase 4.
        for rec in a[0]:
            if rec["kind"] != "mine":
                continue
            path = "ladder" if rec["ladder"] else "spc"
            want = phase4[(rec["dataset"], path, rec["store"])]["launches"]
            if rec["launches"] != want:
                raise AssertionError(f"NCCL 1x1 {rec['store']} {path}: "
                                     f"launches {rec['launches']} != phase "
                                     f"4's {want}")
        # (b): both ranks agree; the 2x1 host loop counts half the rows.
        for r0, r1 in zip(b[0], b[1]):
            if r0["kind"] == "mine" and (r0["digest"], r0["launches"]) != (
                    r1["digest"], r1["launches"]):
                raise AssertionError(f"gloo ranks disagree: {r0} {r1}")
        # (d): rank 1 is the lost device, rank 0 finishes alone.
        lost, survivor = b[1][-1], b[0][-1]
        if not (lost.get("lost") and lost["k"] == 4
                and survivor["kind"] == "elastic" and "digest" in survivor
                and survivor["describe"] == "sharded/packed_bitmap"
                and lost["injected"] == survivor["injected"]
                == ["device_loss"]):
            raise AssertionError(f"elastic: {survivor} / {lost}")
        # (c): the supervisor relaunches one rank from the checkpoint.
        support = dict((n, s) for n, s, _ in workloads)["BMS_WebView_2"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "src")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.multihost",
             "--processes", "2", "--device", "cuda", "--backend", "gloo",
             "--dataset", "BMS_WebView_2", "--scale", str(scale),
             "--min-support", str(support), "--store", "packed_bitmap",
             "--max-k", "16", "--kill-k", "3", "--kill-process", "1",
             "--checkpoint-dir", os.path.join(tmp, "mh_ckpt"),
             "--timeout", "500"],
            env=env, capture_output=True, text=True, timeout=600)
        sup_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"supervisor failed:\n{proc.stderr[-4000:]}")
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith("MULTIHOST_OK "))
        summary = json.loads(line[len("MULTIHOST_OK "):])
        result = summary.pop("result")
        clean_jobs = sum(1 for lv in phase4[("BMS_WebView_2", "spc",
                                             "perfect_hash")]["levels"]
                         if lv[0] >= 2)
        digest = check(dict(result, dataset="BMS_WebView_2"), "supervisor")
        if not (summary["relaunches"] == 1 and summary["final_processes"] == 1
                and result["restored_step"] is not None
                and result["restored_step"] >= 2
                and result["counting_jobs"] == clean_jobs):
            raise AssertionError(f"supervisor: {summary} restored "
                                 f"{result['restored_step']} jobs "
                                 f"{result['counting_jobs']} != {clean_jobs}")
        out["supervisor"] = dict(summary, wall_s=sup_s, digest=digest,
                                 restored_step=result["restored_step"],
                                 counting_jobs=result["counting_jobs"])
        print(f"phase 8 supervisor: worker {summary['failures']} died, "
              f"relaunched {summary['final_processes']} process from step "
              f"{result['restored_step']}, {result['counting_jobs']} counting "
              f"jobs (clean {clean_jobs}), digest {digest} == phase 4, "
              f"{sup_s:.1f} s")
        for r in out["runs"]:
            print(f"phase 8 {r['cluster']} rank {r['rank']} {r['kind']} "
                  f"{r['dataset']} {r.get('store')} {r.get('shape')} "
                  f"ladder={r.get('ladder')}: digest {r.get('digest')}, "
                  f"launches {r.get('launches')}, wall "
                  f"{r.get('wall_s', 0):.3f} s, {r.get('collectives')} "
                  f"collectives {r.get('collective_ms', 0):.3f} ms "
                  f"({r.get('collective_ms_per_wave', 0):.3f} ms a wave)"
                  + (f", walls {r['walls']}" if "walls" in r else ""))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 8: {out['wall_s']:.1f} s")
    return out, by_path


# -- phase 9: the dense LM and token-set mining over its stream ----------------

class LogitLog:
    """While active, ANDs ``isfinite`` of every logit the model API returns
    (on the device, no sync) and counts the calls."""

    def __enter__(self):
        from repro_torch.models import model as M

        self._m, self._saved = M, (M.prefill, M.decode_step)
        self.calls, self.finite = 0, None
        M.prefill, M.decode_step = map(self._logged, self._saved)
        return self

    def _logged(self, fn):
        import torch

        def logged(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            ok = torch.isfinite(logits).all()
            self.finite = ok if self.finite is None else self.finite & ok
            self.calls += 1
            return logits, cache
        return logged

    def __exit__(self, *exc):
        self._m.prefill, self._m.decode_step = self._saved


def events_ms(fn) -> float:
    """Device-clock ms of one call of ``fn`` (which ends in a host fetch)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def lm_serve(name, cfg, batch, prompt_len, new_tokens, max_len, reps=5):
    """``ServeEngine.generate`` in bfloat16 on the card, greedy: every
    run's tokens must agree and every logit be finite.  Times are medians
    (with min and max) of ``reps`` runs each: the one-token ``generate``
    (prefill, the cache's allocation and the fetch to the host) and the
    full one; decode ms a token is the difference over the other tokens."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         M.abstract_params(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()  # serving's peak, not the init's
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    engine = ServeEngine(cfg, params, max_len=max_len, device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    engine.generate(prompts, 2)  # warm-up: library handles, allocator
    with LogitLog() as log:
        first = engine.generate(prompts, new_tokens)
        finite = bool(log.finite)
    outs = []
    fulls = sorted(events_ms(lambda: outs.append(
        engine.generate(prompts, new_tokens))) for _ in range(reps))
    ones = sorted(events_ms(lambda: engine.generate(prompts, 1))
                  for _ in range(reps))
    full_ms, prefill_ms = fulls[reps // 2], ones[reps // 2]
    peak = torch.cuda.max_memory_allocated()
    rec = {"arch": name, "n_layers": cfg.n_layers, "batch": batch,
           "prompt": prompt_len, "new_tokens": new_tokens, "max_len": max_len,
           "param_bytes": param_bytes, "init_s": init_s, "reps": reps,
           "one_token_generate_ms": prefill_ms, "one_token_generate_ms_all": ones,
           "generate_ms": full_ms, "generate_ms_all": fulls,
           "decode_ms_per_token": (full_ms - prefill_ms) / (new_tokens - 1),
           "tok_s": batch * new_tokens / (full_ms / 1e3),
           "peak_bytes": peak, "logit_calls": log.calls,
           "first_row": first[0, :8].tolist()}
    print(f"lm {name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}) bf16: {param_bytes / 1e9:.3f} GB of parameters "
          f"(init {init_s:.2f} s); batch {batch}, prompt {prompt_len}, "
          f"{new_tokens} new tokens, median of {reps} (min-max): one-token "
          f"generate {prefill_ms:.2f} ms ({ones[0]:.2f}-{ones[-1]:.2f}), full "
          f"generate {full_ms:.2f} ms ({fulls[0]:.2f}-{fulls[-1]:.2f}), decode "
          f"{rec['decode_ms_per_token']:.3f} ms a token, {rec['tok_s']:.1f} "
          f"tok/s, peak memory {peak / 1e9:.3f} GB; first row "
          f"{rec['first_row']}")
    if first.shape != (batch, new_tokens) or not all(
            np.array_equal(first, o) for o in outs):
        raise AssertionError(f"lm {name}: greedy runs differ")
    if not finite or log.calls != new_tokens:
        raise AssertionError(f"lm {name}: non-finite logits ({log.calls} "
                             "logit calls)")
    del engine, params
    return rec


def scale_attention(params, cfg):
    """Rescale every layer's attention weights in place to std
    1/sqrt(true fan-in): d_model for wq/wk/wv, n_heads * head_dim for wo.
    The reference's rule (``fan_in = shape[-2]``) gives wq std
    1/sqrt(n_heads), so the softmaxes are near one-hot and a deep random
    stack amplifies rounding; rescaled, it does not."""
    import math

    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factors = {"wq": math.sqrt(h / d), "wk": math.sqrt(kv / d),
               "wv": math.sqrt(kv / d), "wo": 1 / math.sqrt(h)}
    for lp in params["blocks"].values():
        for key, f in factors.items():
            lp["attn"][key].mul_(f)


def lm_consistency(name, cfg, batch, s, max_len, e2e_layers):
    """float32 (TF32 off) at full width, the reference's
    ``tests/test_archs.py`` check that prefill(S) + decode(token S) equals a
    full forward over S + 1 tokens:

    - every layer, teacher-forced: the layer's prefill over the forward's
      own input at positions [0, S), then its decode step at S, against its
      full-sequence output at S; relative max error < 1e-3;
    - the logits end to end through the first ``e2e_layers`` layers (the
      reference's reduced depth): < 1e-3;
    - the logits end to end through every layer: printed, not held.  With
      the reference's random init the stack is chaotic (the reference's own
      check exceeds 1e-3 at 16 layers of width 256 on the CPU:
      ``tests/test_torch_lm.py``), so summation-order differences grow
      with depth;
    - the logits end to end through every layer once the attention weights
      are rescaled to std 1/sqrt(true fan-in) (``scale_attention``): < 1e-3.
      That stack is not chaotic, so this holds the cache and position
      plumbing across the full depth."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the float32 check")
    t0 = time.perf_counter()
    params = materialize(torch.Generator(device=dev).manual_seed(1),
                         M.abstract_params(cfg), dtype_override=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, s + 1), dtype=np.int32)).to(dev)

    def rel(got, want):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"lm {name}: non-finite values")
        return float((got - want).abs().max() / want.abs().max())

    def end_to_end(c):
        cache = materialize(None, M.abstract_cache(c, batch, max_len),
                            dtype_override=torch.float32, device=dev)
        _, cache = M.prefill(params, {"tokens": toks[:, :s]}, c, cache)
        got, _ = M.decode_step(params, toks[:, s:], cache, s + 1, c)
        del cache
        x, _ = M.forward(params, {"tokens": toks}, c)
        return rel(got, M._logits(params, L.rmsnorm(params["final_norm"],
                                                    x[:, -1:]), c)[:, 0])

    with torch.inference_mode():
        x = M._embed_in(params, {"tokens": toks}, cfg)
        pos = torch.arange(s + 1, device=dev).expand(batch, s + 1)
        layer_rel = []
        for i, (t, c) in enumerate(B.layer_kinds(cfg)):
            lp = params["blocks"][str(i)]
            y, _ = B.layer_apply(lp, x, t, c, cfg, positions=pos)
            cache = materialize(None, B.cache_abstract(cfg, t, batch, max_len),
                                dtype_override=torch.float32, device=dev)
            _, cache = B.layer_prefill(lp, x[:, :s], t, c, cfg,
                                       positions=pos[:, :s], cache=cache)
            yd, _ = B.layer_decode(lp, x[:, s:], t, c, cfg, cache=cache,
                                   cache_len=s + 1, positions=pos[:, s:])
            layer_rel.append(rel(yd, y[:, s:]))
            x = y
        del x, y, cache
        e2e = end_to_end(dataclasses.replace(cfg, n_layers=e2e_layers))
        full = end_to_end(cfg) if e2e_layers < cfg.n_layers else e2e
        scale_attention(params, cfg)
        scaled = end_to_end(cfg)
    wall = time.perf_counter() - t0
    rec = {"layers_max_rel": max(layer_rel), "layer_rel": layer_rel,
           "e2e_layers": e2e_layers, "e2e_rel": e2e, "full_depth_rel": full,
           "scaled_full_depth_rel": scaled, "wall_s": wall}
    deep = (f"; through all {cfg.n_layers} layers {full:.3e} (not held: "
            "chaotic random stack)" if e2e_layers < cfg.n_layers else "")
    print(f"lm {name} f32: prefill({s}) + decode vs forward({s + 1}), batch "
          f"{batch}: every layer (teacher-forced) max relative error "
          f"{rec['layers_max_rel']:.3e}, logits through {e2e_layers} layers "
          f"{e2e:.3e}{deep}; through all {cfg.n_layers} layers with the "
          f"attention rescaled {scaled:.3e} (held < 1e-3: every layer, "
          f"{e2e_layers} layers, rescaled {cfg.n_layers}) in {wall:.2f} s")
    if not (rec["layers_max_rel"] < 1e-3 and e2e < 1e-3 and scaled < 1e-3):
        raise AssertionError(f"lm {name}: prefill + decode != forward {rec}")
    del params
    return rec


def token_miner_phase(support=0.01, steps=4, batch=256, seq_len=4096):
    """``TokenSetMiner`` on the card over qwen2-1.5b's vocabulary: every
    kernel store's mine equals the ``perfect_hash`` mine, and each kernel
    launches row blocks x candidate chunks of every level (SPC: one wave
    a level, its size the level's ``JobProfile.n_candidates``)."""
    from repro_torch.analytics import TokenSetMiner
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.support_count import (
        launches, pad_copies, reset_launches)

    pipe = SyntheticLM(151_936, batch=batch, seq_len=seq_len, seed=0)
    counts = {k: 0 for k in launches}
    recs, base = [], None
    for store in ("perfect_hash", "bitmap", "packed_bitmap"):
        miner = TokenSetMiner(min_support=support, store=store, window=32,
                              max_k=4, device="cuda")
        with WaveLog() as waves:
            reset_launches()
            t0 = time.perf_counter()
            res = miner.mine_steps(pipe, range(steps))
            wall = time.perf_counter() - t0
            got = dict(launches)
        if pad_copies["support_count"]:
            raise AssertionError(f"token miner {store}: pad copies")
        sizes = [p.n_candidates for p in res.levels[1:]]
        if waves.sizes != sizes:
            raise AssertionError(f"token miner {store}: waves {waves.sizes} "
                                 f"!= JobProfile candidates {sizes}")
        blocks = math.ceil(res.n_transactions / BLOCK_N)
        expected = blocks * sum(math.ceil(c / CAND_BLOCK) for c in sizes)
        want = {k: (expected if k == KERNEL_OF.get(store) else 0) for k in got}
        n_items = res.levels[0].n_frequent
        print(f"token miner {store}: N={res.n_transactions} F={n_items} "
              f"F_pad={(n_items // 128 + 1) * 128} min_count={res.min_count} "
              f"{len(res.itemsets)} itemsets (max k {res.max_k}), wall "
              f"{wall:.3f} s, launches {got} (expected {want})")
        for p in res.levels:
            print(f"  level k={p.k} candidates={p.n_candidates} "
                  f"frequent={p.n_frequent} seconds={p.seconds:.4f} "
                  f"gen={p.gen_seconds:.4f} encode={p.encode_seconds:.4f} "
                  f"count={p.count_seconds:.4f}")
        if got != want:
            raise AssertionError(f"token miner {store}: launches {got} != {want}")
        if base is None:
            base = res.itemsets
            if res.max_k < 3:
                raise AssertionError("token miner: fewer than 3 levels")
        elif res.itemsets != base:
            raise AssertionError(f"token miner {store}: itemsets/supports "
                                 "differ from the perfect_hash mine")
        for k in got:
            counts[k] += got[k]
        recs.append({"store": store, "wall_s": wall, "launches": got,
                     "n_transactions": res.n_transactions, "f": n_items,
                     "n_itemsets": len(res.itemsets),
                     "levels": [[p.k, p.n_candidates, p.n_frequent, p.seconds,
                                 p.gen_seconds, p.encode_seconds,
                                 p.count_seconds] for p in res.levels]})
    for k, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{k} never launched on the token_miner path")
    print(f"agree token miner: {len(base)} itemsets, identical supports "
          "through perfect_hash, bitmap and packed_bitmap")
    return recs, counts


def lm_phase():
    """Phase 9: (a) qwen2-1.5b at full width, (b) gemma2-2b at full width
    on 4 layers, (c) the token-set miner over the LM stream."""
    import dataclasses

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    qwen = get_config("qwen2-1.5b")
    gemma = dataclasses.replace(get_config("gemma2-2b"), n_layers=4)
    out = {"serve": [lm_serve("qwen2-1.5b", qwen, 4, 128, 32, 256)]}
    out["qwen_f32"] = lm_consistency("qwen2-1.5b", qwen, 4, 128, 256, 3)
    out["serve"].append(lm_serve("gemma2-2b", gemma, 1, 6144, 16, 6160))
    out["gemma_f32"] = lm_consistency("gemma2-2b", gemma, 1, 6144, 6160, 4)
    out["token_miner"], counts = token_miner_phase()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['wall_s']:.1f} s")
    return out, {"token_miner": counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--phase8-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)  # one rank of a phase-8 cluster
    args = ap.parse_args()
    if args.phase8_worker:
        return phase8_worker(args.phase8_worker)

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
    # Phase 7: the Hadoop model beside the card, faults and checkpoints.
    hadoop, hadoop_paths = hadoop_phase(workloads, bases, get_dataset)
    by_path.update(hadoop_paths)
    # Phase 8: the sharded runner over torch.distributed, every rank's
    # launches counted in its own process.
    sharded, sharded_paths = sharded_phase(workloads, bases, mines)
    by_path.update(sharded_paths)
    # Phase 9: the dense LM on the card and token-set mining over its
    # stream through both kernels.
    lm, lm_paths = lm_phase()
    by_path.update(lm_paths)
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
                       "hadoop": hadoop, "sharded": sharded, "lm": lm,
                       "device": device,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
