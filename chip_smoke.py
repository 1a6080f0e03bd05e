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
   T10I4D100K and at ragged shapes (C larger than a tile, mixed k with pad
   rows, a W >= 128 vocabulary); kernel, plain and library times beside the
   least time the card could take;
3. a small mine on the card, every store, against brute-force counting;
4. the main path: ``FrequentItemsetMiner.mine`` on T10I4D100K (scale 1.0,
   min_support 0.01) and the BMS_WebView_2 twin (scale 1.0, min_support
   0.002), each with ``packed_bitmap`` and ``bitmap`` on their kernels and
   with ``perfect_hash``; itemsets AND supports must agree across the three
   stores, and every kernel's launch count must equal the main path's
   blocks x chunks.

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
INT8_TENSOR_OPS = 1.979e15   # H100 SXM dense int8 tensor-core rate
POPC_PER_CLK_PER_SM = 16     # 32-bit popcount issue rate, compute capability 9.0
BLOCK_N, CAND_BLOCK = 2048, 32_768  # the miner's default row block / chunk


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


def kernel_phase(enc, rng, sm_rate):
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
    # The main path's first C2 chunk against its first row block.
    c2 = apriori_gen_matrix(np.arange(enc.n_items, dtype=np.int32)[:, None])
    cand = torch.from_numpy(pad_candidates(c2[:CAND_BLOCK], enc.f_pad)).to(dev)
    packed = torch.from_numpy(enc.packed[:BLOCK_N]).to(dev)
    bitmap = torch.from_numpy(enc.bitmap[:BLOCK_N]).to(dev)
    saved = PackedBitmapStore.use_kernel, BitmapMXUStore.use_kernel
    PackedBitmapStore.use_kernel = BitmapMXUStore.use_kernel = True
    try:
        pc = PackedBitmapStore.encode_candidates(cand, f_pad=enc.f_pad)
        bc = BitmapMXUStore.encode_candidates(cand, f_pad=enc.f_pad)
    finally:
        PackedBitmapStore.use_kernel, BitmapMXUStore.use_kernel = saved

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
         "ragged": [packed_case(513, 9, 300, [5], 0),
                    packed_case(64, 16, 1024, [4], 0),
                    packed_case(100, 5, 70, [2, 3, 4], 7),
                    packed_case(256, 160, 300, [1, 2, 3, 6], 11)]},
        {"name": "support_count", "kernel": support_count,
         "plain": support_count_ref,
         "source": "src/repro_torch/kernels/support_count/csrc/support_count.cu",
         "replaces": "src/repro/kernels/support_count/kernel.py:51",
         "main": (bitmap, bc["khot"], bc["kvec"]),
         "ragged": [bitmap_case(513, 257, 300, [5], 0),
                    bitmap_case(100, 130, 70, [2], 0),
                    bitmap_case(64, 512, 1024, [4], 0),
                    bitmap_case(128, 64, 30, [2, 3, 4], 5),
                    bitmap_case(300, 4096, 200, [1, 2, 3, 6], 9)]},
    ]
    rows = []
    for spec in specs:
        err = 0
        for args in [spec["main"], *spec["ragged"]]:
            got = spec["kernel"](*args)
            torch.cuda.synchronize()
            want = spec["plain"](*args)
            case_err = int((got.long() - want.long()).abs().max())
            err = max(err, case_err)
            print(f"compare {spec['name']} {[tuple(a.shape) for a in args]}: "
                  f"max_abs_err {case_err}, hits {int(want.sum())}")
        if err:
            raise AssertionError(f"{spec['name']} disagrees with its plain "
                                 f"version (max_abs_err {err})")
        a, b, kv = spec["main"]
        n, c, width = a.shape[0], b.shape[0], a.shape[1]
        ms = cuda_ms(lambda: spec["kernel"](a, b, kv), reps=20)
        plain_ms = cuda_ms(lambda: spec["plain"](a, b, kv), reps=3, warmup=1)
        io_bytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
                    + 2 * c * 4)
        if spec["name"] == "packed_support_count":
            ops_s = n * c * width / sm_rate
            library_ms = None
        else:
            ops_s = 2 * n * c * width / INT8_TENSOR_OPS
            a16, b16t = a.to(torch.bfloat16), b.to(torch.bfloat16).T
            library_ms = cuda_ms(lambda: torch.matmul(a16, b16t), reps=20)
        bytes_s = io_bytes / HBM_BYTES_PER_S
        rows.append({
            "name": spec["name"], "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": library_ms,
            "shape": {"n": n, "c": c, "width": width},
        })
        print(f"time {spec['name']} n={n} c={c} width={width}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
              f"({rows[-1]['bound_by']}), library "
              + ("none" if library_ms is None else
                 f"{library_ms:.4f} ms (bf16 torch.matmul only, no compare/sum)"))
    return rows


def mine(db, min_support, store, use_kernel):
    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.stores import ARRAY_STORES

    cls = ARRAY_STORES[store]
    saved = getattr(cls, "use_kernel", None)
    if saved is not None:
        cls.use_kernel = use_kernel
    try:
        t0 = time.perf_counter()
        res = FrequentItemsetMiner(min_support=min_support, store=store,
                                   device="cuda").mine(db)
        return res, time.perf_counter() - t0
    finally:
        if saved is not None:
            cls.use_kernel = saved


def small_check(get_dataset, brute_force_frequent):
    """A small mine through every store on the card vs brute force."""
    db = get_dataset("T10I4D100K", scale=0.002, seed=0)
    want = brute_force_frequent(db, math.ceil(0.02 * len(db)))
    for store, uk in (("packed_bitmap", True), ("bitmap", True),
                      ("packed_bitmap", False), ("bitmap", False),
                      ("perfect_hash", False)):
        res, _ = mine(db, 0.02, store, uk)
        if res.itemsets != want:
            raise AssertionError(f"{store} (kernel={uk}) disagrees with brute "
                                 "force on T10I4D100K scale 0.002")
    print(f"small check: T10I4D100K scale 0.002 min_support 0.02, "
          f"{len(want)} itemsets, every store == brute force")


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
    from repro_torch.kernels.support_count import build, launches, reset_launches

    t_start = time.perf_counter()
    card = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    sm_rate = POPC_PER_CLK_PER_SM * props.multi_processor_count * max_sm_mhz * 1e6
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
            if "registers" in line or "spill" in line:
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
    rows = kernel_phase(enc, np.random.default_rng(0), sm_rate)

    # Phase 3: a small mine against brute force.
    small_check(get_dataset, brute_force_frequent)

    # Phase 4: the main path, counts read just after it.
    mines = []
    total = {name: 0 for name in launches}
    for name, support, db in workloads:
        results = {}
        for store, uk in (("packed_bitmap", True), ("bitmap", True),
                          ("perfect_hash", False)):
            reset_launches()
            res, wall = mine(db, support, store, uk)
            got = dict(launches)
            for k in total:
                total[k] += got[k]
            n = res.n_transactions
            blocks = math.ceil(n / min(BLOCK_N, n))
            chunks = sum(math.ceil(p.n_candidates / CAND_BLOCK)
                         for p in res.levels[1:])
            kname = {"packed_bitmap": "packed_support_count",
                     "bitmap": "support_count"}.get(store)
            want = {k: (blocks * chunks if k == kname else 0) for k in got}
            print(f"mine {name} min_support={support} store={store} "
                  f"kernel={uk}: {len(res.itemsets)} itemsets, wall "
                  f"{wall:.3f} s, launches {got} (expected {want})")
            for p in res.levels:
                print(f"  level k={p.k} candidates={p.n_candidates} "
                      f"frequent={p.n_frequent} seconds={p.seconds:.4f} "
                      f"gen={p.gen_seconds:.4f} encode={p.encode_seconds:.4f} "
                      f"count={p.count_seconds:.4f} inflight={p.inflight_depth}")
            if got != want:
                raise AssertionError(f"{store}: launches {got} != {want}")
            results[store] = res
            mines.append({"dataset": name, "min_support": support,
                          "store": store, "kernel": uk, "wall_s": wall,
                          "n_itemsets": len(res.itemsets), "launches": got,
                          "levels": [[p.k, p.n_candidates, p.n_frequent,
                                      p.seconds, p.gen_seconds,
                                      p.encode_seconds, p.count_seconds]
                                     for p in res.levels]})
        ref = results["perfect_hash"].itemsets
        for store, res in results.items():
            if res.itemsets != ref:
                raise AssertionError(f"{name}: {store} itemsets/supports "
                                     "differ from perfect_hash")
        if not ref:
            raise AssertionError(f"{name}: no frequent itemsets")
        print(f"agree {name}: {len(ref)} itemsets, max k "
              f"{max(len(s) for s in ref)}, identical supports across stores")
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
        row["launches"] = total[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the main path")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": build_s, "kernels": rows,
                       "mines": mines, "host": host, "device": device,
                       "wall_s": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
