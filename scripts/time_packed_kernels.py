"""Times of the two support-count kernels at the shapes of the port's paths,
for one checkout of the repository or, in turns, for several on one card.

    python scripts/time_packed_kernels.py --roots OLD NEW [--share] [--out F]
    python scripts/time_packed_kernels.py --root DIR [--share]

With ``--roots`` the script runs itself once per checkout in the order
OLD, NEW, NEW, OLD (each in its own process, which builds that checkout's
kernels into its own ``build/``), so two versions of a kernel are compared
on one card within one call.  Each run prints one JSON line: the card's
name and power limit (``nvidia-smi``) and, for every shape, the packed
kernel's (kernel 1) and the bitmap kernel's (kernel 2) time a call (CUDA
events over back-to-back calls) and a launch (``torch.profiler``), and
whether kernel 1 equals its plain version there.  The shapes are those of
``chip_smoke.py`` phase 2 (a 2,048-row block against the host loop's
32,768-candidate C2 chunk at W 16; the ladder's whole C2, 127,264 rows;
serving at W 20 over 1, 1,077 and 2,048 rows) and, with ``--share``,
phase 13 (b)'s one-device production share (N 2^23, W 128, C 8,192),
timed by one call after a warm-up.  The inputs are random words and
k-hot candidates from a seed: neither kernel's time depends on the bits.
Needs a CUDA card; it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = [  # (name, n, w, c)
    ("main", 2048, 16, 32_768),
    ("ladder", 2048, 16, 127_264),
    ("serve_n1", 1, 20, 32_768),
    ("serve_tail", 1077, 20, 32_768),
    ("serve_n2048", 2048, 20, 32_768),
]
SHARE = ("share", 2 ** 23, 128, 8192)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def operands(n, w, c, k, gen):
    """Random packed rows (int32 words), C k-hot candidates over the first
    32 W - 1 items, packed, and their unpacked int8 k-hot rows and bitmap
    (kernel 2's operands for the same counts)."""
    import torch

    dev = torch.device("cuda")
    f = 32 * w
    words = torch.randint(-2 ** 31, 2 ** 31, (n, w), dtype=torch.int64,
                          device=dev, generator=gen).to(torch.int32)
    items = torch.rand((c, f - 1), device=dev, generator=gen).argsort(
        dim=1)[:, :k]
    khot = torch.zeros((c, f), dtype=torch.int8, device=dev)
    khot.scatter_(1, items, 1)
    weights = (1 << torch.arange(32, device=dev, dtype=torch.int64))
    cpacked = (khot.view(c, w, 32).to(torch.int64) * weights).sum(-1)
    cpacked = torch.where(cpacked > 0x7FFFFFFF, cpacked - (1 << 32),
                          cpacked).to(torch.int32)
    kvec = torch.full((c,), k, dtype=torch.int32, device=dev)
    return words, cpacked, kvec, khot


def unpack(words):
    """(n, 32 W) uint8 bitmap of int32 words, bit b of word j at 32 j + b."""
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    out = torch.empty((words.shape[0], 32 * words.shape[1]),
                      dtype=torch.uint8, device=words.device)
    for i in range(0, words.shape[0], 2 ** 16):  # bounded int32 temporaries
        part = words[i:i + 2 ** 16]
        out[i:i + 2 ** 16] = ((part[:, :, None] >> shifts) & 1).flatten(1)
    return out


def events_ms(fn, reps):
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel, reps):
    """Device time a launch of ``kernel`` from a torch.profiler trace, or
    None where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        at = ev.key.find(f"{kernel}_kernel")
        if at > 0 and not (ev.key[at - 1].isalpha() or ev.key[at - 1] == "_"):
            total += getattr(ev, "device_time_total", None) or \
                getattr(ev, "cuda_time_total", 0.0)
            count += ev.count
    return total / count / 1e3 if count and total else None


def run_root(root: str, share: bool) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels.support_count import (
        build, packed_support_count, packed_support_count_ref, support_count)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rec = {"root": root, "card": smi(), "shapes": {}}
    for name, n, w, c in SHAPES + ([SHARE] if share else []):
        words, cpacked, kvec, khot = operands(n, w, c, 3 if name == "share"
                                              else 2, gen)
        bitmap = unpack(words)
        k1 = lambda: packed_support_count(words, cpacked, kvec)  # noqa: E731
        k2 = lambda: support_count(bitmap, khot, kvec)  # noqa: E731
        got = k1()
        want = support_count(bitmap, khot, kvec)
        if name != "share":  # the plain version's (N, C) int64 sum fits here
            want = packed_support_count_ref(words, cpacked, kvec)
        reps = 1 if name == "share" else 20
        rec["shapes"][name] = {
            "n": n, "w": w, "c": c, "equal": bool(torch.equal(got, want)),
            "hits": int(want.sum()),
            "k1_ms": events_ms(k1, reps),
            "k1_device_ms": device_ms(k1, "packed_support_count", reps),
            "k2_ms": events_ms(k2, reps),
            "k2_device_ms": device_ms(k2, "support_count", reps)}
        del words, cpacked, kvec, khot, bitmap, got, want
        torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="time the kernels of this checkout")
    ap.add_argument("--roots", nargs=2, metavar=("OLD", "NEW"),
                    help="time both checkouts in turns: OLD NEW NEW OLD")
    ap.add_argument("--share", action="store_true",
                    help="also the one-device production share (4.3 GB of "
                         "words and a 34.4 GB bitmap)")
    ap.add_argument("--out", help="append every JSON line to this file")
    args = ap.parse_args()
    if args.root:
        line = json.dumps(run_root(os.path.abspath(args.root), args.share))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return 0
    if not args.roots:
        ap.error("give --root or --roots")
    old, new = (os.path.abspath(r) for r in args.roots)
    ok = True
    for root in (old, new, new, old):
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root]
        cmd += ["--share"] if args.share else []
        cmd += ["--out", args.out] if args.out else []
        ok &= subprocess.run(cmd).returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
