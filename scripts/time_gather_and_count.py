"""Times of the gather-AND-popcount kernel (``gather_and_count``, the
``perfect_hash`` store's count on the card) at a 2,048-row block and at
the main path's chunk shape, beside its byte bound and the plain gathers
it replaced, for one checkout or, in turns, for two on one card.  Over the
chunk it also times the count alone on words packed once, as the store
keeps them resident, and the pack alone.

    python scripts/time_gather_and_count.py [--root DIR] [--out F]
    python scripts/time_gather_and_count.py --roots OLD NEW [--out F]

With ``--roots`` the script runs itself once per checkout in the order
OLD, NEW, NEW, OLD, each in its own process, which builds and imports that
checkout's kernel (``--root``; by default this script's own).

For k = 2 and 3, at two shapes of 1,024 {0,1} byte columns (T10I4's
F_pad) against 32,768 random candidates (the host loop's ``cand_block``):
- ``k``: a 2,048-row block (the engine's ``block_n``);
- ``chunk``: 2^20 rows, the resident database of the benchmark's
  ``t10i4-c2-hash`` cell, which the engine hands the kernel in one call.
Neither path's time depends on the bits.  Prints one JSON line: the card's
name and power limit (``nvidia-smi``) and, for each shape and k, whether
the kernel equals the plain version (over the chunk: the gathers a block
at a time, summed), the kernel's time a call (CUDA events over
back-to-back wrapper calls) and a launch of each of its two kernels
(``torch.profiler``), the host's time to enqueue a call, and the bytes:
the rows, ids, counts and (over the chunk) the packed scratch a call
takes from device memory, priced at the data sheet's bandwidth
(``floor_ms``, a floor and not a bound: the column words come from L2,
whose bandwidth the data sheet does not state), and the column words,
beside what they would take at the rate ``copy_`` moves a 16 MB tensor
that stays in L2 (``l2_at_copy_rate_ms``, a rate PyTorch reaches, not the
card's peak).  At the block the plain version's time a call; over the
chunk the engine's earlier way to count it, a wrapper call on each of its
512 row blocks and the partial sums added (``block_loop_ms``).  Last, the
host's cost of the steps a wrapper takes to launch on a tensor's device
(``host_step_us``): ``torch.cuda.device`` entered and left on a
``torch.device`` and on its index, and the stream's handle through
``current_stream()`` and raw.  Needs a CUDA card; it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
N, F, C = 2048, 1024, 32_768
N_CHUNK = 2 ** 20
KERNELS = ("gather_and_count_pack", "gather_and_count_popc")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


def device_ms(fn, reps):
    """Device ms a launch of each of ``KERNELS`` from a torch.profiler
    trace (None where the trace holds none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in KERNELS:
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "device_time_total", None) or \
                    getattr(ev, "cuda_time_total", 0.0)
                count += ev.count
        out[name] = total / count / 1e3 if count and total else None
    return out


def l2_bytes_per_s() -> float:
    """Bytes a second read and written by ``copy_`` between two 16 MB int32
    tensors, both staying in the 50 MB L2 between calls."""
    import torch

    x = torch.ones((4 * 2 ** 20,), dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    ms = events_ms(lambda: y.copy_(x), 200)
    return 2 * x.numel() * 4 / (ms / 1e3)


def host_us(fn, reps=20_000):
    """Host microseconds a call of ``fn``, by ``time.perf_counter``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def host_steps(t) -> dict:
    """Host microseconds of each way to make ``t``'s device current and to
    read its current stream's handle."""
    import torch

    def enter(arg):
        def step():
            with torch.cuda.device(arg):
                pass
        return step

    dev = t.device
    return {
        "device_context_on_torch_device": host_us(enter(dev)),
        "device_context_on_index": host_us(enter(dev.index)),
        "current_stream_cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index))}


def chunk_shape(gen, l2_rate) -> dict:
    """For k 2 and 3, one call over ``N_CHUNK`` rows against the engine's
    earlier loop over its ``N``-row blocks, both on the same operands, and,
    where the checkout has them, the count alone on words packed once (the
    store's resident words) beside the pack alone."""
    import torch
    from repro_torch.kernels import support_count as sc
    from repro_torch.kernels.support_count import (
        gather_and_count, gather_and_count_ref)

    bitmap = (torch.rand((N_CHUNK, F), generator=gen, device="cuda")
              < 0.5).to(torch.uint8)
    split = hasattr(sc, "gather_and_count_bits")
    bits = sc.gather_and_count_pack(bitmap) if split else None
    out = {}
    for k in (2, 3):
        cand = torch.randint(0, F - 1, (C, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        blocks = [bitmap[i:i + N] for i in range(0, N_CHUNK, N)]

        def one_call():
            return gather_and_count(bitmap, cand)

        def block_loop(count=gather_and_count):
            total = count(blocks[0], cand)
            for block in blocks[1:]:
                total = total + count(block, cand)
            return total

        words = -(-N_CHUNK // 32)
        hbm = N_CHUNK * F + 2 * F * words * 4 + C * k * 4 + C * 4
        l2 = C * k * words * 4
        got = one_call()
        torch.cuda.synchronize()
        out[k] = {
            "equal": bool(torch.equal(
                got, block_loop(gather_and_count_ref))),
            "one_call_ms": events_ms(one_call, 20),
            "one_call_device_ms": device_ms(one_call, 10),
            "host_call_us": host_us(one_call, 50),
            "block_loop_ms": events_ms(block_loop, 3),
            "hbm_bytes": hbm, "l2_bytes": l2,
            "floor_ms": hbm / HBM_BYTES_PER_S * 1e3,
            "l2_at_copy_rate_ms": l2 / l2_rate * 1e3}
        if split:
            def count_only():
                return sc.gather_and_count_bits(bits, N_CHUNK, cand)

            def pack_only():
                return sc.gather_and_count_pack(bitmap)

            out[k].update({
                "count_equal": bool(torch.equal(count_only(), got)),
                "count_only_ms": events_ms(count_only, 20),
                "count_only_device_ms": device_ms(count_only, 10),
                "host_count_us": host_us(count_only, 50),
                "pack_only_ms": events_ms(pack_only, 20)})
        torch.cuda.synchronize()
        del got, blocks
    return out


def run_root(root: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.kernels.support_count import (
        build, gather_and_count, gather_and_count_ref)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(11)
    l2_rate = l2_bytes_per_s()
    rec = {"root": root, "card": smi(), "n": N, "n_chunk": N_CHUNK,
           "f_pad": F, "c": C, "l2_copy_tbs": l2_rate / 1e12, "k": {}}
    bitmap = (torch.rand((N, F), generator=gen, device="cuda") < 0.5).to(
        torch.uint8)
    for k in (2, 3):
        cand = torch.randint(0, F - 1, (C, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        kernel = lambda: gather_and_count(bitmap, cand)  # noqa: E731
        plain = lambda: gather_and_count_ref(bitmap, cand)  # noqa: E731
        words = -(-N // 32)
        hbm = N * F + C * k * 4 + C * 4  # rows, ids, counts
        l2 = C * k * words * 4 + F * words * 4  # column words read, scratch
        dev = device_ms(kernel, 50)
        torch.cuda.synchronize()
        enqueue_us = host_us(kernel, 2000)
        torch.cuda.synchronize()
        rec["k"][k] = {
            "equal": bool(torch.equal(kernel(), plain())),
            "kernel_ms": events_ms(kernel, 200),
            "device_ms": dev,
            "host_call_us": enqueue_us,
            "plain_ms": events_ms(plain, 20),
            "hbm_bytes": hbm, "l2_bytes": l2,
            "floor_ms": hbm / HBM_BYTES_PER_S * 1e3,
            "l2_at_copy_rate_ms": l2 / l2_rate * 1e3}
    rec["host_step_us"] = host_steps(bitmap)
    del bitmap
    torch.cuda.empty_cache()
    rec["chunk"] = chunk_shape(gen, l2_rate)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="time the kernel of this checkout "
                                   "(default: this script's)")
    ap.add_argument("--roots", nargs=2, metavar=("OLD", "NEW"),
                    help="time both checkouts in turns: OLD NEW NEW OLD")
    ap.add_argument("--out", help="append every JSON line to this file")
    args = ap.parse_args()
    if args.roots:
        ok = True
        for root in (*args.roots, *reversed(args.roots)):
            cmd = [sys.executable, os.path.abspath(__file__), "--root",
                   os.path.abspath(root)]
            cmd += ["--out", args.out] if args.out else []
            ok &= subprocess.run(cmd).returncode == 0
        return 0 if ok else 1
    rec = run_root(os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    shapes = [*rec["k"].values(), *rec["chunk"].values()]
    return 0 if all(v["equal"] and v.get("count_equal", True)
                    for v in shapes) else 1


if __name__ == "__main__":
    sys.exit(main())
