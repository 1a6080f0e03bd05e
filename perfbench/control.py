"""The control of a cell's correctness check, which has to come out as not
correct.

The configurations state every support exact.  The control breaks that
guarantee the way a tempting shortcut would: the plain reference put in
the program's place, with its products and sums kept in bfloat16 (the
precision below its float32), as a count run through a bfloat16 product
would keep them.  For each seed it prints one JSON line with the numbers
the cell's check compares (``kinds/count_job.compare``) and whether they
pass:

    python3 perfbench/control.py --workload NAME --seeds 1 2 3

It makes each seed's baskets as a run of the cell does, at the cell's
size, on the card (``--device cpu`` for a small configuration).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, seed: int, device: str,
             dtype=torch.bfloat16) -> dict:
    """The check's numbers for the control on one seed."""
    from perfbench import generator, harness, reference

    _, _, cfg, traffic, kind = harness.resolve(root, workload)
    b = generator.from_config(cfg, seed, torch.device(device))
    args = (b.items, b.offsets, b.n_items, traffic["min_support"],
            int(traffic["k"]))
    exact = reference.answer(*args, device=device)
    low = reference.answer(*args, device=device, dtype=dtype)
    job = low.levels[-1]
    checks = kind.compare(low.hist, low.item_map, job.cand, [job.supports],
                          exact)
    return {"workload": workload, "seed": seed, "dtype": str(dtype),
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {n: v for n, (v, _) in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no run: CUDA is not available", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t = time.perf_counter()
        line = readings(ROOT, args.workload, seed, args.device)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
