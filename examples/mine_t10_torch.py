"""End-to-end driver on the PyTorch port: mine a registry dataset with
per-level checkpoints and restart.

  PYTHONPATH=src python examples/mine_t10_torch.py [--scale 0.25] \\
      [--min-support 0.02] [--store bitmap] [--ckpt-dir DIR] [--device cuda]

The miner checkpoints after every level job into ``--ckpt-dir`` (by default
a directory under the system's temporary directory).  Kill it mid-run and
re-run it with the same arguments to watch it resume at the last completed
level; a run over a finished directory restores every level and prints the
same per-level lines.
"""

import argparse
import os
import tempfile
import time

from repro_torch.core import FrequentItemsetMiner
from repro_torch.core.stores import ARRAY_STORES
from repro_torch.data import get_dataset


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="T10I4D100K",
                    help="registry dataset name or Quest code")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--min-support", type=float, default=0.02)
    ap.add_argument("--store", default="bitmap", choices=list(ARRAY_STORES))
    ap.add_argument("--inflight", type=int, default=1,
                    help="async wave-dispatch depth (0 = fully synchronous)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_mine_t10"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    print(f"generating {args.dataset} @ scale {args.scale} ...")
    db = get_dataset(args.dataset, scale=args.scale, seed=42)
    print(f"{len(db)} transactions")

    miner = FrequentItemsetMiner(
        min_support=args.min_support, store=args.store,
        inflight=args.inflight, checkpoint_dir=args.ckpt_dir,
        device=args.device,
    )
    t0 = time.time()
    res = miner.mine(db)
    dt = time.time() - t0
    print(f"\nmined in {dt:.1f}s with store={args.store} on {args.device} "
          f"(min_count={res.min_count})")
    for lv in res.levels:
        print(f"  level k={lv.k}: {lv.n_candidates:6d} candidates -> "
              f"{lv.n_frequent:6d} frequent  ({lv.seconds:.2f}s)")
    print(f"total frequent itemsets: {len(res.itemsets)} (max k={res.max_k})")
    print(f"checkpoints in {args.ckpt_dir} — kill and re-run to test restart")


if __name__ == "__main__":
    main()
