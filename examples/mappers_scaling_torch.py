"""Reproduce the paper's Table 2 / Fig 5 on the PyTorch port: speedup vs
number of mappers, for the three candidate structures.

  PYTHONPATH=src python examples/mappers_scaling_torch.py [--scale 0.1]

The Hadoop cluster model (``run_mapreduce_apriori``: every mapper rebuilds
its structure and counts its split on a host CPU) times each job as the
slowest mapper plus the reduce.  Every cell must find the same itemsets
with the same supports; the run fails if one differs.
"""

import argparse

from repro_torch.core import run_mapreduce_apriori
from repro_torch.data import quest_generator

STRUCTURES = ("hash_tree", "trie", "hash_table_trie")
MAPPERS = (1, 2, 5, 10, 20)


def scaling_runs(db, min_support, mappers=MAPPERS):
    """{(structure, mappers): HadoopSimResult} over every cell; raises
    unless every cell's itemsets and supports equal the first's."""
    runs = {}
    for m in mappers:
        for structure in STRUCTURES:
            runs[structure, m] = run_mapreduce_apriori(
                db, min_support, structure=structure, n_mappers=m)
    first = next(iter(runs.values())).itemsets
    for key, res in runs.items():
        if res.itemsets != first:
            raise AssertionError(f"{key} found other itemsets or supports")
    return runs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--min-support", type=float, default=0.02)
    args = ap.parse_args()

    db = quest_generator(n_transactions=int(100_000 * args.scale),
                         avg_transaction_len=10, n_items=1000, seed=42)
    print(f"{len(db)} transactions, min_support={args.min_support}\n")
    runs = scaling_runs(db, args.min_support)
    print(f"{'mappers':>8} | " + " | ".join(f"{s:>16}" for s in STRUCTURES))
    for m in MAPPERS:
        cells = []
        for structure in STRUCTURES:
            t = runs[structure, m].parallel_seconds
            base = runs[structure, MAPPERS[0]].parallel_seconds
            cells.append(f"{t:7.2f}s x{base / t:4.1f}")
        print(f"{m:>8} | " + " | ".join(f"{c:>16}" for c in cells))
    print(f"\n{len(next(iter(runs.values())).itemsets)} frequent itemsets, "
          "equal in every cell")
    print("(speedup saturates: every mapper re-runs apriori-gen + build, "
          "the fixed cost the paper identifies)")


if __name__ == "__main__":
    main()
