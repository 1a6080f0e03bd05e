"""Quickstart on the PyTorch port: mine frequent itemsets with every engine.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The paper's three candidate structures run through ``run_mapreduce_apriori``
(the Hadoop cluster model, 4 mappers on host CPUs), and every array-layout
store through ``FrequentItemsetMiner`` on the card (``--device cpu`` for a
machine without one); all of them must agree, itemsets and supports.
"""

import argparse

from repro_torch.core import (
    FrequentItemsetMiner,
    TorchRunner,
    run_mapreduce_apriori,
)
from repro_torch.core.stores import ARRAY_STORES
from repro_torch.data import quest_from_name


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    # Quest-code workload: T8I4D2K = avg basket 8, avg pattern 4, 2000
    # transactions; the narrow 120-item vocabulary keeps pair supports high
    # enough that the demo mines multi-item itemsets.
    db = quest_from_name("T8I4D2K", seed=7, n_items=120)
    min_support = 0.015
    print(f"database: T8I4D2K = {len(db)} transactions, "
          f"{len({i for t in db for i in t})} items, min_support={min_support}")

    # 1. The paper's implementation: MapReduce Apriori with the three
    #    candidate structures (Java-equivalent, 4 logical mappers).
    print("\n-- paper track (hadoop_sim, 4 mappers) --")
    reference = None
    for structure in ["hash_tree", "trie", "hash_table_trie"]:
        res = run_mapreduce_apriori(db, min_support, structure=structure,
                                    n_mappers=4)
        if reference is None:
            reference = res.itemsets
        assert res.itemsets == reference, structure
        print(f"{structure:16s}: {len(res.itemsets):4d} frequent itemsets, "
              f"parallel time {res.parallel_seconds * 1e3:7.1f} ms")

    # 2. The device track: the same driver over a TorchRunner per
    #    array-layout store (device-side Job1, double-buffered waves).
    print(f"\n-- PyTorch track on {args.device} (array-layout stores) --")
    for store in ARRAY_STORES:
        runner = TorchRunner(store=store, inflight=1, device=args.device)
        res = FrequentItemsetMiner(min_support=min_support,
                                   runner=runner).mine(db)
        assert res.itemsets == reference, store
        total_s = sum(lv.seconds for lv in res.levels)
        print(f"{store:16s}: {len(res.itemsets):4d} frequent itemsets, "
              f"{total_s * 1e3:7.1f} ms over {len(res.levels)} jobs")

    top = sorted(reference.items(), key=lambda kv: (-len(kv[0]), -kv[1]))[:5]
    print("\nlargest frequent itemsets:")
    for s, c in top:
        print(f"  {list(s)} support={c / len(db):.3f}")


if __name__ == "__main__":
    main()
