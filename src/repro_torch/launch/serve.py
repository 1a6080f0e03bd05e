"""Mining-service launcher: stream a dataset through the ``MiningService``.

  python -m repro_torch.launch.serve --dataset T10I4D100K --support 0.01 \\
      --scale 0.02 --batches 20 --query-every 4

Replays the dataset as a seeded basket stream (``repro_torch.data.stream``),
ingests each arrival batch into the slot-based sliding window, and serves
frequent-itemset queries every ``--query-every`` batches, reporting ingest
throughput, query latency, and how many queries were served from the
delta-maintained state without a refresh.  The flags, per-query lines and
summary are those of the JAX package's ``repro.launch.serve``; ``--device``
(default ``cuda``) picks where the service counts.  ``--mesh`` serves
through ``ShardedRunner`` on the data mesh over every ``torch.distributed``
rank (a one-rank group when the process has none), on the ``perfect_hash``
store as in the reference.

The LM path (batched generation with the ``ServeEngine``) is kept behind
``--lm`` and, as in the reference, gated on ``REPRO_LM=1``:

  REPRO_LM=1 python -m repro_torch.launch.serve --lm --arch qwen2-1.5b

On the card it serves the architecture's full config; with ``--device
cpu`` its reduced one.  Any of the ten architectures but the encoder-only
hubert-xlarge; a vision config gets zero patch embeddings, as in the
reference:

  REPRO_LM=1 python -m repro_torch.launch.serve --lm --arch mamba2-2.7b
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np


def _lm_main(argv) -> None:
    if os.environ.get("REPRO_LM") != "1":
        print("the LM serving path is out of scope for the mining repro; "
              "set REPRO_LM=1 to run it anyway")
        sys.exit(0)

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.runtime.engine import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models.params import materialize
    from repro_torch.serve import ServeEngine

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve --lm")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the full config) or cpu (the reduced one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if dev.type == "cuda" else get_reduced(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")

    gen = torch.Generator(device=dev).manual_seed(0)
    params = materialize(gen, M.abstract_params(cfg))
    engine = ServeEngine(cfg, params, max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)

    vis = None
    if cfg.frontend == "vision_patches":
        vis = torch.zeros((args.batch, cfg.n_vis_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device=dev)

    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          temperature=args.temperature, rng=gen,
                          vis_embeds=vis)
    dt = time.time() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * out.shape[1] / dt:.1f} tok/s)")
    print("first row:", out[0, :16].tolist())


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--lm" in argv:
        _lm_main([a for a in argv if a != "--lm"])
        return

    from repro_torch.data.stream import basket_stream
    from repro_torch.serve import MiningService

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--dataset", default="T10I4D100K")
    ap.add_argument("--support", type=float, default=0.01)
    ap.add_argument("--store", default="perfect_hash")
    ap.add_argument("--mesh", action="store_true",
                    help="sharded backend on the data mesh of every rank")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--query-every", type=int, default=4)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--slot-size", type=int, default=256)
    ap.add_argument("--staleness", type=float, default=0.5)
    ap.add_argument("--eviction", choices=["slot", "basket"], default="slot",
                    help="window semantics: whole-slot or per-basket evict")
    ap.add_argument("--query-staleness", type=float, default=None,
                    help="serve approximate answers within this per-query "
                    "staleness budget (certified; never blocks on a refresh)")
    ap.add_argument("--compact-churn", type=float, default=4.0,
                    help="compact the tracked lattice every N windows of "
                    "drained delta volume (0 disables)")
    ap.add_argument("--max-k", type=int, default=8)
    ap.add_argument("--device-loop", action="store_true",
                    help="refresh through the fused LevelLadder")
    ap.add_argument("--no-trim", action="store_true")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the service counts (cuda or cpu)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_data_mesh

        mesh = make_data_mesh(device=args.device)

    svc = MiningService(
        min_support=args.support, store=None if mesh else args.store,
        mesh=mesh, n_slots=args.n_slots,
        slot_size=args.slot_size, staleness=args.staleness,
        max_k=args.max_k, device_loop=args.device_loop,
        trim=not args.no_trim, eviction=args.eviction,
        compact_churn=args.compact_churn, device=args.device)
    print(f"mining service: {svc.runner.describe()} | "
          f"window {args.n_slots}x{args.slot_size} ({args.eviction}-evicted)"
          f" | support {args.support} | staleness {args.staleness}")

    ingest_s = 0.0
    ingested = 0
    q_lat = []
    delta_served = 0
    n_queries = 0
    stream = basket_stream(args.dataset, batch_size=args.batch_size,
                           scale=args.scale, seed=args.seed, repeat=True,
                           max_batches=args.batches)
    for ab in stream:
        rep = svc.ingest(ab.transactions)
        ingest_s += rep.seconds
        ingested += rep.n_ingested
        if (ab.seq + 1) % args.query_every == 0:
            res = svc.query(staleness=args.query_staleness)
            n_queries += 1
            q_lat.append(res.seconds)
            delta_served += 0 if res.refreshed else 1
            if res.refreshed:
                mode = res.stale_reason or "refresh"
            elif res.stale_reason == "stale":
                mode = "stale"
            else:
                mode = "delta"
            cert = ""
            if res.certificate is not None and not \
                    res.certificate.is_exact(res.min_count):
                cert = (f" | drift<={res.certificate.max_drift}"
                        f" miss<{res.certificate.miss_bound}")
            print(f"  batch {ab.seq + 1:4d} | window {res.n_transactions:6d}"
                  f" | {len(res.itemsets):5d} frequent | {mode:9s}"
                  f" | {res.seconds * 1e3:8.1f} ms{cert}")
    st = svc.stats()
    svc.close()
    lat = np.array(q_lat) if q_lat else np.zeros((1,))
    print(f"ingested {ingested} baskets in {ingest_s:.2f}s "
          f"({ingested / max(ingest_s, 1e-9):,.0f} txn/s); "
          f"{delta_served}/{n_queries} queries delta-served "
          f"({st['stale_served']} certified-stale); "
          f"query p50 {np.percentile(lat, 50) * 1e3:.1f} ms "
          f"p95 {np.percentile(lat, 95) * 1e3:.1f} ms; "
          f"{st['refreshes']} refreshes, {st['delta_jobs']} delta jobs, "
          f"{st['compactions']} compactions")


if __name__ == "__main__":
    main()
