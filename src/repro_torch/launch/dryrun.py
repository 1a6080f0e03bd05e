"""Multi-pod dry run: every (arch x shape) cell measured on the production
meshes, with per-device memory, flops, bytes and collective bytes
(PyTorch port of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's analyses.  The port runs the step itself, on a ``fake``
process group of 256 (or 512) ranks in one process and under
``FakeTensorMode``: every tensor is one rank's shard with a shape and no
memory, and every collective returns at once.  ``launch/hlo_stats.py``'s
``StepCounter`` counts what that rank computes, moves and holds.  This
module sets no environment variable.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --apriori
  python -m repro_torch.launch.dryrun --all --out chiprun_out/dryrun_torch.jsonl
      (one subprocess per cell: the fake group is process-wide)

Entry points take ``device`` (``--device``), the device type of the fake
tensors and of the mesh: ``cuda`` by default, which needs a card;
``cpu`` measures the same step on the CPU's kernels' decompositions.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

DEFAULT_OUT = os.path.join("chiprun_out", "dryrun_torch.jsonl")


def _fake_world(size: int, device) -> None:
    """A ``fake`` process group of at least ``size`` ranks, this process
    rank 0 (made once; a group of another backend raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.runtime.engine import resolve_device

    resolve_device(device)  # a CUDA device without a card raises
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < size:
            raise RuntimeError(
                f"the dry run needs a fake process group of {size} ranks; "
                f"this process has a {dist.get_backend()} group of "
                f"{dist.get_world_size()}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(multi_pod: bool, device="cuda"):
    """``make_production_mesh`` on a fake group of 512 ranks (both
    meshes fit it, so the apriori cells of both pods run in one process)."""
    from repro_torch.launch.mesh import make_production_mesh

    _fake_world(512, device)
    return make_production_mesh(multi_pod=multi_pod, device=device)


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _leaves(tree):
    from repro_torch.launch.hlo_stats import _tensors

    return [_local(t) for t in _tensors(tree)]


def _fake_args(args, mesh, device):
    """The step's arguments as fake tensors: a ``ShapeStruct`` becomes a
    DTensor of its shard on ``mesh``, a meta tensor a tensor on
    ``device``; anything else (a scalar) as it is."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import ShapeStruct, placements

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, ShapeStruct):
            local = torch.empty(x.local.shape, dtype=x.dtype, device=device)
            return DTensor.from_local(
                local, mesh, placements(x.pspec, mesh), run_check=False,
                shape=x.shape, stride=x.global_.stride())
        if isinstance(x, torch.Tensor) and x.device.type == "meta":
            return torch.empty(x.shape, dtype=x.dtype, device=device)
        return x

    return tuple(one(a) for a in args)


def _measure(fn, args, donate, mesh, device=None):
    """Runs ``fn`` once on fake stand-ins of ``args`` inside a
    ``StepCounter`` (the counterpart of the reference's ``_lower_compile``)
    and returns {"memory", "flops", "bytes", "coll"}.

    ``argument_bytes`` is exact: the bytes of every argument's shard on
    this rank.  ``alias_bytes`` are the outputs' bytes that live in a
    donated argument (the step wrote it in place), ``peak_device_bytes``
    the most local bytes live during the step, and ``temp_bytes`` what the
    peak holds beyond the arguments and the new outputs."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_stats import (
        StepCounter, _storage_key, collective_bytes)

    if mesh is not None:
        device = mesh.device_type
    device = device or "cuda"
    # 0-d scalars (a cache length, a step) as their numbers
    args = tuple(a.item() if isinstance(a, torch.Tensor) and a.ndim == 0
                 and a.device.type != "meta" else a for a in args)
    with FakeTensorMode():
        fargs = _fake_args(args, mesh, device)
        counter = StepCounter()
        arg_bytes = counter.track(_leaves(fargs))
        donated = {_storage_key(t) for i in donate for t in _leaves(fargs[i])}
        with counter:
            out = fn(*fargs)
        outs, seen = {}, set()
        for t in _leaves(out):
            key = _storage_key(t)
            if key not in seen:
                seen.add(key)
                outs[key] = t.untyped_storage().nbytes()
        out_bytes = sum(outs.values())
        alias = sum(n for k, n in outs.items() if k in donated)
        peak = counter.peak
        del out, fargs
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "alias_bytes": alias,
        "temp_bytes": max(0, peak - (arg_bytes + out_bytes - alias)),
        "peak_device_bytes": peak,
    }
    return {"memory": memory, "flops": float(counter.flops),
            "bytes": float(counter.bytes),
            "coll": collective_bytes(counter.records)}


def _probe_costs(cfg, shape, mesh, rules, sh, device=None):
    """Per-device costs from two shallow probes, as the reference fits
    them: the stack at 1 and 2 pattern periods, its layers unrolled and
    attention in ``probe_chunk`` tiles, cost = fixed + per_period x
    n_super (exact for homogeneous stacks).  The port counts every layer
    it runs (eager has no loop counted once), so the fit is what keeps a
    cell cheap; ``raw_loopcounted`` holds the full depth's count."""
    from repro_torch.launch.steps import make_step
    from repro_torch.models.transformer import plan

    pl = plan(cfg)
    base = len(pl.head) + (cfg.n_layers
                           - len(pl.head) - pl.n_super * max(1, len(pl.pattern)))
    p = max(1, len(pl.pattern))
    probe_chunk = max(1024, sh.seq_len // 8 if sh.kind != "decode" else 1024)

    # SSD probes: at most 16 chunks a sequence, as the reference caps them.
    ssm = cfg.ssm
    if ssm is not None and sh.kind != "decode" and sh.seq_len // ssm.chunk > 16:
        ssm = dataclasses.replace(ssm, chunk=sh.seq_len // 16)

    results = []
    for k in (1, 2):
        pcfg = dataclasses.replace(
            cfg, n_layers=base + k * p, scan_layers=False, unroll_loops=True,
            attn_chunk=probe_chunk, ssm=ssm,
        )
        m = _measure(*make_step(pcfg, shape, mesh, rules), mesh, device)
        results.append(m)
    c1, c2 = results
    n_super = pl.n_super if pl.n_super else (cfg.n_layers - base) // p

    def extrapolate(v1, v2):
        slope = max(0.0, v2 - v1)
        fixed = max(0.0, v1 - slope)
        return fixed + slope * n_super

    kinds = set(c1["coll"]) | set(c2["coll"])
    coll = {k: extrapolate(float(c1["coll"].get(k, 0)),
                           float(c2["coll"].get(k, 0))) for k in kinds}
    return {
        "flops": extrapolate(c1["flops"], c2["flops"]),
        "bytes": extrapolate(c1["bytes"], c2["bytes"]),
        "coll": coll,
        "probe_chunk": probe_chunk,
    }


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: dict | None = None, device="cuda"):
    from repro_torch.configs import get_config, shape_applicable
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.hlo_stats import roofline_terms
    from repro_torch.launch.steps import make_step

    ok, why = shape_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = production_mesh(multi_pod, device)
    rules = default_rules(multi_pod=multi_pod)
    sh = LM_SHAPES[shape]

    t0 = time.time()
    fn, args, donate = make_step(cfg, shape, mesh, rules)
    t_lower = time.time() - t0
    t0 = time.time()
    full = _measure(fn, args, donate, mesh)
    t_compile = time.time() - t0

    probe = _probe_costs(cfg, shape, mesh, rules, sh)
    coll = probe["coll"]

    n_chips = mesh.size()
    flops = probe["flops"]
    bytes_accessed = probe["bytes"]
    coll_total = float(sum(coll.values()))

    n_active = cfg.active_param_count()
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mult = 6 if sh.kind == "train" else 2
    model_flops_total = mult * n_active * tokens
    model_flops_per_chip = model_flops_total / n_chips

    rec = {
        "arch": arch,
        "shape": shape,
        "multi_pod": multi_pod,
        "status": "ok",
        "device": mesh.device_type,
        "n_chips": int(n_chips),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": full["memory"],
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll,
        "collective_total_bytes": coll_total,
        "raw_loopcounted": {  # the full-depth cell at its own chunks
            "flops": full["flops"],
            "bytes": full["bytes"],
            "coll": full["coll"],
        },
        "probe_attn_chunk": probe["probe_chunk"],
        "model_flops_total": model_flops_total,
        "useful_flops_fraction": model_flops_per_chip / flops if flops else None,
        "params_total": cfg.param_count(),
        "params_active": n_active,
    }
    rec.update(roofline_terms(flops, bytes_accessed, coll_total))
    return rec


def one_rank_check(cfg, batch: int, seq: int, ocfg=None, device="cuda",
                   seed: int = 0, steps: int = 2, ready=None):
    """The dry run against a real run on one rank.

    On a (1, 1) ``data x model`` mesh of this process's device (a one-rank
    group is made when none exists), ``cfg``'s train step at ``batch`` x
    ``seq`` tokens is measured by ``_measure``, then run for real on
    tensors placed on that mesh (seeded parameters, zero moments, seeded
    tokens): once under ``FlopCounterMode``, then ``steps`` times timed.
    ``ready``, if given, is called between the two: the prediction needs
    no device memory, so a caller sharing the device can hold the real
    run back until the device is free.  Returns the predicted and the measured flops, argument bytes, peak
    memory and step time, with the roofline terms of the prediction."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import specs as S
    from repro_torch.launch.hlo_stats import roofline_terms
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_step
    from repro_torch.models import model as M
    from repro_torch.models.params import (
        logical_to_pspec, materialize, place, placements, shardings,
        tree_leaves)
    from repro_torch.train import OptConfig
    from repro_torch.train.train_step import opt_abstract_with_ef

    ocfg = ocfg or OptConfig()
    mesh = make_host_mesh(1, device=device)
    rules = default_rules()
    fn, args, donate = make_step(cfg, "train_4k", mesh, rules, ocfg)
    sh = ShapeConfig("one_rank", seq, batch, "train")
    args = (args[0], args[1], S.batch_specs(cfg, sh, mesh, rules), args[3])
    t0 = time.perf_counter()
    pred = _measure(fn, args, donate, mesh)
    measure_s = time.perf_counter() - t0
    if ready is not None:
        ready()

    dev = torch.device(mesh.device_type)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ab = M.abstract_params(cfg)
    oab = opt_abstract_with_ef(ab, ocfg)
    params = place(materialize(gen, ab, device=dev), mesh,
                   shardings(ab, mesh, rules.rules))
    opt = place(materialize(None, oab, device=dev), mesh,
                shardings(oab, mesh, rules.rules))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    row = placements(logical_to_pspec(("batch", None), rules.rules,
                                      tokens.shape, mesh), mesh)
    data = place({"tokens": tokens, "labels": tokens.clone()}, mesh,
                 {"tokens": row, "labels": row})
    placed = sum(t.to_local().numel() * t.element_size() for t in
                 tree_leaves(params) + tree_leaves(opt) + tree_leaves(data))
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        fn(params, opt, data, 0)
    sync()
    step_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        fn(params, opt, data, i + 1)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    terms = roofline_terms(pred["flops"], pred["bytes"],
                           float(sum(pred["coll"].values())))
    return {"device": dev.type, "batch": batch, "seq": seq,
            "measure_s": measure_s, "predicted_flops": pred["flops"],
            "flops": float(counter.get_total_flops()),
            "predicted_argument_bytes": pred["memory"]["argument_bytes"],
            "placed_bytes": placed,
            "predicted_peak_bytes": pred["memory"]["peak_device_bytes"],
            "peak_bytes": (torch.cuda.max_memory_allocated() if on_card
                           else None),
            "predicted_bytes": pred["bytes"], "step_ms": step_ms,
            **terms}


def bitmap_counts(bitmap, khot, kvec):
    """The plain bitmap count step on one device's shard: a bf16 product
    (summed in float32; its values are at most k, exact in bf16), "== k",
    and the per-candidate sum over the rows (the combiner)."""
    import torch

    dots = (bitmap.to(torch.bfloat16) @ khot.to(torch.bfloat16).T).float()
    matched = dots == kvec[None].float()
    return matched.sum(dim=0, dtype=torch.int32)


def hash_counts(bitmap, cand):
    """The plain ``perfect_hash`` count step: k column gathers ANDed, then
    the per-candidate sum over the rows."""
    import torch

    matched = bitmap[:, cand[:, 0]]
    for level in range(1, cand.shape[1]):
        matched = matched & bitmap[:, cand[:, level]]
    return matched.sum(dim=0, dtype=torch.int32)


def run_apriori_cell(multi_pod: bool, *, shard_candidates: bool = True,
                     bitmap_dtype: str = "uint8", store: str = "bitmap",
                     n: int = 2**27, f: int = 4096, c: int = 131_072, k: int = 3,
                     device="cuda"):
    """The paper's own workload at production scale: one support-counting job
    (the K-ItemsetMapper + combiner + reducer) for a web-scale transaction DB.

    Baseline faithful translation replicates candidates to every mapper (the
    Hadoop distributed-cache pattern: shard_candidates=False) and streams the
    bf16 bitmap; the optimized variants shard candidates over the model axis
    (2-D decomposition) and keep the bitmap uint8 in HBM.

    Each device counts its own rows against its own candidates (replicated
    work stays replicated, as the reference's SPMD program has it); the
    per-candidate partial counts are then summed over the data axes and
    placed as the candidates are.
    """
    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch.hlo_stats import roofline_terms
    from repro_torch.models.params import ShapeStruct, local_shape, placements

    mesh = production_mesh(multi_pod, device)
    rules = default_rules(multi_pod=multi_pod)
    dp = rules.rules["batch"]
    cand_spec = ("model", None) if shard_candidates else (None, None)
    kvec_spec = ("model",) if shard_candidates else (None,)
    dt = torch.uint8 if bitmap_dtype == "uint8" else torch.bfloat16

    def sds(shape, dtype, pspec):
        glob = torch.empty(shape, dtype=dtype, device="meta")
        return ShapeStruct(glob, pspec, torch.empty(
            local_shape(shape, pspec, mesh), dtype=dtype, device="meta"))

    out_pl = placements(kvec_spec, mesh)
    summed = [Partial() if i in [mesh.mesh_dim_names.index(a) for a in dp]
              else p for i, p in enumerate(out_pl)]

    def reduced(counts):
        part = DTensor.from_local(counts, mesh, summed, run_check=False)
        return part.redistribute(mesh, out_pl)

    bitmap = sds((n, f), dt, (dp, None))
    if store == "bitmap":
        khot = sds((c, f), torch.bfloat16, cand_spec)
        kvec = sds((c,), torch.int32, kvec_spec)

        def count_step(bitmap, khot, kvec):
            return reduced(bitmap_counts(bitmap.to_local(), khot.to_local(),
                                         kvec.to_local()))

        args = (bitmap, khot, kvec)
    else:  # perfect_hash: k gathers per candidate (the hash-table trie)
        cand = sds((c, k), torch.int32, cand_spec)

        def count_step(bitmap, cand):
            return reduced(hash_counts(bitmap.to_local(), cand.to_local()))

        args = (bitmap, cand)

    t0 = time.time()
    m = _measure(count_step, args, (), mesh)
    t_compile = time.time() - t0
    coll = m["coll"]
    n_chips = mesh.size()
    flops = m["flops"]
    bytes_accessed = m["bytes"]
    model_flops_total = 2.0 * n * f * c  # the counting matmul itself
    rec = {
        "arch": "apriori-count-step",
        "shape": f"{store}_N{n}_F{f}_C{c}"
                 f"{'_candshard' if shard_candidates else '_candrep'}"
                 f"_{bitmap_dtype}",
        "multi_pod": multi_pod,
        "status": "ok",
        "device": mesh.device_type,
        "n_chips": int(n_chips),
        "compile_s": round(t_compile, 2),
        "memory": m["memory"],
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll,
        "collective_total_bytes": float(sum(coll.values())),
        "model_flops_total": model_flops_total,
        "useful_flops_fraction": (model_flops_total / n_chips) / flops if flops else None,
    }
    rec.update(roofline_terms(flops, bytes_accessed, float(sum(coll.values()))))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--apriori", action="store_true",
                    help="run the Apriori count-step cells (baseline + variants)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (cuda or cpu)")
    args = ap.parse_args(argv)

    if args.apriori:
        recs = []
        for mp in (False, True):
            for shard, dtype, store in ((False, "bfloat16", "bitmap"),
                                        (True, "bfloat16", "bitmap"),
                                        (True, "uint8", "bitmap"),
                                        (True, "uint8", "perfect_hash")):
                recs.append(run_apriori_cell(
                    mp, shard_candidates=shard, bitmap_dtype=dtype,
                    store=store, device=args.device))
        for r in recs:
            print(json.dumps(r))
        if args.out:
            with open(args.out, "a") as fh:
                for r in recs:
                    fh.write(json.dumps(r) + "\n")
        return

    if args.all:
        from repro_torch.configs import cells

        out = args.out or DEFAULT_OUT
        if os.path.dirname(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
        done = set()
        if os.path.exists(out):
            with open(out) as f:
                for line in f:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["multi_pod"]))
        todo = []
        for arch, shape, ok, why in cells(include_skipped=True):
            for mp in (False, True):
                if (arch, shape, mp) in done:
                    continue
                todo.append((arch, shape, mp, ok, why))
        for i, (arch, shape, mp, ok, why) in enumerate(todo):
            label = f"[{i + 1}/{len(todo)}] {arch} × {shape} {'pod2' if mp else 'pod1'}"
            if not ok:
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "skipped", "reason": why}
                print(f"{label}: SKIP ({why})", flush=True)
            else:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--device", args.device]
                if mp:
                    cmd.append("--multi-pod")
                t0 = time.time()
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True,
                                          timeout=args.timeout)
                    last = proc.stdout.strip().splitlines()
                    failed = proc.returncode != 0 or not last
                    err = proc.stderr or ""
                except subprocess.TimeoutExpired as e:
                    failed, err = True, f"timeout after {e.timeout} s"
                if not failed:
                    rec = json.loads(last[-1])
                    print(f"{label}: ok compile={rec['compile_s']}s "
                          f"bottleneck={rec.get('bottleneck')}", flush=True)
                else:
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": err[-2000:]}
                    print(f"{label}: ERROR ({time.time()-t0:.0f}s)", flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return

    rec = run_cell(args.arch, args.shape, args.multi_pod, device=args.device)
    if rec["status"] == "ok":
        print(f"# memory: {rec['memory']}", file=sys.stderr)
        print(f"# costs: flops={rec['flops_per_device']:.3e} "
              f"bytes={rec['bytes_per_device']:.3e}", file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
