"""Training launcher (PyTorch port of the JAX package's
``launch/train.py``).

On one CUDA card (the default ``--device cuda``) it trains the
architecture's full published config; on the CPU (``--device cpu``) or
with ``--reduced``, its reduced config:

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 3 \\
      --batch 4 --seq 512
  python -m repro_torch.launch.train --arch qwen2-1.5b --device cpu \\
      --steps 10 --ckpt-dir DIR

The run has the full fault-tolerance path: resume, atomic snapshots, NaN
rollback, straggler flags.  ``--shape``'s global batch and sequence length
are the defaults on the card (on the CPU: 4 x 128); a single card holds
qwen2-1.5b's 4,096-token sequences only at a small ``--batch`` or with
``--microbatches``.  ``--multi-pod`` trains on the multi-pod production mesh
(``make_production_mesh(multi_pod=True)``, 2 x 16 x 16 ranks, under
``default_rules(multi_pod=True)``): every rank runs this module, and a
smaller world fails with the mesh's error.  It prints the reference's JSON summary line.  Every
architecture of ``configs`` trains; a vision config's batches carry zero
patch embeddings (the stub frontend, as ``launch/serve.py --lm`` gives).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.sharding import default_rules
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def with_zero_patches(iterator, cfg, batch: int):
    """``iterator`` (a pipeline's, from a start step) with each batch given
    zero bfloat16 ``vis_embeds`` (batch, n_vis_tokens, d_model)."""
    import torch

    def it(start_step: int = 0):
        for b in iterator(start_step):
            b["vis_embeds"] = torch.zeros(
                (batch, cfg.n_vis_tokens, cfg.d_model), dtype=torch.bfloat16)
            yield b
    return it


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config (always on the CPU)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the full config) or cpu (the reduced one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = rules = None
    if args.multi_pod:
        from repro_torch.distributed.ctx import initialize_multihost
        from repro_torch.launch.mesh import make_production_mesh

        initialize_multihost(device=dev)
        mesh = make_production_mesh(multi_pod=True, device=dev)
        rules = default_rules(multi_pod=True)
    on_card = dev.type == "cuda"
    cfg = (get_config(args.arch) if on_card and not args.reduced
           else get_reduced(args.arch))

    sh = LM_SHAPES[args.shape]
    batch = args.batch or (sh.global_batch if on_card else 4)
    seq = args.seq or (sh.seq_len if on_card else 128)

    pipeline = SyntheticLM(cfg.vocab_size, batch, seq)
    ocfg = OptConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 10))
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )
    data = pipeline.iterator
    if cfg.frontend == "vision_patches":
        data = with_zero_patches(data, cfg, batch)
    trainer = Trainer(cfg, ocfg, tcfg, data, mesh=mesh, rules=rules,
                      device=dev)
    summary = trainer.run()
    print(json.dumps({k: v for k, v in summary.items() if k != "log"}))


if __name__ == "__main__":
    main()
