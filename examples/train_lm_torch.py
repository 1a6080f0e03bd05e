"""Train an LM with the fault-tolerant trainer + inline token-set mining, on
the PyTorch port (``examples/train_lm.py`` on ``repro_torch``).

PROVENANCE: the LM is inherited scaffolding from the repo seed, not part of
the Apriori reproduction, so this example is gated behind ``REPRO_LM=1``
as the reference's is.

  REPRO_LM=1 PYTHONPATH=src python examples/train_lm_torch.py --steps 30
  REPRO_LM=1 PYTHONPATH=src python examples/train_lm_torch.py --steps 30 \\
      --device cpu

Shows: frequent token-sets mined from the training stream through the
``bitmap`` store (on the card, the hand-written tensor-core kernel), the
training loop with atomic snapshots and resume, and a short greedy
generation from the trained weights through ``ServeEngine``.
``--ckpt-dir`` defaults to a directory under the system's temporary
directory; a second run over it resumes at the last snapshot.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch.analytics import TokenSetMiner
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main() -> None:
    if os.environ.get("REPRO_LM") != "1":
        print("examples/train_lm_torch.py is inherited LM scaffolding, not "
              "part of the Apriori reproduction (see README 'Inherited "
              "scaffolding').\nSet REPRO_LM=1 to run it anyway.")
        sys.exit(0)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = dataclasses.replace(
        get_reduced("qwen2-1.5b"),
        n_layers=args.layers, d_model=args.width,
        n_heads=max(4, args.width // 64), n_kv_heads=max(2, args.width // 128),
        d_ff=args.width * 4, vocab_size=args.vocab,
    )
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}) on {args.device}")

    pipeline = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=0)

    # Apriori analytics on the SAME training stream (the paper's technique as
    # a framework feature): which token sets co-occur suspiciously often?
    miner = TokenSetMiner(min_support=0.10, store="bitmap", window=16,
                          max_k=3, device=args.device)
    mined = miner.mine_steps(pipeline, steps=range(2))
    print("\n" + TokenSetMiner.report(mined, top=5) + "\n")

    ocfg = OptConfig(lr=1e-3, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 10))
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(5, args.steps // 4),
                         ckpt_dir=args.ckpt_dir, log_every=5)
    trainer = Trainer(cfg, ocfg, tcfg, pipeline.iterator, device=args.device)
    summary = trainer.run()
    first = summary["log"][0]["loss"] if summary["log"] else float("nan")
    print(f"trained {summary['final_step']} steps: "
          f"loss {first:.3f} -> {summary['final_loss']:.3f} "
          f"(straggler flags: {summary['straggler_flags']})")

    # quick greedy generation from the trained weights
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, trainer.params, max_len=args.seq + 16,
                         device=args.device)
    prompt = pipeline.batch_at(0)["tokens"][:2, :16].numpy()
    out = engine.generate(prompt, max_new_tokens=8)
    print("sample continuation:", out[0].tolist())


if __name__ == "__main__":
    main()
