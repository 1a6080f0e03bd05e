"""Which collectives the port's sharded LM issues, per mixer family.

    PYTHONPATH=src python scripts/lm_sharding_collectives.py [--shape 1x2]

Launches a gloo world of CPU ranks (``--shape`` is ``data x model``) and,
for the reduced config of each mixer family (qwen2-1.5b, recurrentgemma-2b,
mamba2-2.7b, deepseek-v3-671b, llama-3.2-vision-11b), counts with
DTensor's ``CommDebugMode`` the collectives of one prefill (batch 4, 12
tokens), one decode step and one ``loss_fn`` forward and backward, by op,
and the prefill's by the DTensor op that issued them.
Rank 0 prints one JSON line per config.  These are counts, not times: an
all-gather where the reference keeps a dimension sharded shows here as an
``all_gather_into_tensor``.
"""

from __future__ import annotations

import argparse
import os
import sys

_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import ctx
ctx.initialize_multihost(device="cpu", timeout=300)
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch.mesh import mesh_of_ranks
from repro_torch.launch.multihost import exit_rank
from repro_torch.models import model as M
from repro_torch.models.params import materialize, place, shardings, tree_leaves

class ByOp(TorchDispatchMode):
    # The DTensor op that issued each collective: DTensor desugars an op
    # into its collectives after the mode has seen the op itself.
    def __init__(self):
        super().__init__()
        self.last, self.counts = None, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            self.last = str(func.overloadpacket)
            return NotImplemented
        name = func._schema.name
        if name.startswith("_c10d_functional::") and not any(
                w in name for w in ("wait", "wrap")):
            key = f"{self.last} -> {name.split('::')[1]}"
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **kwargs)


shape = tuple(int(n) for n in sys.argv[1].split("x"))
mesh = mesh_of_ranks(range(shape[0] * shape[1]), shape, ("data", "model"),
                     "cpu")
rules = default_rules()
B, S, T = 4, 12, 24
for arch in ["qwen2-1.5b", "recurrentgemma-2b", "mamba2-2.7b",
             "deepseek-v3-671b", "llama-3.2-vision-11b"]:
    cfg = get_reduced(arch)
    abstract = M.abstract_params(cfg)
    params = place(materialize(torch.Generator().manual_seed(0), abstract,
                               dtype_override=torch.float32, device="cpu"),
                   mesh, shardings(abstract, mesh, rules.rules))
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                       dtype=torch.int32)}
    if cfg.frontend == "vision_patches":
        batch["vis_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)), dtype=torch.float32)
    cabs = M.abstract_cache(cfg, B, T)
    cache = place(materialize(None, cabs, dtype_override=torch.float32,
                              device="cpu"), mesh,
                  shardings(cabs, mesh, rules.rules))
    out = {"arch": arch, "shape": list(shape)}
    with torch.no_grad(), ctx.use_sharding(mesh, rules):
        with CommDebugMode() as comm, ByOp() as by_op:
            logits, cache = M.prefill(params, batch, cfg, cache)
        out["prefill"] = {str(k): v for k, v in comm.get_comm_counts().items()}
        out["prefill_by_op"] = by_op.counts
        tok = ctx.whole(logits).argmax(-1).to(torch.int32)[:, None]
        with CommDebugMode() as comm:
            M.decode_step(params, tok, cache, S + 1, cfg)
        out["decode"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    b2 = dict(batch, labels=torch.roll(batch["tokens"], -1, 1))
    leaves = tree_leaves(M.trainable(params))
    with ctx.use_sharding(mesh, rules), CommDebugMode() as comm:
        loss, _ = M.loss_fn(params, b2, cfg)
        torch.autograd.grad(loss, leaves, allow_unused=True)
    out["loss_and_grads"] = {str(k): v
                             for k, v in comm.get_comm_counts().items()}
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
exit_rank(0)
"""


def main(argv=None) -> int:
    from repro_torch.launch.multihost import launch_cluster

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="1x2")
    args = ap.parse_args(argv)
    n_data, n_model = (int(n) for n in args.shape.split("x"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    launch_cluster([sys.executable, "-c", _RANK, args.shape],
                   n_data * n_model, base_env=env, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
