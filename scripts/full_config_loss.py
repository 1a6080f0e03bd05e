"""The loss and gradient norm of qwen2-1.5b at full width from the JAX
package's own init, in the JAX package and in the PyTorch port, on the CPU.

    PYTHONPATH=src python scripts/full_config_loss.py [--layers N] [--float32]
        [--rescale]

Each side runs in its own process, one after the other (each holds the
parameters and their gradients: about 10 GB at the full 28 layers in
bfloat16): the JAX package's ``loss_fn`` and ``jax.value_and_grad`` from
``materialize(PRNGKey(0), ...)`` on step 0 of its ``SyntheticLM(151,936,
1, 128, seed=0)``, then the port's ``loss_fn`` and ``torch.autograd.grad``
on the same parameters (carried over by ``models.convert``) and the same
batch.  Each prints one JSON line: the loss, the global gradient norm as
each package's optimizer computes it (a float32 sum of squares) and in
float64, the largest gradient element and the count of leaves with a
non-finite element.  ``--layers`` cuts the depth (default: all 28);
``--float32`` runs both in float32 instead of the parameters' bfloat16;
``--rescale`` scales the attention weights to std 1/sqrt(true fan-in)
(the reference's init gives near one-hot softmaxes, whose gradients
amplify rounding).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_COMMON = r"""
import dataclasses, json, sys, time
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import model as JM
from repro.models.params import materialize
layers, f32, rescale, batch_path = (int(sys.argv[1]), sys.argv[2] == "1",
                                    sys.argv[3] == "1", sys.argv[4])
cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers)
params = materialize(jax.random.PRNGKey(0), JM.abstract_params(cfg),
                     dtype_override=jnp.float32 if f32 else None)
if rescale:  # attention weights to std 1/sqrt(true fan-in)
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factors = {"wq": (h / d) ** 0.5, "wk": (kv / d) ** 0.5,
               "wv": (kv / d) ** 0.5, "wo": h ** -0.5}
    for part in params["blocks"].values():
        for layer in part.values():
            for k, f in factors.items():
                w = layer["attn"][k]
                layer["attn"][k] = (w * f).astype(w.dtype)
"""

_REFERENCE = _COMMON + r"""
from repro.data.pipeline import SyntheticLM
from repro.train.optimizer import global_norm
batch = SyntheticLM(cfg.vocab_size, 1, 128, seed=0).batch_at(0)
np.savez(batch_path, **{k: np.asarray(v) for k, v in batch.items()})
t0 = time.time()
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p, b: JM.loss_fn(p, b, cfg), has_aux=True))(params, batch)
leaves = jax.tree.leaves(grads)
print(json.dumps({
    "side": "reference", "layers": layers, "float32": f32,
    "rescaled": rescale,
    "loss": float(loss), "grad_norm": float(global_norm(grads)),
    "grad_norm_f64": float(np.sqrt(sum(
        np.sum(np.square(np.asarray(g, np.float64))) for g in leaves))),
    "max_abs_grad": max(float(jnp.max(jnp.abs(g.astype(jnp.float32))))
                        for g in leaves),
    "nonfinite_leaves": sum(not bool(jnp.all(jnp.isfinite(g)))
                            for g in leaves),
    "s": time.time() - t0}))
"""

_PORT = _COMMON + r"""
import torch
from repro_torch.configs import get_config as t_config
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import global_norm
tcfg = dataclasses.replace(t_config("qwen2-1.5b"), n_layers=layers)
tree = M.trainable(params_from_reference(
    jax.tree.map(np.asarray, params), tcfg, device="cpu"))
del params
data = np.load(batch_path)
batch = {k: torch.as_tensor(data[k]) for k in data.files}
t0 = time.time()
loss, _ = M.loss_fn(tree, batch, tcfg)
leaves = tree_leaves(tree)
grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
    leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
print(json.dumps({
    "side": "port", "layers": layers, "float32": f32, "rescaled": rescale,
    "loss": float(loss),
    "grad_norm": float(global_norm({str(i): g for i, g in enumerate(grads)})),
    "grad_norm_f64": float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                          for g in grads))),
    "max_abs_grad": max(float(g.float().abs().max()) for g in grads),
    "nonfinite_leaves": sum(not bool(torch.isfinite(g).all())
                            for g in grads),
    "s": time.time() - t0}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--rescale", action="store_true")
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        batch = os.path.join(tmp, "batch.npz")
        for code in (_REFERENCE, _PORT):
            subprocess.run([sys.executable, "-c", code, str(args.layers),
                            "1" if args.float32 else "0",
                            "1" if args.rescale else "0", batch],
                           env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
