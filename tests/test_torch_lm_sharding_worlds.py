"""The port's LM on a ``data x model`` mesh of gloo ranks, held against the
single-device port.

A module-scoped fixture launches one gloo world of CPU ranks per mesh
shape (2 x 1: data parallel with FSDP; 1 x 2: tensor, expert and
sequence-parallel decode; the 2 x 2 grid, and the JAX package's own
sharded forward, are in ``test_torch_lm_sharding_grid.py``) through the
port's own ``launch_cluster``.  Every rank runs every case on five reduced configs,
one per mixer family (qwen2-1.5b: dense GQA; recurrentgemma-2b: RG-LRU;
mamba2-2.7b: SSD; deepseek-v3-671b: MLA + MoE with experts on ``model``;
llama-3.2-vision-11b: gated cross-attention) in float32, computes the
single-device answer on the same parameters beside it, and rank 0 writes
the comparisons.  The tests below hold them to the tolerances the LM
parity tests use (``test_torch_lm.py``, ``test_torch_train.py``):

* prefill logits and every cache leaf, and two decode steps' logits and
  caches: max |diff| / max |want| < 1e-4;
* ``loss_fn``: < 1e-5; every gradient leaf: ||diff|| / ||want|| < 5e-4,
  the tolerance ``test_torch_train.py`` gives gradients from the raw
  (chaotic at depth) init;
* ``ServeEngine(mesh=, rules=)`` greedy tokens: equal;
* MoE: ``route`` on the placed router probabilities gives dispatch and
  combine bit for bit; the expert-parallel FFN < 1e-4;
* on qwen2-1.5b: the global gradient norm (< 1e-5) and the int8
  compression of placed gradients (bit for bit); ``Trainer(mesh=,
  rules=)`` against the single-device trainer (per-step losses < 1e-5,
  parameters after two AdamW steps < 1e-3), resumed bit for bit, with a NaN step rolled back; a snapshot saved on this mesh
  restored onto the other shape through ``restore(shardings=)`` and
  ``elastic.resume``, bit for bit; ``elastic_mesh`` and
  ``make_host_mesh`` over the world.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.launch.multihost import launch_cluster  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
ARCHS = ["qwen2-1.5b", "recurrentgemma-2b", "mamba2-2.7b",
         "deepseek-v3-671b", "llama-3.2-vision-11b"]
HERE = ["2x1", "1x2"]
TOL = {"prefill_logits": 1e-4, "prefill_cache": 1e-4, "decode_logits": 1e-4,
       "decode_cache": 1e-4, "loss": 1e-5, "grads": 5e-4}

_WORLD = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import ctx
ctx.initialize_multihost(device="cpu", timeout=300)
import torch.distributed as dist
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import elastic
from repro_torch.distributed.compression import compress_grads
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch.mesh import make_host_mesh, mesh_of_ranks
from repro_torch.launch.multihost import exit_rank
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import blocks as BL
from repro_torch.models.params import (materialize, place, shardings,
                                       tree_leaves, tree_map)
from repro_torch.serve.lm import ServeEngine
from repro_torch.train.optimizer import OptConfig, global_norm
from repro_torch.train.train_step import opt_abstract_with_ef
from repro_torch.train.trainer import Trainer, TrainerConfig

spec = json.loads(sys.argv[1])
shape = tuple(spec["shape"])
mesh = mesh_of_ranks(range(shape[0] * shape[1]), shape, ("data", "model"),
                     "cpu")
rules = default_rules()
whole = ctx.whole
F32 = torch.float32
B, S, T = 4, 12, 24


def rel(got, want):
    got, want = whole(got).detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def norm_rel(got, want):
    got, want = whole(got).detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def bits(t):
    t = whole(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().view(np.uint8)


def worst(fn, got, want):
    return max(fn(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def sharded():
    return ctx.use_sharding(mesh, rules)


def params_of(cfg):
    gen = torch.Generator().manual_seed(0)
    return materialize(gen, M.abstract_params(cfg), dtype_override=F32,
                       device="cpu")


def placed(tree, abstract):
    return place(tree, mesh, shardings(abstract, mesh, rules.rules))


def batch_of(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32)}
    if cfg.frontend == "vision_patches":
        out["vis_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)), dtype=F32)
    return out


def arch_cases(arch):
    cfg = get_reduced(arch)
    abstract = M.abstract_params(cfg)
    params = params_of(cfg)
    sp = placed(params, abstract)
    batch = batch_of(cfg)
    res = {}
    # prefill and two decode steps
    cabs = M.abstract_cache(cfg, B, T)
    with torch.no_grad():
        c_ref = materialize(None, cabs, dtype_override=F32, device="cpu")
        c = placed(materialize(None, cabs, dtype_override=F32, device="cpu"),
                   cabs)
        l_ref, c_ref = M.prefill(params, batch, cfg, c_ref)
        with sharded():
            l, c = M.prefill(sp, batch, cfg, c)
        res["prefill_logits"] = rel(l, l_ref)
        res["prefill_cache"] = worst(rel, c, c_ref)
        errs = []
        for i in range(2):
            tok = torch.argmax(l_ref, -1).to(torch.int32)[:, None]
            l_ref, c_ref = M.decode_step(params, tok, c_ref, S + 1 + i, cfg)
            with sharded():
                l, c = M.decode_step(sp, tok, c, S + 1 + i, cfg)
            errs.append(rel(l, l_ref))
        res["decode_logits"] = max(errs)
        res["decode_cache"] = worst(rel, c, c_ref)
    # loss and every gradient
    b2 = dict(batch, labels=torch.roll(batch["tokens"], -1, 1))
    rp = M.trainable(tree_map(lambda t: t.clone(), params))
    loss_ref, _ = M.loss_fn(rp, b2, cfg)
    g_ref = torch.autograd.grad(loss_ref, tree_leaves(rp), allow_unused=True)
    spp = M.trainable(placed(params, abstract))
    with sharded():
        loss, _ = M.loss_fn(spp, b2, cfg)
        g = torch.autograd.grad(loss, tree_leaves(spp), allow_unused=True)
    res["loss"] = rel(loss, loss_ref)
    assert [a is None for a in g] == [b is None for b in g_ref]
    res["grads"] = max(norm_rel(a, b) for a, b in zip(g, g_ref)
                       if b is not None and float(b.abs().max()) > 0)
    # greedy serving
    prompts = batch["tokens"][:, :8].numpy()
    vis = batch.get("vis_embeds")
    want = ServeEngine(cfg, params, max_len=T, device="cpu").generate(
        prompts, 4, vis_embeds=vis)
    got = ServeEngine(cfg, params, max_len=T, mesh=mesh, rules=rules,
                      device="cpu").generate(prompts, 4, vis_embeds=vis)
    res["serve_equal"] = bool(np.array_equal(got, want))
    if cfg.moe is not None:
        res.update(moe_cases(cfg, params, sp))
    return res


def moe_cases(cfg, params, sp):
    i = next(str(n) for n, (_, ch) in enumerate(BL.layer_kinds(cfg))
             if ch == "moe")
    lp, slp = params["blocks"][i]["moe"], sp["blocks"][i]["moe"]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)), dtype=F32)
    with torch.no_grad():
        xg = MOE.group(x, cfg)
        probs = MOE.router_probs(lp, xg)
        cap = MOE._capacity(xg.shape[1], cfg)
        d_ref, c_ref = MOE.route(probs, cfg.moe.top_k, cap, F32)
        out_ref = MOE.experts(lp, xg, d_ref, c_ref, cfg)
        with sharded():
            d, c = MOE.route(ctx.constrain(probs, "batch", None, None),
                             cfg.moe.top_k, cap, F32)
            out = MOE.experts(slp, xg, d_ref, c_ref, cfg)
            d, c = whole(d), whole(c)
    return {"moe_route_equal": bool(torch.equal(d, d_ref)
                                    and torch.equal(c, c_ref)),
            "moe_experts": rel(out, out_ref)}


def world_cases():
    cfg = get_reduced("qwen2-1.5b")
    abstract = M.abstract_params(cfg)
    res = {}
    # the global norm and the int8 compression of placed gradients
    gen = torch.Generator().manual_seed(3)
    grads = materialize(gen, abstract, dtype_override=F32, device="cpu")
    ef = materialize(torch.Generator().manual_seed(4),
                     M.abstract_params(cfg), device="cpu")
    with torch.no_grad(), sharded():
        res["grad_norm"] = rel(global_norm(placed(grads, abstract)),
                               global_norm(grads))
        dq, new_ef = compress_grads(placed(grads, abstract),
                                    placed(ef, abstract), cfg)
    dq_ref, ef_ref = compress_grads(grads, ef, cfg)
    res["compress_equal"] = all(
        torch.equal(whole(a), b) for a, b in zip(
            tree_leaves(dq) + tree_leaves(new_ef),
            tree_leaves(dq_ref) + tree_leaves(ef_ref)))
    # the trainer on the mesh against the single-device trainer
    pipe = SyntheticLM(cfg.vocab_size, B, 16, seed=1)
    ocfg = OptConfig(lr=1e-3, total_steps=8, warmup_steps=1)
    base = spec["ckpt"]

    def trainer(m, d, steps=2):
        tr = Trainer(cfg, ocfg, TrainerConfig(
            total_steps=steps, ckpt_every=1, ckpt_dir=d), pipe.iterator,
            mesh=m, rules=None if m is None else rules, device="cpu")
        # float32 state: sharded and single-device sums agree to ~1e-7
        tree = {"params": params_of(cfg), "opt": materialize(
            None, opt_abstract_with_ef(abstract, ocfg), dtype_override=F32,
            device="cpu")}
        if m is not None:
            tree = place(tree, m, tr.placements)
        tr.params, tr.opt_state = M.trainable(tree["params"]), tree["opt"]
        return tr

    plain = trainer(None, None)
    plain.run()
    t = trainer(mesh, base + "/mesh")
    log = t.run()["log"]
    res["trainer_params"] = worst(norm_rel, t.params, plain.params)
    res["trainer_loss"] = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                              for a, b in zip(log, plain.metrics_log))
    again = trainer(mesh, base + "/mesh")
    snap = ckpt.load(base + "/mesh")[0]
    res["resume_equal"] = again.try_restore() and again.step == 2 and all(
        np.array_equal(bits(a), snap[k].view(np.uint8))
        for a, k in zip(tree_leaves(again._state_tree()),
                        [k for k, _ in ckpt._flatten(again._state_tree())]))
    res["resume_armed"] = all(p.requires_grad
                              for p in tree_leaves(again.params))
    # a NaN step on the mesh rolls back to the snapshot and goes on
    nan = trainer(mesh, base + "/nan", steps=4)
    real = nan.train_step
    seen = {"n": 0}

    def poisoned(p, o, b, s):
        p2, o2, m = real(p, o, b, s)
        if int(s) == 2 and seen["n"] == 0:
            seen["n"] += 1
            m = dict(m)
            m["loss"] = torch.tensor(float("nan"))
        return p2, o2, m

    nan.train_step = poisoned
    out = nan.run()
    res["nan_rollback"] = (out["final_step"] == 4 and seen["n"] == 1
                           and bool(np.isfinite(out["final_loss"])))
    # a snapshot saved on this mesh, restored onto the other shape
    n = shape[0] * shape[1]
    other_shape = (n, 1) if shape[1] > 1 else (1, n)
    other = mesh_of_ranks(range(n), other_shape, ("data", "model"), "cpu")
    state_abs = tree_map(lambda x: dataclasses.replace(x, dtype=F32), {
        "params": abstract, "opt": opt_abstract_with_ef(abstract, ocfg)})
    sh = shardings(state_abs, other, rules.rules)
    tree, step, _ = ckpt.restore(base + "/mesh", t._state_tree(),
                                 device="cpu", shardings=sh, mesh=other)
    via, step2, _ = elastic.resume(base + "/mesh", state_abs, mesh=other,
                                   rules=rules, device="cpu")
    keys = [k for k, _ in ckpt._flatten(tree)]
    res["restore_other_mesh_equal"] = step == step2 == 2 and all(
        tuple(a.device_mesh.shape) == tuple(b.device_mesh.shape)
        == other_shape and np.array_equal(bits(a), snap[k].view(np.uint8))
        and np.array_equal(bits(b), snap[k].view(np.uint8))
        for a, b, k in zip(tree_leaves(tree), tree_leaves(via), keys))
    # meshes over the world
    res["host_mesh"] = list(make_host_mesh(model_axis=shape[1],
                                           device="cpu").shape)
    res["elastic_mesh"] = list(elastic.elastic_mesh(model_axis=2,
                                                    device="cpu").shape)
    return res


def reference_case(path):
    # the JAX package's parameters (float32) and its sharded prefill logits
    cfg = get_reduced("qwen2-1.5b")
    data = torch.load(path, weights_only=False)
    sp = placed(data["params"], M.abstract_params(cfg))
    cabs = M.abstract_cache(cfg, data["tokens"].shape[0], T)
    c = placed(materialize(None, cabs, dtype_override=F32, device="cpu"),
               cabs)
    with torch.no_grad(), sharded():
        logits, _ = M.prefill(sp, {"tokens": data["tokens"]}, cfg, c)
    return {"reference_prefill_logits": rel(logits, data["logits"])}


out = {arch: arch_cases(arch) for arch in spec["archs"]}
out["world"] = world_cases()
if spec.get("reference"):
    out["reference"] = reference_case(spec["reference"])
if dist.get_rank() == 0:
    with open(spec["out"], "w") as f:
        json.dump(out, f)
exit_rank(0)
"""

# The JAX package's sharded prefill on its own host mesh (four forced host
# devices, as its multi-device tests run): 2 x 2 ``data x model``.
_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.distributed.ctx import use_sharding
from repro.distributed.sharding import default_rules
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.models.params import materialize, shardings

cfg = get_reduced("qwen2-1.5b")
abstract = M.abstract_params(cfg)
params = materialize(jax.random.PRNGKey(0), abstract,
                     dtype_override=jnp.float32)
mesh = make_host_mesh(model_axis=2)
rules = default_rules()
params = jax.tree.map(jax.device_put, params,
                      shardings(abstract, mesh, rules.rules))
tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 12))
cache = materialize(jax.random.PRNGKey(1), M.abstract_cache(cfg, 4, 24),
                    dtype_override=jnp.float32)


def run(p, c):
    with use_sharding(mesh, rules):
        return M.prefill(p, {"tokens": jnp.asarray(tokens, jnp.int32)},
                         cfg, c)[0]


logits = jax.jit(run)(params, cache)
flat = jax.tree_util.tree_flatten_with_path(params)[0]
np.savez(sys.argv[1], logits=np.asarray(logits), tokens=tokens,
         **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _reference_inputs(tmp):
    """Runs the JAX package's sharded prefill in a subprocess and writes
    its parameters (in the port's tree) and logits for the world."""
    from repro.configs import get_reduced as j_reduced
    from repro.models import model as JM
    from repro.models.params import materialize as j_materialize

    from repro_torch.configs import get_reduced
    from repro_torch.models.convert import params_from_reference

    npz = str(tmp / "reference.npz")
    subprocess.run([sys.executable, "-c", _REFERENCE, npz], env=_env(),
                   check=True, timeout=300)
    got = np.load(npz)
    cfg = j_reduced("qwen2-1.5b")
    abstract = JM.abstract_params(cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        j_materialize(jax.random.PRNGKey(0), abstract,
                      dtype_override=np.float32))
    tree = jax.tree_util.tree_unflatten(
        treedef, [got[jax.tree_util.keystr(k)] for k, _ in flat])
    path = str(tmp / "reference.pt")
    torch.save({"params": params_from_reference(
        tree, get_reduced("qwen2-1.5b"), device="cpu"),
        "tokens": torch.as_tensor(got["tokens"], dtype=torch.int32),
        "logits": torch.as_tensor(got["logits"])}, path)
    return path


_WORLDS = {}


def get_world(name, tmp_path_factory):
    """The world's results, run once per module."""
    if name not in _WORLDS:
        _WORLDS[name] = run_world(name, tmp_path_factory.mktemp(name))
    return _WORLDS[name]


def run_world(name, tmp):
    shape = SHAPES[name]
    path = str(tmp / f"{name}.json")
    spec = {"shape": shape, "out": path, "archs": ARCHS,
            "ckpt": str(tmp / "ckpt")}
    if name == "2x2":
        spec["reference"] = _reference_inputs(tmp)
    launch_cluster([sys.executable, "-c", _WORLD, json.dumps(spec)],
                   shape[0] * shape[1], base_env=_env(), timeout=600)
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=HERE)
def world(request, tmp_path_factory):
    return request.param, get_world(request.param, tmp_path_factory)


def check_arch(res, arch):
    got = res[arch]
    for key, tol in TOL.items():
        assert got[key] < tol, (key, got[key])
    assert got["serve_equal"]


def check_moe(res):
    got = res["deepseek-v3-671b"]
    assert got["moe_route_equal"]
    assert got["moe_experts"] < 1e-4


def check_trainer(res):
    got = res["world"]
    assert got["grad_norm"] < 1e-5
    assert got["compress_equal"]
    # Per-step losses as the reference-trainer test holds them.  AdamW's
    # first steps move every element by about lr whatever its gradient's
    # size, so an element whose gradient is near zero lands on either side
    # with sums in another order: the parameters agree to 1e-3.
    assert got["trainer_loss"] < 1e-5 and got["trainer_params"] < 1e-3
    assert got["resume_equal"] and got["resume_armed"]
    assert got["nan_rollback"]


def check_meshes(res, shape):
    got = res["world"]
    assert got["restore_other_mesh_equal"]
    assert got["host_mesh"] == list(shape)
    assert got["elastic_mesh"] == [shape[0] * shape[1] // 2, 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_lm_equals_single_device(world, arch):
    check_arch(world[1], arch)


def test_moe_dispatch_exact_and_experts_close(world):
    check_moe(world[1])


def test_norm_compression_and_trainer_on_the_mesh(world):
    check_trainer(world[1])


def test_restore_onto_another_mesh_and_world_meshes(world):
    check_meshes(world[1], SHAPES[world[0]])
