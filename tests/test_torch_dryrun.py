"""PyTorch port vs JAX package: the dry run and its measurements
(``launch/{specs,steps,hlo_stats,dryrun}.py``).

* ``make_step``'s arguments for every cell of ``configs.cells()`` on both
  production meshes, leaf by leaf against the reference's on
  ``jax.sharding.AbstractMesh``: global shape, dtype, spec and one rank's
  shard shape, and ``donate``.  The reference stacks the scanned layers
  under a leading dim (spec ``None``); the port holds one tree per layer,
  so a stacked leaf is compared without that dim.  The port's mesh is a
  stand-in with the axis sizes (``specs`` touches no process group).
* ``make_step``'s functions on reduced configs with ``mesh=None``, on the
  same seeded numpy inputs and weights carried over by ``convert``:
  prefill and decode logits and caches (float32, < 1e-4, as
  ``test_torch_lm.py``), the encoder's bf16 frame logits (one bf16 ulp of
  float32 values that agree to 1e-4: < 2^-7), and one train step's loss,
  parameters and moments (as ``test_torch_train.py``: < 1e-4, the
  attention rescaled, AdamW's eps 1e-5).
* ``roofline_terms`` (the reference's cases with its constants passed in)
  and ``collective_bytes`` (the reference's HLO cases given as records).
* On a ``fake`` process group, each in a subprocess (the group is
  process-wide): the apriori cells' exact per-device flops, flops fraction
  and argument bytes, and a 2 x 2 row-parallel product whose all-reduce
  moves B x F x 4 bytes.
* ``_probe_costs``' fit equals the full-depth count at the same chunk.
* ``chip_smoke.py`` phase 13 (c)'s holds on the CPU (a subprocess): on a
  (1, 1) mesh the prediction's flops equal ``FlopCounterMode`` over the
  real step and its argument bytes the placed tensors' bytes.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import hlo_stats as JH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import materialize as j_materialize  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402

from repro_torch.configs import cells, get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import hlo_stats as TH  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import opt_state_from_reference  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ShapeStruct, StandInMesh, tree_leaves)
from repro_torch.train import OptConfig as TOptConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


# -- specs parity ------------------------------------------------------------------

def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _unstacked(ref, cfg):
    """{port path: (leaf, stacked)} of a reference head/scan/tail tree, in
    the port's layer numbering."""
    pl = TT.plan(cfg)
    n_head, p = len(pl.head), len(pl.pattern)
    out = {}
    for part, index in (("head", lambda i: i),
                        ("tail", lambda i: n_head + pl.n_super * p + i)):
        for i, sub in ref[part].items():
            for path, leaf in _walk(sub):
                out[(str(index(int(i))),) + path] = (leaf, False)
    for j, sub in ref["scan"].items():
        for u in range(pl.n_super):
            for path, leaf in _walk(sub):
                out[(str(n_head + u * p + int(j)),) + path] = (leaf, True)
    return out


def _ref_leaves(ref, cfg):
    """{port path: (reference leaf, stacked)} of one argument."""
    if not isinstance(ref, dict):
        return {(): (ref, False)}
    if "scan" in ref:  # a cache: the stack itself
        return _unstacked(ref, cfg)
    out = {}
    for k, v in ref.items():
        if k == "blocks":
            sub = _unstacked(v, cfg)
        elif isinstance(v, dict) and "blocks" in v:  # an optimizer moment
            sub = {pp: lv for pp, lv in _ref_leaves(v, cfg).items()}
        else:
            sub = {pp: (lv, False) for pp, lv in _walk(v)}
        out.update({(k,) + pp: lv for pp, lv in sub.items()})
    return out


def _check_leaf(ref, stacked, port):
    shape = tuple(ref.shape)
    if ref.sharding is None:
        assert isinstance(port, torch.Tensor) and port.ndim == len(shape)
        assert tuple(port.shape) == shape
        assert str(port.dtype) == f"torch.{jnp.dtype(ref.dtype).name}"
        return
    spec = tuple(ref.sharding.spec)
    spec = spec + (None,) * (len(shape) - len(spec))
    shard = tuple(ref.sharding.shard_shape(ref.shape))
    if stacked:
        assert spec[0] is None
        shape, spec, shard = shape[1:], spec[1:], shard[1:]
    assert isinstance(port, ShapeStruct)
    assert tuple(port.shape) == shape
    assert str(port.dtype) == f"torch.{jnp.dtype(ref.dtype).name}"
    assert port.pspec == spec, (spec, port.pspec)
    assert tuple(port.local.shape) == shard


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted({a for a, *_ in cells()}))
def test_step_args_match_reference(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    tmesh = StandInMesh(sizes, names)
    multi_pod = mesh_name == "pod2"
    jrules = JS.default_rules(multi_pod=multi_pod)
    trules = TS.default_rules(multi_pod=multi_pod)
    jcfg, tcfg = j_config(arch), get_config(arch)
    n = 0
    for a, shape, ok, _ in cells():
        if a != arch:
            continue
        _, jargs, jdonate = JST.make_step(jcfg, shape, jmesh, jrules)
        _, targs, tdonate = TST.make_step(tcfg, shape, tmesh, trules)
        assert tuple(jdonate) == tdonate
        assert len(jargs) == len(targs)
        for jarg, targ in zip(jargs, targs):
            ref = _ref_leaves(jarg, tcfg)
            port = dict(_walk(targ))
            assert sorted(ref) == sorted(port), shape
            for path, (leaf, stacked) in ref.items():
                _check_leaf(leaf, stacked, port[path])
                n += 1
    assert n > 0


def test_input_specs_match_reference():
    jmesh = AbstractMesh(*MESHES["pod1"])
    tmesh = StandInMesh(*MESHES["pod1"])
    jrules, trules = JS.default_rules(), TS.default_rules()
    for arch, shape in (("qwen2-1.5b", "decode_32k"),
                        ("llama-3.2-vision-11b", "prefill_32k"),
                        ("hubert-xlarge", "train_4k")):
        from repro.launch import specs as JSP

        want = JSP.input_specs(j_config(arch), shape, jmesh, jrules)
        got = TSP.input_specs(get_config(arch), shape, tmesh, trules)
        assert sorted(want) == sorted(got)
        for key in want:
            ref = _ref_leaves(want[key], get_config(arch))
            port = dict(_walk(got[key]))
            assert sorted(ref) == sorted(port)
            for path, (leaf, stacked) in ref.items():
                _check_leaf(leaf, stacked, port[path])
    # without a mesh: meta tensors of the global shapes
    plain = TSP.batch_specs(get_config("qwen2-1.5b"), LM_SHAPES["train_4k"],
                            None, None)
    assert plain["tokens"].device.type == "meta"
    assert tuple(plain["tokens"].shape) == (256, 4096)


# -- make_step's functions, mesh=None ----------------------------------------------

EPS = 1e-5


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1e-30, np.max(np.abs(want))))


def norm_rel(got, want, base=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = want if base is None else want - np.asarray(base, np.float64)
    return float(np.linalg.norm(got - want) / max(1e-30, np.linalg.norm(scale)))


def _np(x):
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def ref_params(cfg, seed=0):
    p = j_materialize(jax.random.PRNGKey(seed), JM.abstract_params(cfg),
                      dtype_override=jnp.float32)
    return jax.tree.map(np.asarray, p)


def rescale_attention(params, cfg):
    """Every GQA attention leaf rescaled to std 1/sqrt(true fan-in), as
    ``test_torch_train.py`` does (the reference's init is chaotic)."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factors = {"wq": np.sqrt(h / d), "wk": np.sqrt(kv / d),
               "wv": np.sqrt(kv / d), "wo": 1 / np.sqrt(h)}

    def walk(tree):
        for key, sub in tree.items():
            if key == "attn" and "wq" in sub:
                for name, f in factors.items():
                    sub[name] = (sub[name] * f).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(params)
    return params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_make_step_prefill_and_decode_match_reference(arch):
    jcfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(jcfg)
    tp = params_from_reference(params, tcfg, device="cpu")
    b, s, max_len = 2, 20, 32
    toks = _tokens(jcfg, b, s + 1, seed=6)
    jrules, trules = JS.default_rules(), TS.default_rules()
    jpre, _, jd = JST.make_step(jcfg, "prefill_32k", None, jrules)
    tpre, _, td = TST.make_step(tcfg, "prefill_32k", None, trules)
    assert tuple(jd) == td == (2,)
    jdec, _, jd = JST.make_step(jcfg, "decode_32k", None, jrules)
    tdec, targs, td = TST.make_step(tcfg, "decode_32k", None, trules)
    assert tuple(jd) == td == (2,)
    assert int(targs[3]) == LM_SHAPES["decode_32k"].seq_len

    jcache = j_materialize(jax.random.PRNGKey(0),
                           JM.abstract_cache(jcfg, b, max_len),
                           dtype_override=jnp.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jlp, jcache = jpre(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcache)
    jld, jcache = jdec(jp, jnp.asarray(toks[:, s:]), jcache, jnp.int32(s + 1))

    from repro_torch.models import model as TM
    from repro_torch.models.params import materialize

    tcache = materialize(None, TM.abstract_cache(tcfg, b, max_len),
                         dtype_override=torch.float32, device="cpu")
    tt = torch.from_numpy(toks)
    tlp, tcache = tpre(tp, {"tokens": tt[:, :s]}, tcache)
    tld, tcache = tdec(tp, tt[:, s:], tcache, torch.tensor(s + 1))
    assert not tlp.requires_grad
    assert rel(tlp, jlp) < 1e-4 and rel(tld, jld) < 1e-4
    want = cache_from_reference(jax.tree.map(np.asarray, jcache), tcfg, "cpu")
    for a, w in zip(tree_leaves(tcache), tree_leaves(want)):
        assert rel(a, w) < 1e-4


def test_make_step_encoder_prefill_matches_reference():
    jcfg, tcfg = j_reduced("hubert-xlarge"), get_reduced("hubert-xlarge")
    params = ref_params(jcfg)
    tp = params_from_reference(params, tcfg, device="cpu")
    frames = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    jfn, jargs, jd = JST.make_step(jcfg, "prefill_32k", None,
                                   JS.default_rules())
    tfn, targs, td = TST.make_step(tcfg, "prefill_32k", None,
                                   TS.default_rules())
    assert tuple(jd) == td == () and len(targs) == len(jargs) == 2
    want = np.asarray(jfn(jax.tree.map(jnp.asarray, params),
                          {"frames": jnp.asarray(frames)}), np.float32)
    got = tfn(tp, {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert rel(got.float(), want) < 2.0 ** -7


def test_make_step_train_matches_reference():
    jcfg = dataclasses.replace(j_reduced("qwen2-1.5b"), n_layers=3)
    tcfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_layers=3)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=EPS)
    jfn, _, jd = JST.make_step(jcfg, "train_4k", None, JS.default_rules(),
                               ocfg=JOptConfig(**kw))
    tfn, targs, td = TST.make_step(tcfg, "train_4k", None, TS.default_rules(),
                                   ocfg=TOptConfig(**kw))
    assert tuple(jd) == td == (0, 1)
    assert int(targs[3]) == 0
    params = rescale_attention(ref_params(jcfg), jcfg)
    opt = jax.tree.map(np.zeros_like, {"m": params, "v": params})
    rng = np.random.default_rng(0)
    batch = {"tokens": _tokens(jcfg, 4, 64, 1),
             "labels": rng.integers(0, jcfg.vocab_size, (4, 64),
                                    dtype=np.int32)}
    batch["labels"][0, :5] = -1
    jp, jo, jm = jax.jit(jfn)(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, opt),
                              jax.tree.map(jnp.asarray, batch), jnp.int32(0))
    tp, to, tm = tfn(params_from_reference(params, tcfg, "cpu"),
                     opt_state_from_reference(opt, tcfg, "cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     targs[3])
    assert rel(float(tm["loss"]), float(jm["loss"])) < 1e-4
    p0 = tree_leaves(params_from_reference(params, tcfg, "cpu"))
    want = tree_leaves(params_from_reference(jax.tree.map(np.asarray, jp),
                                             tcfg, "cpu"))
    for got, w, base in zip(tree_leaves(tp), want, p0):
        assert norm_rel(_np(got), _np(w), _np(base)) < 1e-4
    wopt = opt_state_from_reference(jax.tree.map(np.asarray, jo), tcfg, "cpu")
    for key in ("m", "v"):
        for got, w in zip(tree_leaves(to[key]), tree_leaves(wopt[key])):
            if float(w.abs().max()) > 0:
                assert norm_rel(_np(got), _np(w)) < 1e-4


# -- roofline terms and collective bytes ---------------------------------------------

def test_roofline_terms_match_reference():
    ref_consts = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    for args in [(197e12, 819e9, 50e9), (1e12, 819e9 * 5, 0),
                 (3e14, 1e9, 2e11)]:
        want = JH.roofline_terms(*args)
        got = TH.roofline_terms(*args, **ref_consts)
        assert got == want
    t = TH.roofline_terms(197e12, 819e9, 50e9, **ref_consts)
    assert abs(t["t_compute_s"] - 1.0) < 1e-9
    assert abs(t["t_memory_s"] - 1.0) < 1e-9
    assert abs(t["t_collective_s"] - 1.0) < 1e-9
    t = TH.roofline_terms(1e12, 819e9 * 5, 0, **ref_consts)
    assert t["bottleneck"] == "memory"
    # the port's own constants: the H100's data sheet
    t = TH.roofline_terms(989e12, 3.35e12, 450e9)
    assert t["t_compute_s"] == t["t_memory_s"] == t["t_collective_s"] == 1.0
    assert t["step_time_bound_s"] == 1.0


def test_collective_bytes_match_the_reference_parser():
    hlo = """
  %ar = bf16[1024,128] all-reduce(%x), replica_groups={}
  %ag.1 = f32[256] all-gather(%y), dimensions={0}
  %rs = (bf16[64,64], bf16[64,64]) reduce-scatter(%a, %b), dimensions={0}
  %cp = u8[32] collective-permute-start(%z)
  %cpd = u8[32] collective-permute-done(%cp)
  %dot = f32[4,4] dot(%p, %q)
"""
    records = [
        ("all-reduce", [((1024, 128), torch.bfloat16)]),
        ("all-gather", [((256,), torch.float32)]),
        ("reduce-scatter", [((64, 64), torch.bfloat16),
                            ((64, 64), torch.bfloat16)]),
        ("collective-permute-start", [((32,), torch.uint8)]),
        ("collective-permute-done", [((32,), torch.uint8)]),
        ("dot", [((4, 4), torch.float32)]),
    ]
    out = TH.collective_bytes(records)
    assert out == JH.collective_bytes(hlo)
    assert out["all-reduce"] == 1024 * 128 * 2
    assert out["all-gather"] == 256 * 4
    assert out["reduce-scatter"] == 2 * 64 * 64 * 2
    assert out["collective-permute"] == 32
    assert "dot" not in out
    # the functional ops DTensor issues, by their schema names, with the
    # result tensors a recording holds
    rec = [("_c10d_functional::all_gather_into_tensor",
            torch.empty(64, 8, device="meta")),
           ("_c10d_functional::wait_tensor", torch.empty(64, 8)),
           ("_c10d_functional::reduce_scatter_tensor", torch.empty(4, 8)),
           ("_c10d_functional_autograd::all_to_all_single",
            torch.empty(16, dtype=torch.bfloat16)),
           ("_c10d_functional::broadcast", torch.empty(2, 2))]
    assert TH.collective_bytes(rec) == {
        "all-gather": 64 * 8 * 4, "reduce-scatter": 4 * 8 * 4,
        "all-to-all": 16 * 2, "broadcast": 2 * 2 * 4}


# -- on a fake process group (subprocesses) ----------------------------------------------

def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable] + args, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def apriori_records():
    lines = _run(["-m", "repro_torch.launch.dryrun", "--apriori",
                  "--device", "cpu"]).strip().splitlines()
    return [json.loads(x) for x in lines]


APRIORI = [  # (pod2, variant, store, flops a device, useful fraction)
    (False, "candrep_bfloat16", "bitmap", 2**53, 0.0625),
    (False, "candshard_bfloat16", "bitmap", 2**49, 1.0),
    (False, "candshard_uint8", "bitmap", 2**49, 1.0),
    (False, "candshard_uint8", "perfect_hash", 0, None),
    (True, "candrep_bfloat16", "bitmap", 2**52, 0.0625),
    (True, "candshard_bfloat16", "bitmap", 2**48, 1.0),
    (True, "candshard_uint8", "bitmap", 2**48, 1.0),
    (True, "candshard_uint8", "perfect_hash", 0, None),
]


@pytest.mark.parametrize("i", range(len(APRIORI)))
def test_apriori_cell_costs_are_exact(apriori_records, i):
    pod2, variant, store, flops, frac = APRIORI[i]
    n, f, c, k = 2**27, 4096, 131_072, 3
    rec = apriori_records[i]
    assert rec["shape"] == f"{store}_N{n}_F{f}_C{c}_{variant}"
    assert rec["multi_pod"] == pod2 and rec["status"] == "ok"
    assert rec["n_chips"] == (512 if pod2 else 256)
    assert rec["flops_per_device"] == flops
    assert rec["useful_flops_fraction"] == frac
    assert rec["model_flops_total"] == 2.0 * n * f * c
    n_local = n // (32 if pod2 else 16)
    c_local = c if "candrep" in variant else c // 16
    b = 1 if variant.endswith("uint8") else 2
    if store == "bitmap":
        args = n_local * f * b + c_local * f * 2 + c_local * 4
    else:
        args = n_local * f * b + c_local * k * 4
    assert rec["memory"]["argument_bytes"] == args
    if not pod2 and variant == "candshard_uint8" and store == "bitmap":
        assert n_local * f * b == 2**35
    # the per-candidate counts are summed over the data axes: one
    # all-reduce of this rank's int32 counts a data axis
    assert rec["collective_bytes_per_device"] == {
        "all-reduce": c_local * 4 * (2 if pod2 else 1)}
    assert rec["memory"]["output_bytes"] == c_local * 4
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "step_time_bound_s", "compile_s", "bytes_per_device"):
        assert key in rec


_ROW_PARALLEL = """
import json, torch
from torch.distributed.tensor import Replicate
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import mesh_of_ranks
from repro_torch.models.params import ShapeStruct, local_shape
D._fake_world(4, "cpu")
mesh = mesh_of_ranks(range(4), (2, 2), ("data", "model"), "cpu")
B, K, F = 8, 64, 32

def sds(shape, pspec):
    return ShapeStruct(torch.empty(shape, device="meta"), pspec, torch.empty(
        local_shape(shape, pspec, mesh), device="meta"))

def step(x, w):  # row-parallel: K split over model, a pending sum
    return (x @ w).redistribute(mesh, [Replicate(), Replicate()])

m = D._measure(step, (sds((B, K), (None, "model")),
                      sds((K, F), ("model", None))), (), mesh)
print(json.dumps({"coll": m["coll"], "flops": m["flops"],
                  "memory": m["memory"]}))
"""


def test_row_parallel_all_reduce_bytes():
    out = json.loads(_run(["-c", _ROW_PARALLEL]).strip().splitlines()[-1])
    b, k, f = 8, 64, 32
    assert out["coll"] == {"all-reduce": b * f * 4}
    assert out["flops"] == 2 * b * (k // 2) * f
    assert out["memory"]["argument_bytes"] == (b * k // 2 + k // 2 * f) * 4
    assert out["memory"]["output_bytes"] == b * f * 4


# -- the probes' fit ------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen2-1.5b", "train_4k"),
                                        ("gemma2-2b", "prefill_32k")])
def test_probe_costs_equal_the_full_depth_count(arch, shape):
    """On a reduced config (no mesh, fake tensors on the CPU): the fit from
    the 1- and 2-period probes equals the count of the whole stack run at
    the probes' settings (layers unrolled, ``probe_chunk`` tiles)."""
    sh = LM_SHAPES[shape]
    cfg = get_reduced(arch)
    p = max(1, len(TT.plan(cfg).pattern))
    cfg = dataclasses.replace(cfg, n_layers=4 * p)
    probe = TD._probe_costs(cfg, shape, None, TS.default_rules(), sh,
                            device="cpu")
    full_cfg = dataclasses.replace(cfg, scan_layers=False, unroll_loops=True,
                                   attn_chunk=probe["probe_chunk"])
    full = TD._measure(*TST.make_step(full_cfg, shape, None,
                                      TS.default_rules()), None, "cpu")
    assert probe["flops"] == full["flops"] > 0
    assert probe["bytes"] == full["bytes"] > 0
    assert probe["coll"] == {} == full["coll"]


# -- the dry run against a real step on one rank ------------------------------------------

_ONE_RANK = """
import dataclasses, json, sys
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models import params as P
cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_layers=3)
order, place = [], P.place
P.place = lambda *a, **k: order.append("place") or place(*a, **k)
rec = D.one_rank_check(cfg, 2, 64, device="cpu", steps=1,
                       ready=lambda: order.append("ready"))
print(json.dumps(dict(rec, order=order)))
"""


def test_one_rank_prediction_equals_the_real_step():
    """``chip_smoke.py`` phase 13 (c)'s holds on the CPU: on a (1, 1) mesh
    the dry run's flops equal ``FlopCounterMode`` over the real step and
    its argument bytes the placed tensors' bytes, exactly; ``ready`` is
    called once, before anything is placed (phase 13 (c) waits there for
    the card)."""
    out = json.loads(_run(["-c", _ONE_RANK]).strip().splitlines()[-1])
    assert out["order"][0] == "ready" and out["order"].count("ready") == 1
    assert "place" in out["order"]
    assert out["predicted_flops"] == out["flops"] > 0
    assert out["predicted_argument_bytes"] == out["placed_bytes"] > 0
    assert out["predicted_peak_bytes"] >= out["placed_bytes"]
    assert len(out["step_ms"]) == 1
