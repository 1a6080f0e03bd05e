"""PyTorch port vs JAX package: the LM's logical-axis sharding.

* ``logical_to_pspec`` gives the reference's spec for every parameter and
  cache leaf of all ten configs at full width, on stand-in meshes
  (``StandInMesh``: only the axis sizes are read) of {data 16, model 16},
  {pod 2, data 16, model 16} and {data 2, model 2}, under the default
  rules, ``fsdp=False`` and ``context_parallel=True``.  The port holds one
  tree per layer where the reference stacks the scanned layers: a port
  leaf's spec is the stacked leaf's without its leading ``layers`` entry.
* The rules table, ``batch_pspec``/``act_pspec``, ``placements``,
  ``shape_structs`` and ``elastic_mesh``'s grid.
* ``constrain`` outside ``use_sharding`` returns its argument itself.
* The c10d stand-in for the functional all-gather: registered only when a
  gloo group over CUDA tensors is made, and routing other backends' groups
  to the op's own kernel.
* The entry points on a one-rank ``data x model`` mesh in this process
  (every placement replicates, so the sharded path must give the
  single-device numbers): ``ServeEngine(mesh=, rules=)``,
  ``Trainer(mesh=, rules=)`` and ``restore(shardings=)``.  The multi-rank
  worlds are in ``test_torch_lm_sharding_worlds.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import logical_to_pspec as j_pspec  # noqa: E402

from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.distributed.elastic import elastic_grid  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ShapeStruct, StandInMesh, logical_to_pspec, materialize, placements,
    shape_structs, shardings, tree_leaves)
from repro_torch.serve.lm import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


MESHES = {
    "data16_model16": dict(data=16, model=16),
    "pod2_data16_model16": dict(pod=2, data=16, model=16),
    "data2_model2": dict(data=2, model=2),
}
VARIANTS = {"default": {}, "no_fsdp": {"fsdp": False},
            "context_parallel": {"context_parallel": True}}


def _rules(mesh_name, variant):
    multi_pod = "pod" in MESHES[mesh_name]
    kw = VARIANTS[variant]
    return (JS.default_rules(multi_pod, **kw).rules,
            TS.default_rules(multi_pod, **kw).rules)


def _specs(tree):
    """{path: spec} of an abstract tree (either package's ParamSpec)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            out[path] = t

    walk(tree, ())
    return out


def _unstacked(ref_blocks, cfg):
    """The reference's head/scan/tail block specs as {port path: (spec,
    stacked)}, in the port's layer numbering."""
    pl = TT.plan(cfg)
    n_head, p = len(pl.head), len(pl.pattern)
    out = {}
    for part, index in (("head", lambda i: i),
                        ("tail", lambda i: n_head + pl.n_super * p + i)):
        for i, sub in ref_blocks[part].items():
            for path, s in _specs(sub).items():
                out[(str(index(int(i))),) + path] = (s, False)
    for j, sub in ref_blocks["scan"].items():
        for u in range(pl.n_super):
            for path, s in _specs(sub).items():
                out[(str(n_head + u * p + int(j)),) + path] = (s, True)
    return out


def _pairs(ref_tree, port_tree, cfg):
    """(reference spec, stacked, port spec) for every port leaf.  A
    parameter tree holds its stack under ``blocks``; a cache tree is one."""
    if "blocks" not in ref_tree:
        ref = _unstacked(ref_tree, cfg)
    else:
        ref = {("blocks",) + k: v
               for k, v in _unstacked(ref_tree["blocks"], cfg).items()}
        ref.update({k: (s, False) for k, s in _specs(
            {k: v for k, v in ref_tree.items() if k != "blocks"}).items()})
    port = _specs(port_tree)
    assert sorted(ref) == sorted(port)
    return [(ref[k][0], ref[k][1], port[k]) for k in sorted(port)]


def _check_tree(ref_tree, port_tree, cfg, jrules, trules, mesh):
    for rs, stacked, ts in _pairs(ref_tree, port_tree, cfg):
        want = tuple(j_pspec(rs.axes, jrules, rs.shape, mesh))
        got = logical_to_pspec(ts.axes, trules, ts.shape, mesh)
        if stacked:
            assert rs.axes[0] == "layers" and want[0] is None
            want = want[1:]
        assert got == want, (ts.axes, ts.shape)
        # without a mesh: no divisibility fallback, as in the reference
        want = tuple(j_pspec(rs.axes, jrules))
        assert logical_to_pspec(ts.axes, trules) == (
            want[1:] if stacked else want)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_pspec_matches_reference(arch, mesh_name, variant):
    jcfg, tcfg = j_config(arch), get_config(arch)
    mesh = StandInMesh(MESHES[mesh_name].values(), MESHES[mesh_name])
    jrules, trules = _rules(mesh_name, variant)
    _check_tree(JM.abstract_params(jcfg), TM.abstract_params(tcfg), tcfg,
                jrules, trules, mesh)
    if tcfg.frontend != "audio_frames":  # the encoder serves no cache
        b = 2 * mesh.shape["data"] * mesh.shape.get("pod", 1)
        _check_tree(JM.abstract_cache(jcfg, b, 4096),
                    TM.abstract_cache(tcfg, b, 4096), tcfg, jrules, trules,
                    mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_and_activation_specs_match_reference(multi_pod):
    for kw in VARIANTS.values():
        j = JS.default_rules(multi_pod, **kw)
        t = TS.default_rules(multi_pod, **kw)
        assert t.rules == j.rules
        assert TS.batch_pspec(t) == tuple(JS.batch_pspec(j))
        for axes in [("batch", None, "vocab"), ("batch", "seq", "heads"),
                     ("experts", "batch", None, None)]:
            assert TS.act_pspec(t, *axes) == tuple(JS.act_pspec(j, *axes))
        over = t.with_overrides(batch=None, mlp=None)
        assert over.rules["batch"] is None and t.rules["batch"] is not None
        assert over.pspec(("batch", "mlp")) == tuple(
            j.with_overrides(batch=None, mlp=None).pspec(("batch", "mlp")))


def test_placements_and_shape_structs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandInMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # a mesh axis of size 1 replicates
    one_two = StandInMesh((1, 2), ("data", "model"))
    assert placements(("data", "model"), one_two) == (Replicate(), Shard(1))

    cfg = get_config("qwen2-1.5b")
    abstract = TM.abstract_params(cfg)
    rules = TS.default_rules().rules
    two = StandInMesh((16, 16), ("data", "model"))
    plain = shape_structs(abstract)
    assert plain["embed"]["table"].device.type == "meta"
    assert tuple(plain["embed"]["table"].shape) == (151_936, 1536)
    placed = shape_structs(abstract, two, rules,
                           dtype_override=torch.float32)
    table = placed["embed"]["table"]
    assert isinstance(table, ShapeStruct)
    assert table.pspec == ("model", "data") and table.dtype == torch.float32
    assert tuple(table.local.shape) == (151_936 // 16, 1536 // 16)
    # 2 kv heads do not divide a 16-way model axis: replicated there
    wk = placed["blocks"]["0"]["attn"]["wk"]
    assert wk.pspec == ("data", None, None)
    assert tuple(wk.local.shape) == (1536 // 16, 2, 128)
    sh = shardings(abstract, two, rules)
    assert sh["blocks"]["0"]["mlp"]["w_up"] == (Shard(0), Shard(1))
    # every leaf's shards tile it: local numel x shard count == numel
    for s in tree_leaves(placed):
        n = 1
        for entry in s.pspec:
            for a in () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry):
                n *= two.shape[a]
        assert s.local.numel() * n == s.global_.numel()


@pytest.mark.parametrize("n,model_axis,want", [
    (256, 16, (16, 16)), (240, 16, (15, 16)), (200, 16, (25, 8)),
    (7, 16, (7, 1)), (8, 2, (4, 2)), (6, 4, (3, 2)), (1, 16, (1, 1))])
def test_elastic_grid_keeps_model_axis(n, model_axis, want):
    """The reference's rule: the model axis stays, data parallelism goes;
    a model axis that does not divide the survivors halves."""
    assert elastic_grid(n, model_axis) == want


def test_constrain_outside_use_sharding_is_identity():
    x = torch.randn(2, 3, 4)
    assert ctx.constrain(x, "batch", None, "mlp") is x
    assert ctx.active_sharding() is None


@pytest.mark.parametrize("backend,device,registers", [
    ("nccl", "cuda", False), ("gloo", "cpu", False), ("gloo", "cuda", True)])
def test_gloo_cuda_all_gather_registered_only_by_a_gloo_cuda_process(
        monkeypatch, backend, device, registers):
    """The c10d stand-in for the functional all-gather is registered when a
    gloo group over CUDA tensors is made, and only then: an NCCL or CPU
    process keeps the op's own kernel (the group's init is recorded, not
    made, so no card is needed)."""
    import torch.distributed as dist

    from repro_torch.core.runtime import engine

    made, registered = [], []
    monkeypatch.setattr(engine, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: made.append(kw["backend"]))
    monkeypatch.setattr(ctx, "_gloo_cuda_all_gather",
                        lambda: registered.append(True))
    ctx.init_group("127.0.0.1:1", 1, 0, device=device, backend=backend)
    assert made == [backend]
    assert registered == ([True] if registers else [])


# -- the entry points on a one-rank mesh ---------------------------------------

@pytest.fixture
def host_mesh():
    """A one-rank gloo group and its ``data x model`` mesh
    (``make_host_mesh``), torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    yield mesh
    dist.destroy_process_group()


def test_serve_engine_on_a_mesh_equals_single_device(host_mesh):
    cfg = get_reduced("qwen2-1.5b")
    gen = torch.Generator().manual_seed(0)
    params = materialize(gen, TM.abstract_params(cfg),
                         dtype_override=torch.float32, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = ServeEngine(cfg, params, max_len=16, device="cpu").generate(
        prompts, 6)
    eng = ServeEngine(cfg, params, max_len=16, mesh=host_mesh,
                      rules=TS.default_rules(), device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)


def test_trainer_on_a_mesh_resumes_and_restores(tmp_path, host_mesh):
    from torch.distributed.tensor import DTensor

    cfg = get_reduced("qwen2-1.5b")
    pipe = SyntheticLM(cfg.vocab_size, 2, 16, seed=1)
    ocfg = OptConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    rules = TS.default_rules()

    def make(mesh, steps, d):
        return Trainer(cfg, ocfg, TrainerConfig(
            total_steps=steps, ckpt_every=1, ckpt_dir=d), pipe.iterator,
            mesh=mesh, rules=None if mesh is None else rules, device="cpu")

    plain = make(None, 2, str(tmp_path / "plain"))
    plain.run()
    d = str(tmp_path / "mesh")
    placed = make(host_mesh, 2, d)
    assert all(isinstance(p, DTensor) for p in tree_leaves(placed.params))
    placed.run()
    for a, b in zip(tree_leaves(placed.params), tree_leaves(plain.params)):
        torch.testing.assert_close(a.full_tensor().detach(), b.detach(),
                                   rtol=1e-5, atol=1e-6)
    # resume onto the mesh: the snapshot's values, bit for bit, armed
    again = make(host_mesh, 2, d)
    assert again.try_restore() and again.step == 2
    snap, _, _ = ckpt.restore(d, plain._state_tree(), device="cpu")
    for a, b in zip(tree_leaves(again._state_tree()), tree_leaves(snap)):
        assert isinstance(a, DTensor)
        assert torch.equal(a.full_tensor().detach(), b)
    assert all(p.requires_grad for p in tree_leaves(again.params))
    # restore(shardings=) needs the mesh
    with pytest.raises(ValueError, match="needs the mesh"):
        ckpt.restore(d, plain._state_tree(), device="cpu",
                     shardings=again.placements)


def test_all_gather_stand_in_routes_by_backend(host_mesh, monkeypatch):
    """The registered kernel gathers a gloo group by the c10d call and
    hands a group of any other backend to the op's own kernel; the CPU
    process here registered nothing."""
    import torch.distributed as dist
    from torch.distributed._functional_collectives import wait_tensor

    assert ctx._ALL_GATHER_LIB is None
    name = host_mesh.get_group(0).group_name
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(ctx._all_gather_into_tensor(x, 1, name), x)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert torch.equal(wait_tensor(ctx._all_gather_into_tensor(x, 1, name)), x)
