"""PyTorch port vs JAX package: the mixers beyond dense attention (RG-LRU,
Mamba-2 SSD, MoE, MLA, gated cross-attention), one layer at a time, on the
same numpy-seeded inputs and parameters.

Every parameter leaf, biases, gates and float32 scales included, is drawn
from a seeded normal (std 1/sqrt(fan-in) for matrices), so no zero-init
leaf hides a path: the cross layer's ``attn_gate`` is non-zero.

Tolerances (relative max error, max |a - b| / max |b|), float32 on both
sides, where only the summation order differs:
- each mixer's output, state and cache: < 1e-4;
- gradients (SSD and RG-LRU under autograd against ``jax.grad``): < 1e-4,
  and every one finite (the SSD decay matrix masks with -inf);
- the MoE aux loss: < 1e-5; its dispatch tensor (which token lands in
  which expert slot, and which are dropped): exactly equal; the
  renormalised combine weights: < 1e-6.
- bfloat16 MLA decode (scores summed in the cache dtype, then cast):
  < 3e-2, the bfloat16 bound of ``test_torch_lm.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.params import is_spec  # noqa: E402
from repro.models.params import materialize as j_materialize  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.params import materialize, tree_leaves  # noqa: E402


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1e-9, np.max(np.abs(want))))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def rand_tree(abstract, seed):
    """A numpy float32 tree shaped like a reference abstract tree: every
    leaf normal, std 1/sqrt(shape[-2]) for matrices, 0.5 otherwise."""
    rng = np.random.default_rng(seed)

    def one(s):
        std = 1 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree.map(one, abstract, is_leaf=is_spec)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(t, tree)


def jit(fn, **static):
    """``fn`` jitted with its keyword arguments fixed (a config is static):
    eager JAX dispatches the scans op by op, ten times slower here."""
    return jax.jit(lambda *a, **kw: fn(*a, **kw, **static))


def x_of(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- RG-LRU ----------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 100])
def test_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    log_a = -np.abs(rng.standard_normal((2, s, 8))).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    _, want = jax.jit(lambda la, bb: jax.lax.associative_scan(
        lambda l, r: (l[0] + r[0], l[1] * jnp.exp(r[0]) + r[1]),
        (la, bb), axis=1))(jnp.asarray(log_a), jnp.asarray(b))
    assert rel(TR.scan(t(log_a), t(b)), want) < 1e-5


def test_rglru_layer_and_decode_match_reference():
    cfg, tcfg = j_reduced("recurrentgemma-2b"), get_reduced("recurrentgemma-2b")
    p = rand_tree(JR.rglru_abstract(cfg), 0)
    x = x_of((2, 37, cfg.d_model))
    got = TR.rglru_layer(to_torch(p), t(x), tcfg)
    assert rel(got, jit(JR.rglru_layer, cfg=cfg)(to_jax(p), jnp.asarray(x))) < 1e-4
    cache = rand_tree(JR.rglru_decode_state_abstract(cfg, 2), 2)
    want, wc = jit(JR.rglru_decode, cfg=cfg)(to_jax(p), jnp.asarray(x[:, :1]),
                                             to_jax(cache))
    got, gc = TR.rglru_decode(to_torch(p), t(x[:, :1]), to_torch(cache), tcfg)
    assert rel(got, want) < 1e-4
    for k in ("h", "conv_buf"):
        assert rel(gc[k], wc[k]) < 1e-4


def _grads_match(j_fn, t_fn, p, x):
    """jax.grad vs autograd of sum(out * w) for a fixed random w."""
    w = x_of(x.shape, seed=9)  # each mixer maps (B, S, D) to (B, S, D)
    jg = jax.jit(jax.grad(lambda pp, xx: jnp.sum(j_fn(pp, xx) * w),
                          argnums=(0, 1)))(to_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in to_torch(p).items()}
    tx = t(x).requires_grad_(True)
    leaves = [tp[k] for k in sorted(tp)] + [tx]
    tg = torch.autograd.grad((t_fn(tp, tx) * t(w)).sum(), leaves)
    want = [jg[0][k] for k in sorted(tp)] + [jg[1]]
    for g, wg in zip(tg, want):
        assert bool(torch.isfinite(g).all())
        assert rel(g, wg) < 1e-4


def test_rglru_gradients_match_reference():
    cfg, tcfg = j_reduced("recurrentgemma-2b"), get_reduced("recurrentgemma-2b")
    p = rand_tree(JR.rglru_abstract(cfg), 3)
    _grads_match(lambda pp, xx: JR.rglru_layer(pp, xx, cfg),
                 lambda pp, xx: TR.rglru_layer(pp, xx, tcfg), p,
                 x_of((2, 19, cfg.d_model)))


# -- SSD -----------------------------------------------------------------------

def _ssd_cfgs(chunk):
    cfg, tcfg = j_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    return (dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk)),
            dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=chunk)))


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("s", [45, 64])
def test_ssd_layer_matches_reference(chunk, s):
    """45 is no multiple of any chunk (right-padded, then cut back); at
    chunk 64 it is one short chunk."""
    cfg, tcfg = _ssd_cfgs(chunk)
    p = rand_tree(JS.ssd_abstract(cfg), chunk)
    x = x_of((2, s, cfg.d_model))
    got = TS.ssd_layer(to_torch(p), t(x), tcfg)
    assert got.shape == (2, s, cfg.d_model)
    assert rel(got, jit(JS.ssd_layer, cfg=cfg)(to_jax(p), jnp.asarray(x))) < 1e-4
    # The final state of the same pass equals the reference's separate one.
    _, state, _ = TS.ssd_scan(to_torch(p), t(x), tcfg)
    want = jit(JB._ssd_final_state, cfg=cfg)(to_jax(p), jnp.asarray(x))
    assert rel(state, want) < 1e-4


def test_ssd_decode_matches_reference():
    cfg, tcfg = _ssd_cfgs(16)
    p = rand_tree(JS.ssd_abstract(cfg), 4)
    cache = rand_tree(JS.ssd_decode_state_abstract(cfg, 2), 5)
    x = x_of((2, 1, cfg.d_model))
    want, wc = jit(JS.ssd_decode, cfg=cfg)(to_jax(p), jnp.asarray(x),
                                           to_jax(cache))
    got, gc = TS.ssd_decode(to_torch(p), t(x), to_torch(cache), tcfg)
    assert rel(got, want) < 1e-4
    for k in ("state", "conv_buf"):
        assert rel(gc[k], wc[k]) < 1e-4


def test_ssd_gradients_finite_and_match_reference():
    cfg, tcfg = _ssd_cfgs(8)
    p = rand_tree(JS.ssd_abstract(cfg), 6)
    _grads_match(lambda pp, xx: JS.ssd_layer(pp, xx, cfg),
                 lambda pp, xx: TS.ssd_layer(pp, xx, tcfg), p,
                 x_of((2, 21, cfg.d_model)))


# -- MoE -----------------------------------------------------------------------

def _ref_moe_with_routing(p, x, cfg, monkeypatch):
    """The reference's (out, aux, dispatch, combine): its ``constrain``
    calls see the routing tensors, which are recorded on the way."""
    seen = []

    def record(a, *names):
        if names == ("batch", None, "experts", None):
            seen.append(a)
        return a

    def run(pp, xx):
        out, aux = JMoE.moe_layer(pp, xx, cfg)
        return out, aux, seen[0], seen[1]

    monkeypatch.setattr(JMoE, "constrain", record)
    out, aux, dispatch, combine = jax.jit(run)(to_jax(p), jnp.asarray(x))
    return (np.asarray(out), float(aux), np.asarray(dispatch, np.float32),
            np.asarray(combine))


@pytest.mark.parametrize("arch,cf,group,drops", [
    ("deepseek-v3-671b", 64.0, 64, False),   # no token dropped
    ("deepseek-v3-671b", 1.0, 64, True),     # capacity 8 for 64 x top-2 slots
    ("kimi-k2-1t-a32b", 0.5, 64, True),
    ("deepseek-v3-671b", 0.25, 40, True),    # 90 tokens: groups of 30
])
def test_moe_layer_matches_reference(arch, cf, group, drops, monkeypatch):
    moe = dataclasses.replace(j_reduced(arch).moe, capacity_factor=cf,
                              group_size=group)
    cfg = dataclasses.replace(j_reduced(arch), moe=moe)
    tcfg = dataclasses.replace(get_reduced(arch), moe=dataclasses.replace(
        get_reduced(arch).moe, capacity_factor=cf, group_size=group))
    p = rand_tree(JMoE.moe_abstract(cfg), 7)
    b, s = (2, 45) if group == 40 else (2, 32)
    x = x_of((b, s, cfg.d_model))
    want, want_aux, j_dispatch, j_combine = _ref_moe_with_routing(p, x, cfg,
                                                                  monkeypatch)
    tp = to_torch(p)
    got, aux = TMoE.moe_layer(tp, t(x), tcfg)
    assert rel(got, want) < 1e-4
    assert abs(float(aux) - want_aux) <= 1e-5 * abs(want_aux)
    # The routing itself: the same slots, the same drops, the same gates.
    tokens = b * s
    xg = TMoE.group(t(x), tcfg)
    assert xg.shape[1] == (30 if group == 40 else min(group, tokens))
    dispatch, combine = TMoE.route(TMoE.router_probs(tp, xg), moe.top_k,
                                   TMoE._capacity(xg.shape[1], tcfg),
                                   torch.float32)
    np.testing.assert_array_equal(dispatch.numpy(), j_dispatch)
    assert rel(combine, j_combine) < 1e-6
    kept = dispatch.sum(dim=(2, 3)).reshape(-1)         # slots kept a token
    dropped = kept < moe.top_k
    assert bool(dropped.any()) == drops
    if drops:  # the dropped tokens' outputs, on their own
        rows = dropped.numpy()
        assert rel(got.reshape(tokens, -1)[rows], want.reshape(tokens, -1)[rows]) < 1e-4
        # Their kept gates are renormalised to sum 1 (or all dropped: 0).
        sums = combine.sum(dim=(2, 3)).reshape(-1)[dropped]
        assert all(abs(float(v) - 1) < 1e-6 or float(v) == 0 for v in sums)


# -- MLA -----------------------------------------------------------------------

def test_mla_attention_and_decode_match_reference():
    cfg, tcfg = j_reduced("deepseek-v3-671b"), get_reduced("deepseek-v3-671b")
    p = rand_tree(JA.mla_abstract(cfg), 8)
    b, s, t_len = 2, 24, 32
    x = x_of((b, s + 1, cfg.d_model))
    pos = np.tile(np.arange(s + 1), (b, 1))
    for chunk in (8, 1024):
        want = jit(JA.mla_attention, cfg=cfg, q_chunk=chunk, kv_chunk=chunk)(
            to_jax(p), jnp.asarray(x), jnp.asarray(pos))
        got = TA.mla_attention(to_torch(p), t(x), torch.from_numpy(pos), tcfg,
                               q_chunk=chunk, kv_chunk=chunk)
        assert rel(got, want) < 1e-4
    m = cfg.mla
    caches = {"c": x_of((b, t_len, m.kv_lora_rank), 10),
              "krope": x_of((b, t_len, m.rope_head_dim), 11)}
    dpos = np.full((b, 1), s)
    want, wc, wk = jit(JA.mla_decode, cfg=cfg)(
        to_jax(p), jnp.asarray(x[:, s:]), jnp.asarray(caches["c"]),
        jnp.asarray(caches["krope"]), jnp.int32(s + 1), jnp.asarray(dpos))
    got, gc, gk = TA.mla_decode(to_torch(p), t(x[:, s:]), t(caches["c"]),
                                t(caches["krope"]), s + 1,
                                torch.from_numpy(dpos), tcfg)
    assert rel(got, want) < 1e-4
    assert rel(gc, wc) < 1e-4 and rel(gk, wk) < 1e-4


def test_mla_decode_bf16_matches_reference():
    cfg, tcfg = j_reduced("deepseek-v3-671b"), get_reduced("deepseek-v3-671b")
    p = rand_tree(JA.mla_abstract(cfg), 12)
    b, s = 2, 20
    m = cfg.mla
    x = x_of((b, 1, cfg.d_model))
    c, kr = x_of((b, 32, m.kv_lora_rank), 13), x_of((b, 32, m.rope_head_dim), 14)
    jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tb = jax.tree.map(lambda a: t(a).to(torch.bfloat16), p)
    for key in ("q_norm", "kv_norm"):  # float32 leaves, as in the spec
        jb[key], tb[key] = jnp.asarray(p[key]), t(p[key])
    dpos = np.full((b, 1), s)
    want, _, _ = jit(JA.mla_decode, cfg=cfg)(
        jb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
        jnp.asarray(kr, jnp.bfloat16), jnp.int32(s + 1), jnp.asarray(dpos))
    got, _, _ = TA.mla_decode(tb, t(x).to(torch.bfloat16),
                              t(c).to(torch.bfloat16), t(kr).to(torch.bfloat16),
                              s + 1, torch.from_numpy(dpos), tcfg)
    assert got.dtype == torch.bfloat16
    assert rel(got.float(), np.asarray(want, np.float32)) < 3e-2


# -- one layer of each kind through blocks ---------------------------------------

@pytest.mark.parametrize("arch,layer", [
    ("recurrentgemma-2b", 0),       # rglru + mlp (tanh gelu)
    ("mamba2-2.7b", 0),             # ssd, channel "none"
    ("deepseek-v3-671b", 0),        # mla + dense_head
    ("deepseek-v3-671b", 1),        # mla + moe
    ("kimi-k2-1t-a32b", 1),         # attn + moe
    ("llama-3.2-vision-11b", 3),    # cross, gate non-zero
])
def test_layer_apply_prefill_decode_match_reference(arch, layer):
    """``layer_apply`` (with the MoE aux), ``layer_prefill`` (output and
    cache) and one ``layer_decode`` step, against the reference's."""
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    temporal, channel = JB.layer_kinds(cfg)[layer]
    assert TB.layer_kinds(tcfg)[layer] == (temporal, channel)
    lp = rand_tree(JB.layer_abstract(cfg, temporal, channel), layer + 20)
    if temporal == "cross":
        assert float(lp["attn_gate"]) != 0.0
    b, s, max_len = 2, 13, 16
    x = x_of((b, s + 1, cfg.d_model), 15)
    vis = x_of((b, cfg.n_vis_tokens, cfg.d_model), 16)
    pos = np.tile(np.arange(s + 1), (b, 1))
    kw = {"vis_embeds": vis} if temporal == "cross" else {}
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: t(v) for k, v in kw.items()}
    jlp, tlp = to_jax(lp), to_torch(lp)

    kinds = dict(temporal=temporal, channel=channel, cfg=cfg)
    jy, jaux = jit(JB.layer_apply, **kinds)(jlp, jnp.asarray(x),
                                            positions=jnp.asarray(pos), **jkw)
    ty, taux = TB.layer_apply(tlp, t(x), temporal, channel, tcfg,
                              positions=torch.from_numpy(pos), **tkw)
    assert rel(ty, jy) < 1e-4
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))
    assert (float(jaux) != 0.0) == (channel == "moe")

    jc = j_materialize(jax.random.PRNGKey(0),
                       JB.cache_abstract(cfg, temporal, b, max_len),
                       dtype_override=jnp.float32)
    tc = materialize(None, TB.cache_abstract(tcfg, temporal, b, max_len),
                     dtype_override=torch.float32, device="cpu")
    jx, jc = jit(JB.layer_prefill, **kinds)(
        jlp, jnp.asarray(x[:, :s]), positions=jnp.asarray(pos[:, :s]),
        cache=jc, **jkw)
    tx, tc = TB.layer_prefill(tlp, t(x[:, :s]), temporal, channel, tcfg,
                              positions=torch.from_numpy(pos[:, :s]), cache=tc,
                              **tkw)
    assert rel(tx, jx) < 1e-4
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and rel(tc[k], jc[k]) < 1e-4

    jx, jc = jit(JB.layer_decode, **kinds)(
        jlp, jnp.asarray(x[:, s:]), cache=jc, cache_len=jnp.int32(s + 1),
        positions=jnp.asarray(pos[:, s:]))
    tx, tc = TB.layer_decode(tlp, t(x[:, s:]), temporal, channel, tcfg,
                             cache=tc, cache_len=s + 1,
                             positions=torch.from_numpy(pos[:, s:]))
    assert rel(tx, jx) < 1e-4
    for k in jc:
        assert rel(tc[k], jc[k]) < 1e-4


def test_scalar_leaves_materialize_and_count():
    """The cross layer's ``attn_gate`` is a float32 scalar: materialized as
    a 0-d zero, counted as one parameter."""
    tcfg = get_reduced("llama-3.2-vision-11b")
    tree = TB.layer_abstract(tcfg, "cross", "mlp")
    lp = materialize(torch.Generator().manual_seed(0), tree)
    assert lp["attn_gate"].shape == () and lp["attn_gate"].dtype == torch.float32
    assert float(lp["attn_gate"]) == 0.0
    ref = JB.layer_abstract(j_reduced("llama-3.2-vision-11b"), "cross", "mlp")
    n_ref = sum(int(np.prod(s.shape)) if s.shape else 1
                for s in jax.tree.leaves(ref, is_leaf=is_spec))
    assert sum(x.numel() for x in tree_leaves(lp)) == n_ref
