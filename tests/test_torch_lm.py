"""PyTorch port vs JAX package: the dense LM's layers, attention, blocks,
model API and ``ServeEngine`` on the same numpy-seeded inputs, with the
reference's parameters carried across by ``params_from_reference``.

Tolerances (relative max error, max |a - b| / max |b|):
- float32 (``dtype_override``): < 1e-4.  Both sides compute in float32;
  what differs is the summation order of the products.
- bfloat16, one layer (prefill output and cache, one decode step): < 3e-2.
  Both sides round to bfloat16 (2**-8 relative) after each product, but
  XLA computes fused elementwise chains (silu * gate, the rope and norm
  casts) in float32 where torch rounds between ops; the largest seen was
  7e-3, two roundings of the largest value.
- bfloat16, whole model: the reference's init (``fan_in = shape[-2]``, so
  ``wq`` has std 1/sqrt(n_heads)) makes the reduced models' softmaxes so
  peaked that one-rounding differences grow through the layers: the
  reference's own bfloat16 logits lie 4-53 % (max error) from a float32 run
  of the same bfloat16 weights, and the port's 1-21 % from the
  reference's.  So the test holds the port's bfloat16 logits to that
  float32 run: their mean error may be at most twice the reference's (the
  ratio seen over four seeds was 0.69-1.68).
- bfloat16, the model's last part (final_norm, then the logits) on one
  carried-over hidden state: < 3e-2, and without the softcap every logit is
  a bfloat16 value, as the reference's (the product runs in bfloat16).
- The port's own prefill + decode against its full forward: < 1e-3 in
  float32, the reference's own check (``tests/test_archs.py``).  At the
  published depth this holds only with the attention rescaled (see
  ``test_full_depth_stack_with_rescaled_attention``).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import materialize as j_materialize  # noqa: E402
from repro.serve.lm import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import LM, cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import materialize, tree_leaves  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DENSE = ["qwen2-1.5b", "gemma2-2b", "phi3-medium-14b", "starcoder2-15b"]


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1e-9, np.max(np.abs(want))))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def ref_params(cfg, dtype=jnp.float32, seed=0):
    """The reference's seeded parameters, as numpy (for both sides)."""
    p = j_materialize(jax.random.PRNGKey(seed), JM.abstract_params(cfg),
                      dtype_override=dtype)
    return jax.tree.map(np.asarray, p)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(t, tree)


# -- layers --------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    got = TL.rmsnorm({"scale": t(scale)}, t(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert rel(got, want) < 1e-4
    pos = np.broadcast_to(np.arange(16), (2, 16)) + 5
    for theta in (10_000.0, 500_000.0):
        got = TL.rope(t(x), t(pos), theta)
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        assert rel(got, want) < 1e-4


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-15b"])
def test_mlp_gated_silu_and_plain_gelu_with_bias(arch):
    cfg = j_reduced(arch)  # qwen2: gated silu; starcoder2: tanh gelu + bias
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in JL.mlp_abstract(cfg).items()}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    got = TL.mlp({k: t(v) for k, v in p.items()}, t(x), get_reduced(arch))
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg)
    assert rel(got, want) < 1e-4
    assert ("b_up" in p) == (arch == "starcoder2-15b")


# -- attention -----------------------------------------------------------------

def _qkv(rng, b=2, s=128, h=8, kv=2, d=32, t_len=None):
    t_len = t_len or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t_len, kv, d)).astype(np.float32),
            rng.standard_normal((b, t_len, kv, d)).astype(np.float32))


@pytest.mark.parametrize("kwargs", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=40),
    dict(causal=True, softcap=20.0),
    dict(causal=True, window=56, softcap=50.0),
])
@pytest.mark.parametrize("chunks", [(32, 32), (64, 16), (128, 128), (48, 40)])
def test_flash_attention_matches_reference(kwargs, chunks):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    got = TA.flash_attention(t(q), t(k), t(v), q_chunk=chunks[0],
                             kv_chunk=chunks[1], **kwargs)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_chunk=chunks[0], kv_chunk=chunks[1], **kwargs)
    assert got.dtype == torch.float32
    assert rel(got, want) < 1e-4


@pytest.mark.parametrize("kv,q_offset", [(1, 0), (4, 0), (2, 64)])
def test_flash_attention_mqa_gqa_and_offset(kv, q_offset):
    """MQA (one KV head), GQA, and a prefill continuation (S < T)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, s=128 - q_offset, kv=kv, t_len=128)
    kw = dict(causal=True, window=48, q_offset=q_offset, q_chunk=32,
              kv_chunk=32)
    got = TA.flash_attention(t(q), t(k), t(v), **kw)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    assert rel(got, want) < 1e-4


def test_flash_attention_bf16_scores_and_inputs():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, s=64)
    tq, tk, tv = (t(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for sd_t, sd_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = TA.flash_attention(tq, tk, tv, q_chunk=32, kv_chunk=16,
                                 score_dtype=sd_t)
        want = JA.flash_attention(jq, jk, jv, q_chunk=32, kv_chunk=16,
                                  score_dtype=sd_j)
        assert got.dtype == torch.bfloat16
        assert rel(got.float(), np.asarray(want, np.float32)) < 3e-2


@pytest.mark.parametrize("window,softcap", [(None, None), (24, None),
                                            (None, 30.0), (16, 50.0)])
@pytest.mark.parametrize("kv", [1, 2])
def test_decode_attention_matches_reference(window, softcap, kv):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, s=1, kv=kv, t_len=64)
    for cache_len in (1, 37, 64):
        got = TA.decode_attention(t(q), t(k), t(v), cache_len, window=window,
                                  softcap=softcap)
        want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(cache_len),
                                   window=window, softcap=softcap)
        assert rel(got, want) < 1e-4


# -- one layer -----------------------------------------------------------------

@pytest.mark.parametrize("arch,layer", [("gemma2-2b", 0), ("gemma2-2b", 1),
                                        ("starcoder2-15b", 0)])
def test_layer_prefill_and_decode_match_reference(arch, layer):
    """A local (windowed, post-norm) and a global gemma2 layer and a
    starcoder2 layer: prefill's output and cache, then one decode step."""
    cfg = dataclasses.replace(j_reduced(arch), window=8)
    tcfg = dataclasses.replace(get_reduced(arch), window=8)
    temporal, channel = JB.layer_kinds(cfg)[layer]
    lp = jax.tree.map(np.asarray, j_materialize(
        jax.random.PRNGKey(layer), JB.layer_abstract(cfg, temporal, channel),
        dtype_override=jnp.float32))
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 12, 16
    x = rng.standard_normal((b, s + 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc = j_materialize(jax.random.PRNGKey(0),
                       JB.cache_abstract(cfg, temporal, b, max_len),
                       dtype_override=jnp.float32)
    jx, jc = JB.layer_prefill(to_jax(lp), jnp.asarray(x[:, :s]), temporal,
                              channel, cfg, positions=jnp.asarray(pos), cache=jc)
    tc = materialize(None, TB.cache_abstract(tcfg, temporal, b, max_len),
                     dtype_override=torch.float32, device="cpu")
    tlp = to_torch(lp)
    tx, tc = TB.layer_prefill(tlp, t(x[:, :s]), temporal, channel, tcfg,
                              positions=t(pos), cache=tc)
    assert rel(tx, jx) < 1e-4
    assert rel(tc["k"], jc["k"]) < 1e-4 and rel(tc["v"], jc["v"]) < 1e-4

    dpos = np.full((b, 1), s)
    jx, jc = JB.layer_decode(to_jax(lp), jnp.asarray(x[:, s:]), temporal,
                             channel, cfg, cache=jc, cache_len=jnp.int32(s + 1),
                             positions=jnp.asarray(dpos))
    tx, tc = TB.layer_decode(tlp, t(x[:, s:]), temporal, channel, tcfg,
                             cache=tc, cache_len=s + 1, positions=t(dpos))
    assert rel(tx, jx) < 1e-4
    assert rel(tc["k"], jc["k"]) < 1e-4 and rel(tc["v"], jc["v"]) < 1e-4


# -- the model -------------------------------------------------------------------

def _prefill_decode_ref(cfg, params, toks, s, max_len, cache_dtype):
    cache = j_materialize(jax.random.PRNGKey(0),
                          JM.abstract_cache(cfg, toks.shape[0], max_len),
                          dtype_override=cache_dtype)
    jp = to_jax(params)
    lp, cache = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, cfg, cache)
    ld, cache = JM.decode_step(jp, jnp.asarray(toks[:, s : s + 1]), cache,
                               jnp.int32(s + 1), cfg)
    return np.asarray(lp, np.float32), np.asarray(ld, np.float32), cache


def _prefill_decode_port(cfg, params, toks, s, max_len, cache_dtype):
    cache = materialize(None, TM.abstract_cache(cfg, toks.shape[0], max_len),
                        dtype_override=cache_dtype, device="cpu")
    tt = t(toks.astype(np.int32))
    lp, cache = TM.prefill(params, {"tokens": tt[:, :s]}, cfg, cache)
    ld, cache = TM.decode_step(params, tt[:, s : s + 1], cache, s + 1, cfg)
    return lp, ld, cache


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_logits_match_reference_f32(arch):
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(cfg)
    tp = params_from_reference(params, tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 24))
    s, max_len = 20, 32
    jlp, jld, jcache = _prefill_decode_ref(cfg, params, toks, s, max_len,
                                           jnp.float32)
    tlp, tld, tcache = _prefill_decode_port(tcfg, tp, toks, s, max_len,
                                            torch.float32)
    assert tlp.shape == (2, cfg.vocab_size) and tlp.dtype == torch.float32
    assert rel(tlp, jlp) < 1e-4 and rel(tld, jld) < 1e-4
    # The caches agree leaf for leaf once the reference's stack is unstacked.
    want = cache_from_reference(jax.tree.map(np.asarray, jcache), tcfg, "cpu")
    for a, b in zip(tree_leaves(tcache), tree_leaves(want)):
        assert rel(a, b) < 1e-4
    # And the full forward's hidden states.
    jx, _ = JM.forward(to_jax(params), {"tokens": jnp.asarray(toks)}, cfg)
    tx, aux = TM.forward(tp, {"tokens": t(toks.astype(np.int32))}, tcfg)
    assert rel(tx, jx) < 1e-4 and float(aux) == 0.0


def mean_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


@pytest.mark.parametrize("arch", DENSE)
def test_layer_bf16_matches_reference(arch):
    """bfloat16 parameters read across through their bits; the first layer's
    prefill (output and cache) and one decode step."""
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(cfg, dtype=None)
    assert params["blocks"]["scan"]["0"]["attn"]["wq"].dtype.name == "bfloat16"
    tp = params_from_reference(params, tcfg, device="cpu")
    assert tp["blocks"]["0"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["final_norm"]["scale"].dtype == torch.float32
    temporal, channel = JB.layer_kinds(cfg)[0]
    jlp = to_jax(jax.tree.map(lambda a: a[0], params["blocks"]["scan"]["0"]))
    b, s = 2, 20
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s + 1))
    jx = JM._embed_in(to_jax(params), {"tokens": jnp.asarray(toks)}, cfg)
    tx = TM._embed_in(tp, {"tokens": t(toks)}, tcfg)
    assert rel(tx.float(), np.asarray(jx, np.float32)) == 0.0
    pos = np.broadcast_to(np.arange(s), (b, s))
    jc = j_materialize(jax.random.PRNGKey(0),
                       JB.cache_abstract(cfg, temporal, b, 32))
    tc = materialize(None, TB.cache_abstract(tcfg, temporal, b, 32), device="cpu")
    jy, jc = JB.layer_prefill(jlp, jx[:, :s], temporal, channel, cfg,
                              positions=jnp.asarray(pos), cache=jc)
    ty, tc = TB.layer_prefill(tp["blocks"]["0"], tx[:, :s], temporal, channel,
                              tcfg, positions=t(pos), cache=tc)

    def f32(a):
        return np.asarray(a, np.float32) if not torch.is_tensor(a) \
            else a.float().numpy()

    assert rel(f32(ty), f32(jy)) < 3e-2
    for key in ("k", "v"):
        assert rel(f32(tc[key]), f32(jc[key])) < 3e-2
    dpos = np.full((b, 1), s)
    jy, _ = JB.layer_decode(jlp, jx[:, s:], temporal, channel, cfg, cache=jc,
                            cache_len=jnp.int32(s + 1), positions=jnp.asarray(dpos))
    ty, _ = TB.layer_decode(tp["blocks"]["0"], tx[:, s:], temporal, channel,
                            tcfg, cache=tc, cache_len=s + 1, positions=t(dpos))
    assert rel(f32(ty), f32(jy)) < 3e-2


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_logits_bf16_as_close_to_f32_as_reference(arch):
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(cfg, dtype=None)
    as_f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24))
    jlp, jld, _ = _prefill_decode_ref(cfg, params, toks, 20, 32, None)
    flp, fld, _ = _prefill_decode_ref(cfg, as_f32, toks, 20, 32, jnp.float32)
    tp = params_from_reference(params, tcfg, device="cpu")
    tlp, tld, _ = _prefill_decode_port(tcfg, tp, toks, 20, 32, None)
    assert tlp.dtype == torch.float32 and np.isfinite(tlp.numpy()).all()
    for got, ref, truth in ((tlp, jlp, flp), (tld, jld, fld)):
        assert mean_rel(got, truth) <= 2 * mean_rel(ref, truth)


@pytest.mark.parametrize("arch,softcap", [
    ("qwen2-1.5b", None), ("qwen2-1.5b", 30.0), ("gemma2-2b", 30.0),
    ("gemma2-2b", None), ("phi3-medium-14b", None), ("starcoder2-15b", 30.0)])
def test_head_bf16_matches_reference(arch, softcap):
    """The model's last part in bfloat16, final_norm then the logits (tied
    ``unembed`` or ``lm_head``, with and without ``final_softcap``), on one
    bfloat16 hidden state carried to both sides: < 3e-2.  Without the
    softcap every logit must be a bfloat16 value cast to float32, as the
    reference's are: the product runs in the parameter dtype and is cast
    after it, so a port that upcast before the product would fail here."""
    cfg = dataclasses.replace(j_reduced(arch), final_softcap=softcap)
    tcfg = dataclasses.replace(get_reduced(arch), final_softcap=softcap)
    params = ref_params(cfg, dtype=None)
    tp = params_from_reference(params, tcfg, device="cpu")
    x = jnp.asarray(np.random.default_rng(8).standard_normal(
        (2, 3, cfg.d_model)) * 4, jnp.bfloat16)
    jp = to_jax(params)
    want = np.asarray(JM._logits(jp, JL.rmsnorm(jp["final_norm"], x), cfg))
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = TM._logits(tp, TL.rmsnorm(tp["final_norm"], tx), tcfg)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert rel(got, want) < 3e-2
    if softcap is None:
        assert torch.equal(got.to(torch.bfloat16).float(), got)
        assert np.array_equal(want.astype(jnp.bfloat16).astype(np.float32), want)


def _scaled_ref_attention(tree, cfg):
    """``chip_smoke.scale_attention``'s factors on the reference's numpy
    tree (stacked leaves scale alike)."""
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factors = {"wq": np.sqrt(h / d), "wk": np.sqrt(kv / d),
               "wv": np.sqrt(kv / d), "wo": 1 / np.sqrt(h)}
    if "attn" in tree:
        for key, f in factors.items():
            tree["attn"][key] = (tree["attn"][key] * f).astype(np.float32)
    for v in tree.values():
        if isinstance(v, dict):
            _scaled_ref_attention(v, cfg)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
def test_full_depth_stack_with_rescaled_attention(arch):
    """The reduced width at the published depth (28 / 26 layers) with the
    attention weights rescaled to std 1/sqrt(true fan-in) by
    ``chip_smoke.scale_attention``: the stack is then not chaotic, so the
    port's prefill + decode logits match the reference's (< 1e-4) and the
    port's own full forward (< 1e-3) through every layer's cache."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    depth = get_config(arch).n_layers
    cfg = dataclasses.replace(j_reduced(arch), n_layers=depth)
    tcfg = dataclasses.replace(get_reduced(arch), n_layers=depth)
    params = ref_params(cfg, seed=1)
    tp = params_from_reference(params, tcfg, "cpu")
    smoke.scale_attention(tp, tcfg)
    _scaled_ref_attention(params["blocks"], cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 97))
    s = 96                                  # past gemma's reduced window (64)
    _, jld, _ = _prefill_decode_ref(cfg, params, toks, s, 104, jnp.float32)
    _, tld, _ = _prefill_decode_port(tcfg, tp, toks, s, 104, torch.float32)
    assert rel(tld, jld) < 1e-4
    x, _ = TM.forward(tp, {"tokens": t(toks.astype(np.int32))}, tcfg)
    want = TM._logits(tp, TL.rmsnorm(tp["final_norm"], x[:, -1:]), tcfg)[:, 0]
    assert rel(tld, want) < 1e-3


@pytest.mark.parametrize("arch", DENSE)
def test_port_prefill_decode_equals_forward(arch):
    """prefill(S) + decode(token S) == full forward on S+1 tokens (f32)."""
    cfg = get_reduced(arch)
    g = torch.Generator().manual_seed(0)
    params = materialize(g, TM.abstract_params(cfg), dtype_override=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    s = 32
    cache = materialize(None, TM.abstract_cache(cfg, 2, 64),
                        dtype_override=torch.float32, device="cpu")
    _, cache = TM.prefill(params, {"tokens": toks[:, :s]}, cfg, cache)
    ld, _ = TM.decode_step(params, toks[:, s : s + 1], cache, s + 1, cfg)
    x, _ = TM.forward(params, {"tokens": toks[:, : s + 1]}, cfg)
    ref = TM._logits(params, TL.rmsnorm(params["final_norm"], x[:, -1:]), cfg)[:, 0]
    assert rel(ld, ref) < 1e-3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b"])
@pytest.mark.parametrize("stop", [False, True])
def test_greedy_generate_tokens_equal_reference(arch, stop):
    """16 greedy tokens, batch 2, prompt 8, f32 parameters (the engines'
    caches are bfloat16 on both sides).  With ``stop``, the stop token is
    row 0's fifth token: row 0 goes on after it until row 1 stops too (or
    the budget ends), as in the reference."""
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(cfg)
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jeng = JServeEngine(cfg, to_jax(params), max_len=32)
    want = jeng.generate(prompts, max_new_tokens=16)
    teng = ServeEngine(tcfg, params_from_reference(params, tcfg, "cpu"),
                       max_len=32, device="cpu")
    got = teng.generate(prompts, max_new_tokens=16)
    assert got.dtype == np.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got, want)
    if stop:
        stop_token = int(want[0, 4])
        want = jeng.generate(prompts, max_new_tokens=16, stop_token=stop_token)
        got = teng.generate(prompts, max_new_tokens=16, stop_token=stop_token)
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] >= 5


def test_generate_from_lm_module_and_sampling():
    """``ServeEngine`` takes an ``LM``; sampling draws from the generator
    given (the same seed, the same tokens), and a too-long request raises."""
    cfg = get_reduced("qwen2-1.5b")
    params = materialize(torch.Generator().manual_seed(0),
                         TM.abstract_params(cfg), dtype_override=torch.float32)
    model = LM(cfg, params)
    assert "tree.blocks.0.attn.wq" in model.state_dict()
    eng = ServeEngine(cfg, model, max_len=24, device="cpu")
    prompts = np.zeros((2, 8), np.int32)
    draws = [eng.generate(prompts, 8, temperature=1.0,
                          rng=torch.Generator().manual_seed(s))
             for s in (3, 3, 4)]
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts, 17)
    with pytest.raises(ValueError, match="mesh= and rules="):
        ServeEngine(cfg, model, mesh=object(), device="cpu")


def test_params_from_reference_loads_into_module():
    cfg, tcfg = j_reduced("gemma2-2b"), get_reduced("gemma2-2b")
    params = ref_params(cfg, seed=1)
    model = LM(tcfg, materialize(torch.Generator().manual_seed(0),
                                 TM.abstract_params(tcfg),
                                 dtype_override=torch.float32))
    tree = params_from_reference(params, tcfg, "cpu", model=model)
    # Layer 2 is the second super-block's first pattern entry.
    np.testing.assert_array_equal(
        model.params["blocks"]["2"]["attn"]["wq"].numpy(),
        params["blocks"]["scan"]["0"]["attn"]["wq"][1])
    assert tree["embed"]["table"] is model.params["embed"]["table"]
    assert "lm_head" not in tree  # tied embeddings


def test_serve_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = get_reduced("qwen2-1.5b")
    params = materialize(torch.Generator().manual_seed(0),
                         TM.abstract_params(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        materialize(None, TM.abstract_params(cfg), device="cuda")


def test_launcher_lm_path_prints_the_reference_lines(capsys, monkeypatch):
    """``launch/serve.py --lm``: gated on ``REPRO_LM=1`` as in the
    reference; with ``--device cpu`` it serves the reduced config and
    prints the reference's two lines; without a card the default raises."""
    from repro.launch import serve as j_serve

    from repro_torch.launch import serve as t_serve

    args = ["--lm", "--arch", "starcoder2-15b", "--batch", "2",
            "--prompt-len", "4", "--new-tokens", "3", "--max-len", "16"]
    monkeypatch.delenv("REPRO_LM", raising=False)
    with pytest.raises(SystemExit) as done:
        t_serve.main(args)
    assert done.value.code == 0
    gate = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    with pytest.raises(SystemExit):
        j_serve.main()
    assert capsys.readouterr().out == gate
    monkeypatch.setenv("REPRO_LM", "1")
    t_serve.main(args + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    j_serve.main()
    ref = capsys.readouterr().out.splitlines()
    assert len(port) == len(ref) == 2
    assert port[0].split(" in ")[0] == ref[0].split(" in ")[0] == \
        "generated (2, 3)"
    assert port[1].startswith("first row: [") and ref[1].startswith("first row: [")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_serve.main(args)


def test_deep_random_stack_is_chaotic_in_the_reference_too():
    """Why ``chip_smoke.py`` holds the reference-init stacks layer by layer
    and the full depth end to end only with the attention rescaled: with
    the reference's init (``wq`` std 1/sqrt(n_heads)), 16 float32 layers of
    width 256 already push the reference's own prefill + decode vs forward
    check past 1e-3, and the port's likewise, while each layer, fed the
    forward's own input, agrees to float32 rounding."""
    base = dict(n_layers=16, d_model=256, n_heads=12, n_kv_heads=2,
                head_dim=32, d_ff=1024)
    cfg = dataclasses.replace(j_reduced("qwen2-1.5b"), **base)
    tcfg = dataclasses.replace(get_reduced("qwen2-1.5b"), **base)
    params = ref_params(cfg, seed=1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65))
    s = 64
    _, jld, _ = _prefill_decode_ref(cfg, params, toks, s, 72, jnp.float32)
    jx, _ = JM.forward(to_jax(params), {"tokens": jnp.asarray(toks)}, cfg)
    jp = to_jax(params)
    want = JM._logits(jp, JL.rmsnorm(jp["final_norm"], jx[:, -1:]), cfg)[:, 0]
    assert rel(jld, want) > 1e-3
    tp = params_from_reference(params, tcfg, "cpu")
    _, tld, _ = _prefill_decode_port(tcfg, tp, toks, s, 72, torch.float32)
    tt = t(toks.astype(np.int32))
    x, _ = TM.forward(tp, {"tokens": tt}, tcfg)
    assert rel(tld, TM._logits(tp, TL.rmsnorm(tp["final_norm"], x[:, -1:]),
                               tcfg)[:, 0]) > 1e-3
    x = TM._embed_in(tp, {"tokens": tt}, tcfg)
    pos = torch.arange(s + 1).expand(2, s + 1)
    for i, (kind, channel) in enumerate(TB.layer_kinds(tcfg)):
        lp = tp["blocks"][str(i)]
        y, _ = TB.layer_apply(lp, x, kind, channel, tcfg, positions=pos)
        cache = materialize(None, TB.cache_abstract(tcfg, kind, 2, 72),
                            dtype_override=torch.float32, device="cpu")
        _, cache = TB.layer_prefill(lp, x[:, :s], kind, channel, tcfg,
                                    positions=pos[:, :s], cache=cache)
        yd, _ = TB.layer_decode(lp, x[:, s:], kind, channel, tcfg, cache=cache,
                                cache_len=s + 1, positions=pos[:, s:])
        assert rel(yd, y[:, s:]) < 1e-5
        x = y
