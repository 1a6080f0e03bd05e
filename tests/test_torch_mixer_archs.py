"""PyTorch port vs JAX package: the five reduced architectures whose layers
go beyond dense attention (deepseek-v3 and kimi-k2: MLA / attention + MoE;
recurrentgemma-2b: RG-LRU + local attention; mamba2-2.7b: SSD;
llama-3.2-vision-11b: gated cross-attention), with the reference's seeded
parameters carried across by ``params_from_reference``.

Tolerances:
- float32 logits of prefill(S) and of one decode step, and every cache
  leaf after them: relative max error < 1e-4 (both sides compute in
  float32; only the summation order differs);
- greedy tokens of ``ServeEngine(device="cpu")``: equal to the reference
  engine's, float32 parameters.  The engines' caches are their default
  dtypes (bfloat16 k/v and ``conv_buf``, float32 states), except for MLA:
  the reference's engine cannot write float32 latents into its bfloat16
  latent cache (``lax.dynamic_update_slice`` refuses mixed dtypes), so
  there both engines hold float32 caches;
- the port's own prefill(S) + decode(token S) against its full forward
  over S + 1 tokens: < 1e-3, the reference's own check
  (``tests/test_archs.py``), MoE at capacity factor 64 as there; and the
  greedy tokens after a prompt do not depend on how the prompt is split
  between prefill and decode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.serve.lm as j_lm  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import materialize as j_materialize  # noqa: E402

import repro_torch.serve.lm as t_lm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import materialize, tree_leaves  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCHS = ["deepseek-v3-671b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
         "mamba2-2.7b", "llama-3.2-vision-11b"]


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1e-9, np.max(np.abs(want))))


def ref_params(cfg, seed=0):
    p = j_materialize(jax.random.PRNGKey(seed), JM.abstract_params(cfg),
                      dtype_override=jnp.float32)
    return jax.tree.map(np.asarray, p)


def vis_of(cfg, b, seed=1):
    """Patch embeddings for a vision config, else None."""
    if cfg.frontend != "vision_patches":
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_and_caches_match_reference_f32(arch):
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    params = ref_params(cfg)
    tp = params_from_reference(params, tcfg, "cpu")
    b, s, max_len = 2, 37, 48       # 37: no multiple of mamba2's chunk (32)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, s + 1),
                                             dtype=np.int32)
    vis = vis_of(cfg, b)
    jb, tb = {"tokens": jnp.asarray(toks[:, :s])}, {"tokens": torch.from_numpy(toks[:, :s])}
    if vis is not None:
        jb["vis_embeds"], tb["vis_embeds"] = jnp.asarray(vis), torch.from_numpy(vis)
    jp = jax.tree.map(jnp.asarray, params)
    jc = j_materialize(jax.random.PRNGKey(0), JM.abstract_cache(cfg, b, max_len),
                       dtype_override=jnp.float32)
    jlp, jc = jax.jit(lambda p, bb, c: JM.prefill(p, bb, cfg, c))(jp, jb, jc)
    jld, jc = jax.jit(lambda p, tk, c, n: JM.decode_step(p, tk, c, n, cfg))(
        jp, jnp.asarray(toks[:, s:]), jc, jnp.int32(s + 1))
    tc = materialize(None, TM.abstract_cache(tcfg, b, max_len),
                     dtype_override=torch.float32, device="cpu")
    tlp, tc = TM.prefill(tp, tb, tcfg, tc)
    tld, tc = TM.decode_step(tp, torch.from_numpy(toks[:, s:]), tc, s + 1, tcfg)
    assert tlp.shape == (b, cfg.vocab_size) and tlp.dtype == torch.float32
    assert rel(tlp, jlp) < 1e-4 and rel(tld, jld) < 1e-4
    want = cache_from_reference(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    for got, w in zip(tree_leaves(tc), tree_leaves(want)):
        assert got.shape == w.shape and rel(got, w) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch, monkeypatch):
    cfg, tcfg = j_reduced(arch), get_reduced(arch)
    if cfg.attention == "mla":  # float32 caches on both sides (see above)
        j_mat, t_mat = j_lm.materialize, t_lm.materialize
        monkeypatch.setattr(j_lm, "materialize", lambda k, tree: j_mat(
            k, tree, dtype_override=jnp.float32))
        monkeypatch.setattr(t_lm, "materialize", lambda g, tree, **kw: t_mat(
            g, tree, dtype_override=torch.float32, **kw))
    params = ref_params(cfg)
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    vis = vis_of(cfg, 2)
    want = j_lm.ServeEngine(cfg, jax.tree.map(jnp.asarray, params),
                            max_len=32).generate(
        prompts, max_new_tokens=16,
        vis_embeds=None if vis is None else jnp.asarray(vis))
    got = ServeEngine(tcfg, params_from_reference(params, tcfg, "cpu"),
                      max_len=32, device="cpu").generate(
        prompts, max_new_tokens=16, vis_embeds=vis)
    assert got.dtype == np.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got, want)


def _serving_cfg(arch):
    cfg = get_reduced(arch)
    if cfg.moe is not None:  # no token dropped in any group
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_decode_equals_forward(arch):
    """prefill(S) + decode(token S) == full forward on S+1 tokens (f32),
    and greedy decoding after the prompt is the same whether the prompt
    went through prefill whole or partly through decode steps."""
    cfg = _serving_cfg(arch)
    g = torch.Generator().manual_seed(0)
    params = materialize(g, TM.abstract_params(cfg), dtype_override=torch.float32)
    b, s, max_len = 2, 32, 64
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g,
                         dtype=torch.int32)
    vis = vis_of(cfg, b)
    extra = {} if vis is None else {"vis_embeds": torch.from_numpy(vis)}

    def fresh():
        return materialize(None, TM.abstract_cache(cfg, b, max_len),
                           dtype_override=torch.float32, device="cpu")

    _, cache = TM.prefill(params, {"tokens": toks[:, :s], **extra}, cfg, fresh())
    ld, _ = TM.decode_step(params, toks[:, s:], cache, s + 1, cfg)
    x, _ = TM.forward(params, {"tokens": toks, **extra}, cfg)
    ref = TM._logits(params, TL.rmsnorm(params["final_norm"], x[:, -1:]), cfg)[:, 0]
    assert rel(ld, ref) < 1e-3

    def greedy(split, n=8):
        logits, cache = TM.prefill(params, {"tokens": toks[:, :split], **extra},
                                   cfg, fresh())
        for i in range(split, s):  # the rest of the prompt, teacher-forced
            logits, cache = TM.decode_step(params, toks[:, i : i + 1], cache,
                                           i + 1, cfg)
        out = []
        for i in range(n):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(tok)
            logits, cache = TM.decode_step(params, tok, cache, s + i + 1, cfg)
        return torch.cat(out, dim=1)

    whole = greedy(s)
    for split in (1, 20):
        assert torch.equal(greedy(split), whole)


@pytest.mark.parametrize("arch", ARCHS + ["hubert-xlarge"])
def test_launcher_serves_every_decoder_arch(arch, capsys, monkeypatch):
    """``launch/serve.py --lm --device cpu`` serves each reduced config (the
    vision one on zero patch embeddings); the encoder-only hubert-xlarge
    has no decode path and exits, as in the reference."""
    from repro_torch.launch import serve as t_serve

    monkeypatch.setenv("REPRO_LM", "1")
    args = ["--lm", "--arch", arch, "--batch", "2", "--prompt-len", "4",
            "--new-tokens", "3", "--max-len", "16", "--device", "cpu"]
    if arch == "hubert-xlarge":
        with pytest.raises(SystemExit, match="encoder-only"):
            t_serve.main(args)
        return
    t_serve.main(args)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated (2, 3) in ")
    assert out[1].startswith("first row: [")
