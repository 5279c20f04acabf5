"""The port's configs, layers, prefill attention and train-path forward
(``repro_torch``) held against the JAX package (``repro``) on the same
numpy inputs and the same weights, at the reduced Llama2-7B config and
the reduced dense-MLA DeepSeek-V2-Lite (the reference's config with
``moe=None``).

Tolerances: f32 inputs ``rtol = atol = 1e-5`` (summation order only);
bf16 inputs compared in f32 at ``2e-2`` (a value on a bf16 rounding
boundary may round the other way under another summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.fused_decode.ops import rope_at as ref_rope_at
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.ctx import ParallelCtx
from repro.models.transformer import Layout, forward as ref_forward
from repro.models.transformer import init_device_major, unwrap_local

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.fused_decode.fused_decode import rope_at
from repro_torch.models import attention, layers
from repro_torch.models.transformer import forward, from_reference_params

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()


def jax_tree_to_numpy(tree):
    """A JAX parameter tree as the port's ``from_reference_params`` takes
    it: NamedTuples → dicts, lists stay lists, arrays → numpy."""
    if hasattr(tree, "_asdict"):
        return {k: jax_tree_to_numpy(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def dense_mla(cfg):
    """DeepSeek-V2-Lite's dense-MLA arm: the same config without experts
    (as ``tests/test_router.py`` builds it for the reference)."""
    return dataclasses.replace(cfg, moe=None)


@pytest.mark.parametrize("arch", ["llama2-7b", "deepseek-v2-lite",
                                  "recurrentgemma-9b"])
def test_config_mirrors_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(get_config(arch)),
                       ref_reduced(ref_get_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_kinds == ref.layer_kinds
        assert port.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("bf16", [False, True])
def test_rms_norm(bf16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = (rng.standard_normal(64) * 0.1).astype(np.float32)
    jx, tx = _pair(x, bf16)
    got = layers.rms_norm(tx, torch.from_numpy(s), 1e-6)
    want = ref_layers.rms_norm(jx, jnp.asarray(s), 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if bf16 else F32))


def test_rope():
    rng = np.random.default_rng(1)
    hd = 16
    pos = np.array([-1, 0, 1, 7, 1023], np.int32)
    c, s = rope_at(torch.from_numpy(pos), hd)
    jc, js = ref_rope_at(jnp.asarray(pos), hd)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **F32)
    x = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
    c, s = layers.rope_cos_sin(torch.arange(6), hd, 10000.0)
    jc, js = ref_layers.rope_cos_sin(jnp.arange(6), hd, 10000.0)
    got = layers.apply_rope(torch.from_numpy(x), c, s)
    want = ref_layers.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
def test_ffn_apply(act, bf16):
    rng = np.random.default_rng(2)
    D, F = 32, 48
    arrs = [rng.standard_normal((4, D)).astype(np.float32)] + [
        (rng.standard_normal(s) * 0.2).astype(np.float32)
        for s in ((D, F), (D, F), (F, D))]
    (jx, jwi, jwg, jwo), (tx, twi, twg, two) = zip(
        *(_pair(a, bf16) for a in arrs))
    got = layers.ffn_apply({"w_in": twi, "w_gate": twg, "w_out": two}, tx,
                           act)
    want = ref_layers.ffn_apply(
        CTX, ref_layers.FFNParams(w_in=jwi, w_out=jwo, w_gate=jwg), jx, act)
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if bf16 else F32))


def test_embed_and_lm_head():
    rng = np.random.default_rng(3)
    V, D = 50, 16
    table = rng.standard_normal((V, D)).astype(np.float32)
    toks = rng.integers(0, V, (3, 4)).astype(np.int32)
    jt, tt = _pair(table, True)
    got = layers.embed_lookup(tt, torch.from_numpy(toks))
    want = ref_layers.embed_lookup(CTX, ref_layers.EmbedParams(jt),
                                   jnp.asarray(toks))
    np.testing.assert_array_equal(_np(got), _np(want))
    x = rng.standard_normal((3, D)).astype(np.float32)
    jx, tx = _pair(x, True)
    got = layers.lm_head_logits(tt, tx)
    want = ref_layers.lm_head_logits(CTX, jt, jx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    c = np.linspace(-80, 80, 9, dtype=np.float32)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(c), 30.0).numpy(),
        np.asarray(ref_layers.softcap(jnp.asarray(c), 30.0)), **F32)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 20.0)])
def test_flash(window, cap):
    """Chunked online softmax, with a ragged last chunk and a
    ``kv_valid_len`` bound."""
    rng = np.random.default_rng(4)
    B, S, KV, QPK, hd = 2, 11, 2, 2, 8
    q = rng.standard_normal((B, S, KV, QPK, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kw = dict(q_offset=0, causal=True, window=window, cap=cap,
              scale=hd ** -0.5, chunk=4)
    got = attention._flash(*(torch.from_numpy(a) for a in (q, k, v)),
                           kv_valid_len=torch.tensor(9), **kw)
    want = ref_attn._flash(*(jnp.asarray(a) for a in (q, k, v)),
                           kv_valid_len=jnp.int32(9), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.fixture(scope="module")
def reduced_model():
    cfg = ref_reduced(ref_get_config("llama2-7b"))
    tree = init_device_major(cfg, Layout(1), jax.random.PRNGKey(0))
    port_cfg = reduced(get_config("llama2-7b"))
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    return cfg, port_cfg, tree, params


def test_attention_train(reduced_model):
    cfg, port_cfg, tree, params = reduced_model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, True)
    blk = unwrap_local(tree)["blocks"][0]
    j_attn = jax.tree.map(lambda leaf: leaf[0], blk["attn"])
    t_attn = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    got, (gk, gv) = attention.attention_train(t_attn, tx, port_cfg,
                                              "attn_global", return_kv=True)
    want, (wk, wv) = ref_attn.attention_train(CTX, j_attn, jx, cfg,
                                              "attn_global", return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_logits_match_reference(reduced_model, bf16):
    """The whole train-path forward and the LM head on the same weights.
    In f32 (the weights upcast on both sides) hidden states and logits
    agree to 1e-5: the algorithm is the same.  In bf16 the greedy tokens
    of every position agree; elementwise, rounding flips compound over
    the layers."""
    cfg, port_cfg, tree, params = reduced_model
    if not bf16:
        tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32), tree)
        params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                       device="cpu")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    want = ref_forward(CTX, cfg, unwrap_local(tree), jnp.asarray(toks),
                       remat=False)
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.lm_head_logits(params["lm_head"], got)
    lw = ref_layers.lm_head_logits(CTX, unwrap_local(tree)["lm_head"], want)
    if not bf16:
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(lg), _np(lw), **F32)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(lw).argmax(-1))


@pytest.fixture(scope="module")
def reduced_mla_model():
    cfg = dense_mla(ref_reduced(ref_get_config("deepseek-v2-lite")))
    tree = init_device_major(cfg, Layout(1), jax.random.PRNGKey(1))
    port_cfg = dense_mla(reduced(get_config("deepseek-v2-lite")))
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    return cfg, port_cfg, tree, params


@pytest.mark.parametrize("bf16", [False, True])
def test_mla_attention_train(reduced_mla_model, bf16):
    """MLA prefill attention in the latent-space form, and the latent
    entries it caches, on the reference's weights."""
    cfg, port_cfg, tree, params = reduced_mla_model
    if not bf16:
        tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32), tree)
        params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                       device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, bf16)
    blk = unwrap_local(tree)["blocks"][0]
    j_attn = jax.tree.map(lambda leaf: leaf[0], blk["attn"])
    t_attn = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    assert set(t_attn) == {"wq", "wdkv", "wuk", "wuv", "wo"}
    got, g_kv = attention.mla_attention_train(t_attn, tx, port_cfg,
                                              return_kv=True)
    want, w_kv = ref_attn.mla_attention_train(CTX, j_attn, jx, cfg,
                                              return_kv=True)
    m = cfg.mla
    assert tuple(g_kv.shape) == (2, 9, m.kv_lora_rank + m.rope_head_dim)
    for g, w in ((got, want), (g_kv, w_kv)):
        assert g.dtype == tx.dtype
        np.testing.assert_allclose(_np(g), _np(w), **(BF16 if bf16 else F32))


@pytest.mark.parametrize("bf16", [False, True])
def test_mla_prefill_logits_match_reference(reduced_mla_model, bf16):
    """The dense-MLA train-path forward and the LM head on the same
    weights: f32 to 1e-5.  In bf16 the greedy tokens agree on at least
    90 % of positions (ROADMAP C2), and where they differ the port's
    token is a near-tie in the reference's own logits (within
    ``NEAR_TIE`` of its best; with these seeds 35 of 36 positions agree,
    the other's top two reference logits 0.021 apart)."""
    cfg, port_cfg, tree, params = reduced_mla_model
    if not bf16:
        tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32), tree)
        params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                       device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    want = ref_forward(CTX, cfg, unwrap_local(tree), jnp.asarray(toks),
                       remat=False)
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.lm_head_logits(params["lm_head"], got)
    lw = ref_layers.lm_head_logits(CTX, unwrap_local(tree)["lm_head"], want)
    lw = np.asarray(lw)
    g_tok, w_tok = lg.argmax(-1).numpy(), lw.argmax(-1)
    if not bf16:
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(lg), lw, **F32)
        np.testing.assert_array_equal(g_tok, w_tok)
    assert (g_tok == w_tok).mean() >= 0.9, (g_tok, w_tok)
    best = np.take_along_axis(lw, w_tok[..., None], -1)[..., 0]
    port_pick = np.take_along_axis(lw, g_tok[..., None], -1)[..., 0]
    assert (best - port_pick).max() <= NEAR_TIE, best - port_pick


NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread


def test_moe_config_raises_naming_the_roadmap():
    """MoE serves lockstep only: the port's ``SlotScheduler`` refuses a MoE
    engine with the reference's assertion (``scheduler.py:152–158``:
    capacity couples the slots), and accepts its dense-MLA arm."""
    from types import SimpleNamespace

    from repro.serving.scheduler import SlotScheduler as RefScheduler

    from repro_torch.launch.serve import build_engine_full
    from repro_torch.serving.scheduler import SlotScheduler
    cfg = reduced(get_config("deepseek-v2-lite"))
    msg = "MoE capacity routing makes tokens depend on co-resident slots"
    with pytest.raises(AssertionError, match=msg):
        RefScheduler(SimpleNamespace(cfg=ref_reduced(ref_get_config(
            "deepseek-v2-lite"))), prompt_cap=8)
    for c in (cfg, dense_mla(cfg)):
        eng = build_engine_full(c, max_seq=16, batch_global=2, device="cpu")
        if c.moe is None:
            assert SlotScheduler(eng, prompt_cap=8).n_slots == 2
            continue
        with pytest.raises(AssertionError, match=msg):
            SlotScheduler(eng, prompt_cap=8)
