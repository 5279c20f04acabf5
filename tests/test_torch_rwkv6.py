"""The port's RWKV-6 slice (``repro_torch``) held against the JAX package
(``repro``) on the same numpy inputs and the same weights, at the reduced
RWKV-6 3B config (2 layers, ``d_model`` 128, 8 heads of 16): the config
mirror, the four layer functions, the prefill forward, and the lockstep
engine against the JAX engine on the fused, prepacked Pallas path in
interpret mode.  On the CPU the WKV scan takes B7's plain version.

Tolerances: f32 ``rtol = atol = 1e-5`` (summation order only); the
forward's f32 hidden states and logits relative to each row's largest
element (they grow to ≈ 4, and the port and the reference each lie
≈ 1e-5 from the f64 values); bf16 compared in f32 at ``2e-2`` (a value on
a bf16 rounding boundary may round the other way under another summation
order).  Token streams are bf16 greedy decodes: a near-tie may flip an
argmax under another summation order (ROADMAP C2), so tokens must agree
on at least 90 % of positions, and where they differ the token picked is
a near-tie, within ``NEAR_TIE`` of the best logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.launch.serve import generate as ref_generate
from repro.models import layers as ref_layers
from repro.models import rwkv6 as ref_rwkv
from repro.models.ctx import ParallelCtx
from repro.models.transformer import Layout, forward as ref_forward
from repro.models.transformer import init_device_major, unwrap_local
from repro.serving.engine import EngineOptions as RefOptions

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import (ATTN_LOCAL, RECURRENT, RWKV6, get_config,
                                 reduced)
from repro_torch.core import tracecount
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models import layers, rwkv6
from repro_torch.models.transformer import (forward, from_reference_params,
                                            init_params)
from repro_torch.serving.engine import KERNELS, EngineOptions, decode_step
from repro_torch.serving.sampling import head_candidates
from repro_torch.serving.scheduler import Request, SlotScheduler

ARCH = "rwkv6-3b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()
SLOTS, MAX_SEQ = 3, 48
D, HD, H, FF = 64, 16, 4, 96        # layer tests: d_model, head dim, heads
F32_LEAVES = ("w_base", "u", "ln_scale")   # f32 in the reference's init
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread


def _tol(bf16):
    return BF16 if bf16 else F32


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _params(bf16, seed=0):
    """RWKV-6 layer params at the reference's init scales, as the
    reference's ``RWKV6Params`` and the port's dict."""
    rng = np.random.default_rng(seed)
    n = lambda *shape, sc: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    s = D ** -0.5
    arrs = dict(
        mu=rng.uniform(size=(5, D)).astype(np.float32),
        w_r=n(D, D, sc=s), w_k=n(D, D, sc=s), w_v=n(D, D, sc=s),
        w_g=n(D, D, sc=s), w_out=n(D, D, sc=s),
        w_base=np.full((D,), -0.5, np.float32), lora_a=n(D, 32, sc=s),
        lora_b=n(32, D, sc=0.01), u=n(D, sc=0.1),
        ln_scale=(1 + n(D, sc=0.1)), mu_c=rng.uniform(size=(2, D)).astype(
            np.float32),
        cm_k=n(D, FF, sc=s), cm_v=n(FF, D, sc=FF ** -0.5), cm_r=n(D, D, sc=s))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _pair(a, bf16 and k not in F32_LEAVES)
    return ref_rwkv.RWKV6Params(**j), t


def _state(bf16, B, seed=1):
    """A random nonzero RWKV6State: f32 ``s``, shift rows in the model
    dtype (bf16 in serving)."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((B, H, HD, HD)) * 0.1).astype(np.float32)
    xt, xc = (rng.standard_normal((B, D)).astype(np.float32)
              for _ in range(2))
    (js, ts), (jt, tt), (jc, tc) = (_pair(s, False), _pair(xt, bf16),
                                    _pair(xc, bf16))
    return (ref_rwkv.RWKV6State(js, jt, jc), rwkv6.RWKV6State(ts, tt, tc))


def _close(got, want, bf16, name=""):
    if want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, name
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16),
                               err_msg=name)


def test_config_mirrors_reference():
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (reduced(get_config(ARCH)),
                       ref_reduced(ref_get_config(ARCH)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_kinds == ref.layer_kinds
    assert reduced(get_config(ARCH)).rwkv_head_dim == 16


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(bf16, with_state):
    """Over a 7-token sequence, from the zero state or a random one: the
    output and the final f32 state."""
    jp, tp = _params(bf16)
    x = np.random.default_rng(2).standard_normal((2, 7, D)).astype(
        np.float32)
    jx, tx = _pair(x, bf16)
    jst, tst = _state(bf16, 2) if with_state else (None, None)
    got, g_s = rwkv6.rwkv6_time_mix(tp, tx, HD, tst)
    want, w_s = ref_rwkv.rwkv6_time_mix(CTX, jp, jx, HD, jst)
    assert got.dtype == tx.dtype and g_s.dtype == torch.float32
    _close(got, want, bf16, "y")
    _close(g_s, w_s, bf16, "s_fin")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix_matches_reference(bf16, with_prev):
    jp, tp = _params(bf16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    prev = rng.standard_normal((2, D)).astype(np.float32)
    (jx, tx), (jv, tv) = _pair(x, bf16), _pair(prev, bf16)
    got = rwkv6.rwkv6_channel_mix(tp, tx, tv if with_prev else None)
    want = ref_rwkv.rwkv6_channel_mix(CTX, jp, jx, jv if with_prev else None)
    assert got.dtype == tx.dtype
    _close(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_steps_match_reference(bf16):
    """``rwkv6_step`` (the scan at S = 1) then ``rwkv6_channel_step`` from
    a random state: outputs and every leaf of the new state."""
    jp, tp = _params(bf16)
    x = np.random.default_rng(4).standard_normal((3, D)).astype(np.float32)
    jx, tx = _pair(x, bf16)
    jst, tst = _state(bf16, 3)
    got, g_in, g_st = rwkv6.rwkv6_step(tp, tx, HD, tst)
    want, w_in, w_st = ref_rwkv.rwkv6_step(CTX, jp, jx, HD, jst)
    _close(got, want, bf16, "y")
    assert torch.equal(g_in, tx)
    for name in ("s", "x_prev_t", "x_prev_c"):
        _close(getattr(g_st, name), getattr(w_st, name), bf16, name)
    gc, g_st = rwkv6.rwkv6_channel_step(tp, tx, g_st)
    wc, w_st = ref_rwkv.rwkv6_channel_step(CTX, jp, jx, w_st)
    _close(gc, wc, bf16, "channel")
    _close(g_st.x_prev_c, w_st.x_prev_c, bf16, "x_prev_c")


def test_step_equals_one_token_of_the_sequence():
    """The decode step is the time mix at S = 1 from the same state."""
    _, tp = _params(False)
    _, tst = _state(False, 2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, D)).astype(np.float32))
    y_seq, s_seq = rwkv6.rwkv6_time_mix(tp, x[:, None], HD, tst)
    y, _, st = rwkv6.rwkv6_step(tp, x, HD, tst)
    torch.testing.assert_close(y, y_seq[:, 0], **F32)
    torch.testing.assert_close(st.s, s_seq, **F32)


@pytest.fixture(scope="module")
def reduced_model():
    cfg = ref_reduced(ref_get_config(ARCH))
    tree = init_device_major(cfg, Layout(1), jax.random.PRNGKey(2))
    port_cfg = reduced(get_config(ARCH))
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    return cfg, port_cfg, tree, params


def _rowwise(a: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return a / np.abs(scale).max(axis=-1, keepdims=True)


@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_logits_match_reference(reduced_model, bf16):
    """The RWKV-6 train-path forward and the LM head on the reference's
    weights: f32 to 1e-5 of each row's largest element (measured ≤ 3.8e-6
    of it), tokens equal; in bf16 the greedy tokens agree on at least
    90 % of positions, every other one a near-tie in the reference's own
    logits (with these seeds 34 of 36 agree, the others 0.017 apart)."""
    cfg, port_cfg, tree, params = reduced_model
    blk = params["blocks"][0]
    assert set(blk) == {"ln1", "ln2", "rwkv"}
    assert set(blk["rwkv"]) == set(ref_rwkv.RWKV6Params._fields)
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
    lw = _np(ref_layers.lm_head_logits(CTX, unwrap_local(tree)["lm_head"],
                                       want))
    g_tok, w_tok = lg.argmax(-1).numpy(), lw.argmax(-1)
    if not bf16:
        for g, w in ((_np(got), _np(want)), (_np(lg), lw)):
            np.testing.assert_allclose(_rowwise(g, w), _rowwise(w, w), **F32)
        np.testing.assert_array_equal(g_tok, w_tok)
    assert (g_tok == w_tok).mean() >= 0.9, (g_tok, w_tok)
    best = np.take_along_axis(lw, w_tok[..., None], -1)[..., 0]
    port_pick = np.take_along_axis(lw, g_tok[..., None], -1)[..., 0]
    assert (best - port_pick).max() <= NEAR_TIE, best - port_pick


def test_init_params_layout_and_unported_kinds():
    """Seeded init: the reference's leaves and dtypes with the group
    axis leading; RWKV-6 beside other kinds, and the Gemma-2 post-norms,
    raise naming ROADMAP (RG-LRU and local attention are ported:
    ``tests/test_torch_rglru.py``)."""
    cfg = reduced(get_config(ARCH))
    p = init_params(cfg, seed=1, device="cpu")
    ref = init_device_major(ref_reduced(ref_get_config(ARCH)), Layout(1),
                            jax.random.PRNGKey(0))["blocks"][0]["rwkv"]
    for name, leaf in p["blocks"][0]["rwkv"].items():
        want = getattr(ref, name)
        assert tuple(leaf.shape) == want.shape[1:], name
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
    assert torch.all(p["blocks"][0]["rwkv"]["w_base"] == -0.5)
    assert "lm_head" in p and "attn" not in p["blocks"][0]
    llama = reduced(get_config("llama2-7b"))
    for bad, item in (
            (dataclasses.replace(cfg, block_pattern=(RWKV6, ATTN_LOCAL)),
             "item 15a"),
            (dataclasses.replace(llama, block_pattern=(RECURRENT,
                                                       ATTN_LOCAL),
                                 use_post_norm=True), "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            init_params(bad, device="cpu")


# ---------------------------------------------------------------------------
# The lockstep engine against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = ref_reduced(ref_get_config(ARCH))
    port_cfg = reduced(get_config(ARCH))
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS,
                    options=RefOptions(backend="pallas", interpret=True,
                                       prepack="on", fuse_head=True))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train,
                             options=EngineOptions(backend="pallas"))
    return ref, port


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x))


def test_decode_state_layout_matches_reference(engines):
    ref, port = engines
    unwrap = lambda leaf: tuple(leaf.shape[2:])     # drop the [dp, ms] wrap
    assert len(port.state["layers"]) == len(ref.state["layers"]) == 1
    for r, p in zip(ref.state["layers"], port.state["layers"]):
        assert type(p).__name__ == type(r).__name__ == "RWKV6State"
        for name in r._fields:
            assert tuple(getattr(p, name).shape) == unwrap(getattr(r, name))
            assert str(getattr(p, name).dtype).split(".")[-1] == \
                str(getattr(r, name).dtype)
    G, B, hd = port.cfg.n_layers, SLOTS, port.cfg.rwkv_head_dim
    assert tuple(port.state["layers"][0].s.shape) == (
        G, B, port.cfg.d_model // hd, hd, hd)
    assert port.params["serve"]["blocks"][0] is port.params["train"][
        "blocks"][0]                                 # rides through unpacked


def test_decode_step_makes_one_scan_per_layer_plus_head(engines):
    _, port = engines
    nxt, st = port.prefill_fn(port.params["train"], port.state,
                              np.ones((SLOTS, 4), np.int32))
    tracecount.reset()
    port.decode_fn(port.params["serve"], st, nxt)
    calls = tracecount.calls()
    assert calls == {"fused_decode": 0, "fused_ffn": 0, "fused_head": 1,
                     "fused_mla_decode": 0, "rwkv6_scan": port.cfg.n_layers,
                     "flash_decode": 0, "rglru_scan": 0}
    assert sum(calls.values()) == port.cfg.n_layers + 1
    assert sum(tracecount.launches().values()) == 0     # CPU: no kernels


def test_teacher_forced_decode_matches_reference(engines):
    """Prefill the same prompts, then force the same input tokens on both
    sides each step (no cascade from an earlier disagreement); with these
    seeds all 27 (step, slot) tokens agree.  The recurrent state after the
    last step too."""
    ref, port = engines
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, port.cfg.vocab_size, (SLOTS, 10)).astype(
        np.int32)
    forced = rng.integers(0, port.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    r_tok, r_st = ref.prefill_fn(ref.params["train"], ref.state, prompts,
                                 None)
    p_tok, p_st = port.prefill_fn(port.params["train"], port.state, prompts)
    r_out, p_out = [_host(r_tok).reshape(-1)], [_host(p_tok)]
    for t in range(len(forced)):
        r_tok, r_st = ref.decode_fn(ref.params["serve"], r_st, forced[t])
        p_tok, p_st = port.decode_fn(port.params["serve"], p_st,
                                     torch.from_numpy(forced[t]))
        r_out.append(_host(r_tok).reshape(-1))
        p_out.append(_host(p_tok))
    same = np.stack(r_out) == np.stack(p_out)
    assert same.mean() >= 0.9, (f"{same.sum()} of {same.size} agree",
                                np.stack(r_out), np.stack(p_out))
    np.testing.assert_array_equal(_host(p_st["cache_lens"]),
                                  _host(r_st["cache_lens"]).reshape(-1))
    # the first layer's f32 state, relative to each (slot, head)'s largest
    # element (measured 6e-5); deeper layers' inputs follow a layer of
    # bf16 rounding flips, which compound, so they are held by tokens
    g_s, w_s = _np(p_st["layers"][0].s[0]), _np(r_st["layers"][0].s[0, 0, 0])
    scale = np.abs(w_s).max(axis=(2, 3), keepdims=True)
    np.testing.assert_allclose(g_s / scale, w_s / scale, rtol=0, atol=1e-3)


def _generate_with_candidates(port, state, prompts, n_new):
    """``generate`` on the port's engine, keeping each token's head
    candidates: the prefill's from its last-position logits, every
    decode step's from B3's (plain) candidates."""
    cands = []

    def head(*a, **k):
        out = KERNELS.head(*a, **k)
        cands.append(out)
        return out

    kernels = KERNELS._replace(head=head)

    def dec(p, st, tok):
        return decode_step(port.cfg, port.scfg, p, st, tok, kernels=kernels)

    tp = port.params["train"]
    h = forward(port.cfg, tp, torch.from_numpy(prompts))[:, -1]
    cands.append(head_candidates(layers.lm_head_logits(tp["lm_head"], h)))
    toks, st = generate(port.params, port.prefill_fn, dec, state,
                        torch.from_numpy(prompts), n_new)
    return toks.numpy(), st, cands


def test_two_generate_batches_match_reference(engines):
    """Two lockstep batches on one engine, the second from whatever the
    first left in the state: prefill starts every slot afresh, so each
    batch follows the reference's stream, and the second equals a fresh
    engine's exactly.  Lockstep greedy streams cascade after a near-tie
    flip, so each slot's stream must equal the reference's up to its
    first difference, and there the reference's token must be a near-tie
    among the port's own candidates (with these seeds the first batch's
    slots 0 and 2 split at tokens 4 and 5 of 6, the reference's token
    0.022 and 0.023 below the port's best; the second batch agrees on
    every token)."""
    ref, port = engines
    rng = np.random.default_rng(1)
    r_st, p_st = ref.state, port.state
    batches = []
    for n_prompt, n_new in ((9, 6), (5, 4)):
        prompts = rng.integers(0, port.cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        r_toks, r_st = ref_generate(ref.cfg, ref.params, ref.prefill_fn,
                                    ref.decode_fn, r_st, prompts, n_new)
        got, p_st, cands = _generate_with_candidates(port, p_st, prompts,
                                                     n_new)
        want = _host(r_toks).reshape(SLOTS, n_new)
        for b in range(SLOTS):
            diff = np.nonzero(got[b] != want[b])[0]
            if len(diff):
                vals, ids = (c[b].numpy() for c in cands[diff[0]])
                assert want[b, diff[0]] in ids, (b, diff, ids)
                gap = vals[0] - vals[list(ids).index(want[b, diff[0]])]
                assert gap <= NEAR_TIE, (b, diff, gap)
        assert _host(p_st["cache_lens"]).tolist() == \
            [n_prompt + n_new - 1] * SLOTS
        batches.append((prompts, got))
    fresh = build_engine_full(port.cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              device="cpu", train_params=port.params["train"],
                              options=EngineOptions(backend="pallas"))
    prompts, toks = batches[-1]
    again, _ = generate(fresh.params, fresh.prefill_fn, fresh.decode_fn,
                        fresh.state, torch.from_numpy(prompts),
                        toks.shape[1])
    np.testing.assert_array_equal(again.numpy(), toks)


def test_admit_raises_as_the_reference_does(engines):
    ref, port = engines
    toks = np.ones((SLOTS, 6), np.int32)
    lens = np.array([3, 0, 6], np.int32)
    msg = "per-slot prefill insert supports attention-only models"
    with pytest.raises(AssertionError, match=msg):
        ref.admit_fn(ref.params["train"], ref.state, toks, lens)
    with pytest.raises(AssertionError, match=msg):
        port.admit_fn(port.params["train"], port.state, toks, lens)
    sched = SlotScheduler(port, prompt_cap=8)
    sched.submit(Request(0, [1, 2, 3], 2))
    with pytest.raises(AssertionError, match=msg):
        sched.step()
