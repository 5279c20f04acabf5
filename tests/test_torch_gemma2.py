"""Gemma-2 27B in the port — local and global attention in turn on a
sliding-window ring cache, both softcaps, post-norms, tied embeddings —
held against the JAX package at reduced size, with the same weights
carried across by ``from_reference_params``.

``reduced()`` keeps the 2:1 head ratio (4/2 heads of 32), the window
(cut to 64), both softcaps and the tied head, but drops
``use_post_norm`` (the reference's ``reduced`` never sets it), so every
model-level test sets it back on both sides with
``dataclasses.replace``.  ``max_seq`` 96 > 64: the local layer's cache
is a 64-row ring that wraps, the global layer's is linear.

* the config, field for field;
* B1 (``fused_decode``) at ``q_per_kv`` 2 with the window, the ring and
  the attention softcap, B2 (``fused_ffn``) with ``post_ln1`` (gated
  ``gelu_tanh``), B3 (``fused_head``) with the logit softcap 30: the
  plain versions against the interpret-mode Pallas kernels and their
  ``ref.py`` oracles (f32 to 1e-5: summation order only; bf16 compared
  in f32 to 2e-2; head indices exact, capped values within 2 f32 ulps
  of the exact cap and 12 of the reference's: C3 plus the two
  frameworks' f32 tanh),
  B1 on a wrapped ring whose row ``cache_len mod S`` still holds an
  out-of-window position and with a free slot, B3 with two different
  logits the cap makes equal;
* the f32 train-path forward with post-norms and the capped head: to
  1e-5, every position's greedy token exact;
* prefill's ring fill rewrites every ring row of an admitted slot, under
  ragged admits past the wrap (the ring cases of the reference's
  ``tests/test_ragged_decode.py``): ``pos`` exact against the
  reference's engine, nothing of an earlier occupant left;
* the port's ``"xla"`` and ``"pallas"`` engines against the reference's
  engines (each built once for the module: XLA, and interpret-mode
  Pallas for the fused arm): teacher-forced bf16 greedy tokens on at
  least 90 % of (step, slot), every difference a near-tie (ROADMAP C2),
  ring ``pos`` exact, and a staggered trace with admits past the wrap
  event for event.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.fused_decode.fused_decode import \
    fused_decode_attention as jax_fused_decode
from repro.kernels.fused_decode.ref import fused_decode_attention_ref
from repro.kernels.fused_ffn.fused_ffn import fused_ffn_block as jax_ffn
from repro.kernels.fused_ffn.ref import fused_ffn_block_ref
from repro.kernels.fused_head.fused_head import fused_head_block as jax_head
from repro.kernels.fused_head.ref import fused_head_ref
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.models import layers as ref_layers
from repro.models.ctx import ParallelCtx
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import unwrap_local
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler
from repro.serving.scheduler import replay_trace as ref_replay

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.kernels.fused_ffn import fused_ffn as b2
from repro_torch.kernels.fused_head import fused_head as b3
from repro_torch.launch.serve import build_engine_full
from repro_torch.models import layers
from repro_torch.models.transformer import (forward, from_reference_params,
                                            head_table)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

ARCH = "gemma2-27b"
SLOTS, MAX_SEQ, PROMPT_CAP = 3, 96, 80
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()


def _configs():
    """(reference, port) reduced configs with the post-norms set back."""
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                                use_post_norm=True),
            dataclasses.replace(reduced(get_config(ARCH)),
                                use_post_norm=True))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, bf16: bool):
    if a.dtype.kind != "f" or not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _ring_pos(S: int, length: int) -> np.ndarray:
    """Ring row ``r`` of a slot that holds ``length`` positions: the
    largest ``p < length`` with ``p ≡ r (mod S)``, else −1 — what
    prefill's ring fill and in-order appends leave."""
    r = np.arange(S)
    p = r + np.maximum(length - 1 - r, 0) // S * S
    return np.where(r < length, p, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
def test_config_mirrors_reference():
    port, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(port)) == dataclasses.asdict(
        ref_reduced(ref))
    r, p = _configs()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
            port.head_dim, port.d_ff, port.vocab_size, port.sliding_window,
            port.attn_softcap, port.logit_softcap) == (
        46, 4608, 32, 16, 128, 36864, 256000, 4096, 50.0, 30.0)
    assert port.use_post_norm and port.tie_embeddings
    assert port.ffn_act == "gelu_tanh" and port.ffn_gated
    assert port.n_layers % len(port.block_pattern) == 0      # no tail
    assert not reduced(port).use_post_norm and p.q_per_kv == 2


# ---------------------------------------------------------------------------
# B1 at q_per_kv 2 with the window, the ring and the softcap; B2 with
# post_ln1; B3 with the logit softcap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ring", [True, False])
def test_fused_decode_window_ring_softcap_plain_vs_pallas_and_ref(ring,
                                                                  bf16):
    """4/2 heads of 16, attention softcap 50 (scores scaled up so it
    bites).  Ring (``S`` = window = 16): a free slot whose rows hold a
    stale occupant's positions, a slot of 5, a full ring of 16 whose row
    0 holds position 0 = ``cache_len − window`` (masked), and a ring
    wrapped at 37 whose row ``37 mod 16`` holds 21 (masked); the new
    token counted on every live slot.  Linear (``S`` 32, window 8):
    −1, 0, 9, 31 with stale entries past each live prefix."""
    rng = np.random.default_rng(30 + ring)
    B, D, nq, nkv, hd = 4, 64, 4, 2, 16
    P = (nq + 2 * nkv) * hd
    if ring:
        S = window = 16
        lens = np.array([-1, 5, 16, 37], np.int32)
        pos = np.stack([_ring_pos(S, n) for n in (20, 5, 16, 37)], axis=1)
        inc = (lens >= 0).astype(np.int32)
        pos_base = -1
        assert pos[37 % S, 3] == 37 - window
    else:
        S, window = 32, 8
        lens = np.array([-1, 0, 9, 31], np.int32)
        pos = np.where(np.arange(S)[:, None] < lens[None, :] + 3,
                       np.arange(S)[:, None], -1).astype(np.int32)
        inc = ((lens >= 0) & (lens < S)).astype(np.int32)
        pos_base = 0
    ang = lens.astype(np.float32)[:, None] * (
        10000.0 ** (-np.arange(hd // 2, dtype=np.float32) / (hd // 2)))
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = dict(x=f(B, D), wqkv=f(D, P, sc=3 * D ** -0.5),
                wo=f(nq, hd, D, sc=(nq * hd) ** -0.5), ln1=f(D, sc=0.1),
                kc=f(S, B * nkv, hd, sc=3.0), vc=f(S, B * nkv, hd), pos=pos,
                lens=lens, inc=inc, cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, bf16 and k not in ("ln1", "cos", "sin"))
    mode = dict(window=window, attn_softcap=50.0)
    got = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq, kv_heads=nkv,
        norm_eps=1e-6, **mode)
    kc, vc = (j[k].reshape(S, B, nkv, hd) for k in ("kc", "vc"))

    def one(use_ref, xb, kb, vb, cl, cb, sb, pb, ib):
        kw = dict(q_heads=nq, kv_heads=nkv, fuse_out="partial_o", pos=pb,
                  include_new=ib, norm_scale=j["ln1"], norm_eps=1e-6, **mode)
        if use_ref:
            out = fused_decode_attention_ref(xb[None], j["wqkv"], None,
                                             j["wo"], kb, vb, cl, cb, sb,
                                             **kw)
        else:
            out = jax_fused_decode(xb[None], j["wqkv"], None, j["wo"], kb,
                                   vb, cl, cb, sb, block_s=8, interpret=True,
                                   ring=ring, pos_base=jnp.int32(pos_base),
                                   **kw)
        return tuple(o[0] for o in out)

    for use_ref in (False, True):
        want = jax.jit(jax.vmap(lambda *a: one(use_ref, *a),
                                in_axes=(0, 1, 1, 0, 0, 0, 1, 0)))(
            j["x"], kc, vc, j["lens"], j["cos"], j["sin"], j["pos"],
            j["inc"])
        for name, g, w in zip(("o", "k_new", "v_new", "m", "l"), got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            np.testing.assert_allclose(_np(g), _np(w), **(BF16 if bf16
                                                           else F32),
                                       err_msg=f"{name} ref={use_ref}")
    assert torch.all(got[4][0] == 1.0)      # a free slot: l = 1, no NaN
    # the window and the cap both changed the result
    for other in (dict(window=0, attn_softcap=50.0),
                  dict(window=window, attn_softcap=0.0)):
        alt = b1.fused_decode_attention(
            t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"],
            t["pos"], t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq,
            kv_heads=nkv, norm_eps=1e-6, **other)
        assert not torch.allclose(alt[0][3], got[0][3]), other


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("add_r", [0.0, 1.0])
def test_fused_ffn_post_ln1_plain_vs_pallas_and_ref(add_r, bf16):
    """Gated ``gelu_tanh`` with ``post_ln1``: ``r = x + rms(a,
    post_ln1)``, rounded where the reference rounds; ``add_r`` 0 is the
    post-norm model's (the second add after the kernel), 1 the other
    models'."""
    rng = np.random.default_rng(31)
    B, D, F = 3, 64, 96
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = [f(B, D), f(B, D, sc=3.0), f(D, F, sc=D ** -0.5),
            f(D, F, sc=D ** -0.5), f(F, D, sc=F ** -0.5), f(D, sc=0.1),
            f(D, sc=0.1)]
    j, t = zip(*(_both(a, bf16 and i < 5) for i, a in enumerate(arrs)))
    got = b2.fused_ffn_block(*t[:6], post_ln1=t[6], add_r=add_r,
                             act="gelu_tanh", eps=1e-6)
    kw = dict(act="gelu_tanh", eps=1e-6)
    for want in (jax_ffn(*j[:6], j[6], jnp.float32(add_r), block_f=32,
                         interpret=True, **kw),
                 fused_ffn_block_ref(*j[:6], j[6], add_r, **kw)):
        for name, g, w in zip(("o", "r"), got, want):
            assert g.dtype == t[0].dtype
            np.testing.assert_allclose(_np(g), _np(w), **(BF16 if bf16
                                                           else F32),
                                       err_msg=name)
    no_post = b2.fused_ffn_block(*t[:6], add_r=add_r, act="gelu_tanh",
                                 eps=1e-6)
    assert not torch.allclose(no_post[1].float(), got[1].float())


# capped head values against the reference: C3's 4 f32 ulps of
# summation order (7 here, on these logits) plus the reference's f32
# tanh, which differs from torch's by up to 4 ulps of the capped value
# (XLA's approximation; measured over [−5, 5]); against the exact cap of
# the f64 sum the port's values hold to 2 ulps
CAPPED_ULPS, EXACT_ULPS = 12, 2


def _close_ulps(got, want, n):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= n * ulp).all(), (got, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_head_softcap_plain_vs_pallas_and_ref(bf16):
    """Logit softcap 30 before the top-k.  Slot 0's two best rows, 20 and
    70, have different logits near 250 (row 70's larger: one element a
    bf16 step up) that the cap makes equal in f32: the tie goes to the
    lower index, 20 first — capping only the survivors would put 70
    first.  Slot 1 holds an exact tie across vocab tiles."""
    rng = np.random.default_rng(32)
    B, D, V = 3, 64, 96
    x = rng.standard_normal((B, D)).astype(np.float32)
    x[0] = np.sign(x[0])                     # rms 1: h = x/√(1 + ε)
    table = (rng.standard_normal((V, D)) * D ** -0.5).astype(np.float32)
    table[20] = np.sign(x[0]) * (250.0 / D)          # 3.90625: bf16 exact
    table[70] = table[20]
    table[70, 5] += np.sign(x[0, 5]) * 0.015625      # the next bf16 up
    table[41] = table[90] = np.sign(x[1]) * 0.2      # tiles 1 and 2
    ln = np.zeros(D, np.float32)
    (jx, jt, jl), (tx, tt, tl) = zip(_both(x, bf16), _both(table, bf16),
                                     _both(ln, False))
    h = layers.rms_norm(tx, tl).double()
    raw = (h @ tt.double().T).float()
    assert raw[0, 70] > raw[0, 20]
    capped = torch.tanh(raw / 30.0) * 30.0
    assert capped[0, 70] == capped[0, 20]
    gv, gi = b3.fused_head_block(tx, tt, tl, eps=1e-6, logit_softcap=30.0,
                                 k=8)
    assert gi[0, :2].tolist() == [20, 70] and gi[1, :2].tolist() == [41, 90]
    assert (gv <= 30.0).all()
    exact = torch.tanh(h @ tt.double().T / 30.0) * 30.0
    _close_ulps(gv.numpy(), torch.gather(exact, 1, gi.long()).float(),
                EXACT_ULPS)
    for wv, wi in (jax_head(jx, jt, jl, eps=1e-6, logit_softcap=30.0,
                            block_v=32, k=8, interpret=True),
                   fused_head_ref(jx, jt, jl, eps=1e-6, logit_softcap=30.0,
                                  k=8)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close_ulps(gv.numpy(), wv, CAPPED_ULPS)


# ---------------------------------------------------------------------------
# The f32 forward; prefill's ring fill; the engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_fused():
    """The reference's fused engine (interpret-mode Pallas, prepacked,
    the fused head) on the same weights, built once for the module."""
    cfg, _ = _configs()
    return ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                     batch_global=SLOTS,
                     options=RefOptions(backend="pallas", interpret=True,
                                        prepack="on", fuse_head=True))


@pytest.fixture(scope="module")
def engines():
    """(reference on "xla", port on "xla", port on "pallas"), all on the
    reference's weights with the post-norms; the reference engine is
    built once for the module."""
    cfg, port_cfg = _configs()
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    ports = [build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                               device="cpu", train_params=train,
                               options=EngineOptions(backend=b))
             for b in ("xla", "pallas")]
    return (ref, *ports)


def test_f32_forward_with_post_norms_matches_reference(engines):
    """The train-path forward (both post-norms, the local layer's window
    and the attention softcap over 80 positions, past the window) and the
    capped loose head on the reference engine's weights upcast to f32:
    hidden states and logits to 1e-5, every position's greedy token
    exact."""
    ref, unfused, _ = engines
    cfg, port_cfg = ref.cfg, unfused.cfg
    tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32),
                        ref.params["train"])
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    assert set(params["blocks"][0]) >= {"post_ln1", "post_ln2"}
    toks = np.random.default_rng(33).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    local = unwrap_local(tree)
    want = jax.jit(lambda p, t: ref_forward(CTX, cfg, p, t, remat=False))(
        local, jnp.asarray(toks))
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.softcap(layers.lm_head_logits(head_table(port_cfg, params),
                                              got), cfg.logit_softcap)
    lw = ref_layers.softcap(ref_layers.lm_head_logits(CTX, local["embed"],
                                                      want),
                            cfg.logit_softcap)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(lg), _np(lw), **F32)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(lw).argmax(-1))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(jax.device_get(x))


def _cache(st, p: int):
    """Layer group 0 of block-pattern position ``p`` (0: the local ring,
    1: the global cache) as numpy ``(k, v, pos)``."""
    blk = st["layers"][p]
    return tuple(_host(t).reshape(-1, *t.shape[-(3 if n != "pos" else 2):])
                 [0].astype(np.float32 if n != "pos" else np.int32)
                 for n, t in zip(("k", "v", "pos"), blk))


def test_ring_fill_rewrites_every_row_of_an_admitted_slot(engines):
    """Ragged admits past the wrap: slots admitted with 75, 10 and 64
    tokens, three decode steps, slots 0 and 2 retired and re-admitted
    with 9 and 70 tokens.  After each admit every ring row of every
    slot holds what the reference's engine holds (``pos`` exact, k and v
    to bf16 tolerance), the re-admitted short slot keeps nothing of its
    75-token occupant (rows past its length ``pos`` −1 and zero k/v), and
    ring row ``r`` holds the largest admitted position ≡ ``r``."""
    ref, unfused, _ = engines
    rng = np.random.default_rng(34)
    V = unfused.cfg.vocab_size
    S = unfused.cfg.sliding_window
    steps = [([75, 10, 64], 3), ([9, 0, 70], 0)]
    r_st, p_st = ref.state, unfused.state
    r_st = ref.retire_fn(r_st, np.ones(SLOTS, np.int32))
    p_st = unfused.retire_fn(p_st, np.ones(SLOTS, np.int32))
    for lens, n_dec in steps:
        lens = np.asarray(lens, np.int32)
        toks = rng.integers(0, V, (SLOTS, PROMPT_CAP)).astype(np.int32)
        r_tok, r_st = ref.admit_fn(ref.params["train"], r_st, toks, lens)
        p_tok, p_st = unfused.admit_fn(unfused.params["train"], p_st, toks,
                                       lens)
        got, want = _cache(p_st, 0), _cache(r_st, 0)
        np.testing.assert_array_equal(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, **BF16)
        for b, n in enumerate(lens):
            if n:
                np.testing.assert_array_equal(got[2][:, b], _ring_pos(S, n))
                dead = got[2][:, b] < 0
                assert not got[0].reshape(S, SLOTS, -1)[dead, b].any()
        for _ in range(n_dec):
            # the same input tokens on both sides (a near-tie may pick
            # another greedy token: ROADMAP C2)
            fed = torch.from_numpy(_host(r_tok).copy())
            p_tok, p_st = unfused.decode_fn(unfused.params["serve"], p_st,
                                            fed)
            r_tok, r_st = ref.decode_fn(ref.params["serve"], r_st, r_tok)
        np.testing.assert_array_equal(_cache(p_st, 0)[2], _cache(r_st, 0)[2])
        if n_dec:
            r_st = ref.retire_fn(r_st, np.array([1, 0, 1], np.int32))
            p_st = unfused.retire_fn(p_st, np.array([1, 0, 1], np.int32))


def test_serve_layout_and_launches(engines):
    """``"pallas"``: 2·L + 1 kernel calls a step (B1 on the local and the
    global layer, B2 with ``post_ln1``, B3 with the cap on ``embed``
    itself), ``post_ln2`` beside the bundle, and the train tree's q/k/v
    views of the packed ``wqkv`` (one copy); ``"xla"``: one B5 call a
    layer."""
    _, unfused, fused = engines
    cfg = fused.cfg
    serve = fused.params["serve"]
    assert serve["head"].table is fused.params["train"]["embed"]
    for blk, train in zip(serve["blocks"], fused.params["train"]["blocks"]):
        assert blk["ffn"].post_ln1 is train["post_ln1"]
        assert blk["post_ln2"] is train["post_ln2"]
        store = blk["attn"].wqkv.untyped_storage().data_ptr()
        for name in ("wq", "wk", "wv"):
            assert train["attn"][name].untyped_storage().data_ptr() == store
    for eng, want in ((fused, {"fused_decode": cfg.n_layers,
                               "fused_ffn": cfg.n_layers, "fused_head": 1}),
                      (unfused, {"flash_decode": cfg.n_layers})):
        nxt, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 np.ones((SLOTS, 4), np.int32))
        tracecount.reset()
        eng.decode_fn(eng.params["serve"], st, nxt)
        calls = {k: n for k, n in tracecount.calls().items() if n}
        assert calls == want


def _forced(eng, prompts, forced, *, ref=False):
    if ref:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                                 None)
    else:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts)
    out = [_host(tok).reshape(-1)]
    for t in range(len(forced)):
        f = forced[t] if ref else torch.from_numpy(forced[t])
        tok, st = eng.decode_fn(eng.params["serve"], st, f)
        out.append(_host(tok).reshape(-1))
    return np.stack(out), st


def test_teacher_forced_decode_matches_reference(engines, ref_fused,
                                                 monkeypatch):
    """Both port engines against the reference's engine of the same
    backend (XLA; interpret-mode Pallas, prepacked, on the same weights)
    and against its XLA engine: 60-token prompts, then 10 forced tokens,
    so every slot's ring wraps in decode (at 64): ≥ 0.9 of (step, slot)
    agree, each difference a near-tie among the port's candidates; the
    ring and global ``pos`` exact; and the port's two backends against
    each other."""
    ref, unfused, fused = engines
    rng = np.random.default_rng(35)
    prompts = rng.integers(0, fused.cfg.vocab_size, (SLOTS, 60)).astype(
        np.int32)
    forced = rng.integers(0, fused.cfg.vocab_size, (10, SLOTS)).astype(
        np.int32)
    want, r_st = _forced(ref, prompts, forced, ref=True)
    want_fused, _ = _forced(ref_fused, prompts, forced, ref=True)
    toks, cands = {}, []
    for tail in ("_loose_head_tail", "_fused_head_tail"):
        # every decode step's head candidates, loose (B5 path) or B3's
        real = getattr(engine_mod, tail)
        monkeypatch.setattr(engine_mod, tail, lambda *a, _r=real:
                            cands.append(_r(*a)) or cands[-1])
    for name, eng in (("xla", unfused), ("pallas", fused)):
        cands.clear()
        got, p_st = _forced(eng, prompts, forced)
        assert len(cands) == len(forced)
        for ref_toks in ((want,) if name == "xla" else (want, want_fused)):
            assert (got == ref_toks).mean() >= 0.9, (name, got, ref_toks)
            for t, b in zip(*np.nonzero(got[1:] != ref_toks[1:])):
                vals, ids = (c[b].numpy() for c in cands[t])
                assert ref_toks[1 + t, b] in ids, (name, t, b, ids)
                gap = vals[0] - vals[list(ids).index(ref_toks[1 + t, b])]
                assert gap <= NEAR_TIE, (name, t, b, gap)
        for p in (0, 1):
            np.testing.assert_array_equal(_cache(p_st, p)[2],
                                          _cache(r_st, p)[2])
        assert (_cache(p_st, 0)[2] >= 6).all()          # wrapped: 6 … 69
        toks[name] = got
    assert (toks["xla"] == toks["pallas"]).mean() >= 0.9


def test_staggered_trace_matches_reference(engines):
    """5 requests on 3 slots through the scheduler: a 70-token prompt
    (prefill wraps the ring) and a 58-token one that wraps in decode,
    each admitted while short requests are live, and a re-admitted slot:
    events equal to the reference's on both backends, tokens ≥ 0.9."""
    ref, *ports = engines
    rng = np.random.default_rng(36)
    spec = [(0, 5, 12), (0, 9, 3), (1, 70, 6), (2, 58, 12), (3, 20, 5)]
    prompts = [rng.integers(0, ports[0].cfg.vocab_size, n).tolist()
               for _, n, _ in spec]
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    r_res = ref_replay(r_sched, [(a, RefRequest(i, prompts[i], m))
                                 for i, (a, _, m) in enumerate(spec)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    for port in ports:
        p_sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
        p_res = replay_trace(p_sched, [(a, Request(i, prompts[i], m))
                                       for i, (a, _, m) in enumerate(spec)])
        assert p_sched.events == r_sched.events
        got = np.concatenate([p_res[r].tokens for r in sorted(p_res)])
        assert got.shape == want.shape
        assert (got == want).mean() >= 0.9, (port.scfg.backend, got, want)
        assert (p_sched.cache_lens() == -1).all()
