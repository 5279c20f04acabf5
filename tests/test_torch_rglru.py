"""The port's RecurrentGemma slice (``repro_torch``) held against the JAX
package (``repro``) on the same numpy inputs and the same weights: B6's
plain version against the Pallas RG-LRU scan in interpret mode and its
``ref.py``; the RG-LRU layer functions; the ring-cache attention layer
and the ring fill; the forward; and the lockstep engine on the unfused
``backend="xla"`` path against the JAX XLA engine, at the reduced
RecurrentGemma-9B config with ``n_layers=5`` (kinds R, R, L and a tail
of R, R; ``d_model`` 128, 4 query heads over 1 KV head of 32, window 64,
``max_seq`` 128).  On the CPU B5 and B6 take their plain versions.

Tolerances: f32 ``1e-5`` relative to each row's largest element (the
reference scans with ``lax.associative_scan``, B6 in sequence: summation
order only); bf16 compared in f32 at ``2e-2`` (a value on a bf16
rounding boundary may round the other way under another summation order,
and XLA may keep excess precision inside the causal conv's fusion).  The
attention layer is held to the bf16 tolerance 1e-2 of
``tests/test_torch_xla_path.py`` (ROADMAP C5).  Token streams are bf16
greedy decodes: per-step tokens must agree on at least 90 % of (step,
slot), and every difference must be a near-tie, the reference's token
within ``NEAR_TIE`` of the port's best logit (ROADMAP C2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import dataflow as ref_df
from repro.kernels.rglru_scan.ops import rglru_scan as ref_scan_op
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.launch.serve import generate as ref_generate
from repro.models import layers as ref_layers
from repro.models import rglru as ref_rglru
from repro.models.ctx import ParallelCtx
from repro.models.transformer import Layout, forward as ref_forward
from repro.models.transformer import init_device_major, unwrap_local
from repro.serving import prefill as ref_prefill
from repro.serving.engine import EngineOptions as RefOptions

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import (ATTN_LOCAL, RECURRENT, get_config,
                                 reduced)
from repro_torch.core import tracecount
from repro_torch.core import dataflow as df
from repro_torch.kernels.fused_decode.fused_decode import rope_at
from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                       rglru_scan_plain)
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models import layers, rglru
from repro_torch.models.transformer import (forward, from_reference_params,
                                            init_params)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.prefill import _fill_ring
from repro_torch.serving.sampling import head_candidates
from repro_torch.serving.scheduler import Request, SlotScheduler

ARCH = "recurrentgemma-9b"
N_LAYERS = 5                      # one group of (R, R, L) and a tail R, R
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()
SLOTS, MAX_SEQ = 3, 128
D, C, NB, WIDTH = 64, 64, 4, 4    # layer tests: d_model, channels, gate blocks
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a: np.ndarray, bf16: bool):
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _rowwise(a: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return a / np.maximum(np.abs(scale).max(axis=-1, keepdims=True), 1e-30)


def _close(got, want, bf16, name=""):
    """f32: within 1e-5 of each row's largest element; bf16: 2e-2, and
    the dtype kept."""
    if want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, name
    g, w = _np(got), _np(want)
    if bf16:
        np.testing.assert_allclose(g, w, **BF16, err_msg=name)
    else:
        np.testing.assert_allclose(_rowwise(g, w), _rowwise(w, w), **F32,
                                   err_msg=name)


def test_reduced_config_keeps_the_slice_shapes():
    """The reduced config the tests run: R, R, L and a tail of R, R,
    MQA (4 query heads over 1 KV head of 32), window 64, ``d_state`` =
    ``d_model``, tied embeddings — as the reference reduces it."""
    port, ref = (reduced(get_config(ARCH), n_layers=N_LAYERS),
                 ref_reduced(ref_get_config(ARCH), n_layers=N_LAYERS))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.layer_kinds == (RECURRENT, RECURRENT, ATTN_LOCAL,
                                RECURRENT, RECURRENT)
    assert (port.n_heads, port.n_kv_heads, port.resolved_head_dim,
            port.sliding_window, port.rglru_d_state) == (4, 1, 32, 64, 0)
    assert port.tie_embeddings and not port.is_attention_free


# ---------------------------------------------------------------------------
# B6: the plain version against the Pallas kernel and its ref.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,Ch", [(2, 256, 128), (1, 64, 512),
                                    (4, 128, 64), (3, 1, 128)])
def test_rglru_scan_plain_matches_pallas_and_ref(B, S, Ch):
    """``tests/test_kernels.py:288``'s f32 shapes plus ``S = 1`` (the
    decode step), from a nonzero ``h0``: ``h_seq`` and ``h_fin`` within
    1e-5 of the interpret-mode kernel and of ``ref.py``; the wrapper
    takes the plain version on the CPU (a call, no launch) and writes
    ``h_fin`` in place into ``h_out``."""
    rng = np.random.default_rng(5)
    la = (-np.abs(rng.standard_normal((B, S, Ch))) * 0.1).astype(np.float32)
    b = (rng.standard_normal((B, S, Ch)) * 0.2).astype(np.float32)
    h0 = (rng.standard_normal((B, Ch)) * 0.3).astype(np.float32)
    args = [jnp.asarray(a) for a in (la, b, h0)]
    wants = (ref_scan_op(*args, block_t=64, block_c=64, interpret=True),
             ref_scan_op(*args, use_ref=True))
    state = torch.from_numpy(h0.copy())
    tracecount.reset()
    h_seq, h_fin = rglru_scan(torch.from_numpy(la), torch.from_numpy(b),
                              state, h_out=state)
    assert tracecount.calls()["rglru_scan"] == 1
    assert sum(tracecount.launches().values()) == 0
    assert h_fin.data_ptr() == state.data_ptr()
    assert h_seq.dtype == h_fin.dtype == torch.float32
    for o, hf in wants:
        np.testing.assert_allclose(h_seq.numpy(), np.asarray(o), **F32)
        np.testing.assert_allclose(h_fin.numpy(), np.asarray(hf), **F32)
    again, _ = rglru_scan_plain(torch.from_numpy(la), torch.from_numpy(b),
                                torch.from_numpy(h0))
    assert torch.equal(again, h_seq)


# ---------------------------------------------------------------------------
# The RG-LRU layer functions
# ---------------------------------------------------------------------------
F32_LEAVES = ("b_r", "b_i", "lam")        # f32 in the reference's init


def _params(bf16, seed=0):
    """RG-LRU params at the reference's init scales (nonzero biases), as
    the reference's ``RGLRUParams`` and the port's dict."""
    rng = np.random.default_rng(seed)
    n = lambda *shape, sc: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    bs = C // NB
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, C)) * 2.0 / 8.0))
    arrs = dict(w_x=n(D, C, sc=D ** -0.5), w_gate=n(D, C, sc=D ** -0.5),
                conv_w=n(WIDTH, C, sc=0.2), conv_b=n(C, sc=0.1),
                w_r=n(NB, bs, bs, sc=bs ** -0.5), b_r=n(C, sc=0.1),
                w_i=n(NB, bs, bs, sc=bs ** -0.5), b_i=n(C, sc=0.1),
                lam=lam.astype(np.float32), w_out=n(C, D, sc=bs ** -0.5))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _pair(a, bf16 and k not in F32_LEAVES)
    return ref_rglru.RGLRUParams(**j), t


def _state(B, seed=1):
    """A random nonzero f32 RGLRUState (its dtype in serving)."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((B, C)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((B, WIDTH - 1, C)).astype(np.float32)
    (jh, th), (jc, tc) = _pair(h, False), _pair(conv, False)
    return ref_rglru.RGLRUState(jh, jc), rglru.RGLRUState(th, tc)


def test_gates_match_reference():
    """``_gates`` of f32 ``u`` on bf16 and f32 weights: ``log a`` (≤ 0)
    and ``i`` in f32."""
    u = np.random.default_rng(2).standard_normal((2, 5, C)).astype(
        np.float32)
    for bf16 in (False, True):
        jp, tp = _params(bf16)
        g_la, g_i = rglru._gates(tp, torch.from_numpy(u))
        w_la, w_i = ref_rglru._gates(jp, jnp.asarray(u))
        assert g_la.dtype == g_i.dtype == torch.float32
        assert (g_la <= 0).all()
        _close(g_la, w_la, False, "log_a")
        _close(g_i, w_i, False, "i")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(bf16, with_tail):
    jp, tp = _params(bf16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, C)).astype(np.float32)
    tail = rng.standard_normal((2, WIDTH - 1, C)).astype(np.float32)
    (jx, tx), (jt, tt) = _pair(x, bf16), _pair(tail, False)
    got = rglru._causal_conv(tp, tx, tt if with_tail else None)
    want = ref_rglru._causal_conv(jp, jx, jt if with_tail else None)
    _close(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_scan_and_step_match_reference(bf16):
    """``rglru_scan`` over 9 steps from the zero state; ``rglru_step``
    from a random f32 state: both outputs (the step's in ``u``'s dtype
    and in the state's f32)."""
    jp, tp = _params(bf16)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 9, C)).astype(np.float32)
    ju, tu = _pair(u, bf16)
    _close(rglru.rglru_scan(tp, tu), ref_rglru.rglru_scan(jp, ju), bf16,
           "scan")
    js, ts = _state(3)
    u1 = rng.standard_normal((3, C)).astype(np.float32)
    ju1, tu1 = _pair(u1, bf16)
    g_h, g_new = rglru.rglru_step(tp, tu1, ts.h)
    w_h, w_new = ref_rglru.rglru_step(jp, ju1, js.h)
    _close(g_h, w_h, bf16, "h")
    assert g_new.dtype == torch.float32
    _close(g_new, w_new, False, "h_new")


@pytest.mark.parametrize("bf16", [False, True])
def test_block_and_block_step_match_reference(bf16):
    """The full block over 11 tokens, and one decode step from a random
    state: the output and both leaves of the new state."""
    jp, tp = _params(bf16)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, D)).astype(np.float32)
    jx, tx = _pair(x, bf16)
    _close(rglru.rglru_block(tp, tx), ref_rglru.rglru_block(CTX, jp, jx),
           bf16, "block")
    js, ts = _state(3)
    x1 = rng.standard_normal((3, D)).astype(np.float32)
    jx1, tx1 = _pair(x1, bf16)
    got, g_st = rglru.rglru_block_step(tp, tx1, ts)
    want, w_st = ref_rglru.rglru_block_step(CTX, jp, jx1, js)
    _close(got, want, bf16, "y")
    _close(g_st.h, w_st.h, bf16, "h")
    _close(g_st.conv, w_st.conv, bf16, "conv")


def test_step_equals_one_token_of_the_block():
    """From the zero state the decode step is the block at S = 1."""
    _, tp = _params(False)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, D)).astype(np.float32))
    zero = rglru.rglru_state_init(2, C, WIDTH, device="cpu")
    y, st = rglru.rglru_block_step(tp, x, zero)
    torch.testing.assert_close(y, rglru.rglru_block(tp, x[:, None])[:, 0],
                               **F32)
    assert torch.equal(st.conv[:, -1], (x @ tp["w_x"]).float())


# ---------------------------------------------------------------------------
# The ring cache: the XLA branch of split_token_attention, and the fill
# ---------------------------------------------------------------------------
def _ring_pos(lens, S, rng, stale=True):
    """Ring positions before this step's append: row r of a slot with
    length c holds the newest position p < c with p ≡ r (mod S); a row
    with none holds −1 or, from an earlier, longer occupant, a position
    past c (which the reference's mask drops)."""
    pos = np.full((S, len(lens)), -1, np.int32)
    for b, c in enumerate(lens):
        for r in range(S):
            live = [p for p in range(max(c, 0)) if p % S == r]
            if live:
                pos[r, b] = live[-1]
            elif stale and rng.random() < 0.5:
                pos[r, b] = r + S * (max(c, 0) // S + 1)
    return pos


def test_ring_split_token_attention_matches_reference_xla_branch():
    """One local-attention layer on an 8-row ring with window 8 at
    lengths −1 (free), 0, 1, 5, 7, 8 (the append wraps), 13 and 21
    (wrapped), with stale rows from an earlier occupant: the output
    within 1e-2, the appended ring (k, v, pos) exactly, against the
    reference run under ``shard_map`` on a one-device mesh."""
    rng = np.random.default_rng(0)
    S, Dm, hd, q_loc, kv_loc = 8, 64, 16, 4, 1
    lens = np.array([-1, 0, 1, 5, 7, 8, 13, 21], np.int32)
    B = len(lens)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x = f(B, Dm)
    wq, wk, wv = (f(Dm, n, hd, sc=Dm ** -0.5) for n in (q_loc, kv_loc,
                                                        kv_loc))
    wo = f(q_loc * hd, Dm, sc=(q_loc * hd) ** -0.5)
    k, v = f(S, B * kv_loc, hd), f(S, B * kv_loc, hd)
    pos = _ring_pos(lens, S, rng)
    assert (pos[:, 2] > 1).any()                     # a stale row in play

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    mesh = jax.make_mesh((1,), ("c",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    spec = ref_df.ClusterSpec(heads="c", cluster="c", backend="xla",
                              block_s=4)

    def body(k, v, pos, lens, x, wq, wk, wv, wo):
        w = ref_df.SplitTokenWeights(wq, wk, wv, wo)
        o, c = ref_df.split_token_attention(
            spec, x, w, ref_df.KVBlock(k, v, pos), lens, window=S)
        return o, c.k, c.v, c.pos

    args = [bf(k), bf(v), jnp.asarray(pos), jnp.asarray(lens)] + [
        bf(a) for a in (x, wq, wk, wv, wo)]
    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),) * len(args),
                             out_specs=(P(),) * 4, check_vma=False))(*args)

    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    cache = df.KVBlock(tb(k), tb(v), torch.from_numpy(pos.copy()))
    t_lens = torch.from_numpy(lens)
    cos, sin = rope_at(t_lens, hd)
    w = df.SplitTokenWeights(tb(wq), tb(wk), tb(wv), tb(wo))
    got = df.split_token_attention(tb(x), w, cache, t_lens, cos, sin,
                                   window=S)
    assert not got[0].any()                          # a free slot: zeros
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want[0], np.float32),
                               rtol=1e-2, atol=1e-2)
    for name, g, r in zip(("k", "v", "pos"), cache, want[1:]):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r, np.float32),
                                      err_msg=name)


def test_fill_ring_matches_reference():
    """Prefill's ring fill on an 8-row ring over a cache full of an
    earlier batch's rows: lengths 0 (slot untouched), 3, 8 and 13 (the
    prompt wraps the ring), k/v/pos exactly as the reference's."""
    rng = np.random.default_rng(1)
    S, S_p, kv, hd = 8, 13, 1, 4
    lens = np.array([0, 3, 8, 13], np.int32)
    B = len(lens)
    k_old, v_old = (rng.standard_normal((S, B * kv, hd)).astype(np.float32)
                    for _ in range(2))
    pos_old = rng.integers(-1, 40, (S, B)).astype(np.int32)
    ks, vs = (rng.standard_normal((S_p, B * kv, hd)).astype(np.float32)
              for _ in range(2))
    want = ref_prefill._fill_ring(
        ref_df.KVBlock(*(jnp.asarray(a) for a in (k_old, v_old, pos_old))),
        (jnp.asarray(ks), jnp.asarray(vs)), 0, jnp.asarray(lens), S)
    cache = df.KVBlock(*(torch.from_numpy(a.copy())
                         for a in (k_old, v_old, pos_old)))
    rows = torch.tensor([1, 2, 3])
    to_rows = lambda a: torch.from_numpy(a).reshape(S_p, B, kv, hd)[
        :, rows].transpose(0, 1)                      # [n, S_p, kv, hd]
    _fill_ring(cache, to_rows(ks), to_rows(vs), rows,
               torch.from_numpy(lens)[rows])
    for name, g, r in zip(("k", "v", "pos"), cache, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced_model():
    cfg = ref_reduced(ref_get_config(ARCH), n_layers=N_LAYERS)
    tree = init_device_major(cfg, Layout(1), jax.random.PRNGKey(2))
    port_cfg = reduced(get_config(ARCH), n_layers=N_LAYERS)
    return cfg, port_cfg, tree


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_logits_match_reference(reduced_model, bf16):
    """The train-path forward over 70 tokens (past the 64-position
    window) and the tied head: f32 hidden states and logits to 1e-5 of
    each row's largest element, tokens equal; in bf16 the greedy tokens
    agree on at least 90 % of positions, every other one a near-tie in
    the reference's own logits."""
    cfg, port_cfg, tree = reduced_model
    if not bf16:
        tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32), tree)
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    assert "lm_head" not in params and len(params["tail"]) == 2
    assert set(params["tail"][0]) == {"ln1", "ln2", "rglru", "ffn"}
    assert set(params["blocks"][0]["rglru"]) == set(
        ref_rglru.RGLRUParams._fields)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 70)).astype(np.int32)
    want = ref_forward(CTX, cfg, unwrap_local(tree), jnp.asarray(toks),
                       remat=False)
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.lm_head_logits(params["embed"], got)
    lw = _np(ref_layers.lm_head_logits(CTX, unwrap_local(tree)["embed"],
                                       want))[..., :cfg.vocab_size]
    g_tok, w_tok = lg.argmax(-1).numpy(), lw.argmax(-1)
    if not bf16:
        for g, w in ((_np(got), _np(want)), (_np(lg), lw)):
            np.testing.assert_allclose(_rowwise(g, w), _rowwise(w, w), **F32)
        np.testing.assert_array_equal(g_tok, w_tok)
    assert (g_tok == w_tok).mean() >= 0.9, (g_tok, w_tok)
    best = np.take_along_axis(lw, w_tok[..., None], -1)[..., 0]
    port_pick = np.take_along_axis(lw, g_tok[..., None], -1)[..., 0]
    assert (best - port_pick).max() <= NEAR_TIE, best - port_pick


def test_init_params_layout():
    """Seeded init: the reference's leaves, shapes and dtypes, the group
    axis leading in ``blocks`` and none in ``tail``, no ``lm_head``."""
    cfg = reduced(get_config(ARCH), n_layers=N_LAYERS)
    p = init_params(cfg, seed=1, device="cpu")
    ref = init_device_major(ref_reduced(ref_get_config(ARCH),
                                        n_layers=N_LAYERS), Layout(1),
                            jax.random.PRNGKey(0))
    want = jax_tree_to_numpy(jax.tree.map(lambda a: a[0], ref))
    for got_blk, ref_blk, lead in (
            [(g, r, 1) for g, r in zip(p["blocks"], want["blocks"])]
            + [(g, r, 0) for g, r in zip(p["tail"], want["tail"])]):
        assert set(got_blk) == set(ref_blk)
        for part in ("rglru", "attn", "ffn"):
            for name, leaf in got_blk.get(part, {}).items():
                r = ref_blk[part][name]
                assert tuple(leaf.shape) == r.shape, (part, name)
                assert str(leaf.dtype).split(".")[-1] == str(r.dtype), name
    assert len(p["tail"]) == 2 and "lm_head" not in p
    assert tuple(p["blocks"][2]["attn"]["wk"].shape) == (1, 128, 1, 32)


# ---------------------------------------------------------------------------
# The lockstep engine against the JAX XLA engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = ref_reduced(ref_get_config(ARCH), n_layers=N_LAYERS)
    port_cfg = reduced(get_config(ARCH), n_layers=N_LAYERS)
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train)
    return ref, port


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x))


def _ring(st) -> np.ndarray:
    """The local layer's ring ``pos [S, B]`` (group 0)."""
    pos = st["layers"][2].pos
    return _host(pos).reshape(-1, *pos.shape[-2:])[0]


def test_decode_state_layout_matches_reference(engines):
    """Default options serve on ``"xla"`` with the train tree; the state
    has the reference's leaves, shapes and dtypes: RG-LRU ``h``/``conv``
    f32 per group and per tail layer, a ring of ``min(window, max_seq)``
    = 64 rows for the local layer."""
    ref, port = engines
    assert (port.scfg.backend, port.scfg.prepack) == ("xla", False)
    assert ref.scfg.backend == "xla"
    assert port.params["serve"] is port.params["train"]
    unwrap = lambda leaf: tuple(leaf.shape[2:])     # drop the [dp, ms] wrap
    pairs = (list(zip(ref.state["layers"], port.state["layers"]))
             + list(zip(ref.state["tail"], port.state["tail"])))
    assert len(pairs) == 5
    for r, p in pairs:
        assert type(p).__name__ == type(r).__name__
        for name in r._fields:
            assert tuple(getattr(p, name).shape) == unwrap(getattr(r, name))
            assert str(getattr(p, name).dtype).split(".")[-1] == \
                str(getattr(r, name).dtype), name
    assert tuple(port.state["layers"][2].k.shape) == (1, 64, SLOTS, 32)
    assert tuple(port.state["tail"][0].h.shape) == (SLOTS, 128)


def test_decode_step_makes_one_kernel_call_per_layer(engines):
    """``L`` wrapper calls a step: one B6 per RG-LRU layer (groups and
    tail), one B5 per local-attention layer, nothing else."""
    _, port = engines
    nxt, st = port.prefill_fn(port.params["train"], port.state,
                              np.ones((SLOTS, 4), np.int32))
    tracecount.reset()
    port.decode_fn(port.params["serve"], st, nxt)
    calls = tracecount.calls()
    assert calls == {"fused_decode": 0, "fused_ffn": 0, "fused_head": 0,
                     "fused_mla_decode": 0, "rwkv6_scan": 0,
                     "flash_decode": 1, "rglru_scan": 4}
    assert sum(calls.values()) == port.cfg.n_layers
    assert sum(tracecount.launches().values()) == 0     # CPU: no kernels


def _capture_loose_head(monkeypatch):
    cands = []
    real = engine_mod.head_candidates

    def capture(logits, k):
        out = real(logits, k)
        cands.append(out)
        return out

    monkeypatch.setattr(engine_mod, "head_candidates", capture)
    return cands


def test_teacher_forced_decode_matches_reference(engines, monkeypatch):
    """70-token prompts (the ring wraps in prefill), then 8 forced input
    tokens on both sides: greedy tokens agree on ≥ 0.9 of (step, slot),
    every difference a near-tie (with these seeds 26 of 27 agree); the
    ring positions exactly, and the first layer's f32 ``h`` after the
    last step to 1e-5 of each slot's largest element (summation order
    only: its input is the embedding; measured 1.6e-7)."""
    ref, port = engines
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, port.cfg.vocab_size, (SLOTS, 70)).astype(
        np.int32)
    forced = rng.integers(0, port.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    r_tok, r_st = ref.prefill_fn(ref.params["train"], ref.state, prompts,
                                 None)
    p_tok, p_st = port.prefill_fn(port.params["train"], port.state, prompts)
    np.testing.assert_array_equal(_ring(p_st), _ring(r_st))
    cands = _capture_loose_head(monkeypatch)
    r_out, p_out = [_host(r_tok).reshape(-1)], [_host(p_tok)]
    for t in range(len(forced)):
        r_tok, r_st = ref.decode_fn(ref.params["serve"], r_st, forced[t])
        p_tok, p_st = port.decode_fn(port.params["serve"], p_st,
                                     torch.from_numpy(forced[t]))
        r_out.append(_host(r_tok).reshape(-1))
        p_out.append(_host(p_tok))
    want, got = np.stack(r_out), np.stack(p_out)
    assert (got == want).mean() >= 0.9, (got, want)
    for t, b in zip(*np.nonzero(got[1:] != want[1:])):
        vals, ids = (c[b].numpy() for c in cands[t])
        assert want[1 + t, b] in ids, (t, b, ids)
        assert vals[0] - vals[list(ids).index(want[1 + t, b])] <= NEAR_TIE
    np.testing.assert_array_equal(_ring(p_st), _ring(r_st))
    np.testing.assert_array_equal(_host(p_st["cache_lens"]),
                                  _host(r_st["cache_lens"]).reshape(-1))
    g_h = _np(p_st["layers"][0].h[0])
    w_h = _np(r_st["layers"][0].h).reshape(g_h.shape)
    np.testing.assert_allclose(_rowwise(g_h, w_h), _rowwise(w_h, w_h),
                               **F32)


def _generate_with_candidates(port, state, prompts, n_new, monkeypatch):
    """``generate`` on the port's engine, keeping each token's head
    candidates: the prefill's from its last-position logits, every
    decode step's from the loose head."""
    tp = port.params["train"]
    h = forward(port.cfg, tp, torch.from_numpy(prompts))[:, -1]
    first = head_candidates(layers.lm_head_logits(tp["embed"], h))
    steps = _capture_loose_head(monkeypatch)
    toks, st = generate(port.params, port.prefill_fn, port.decode_fn, state,
                        torch.from_numpy(prompts), n_new)
    return toks.numpy(), st, [first] + steps


def test_two_generate_batches_match_reference(engines, monkeypatch):
    """Two lockstep batches on one engine, the second from what the first
    left: 70-token prompts and 8 new tokens (the ring wraps in prefill),
    then 60-token prompts and 12 new tokens (it wraps in decode, over the
    first batch's stale rows).  Each slot's stream equals the
    reference's up to its first difference, and there the reference's
    token is a near-tie among the port's candidates (with these seeds the
    first batch agrees on every token; in the second, slot 1 splits at
    its fourth token); the ring positions match after each batch, and
    the second batch equals a fresh engine's exactly."""
    ref, port = engines
    rng = np.random.default_rng(1)
    r_st, p_st = ref.state, port.state
    for n_prompt, n_new in ((70, 8), (60, 12)):
        prompts = rng.integers(0, port.cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        r_toks, r_st = ref_generate(ref.cfg, ref.params, ref.prefill_fn,
                                    ref.decode_fn, r_st, prompts, n_new)
        got, p_st, cands = _generate_with_candidates(port, p_st, prompts,
                                                     n_new, monkeypatch)
        want = _host(r_toks).reshape(SLOTS, n_new)
        for b in range(SLOTS):
            diff = np.nonzero(got[b] != want[b])[0]
            if len(diff):
                vals, ids = (c[b].numpy() for c in cands[diff[0]])
                assert want[b, diff[0]] in ids, (b, diff, ids)
                gap = vals[0] - vals[list(ids).index(want[b, diff[0]])]
                assert gap <= NEAR_TIE, (b, diff, gap)
        np.testing.assert_array_equal(_ring(p_st), _ring(r_st))
        assert _host(p_st["cache_lens"]).tolist() == \
            [n_prompt + n_new - 1] * SLOTS
    fresh = build_engine_full(port.cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              device="cpu", train_params=port.params["train"])
    again, _ = generate(fresh.params, fresh.prefill_fn, fresh.decode_fn,
                        fresh.state, torch.from_numpy(prompts), n_new)
    np.testing.assert_array_equal(again.numpy(), got)


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


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_fused_backend_raises_naming_item_10(backend):
    """``"auto"`` resolves to ``"pallas"`` as in the reference (the model
    has attention layers), and the fused arm raises before any weight is
    made; it never falls back to ``"xla"``."""
    cfg = reduced(get_config(ARCH), n_layers=N_LAYERS)
    with pytest.raises(NotImplementedError, match="item 10"):
        build_engine_full(cfg, max_seq=16, batch_global=2, device="cpu",
                          options=EngineOptions(backend=backend))
