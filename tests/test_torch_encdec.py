"""The port's modality models — SeamlessM4T-medium (an encoder over stub
audio frames, cross-attended by every decoder layer) and InternVL2-2B
(stub patch embeddings spliced into the prompt) — held against the JAX
package at reduced size, with the same weights carried across by
``from_reference_params`` and the same inputs made with numpy from a
seed:

* the configs, field for field;
* ``encode``, ``cross_attention`` and ``engine._cross_decode`` against
  the reference's in f32, to 1e-5 (summation order only);
* the f32 train-path forward of both models, to 1e-5;
* prefill's ``enc_kv`` against the reference's state, to the bf16
  tolerance, written into the state's own tensors;
* B1's plain version at ``head_dim`` 64 and MHA (``dataclasses.replace``
  of the reduced SeamlessM4T to ``head_dim`` 64: ``reduced()`` gives 32)
  against the interpret-mode Pallas kernel and its ``ref.py`` (f32 to
  1e-5, bf16 to 2e-2), and ``cluster_plan`` at the full shapes;
* B3's plain version at a vocabulary that is no multiple of 16 against
  the reference's (indices exact, values within 4 f32 ulps: ROADMAP C3);
* both port backends' lockstep engines against the JAX XLA engine, and
  the fused one against the JAX interpret-mode Pallas engine,
  teacher-forced: at least 0.9 of (step, slot) agree, every difference a
  near-tie among the port's candidates (ROADMAP C2);
* the graphed step (``serving/step_graph.py``, with the fake graph
  factory of ``tests/test_torch_step_graph.py``) reading the ``enc_kv``
  each prefill writes in place: two ``generate`` batches on other
  frames give the eager step's tokens, and a rebound ``enc_kv`` raises;
* ``SlotScheduler`` and ``admit_fn`` refusing these models, as the
  reference's do.
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
from repro.kernels.fused_head.fused_head import fused_head_block as jax_head
from repro.kernels.fused_head.ref import fused_head_ref
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.models import transformer as ref_tf
from repro.models.ctx import ParallelCtx
from repro.serving import engine as ref_engine
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import SlotScheduler as RefScheduler

from test_torch_kernels import _record_launch
from test_torch_layers import jax_tree_to_numpy
from test_torch_step_graph import _capture_rules

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.kernels.fused_head import fused_head as b3
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models import transformer as tf
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving import step_graph
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.step_graph import StepGraph

ARCHS = ("seamless-m4t-medium", "internvl2-2b")
SLOTS, MAX_SEQ, PROMPT = 3, 48, 20     # prompts hold the 16 patch positions
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
HEAD_ULPS = 4
CTX = ParallelCtx()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, bf16: bool):
    if a.dtype.kind != "f" or not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _frontend(cfg, seed: int) -> np.ndarray:
    f = cfg.frontend
    return np.random.default_rng(seed).standard_normal(
        (SLOTS, f.num_positions, f.feature_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(get_config(arch)),
                       ref_reduced(ref_get_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.frontend.num_positions) == {
        "seamless-m4t-medium": (12, 1024, 16, 16, 64, 4096, 256206, 1024),
        "internvl2-2b": (24, 2048, 16, 8, 128, 8192, 92553, 256)}[arch]


# ---------------------------------------------------------------------------
# The engines, on the reference's weights (built once per model)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    """(reference on "xla", reference on interpret-mode "pallas", port on
    "xla", port on "pallas"), all on the reference XLA engine's
    weights."""
    arch = request.param
    cfg, port_cfg = ref_reduced(ref_get_config(arch)), reduced(
        get_config(arch))
    mesh = make_test_mesh(data=1, model=1)
    ref = ref_build(cfg, mesh, max_seq=MAX_SEQ, batch_global=SLOTS,
                    options=RefOptions(backend="xla"))
    ref_fused = ref_build(cfg, mesh, max_seq=MAX_SEQ, batch_global=SLOTS,
                          options=RefOptions(backend="pallas",
                                             interpret=True, prepack="on",
                                             fuse_head=True))
    train = from_ref(port_cfg, ref.params["train"])
    ports = [build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                               device="cpu", train_params=train,
                               options=EngineOptions(backend=b))
             for b in ("xla", "pallas")]
    return (ref, ref_fused, *ports)


def from_ref(port_cfg, tree):
    return tf.from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                    device="cpu")


def _f32_params(ref, port_cfg):
    """The reference engine's train weights upcast to f32: the JAX local
    tree and the port's."""
    tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32),
                        ref.params["train"])
    return ref_tf.unwrap_local(tree), from_ref(port_cfg, tree)


def test_encoder_and_cross_attention_match_reference():
    """f32, on the reference's own seeded weights of the reduced
    SeamlessM4T: ``encode`` over the frontend's frames, the first
    layer's ``cross_attention`` of a sequence over the encoder's output,
    and ``_cross_decode`` of one row a slot against that layer's k/v as
    prefill lays them out, each to 1e-5."""
    cfg = ref_reduced(ref_get_config("seamless-m4t-medium"))
    port_cfg = reduced(get_config("seamless-m4t-medium"))
    tree = ref_tf.init_device_major(cfg, ref_tf.layout_for(cfg, 1),
                                    jax.random.PRNGKey(3), dtype=jnp.float32)
    local, params = ref_tf.unwrap_local(tree), from_ref(port_cfg, tree)
    fe = _frontend(cfg, 11)
    enc_w = jax.jit(lambda p, f: ref_tf.encode(CTX, cfg, p, f, remat=False))(
        local, jnp.asarray(fe))
    enc_g = tf.encode(port_cfg, params, torch.from_numpy(fe))
    np.testing.assert_allclose(_np(enc_g), _np(enc_w), **F32)

    rng = np.random.default_rng(12)
    x = rng.standard_normal((SLOTS, 7, cfg.d_model)).astype(np.float32)
    ca_w = jax.tree.map(lambda leaf: leaf[0], local["cross_attn"])
    ca_g = tf.cross_params(params, port_cfg)[0]
    want = jax.jit(lambda p, x_, e: ref_tf.cross_attention(
        CTX, p, x_, e, cfg))(ca_w["attn"], jnp.asarray(x), enc_w)
    got = tf.cross_attention(ca_g["attn"], torch.from_numpy(x), enc_g,
                             port_cfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)

    # one decode row a slot against k/v [P, B·kv, hd] (prefill's layout)
    P = cfg.frontend.num_positions
    k = np.einsum("bpd,dkh->pbkh", _np(enc_g), _np(ca_g["attn"]["wk"]))
    v = np.einsum("bpd,dkh->pbkh", _np(enc_g), _np(ca_g["attn"]["wv"]))
    k, v = (t.reshape(P, -1, t.shape[-1]).astype(np.float32) for t in (k, v))
    row = x[:, 0]
    want = jax.jit(lambda c, r, kk, vv: ref_engine._cross_decode(
        CTX, c, r, (kk, vv), cfg))(ca_w, jnp.asarray(row), jnp.asarray(k),
                                   jnp.asarray(v))
    got = engine_mod._cross_decode(ca_g, torch.from_numpy(row),
                                   (torch.from_numpy(k), torch.from_numpy(v)),
                                   port_cfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_f32_forward_matches_reference(engines):
    """The train-path forward on the reference's weights upcast to f32:
    SeamlessM4T's encoder and every layer's cross-attention, InternVL2's
    patch embeddings in place of the first 16 token embeddings; hidden
    states to 1e-5.  A prompt too short for the patches raises."""
    ref, _, unfused, _ = engines
    cfg, port_cfg = ref.cfg, unfused.cfg
    local, params = _f32_params(ref, port_cfg)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (SLOTS, PROMPT)).astype(np.int32)
    fe = _frontend(cfg, 13)
    want = jax.jit(lambda p, t, f: ref_tf.forward(CTX, cfg, p, t, f,
                                                  remat=False))(
        local, jnp.asarray(toks), jnp.asarray(fe))
    got = tf.forward(port_cfg, params, torch.from_numpy(toks),
                     torch.from_numpy(fe))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    if cfg.encoder is None:
        with pytest.raises(ValueError, match="cannot hold"):
            tf.forward(port_cfg, params, torch.from_numpy(toks[:, :8]),
                       torch.from_numpy(fe))


def test_prefill_state_matches_reference(engines):
    """After prefill the first and the last layer's k/v caches hold the
    reference's (InternVL2's patches spliced into the prompt reach them
    through every layer), and SeamlessM4T's ``enc_kv`` — the same
    tensors as before the prefill, as the decode graph needs — holds the
    reference's cross-attention k/v ``[L, P, B·kv, hd]``; bf16 to the
    tensor's scale: an element sums ``D`` products of bf16 activations
    whose roundings differ by an ulp here and there, so a small element
    can move by more than its own bf16 step."""
    ref, _, unfused, fused = engines
    cfg = ref.cfg
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(
        np.int32)
    fe = _frontend(cfg, 15)
    _, r_st = ref.prefill_fn(ref.params["train"], ref.state,
                             jnp.asarray(prompts), jnp.asarray(fe))
    pairs = [(f"layers.{n}", np.asarray(getattr(r_st["layers"][0], n),
                                        np.float32)[0, 0][g], g, n)
             for g in (0, cfg.n_layers - 1) for n in ("k", "v")]
    for eng in (unfused, fused):
        enc_ptrs = {n: t.data_ptr()
                    for n, t in eng.state.get("enc_kv", {}).items()}
        _, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                               torch.from_numpy(fe))
        got = [(name, getattr(st["layers"][0], n)[g], want)
               for name, want, g, n in pairs]
        for n, t in st.get("enc_kv", {}).items():
            assert t.data_ptr() == enc_ptrs[n] and t.dtype == torch.bfloat16
            got.append((f"enc_kv.{n}", t,
                        np.asarray(r_st["enc_kv"][n], np.float32)[0, 0]))
        assert ("enc_kv" in st) == (cfg.encoder is not None)
        for name, t, want in got:
            assert t.shape == want.shape, name
            np.testing.assert_allclose(
                _np(t), want, rtol=BF16["rtol"],
                atol=BF16["atol"] * np.abs(want).max(), err_msg=name)


# ---------------------------------------------------------------------------
# B1 at head_dim 64 (MHA), B3 on a ragged vocabulary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_decode_hd64_plain_vs_pallas_and_ref(bf16):
    """SeamlessM4T's decoder attention at reduced width and ``head_dim``
    64 (4/4 heads, ``D`` 128): ragged lengths (−1 = free, 0, 9, 31) with
    stale entries past each live prefix."""
    cfg = dataclasses.replace(reduced(get_config("seamless-m4t-medium")),
                              head_dim=64)
    rng = np.random.default_rng(21)
    B, D, S = 4, cfg.d_model, 32
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert (nq, nkv, hd) == (4, 4, 64)
    P = (nq + 2 * nkv) * hd
    lens = np.array([-1, 0, 9, 31], np.int32)
    pos = np.where(np.arange(S)[:, None] < lens[None, :] + 3,
                   np.arange(S)[:, None], -1).astype(np.int32)
    inc = (lens >= 0).astype(np.int32)
    ang = lens.astype(np.float32)[:, None] * (
        10000.0 ** (-np.arange(hd // 2, dtype=np.float32) / (hd // 2)))
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = dict(x=f(B, D), wqkv=f(D, P, sc=D ** -0.5),
                wo=f(nq, hd, D, sc=(nq * hd) ** -0.5), ln1=f(D, sc=0.1),
                kc=f(S, B * nkv, hd), vc=f(S, B * nkv, hd), pos=pos,
                lens=lens, inc=inc, cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, bf16 and k not in ("ln1", "cos", "sin"))
    got = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq, kv_heads=nkv,
        norm_eps=1e-6)
    kc, vc = (j[k].reshape(S, B, nkv, hd) for k in ("kc", "vc"))

    def one(use_ref, xb, kb, vb, cl, cb, sb, pb, ib):
        kw = dict(q_heads=nq, kv_heads=nkv, fuse_out="partial_o", pos=pb,
                  include_new=ib, norm_scale=j["ln1"], norm_eps=1e-6)
        if use_ref:
            out = fused_decode_attention_ref(xb[None], j["wqkv"], None,
                                             j["wo"], kb, vb, cl, cb, sb,
                                             **kw)
        else:
            out = jax_fused_decode(xb[None], j["wqkv"], None, j["wo"], kb,
                                   vb, cl, cb, sb, block_s=8, interpret=True,
                                   pos_base=jnp.int32(0), **kw)
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


@pytest.mark.parametrize("heads,kv,D,hd,plan", [
    (16, 16, 1024, 64, (4, 1)),       # SeamlessM4T: 16 clusters of 4
    (16, 8, 2048, 128, (8, 2)),       # InternVL2: 8 clusters of 8
    (16, 8, 1024, 64, (0, 0)),        # GQA at head_dim 64
    (32, 8, 4096, 64, (0, 0)),
    (16, 16, 128, 32, (0, 0))])       # the reduced model's head_dim
def test_cluster_plan_at_head_dim_64(monkeypatch, heads, kv, D, hd, plan):
    """The plan from the shapes alone: at ``head_dim`` 64 only MHA has
    one — a cluster a head, 256 rows a rank at ``D`` 1024 —; any other
    pair is ``(0, 0)``, and the CUDA wrapper then raises
    ``NotImplementedError`` (never the plain version)."""
    assert b1.cluster_plan(heads, kv, D, hd) == plan
    calls = _record_launch(monkeypatch)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    B, S = 2, 8
    args = (torch.zeros(B, D, dtype=bf),
            torch.zeros(D, (heads + 2 * kv) * hd, dtype=bf),
            torch.zeros(heads, hd, D, dtype=bf), torch.zeros(D, dtype=f32),
            torch.zeros(S, B * kv, hd, dtype=bf),
            torch.zeros(S, B * kv, hd, dtype=bf),
            torch.zeros(S, B, dtype=i32), torch.zeros(B, dtype=i32),
            torch.zeros(B, dtype=i32), torch.zeros(B, hd // 2, dtype=f32),
            torch.zeros(B, hd // 2, dtype=f32))
    kw = dict(q_heads=heads, kv_heads=kv, scale=hd ** -0.5, norm_eps=1e-6)
    if plan == (0, 0):
        with pytest.raises(NotImplementedError, match="head_dim"):
            b1.fused_decode_cuda(*args, **kw)
        assert not calls
        return
    b1.fused_decode_cuda(*args, **kw)
    (got,) = calls
    assert got[17:25] == (B, D, S, heads, kv, hd, *plan)   # after bqkv


def _close_ulps(got, want, n):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= n * ulp).all(), (got, want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("V", [1000, 1001])
def test_fused_head_ragged_vocab_plain_vs_pallas_and_ref(V, bf16):
    """B3 at a vocabulary that is no multiple of 16 rows (remainders 8 and
    9, as 92553's): the best rows planted in the last, partial 16-row
    unit and across the vocabulary's two ends (a tie: the lower index
    first); indices exact, values within 4 f32 ulps of the reference's."""
    rng = np.random.default_rng(V)
    B, D = 3, 64
    x = rng.standard_normal((B, D)).astype(np.float32)
    table = (rng.standard_normal((V, D)) * D ** -0.5).astype(np.float32)
    table[V - 1] = np.sign(x[0]) * 0.2               # the last row
    table[V - 3] = np.sign(x[0]) * 0.19
    table[5] = table[V - 2] = np.sign(x[1]) * 0.2    # a tie across the ends
    ln = np.zeros(D, np.float32)
    (jx, jt, jl), (tx, tt, tl) = zip(_both(x, bf16), _both(table, bf16),
                                     _both(ln, False))
    gv, gi = b3.fused_head_block(tx, tt, tl, eps=1e-6, k=8)
    assert gi[0, :2].tolist() == [V - 1, V - 3]
    assert gi[1, :2].tolist() == [5, V - 2]
    block_v = max(d for d in range(1, 257) if V % d == 0)
    for wv, wi in (jax_head(jx, jt, jl, eps=1e-6, block_v=block_v, k=8,
                            interpret=True),
                   fused_head_ref(jx, jt, jl, eps=1e-6, k=8)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close_ulps(gv.numpy(), wv, HEAD_ULPS)


# ---------------------------------------------------------------------------
# The lockstep engines
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x)).reshape(-1)


def _forced(eng, prompts, fe, forced, *, ref=False):
    if ref:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 jnp.asarray(prompts), jnp.asarray(fe))
    else:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                                 torch.from_numpy(fe))
    out = [_host(tok)]
    for t in range(len(forced)):
        f = jnp.asarray(forced[t]) if ref else torch.from_numpy(forced[t])
        tok, st = eng.decode_fn(eng.params["serve"], st, f)
        out.append(_host(tok))
    return np.stack(out)


def test_fused_step_launches(engines):
    """``"pallas"``: SeamlessM4T ``L`` B1 + one B3 a step (its FFN and
    cross-attention stay in torch, unbundled in the serve tree),
    InternVL2 ``2·L + 1``; ``"xla"``: one B5 a layer; no launch at
    prefill."""
    _, _, unfused, fused = engines
    cfg = fused.cfg
    L = cfg.n_layers
    ffn = {} if cfg.encoder is not None else {"fused_ffn": L}
    if cfg.encoder is not None:
        assert isinstance(fused.params["serve"]["blocks"][0]["ffn"], dict)
        assert fused.params["serve"]["cross_attn"] is \
            fused.params["train"]["cross_attn"]
    prompts = np.ones((SLOTS, PROMPT), np.int32)
    fe = torch.from_numpy(_frontend(cfg, 16))
    for eng, want in ((fused, {"fused_decode": L, **ffn, "fused_head": 1}),
                      (unfused, {"flash_decode": L})):
        tracecount.reset()
        nxt, st = eng.prefill_fn(eng.params["train"], eng.state, prompts, fe)
        assert not any(tracecount.calls().values())
        eng.decode_fn(eng.params["serve"], st, nxt)
        calls = {k: n for k, n in tracecount.calls().items() if n}
        assert calls == want


def test_teacher_forced_decode_matches_reference(engines, monkeypatch):
    """Both port engines against the reference's XLA engine and the fused
    one also against the reference's interpret-mode Pallas engine, the
    same prompts, frontend embeddings and forced tokens: ≥ 0.9 of (step,
    slot) agree, each difference a near-tie among the port's
    candidates."""
    ref, ref_fused, unfused, fused = engines
    cfg = fused.cfg
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(
        np.int32)
    forced = rng.integers(0, cfg.vocab_size, (6, SLOTS)).astype(np.int32)
    fe = _frontend(cfg, 17)
    want_xla = _forced(ref, prompts, fe, forced, ref=True)
    want_pallas = _forced(ref_fused, prompts, fe, forced, ref=True)
    cands = []
    for tail in ("_loose_head_tail", "_fused_head_tail"):
        real = getattr(engine_mod, tail)
        monkeypatch.setattr(engine_mod, tail, lambda *a, _r=real:
                            cands.append(_r(*a)) or cands[-1])
    for name, eng, wants in (("xla", unfused, (want_xla,)),
                             ("pallas", fused, (want_xla, want_pallas))):
        cands.clear()
        got = _forced(eng, prompts, fe, forced)
        assert len(cands) == len(forced)
        for want in wants:
            assert (got == want).mean() >= 0.9, (name, got, want)
            for t, b in zip(*np.nonzero(got[1:] != want[1:])):
                vals, ids = (c[b].numpy() for c in cands[t])
                assert want[1 + t, b] in ids, (name, t, b, ids)
                gap = vals[0] - vals[list(ids).index(want[1 + t, b])]
                assert gap <= NEAR_TIE, (name, t, b, gap)


def test_scheduler_and_admit_refuse(engines):
    """As the reference: ``SlotScheduler`` asserts a text decoder, and
    the targeted insert refuses an encoder (its k/v are the whole
    batch's) and a VLM admitted without its embeddings."""
    ref, _, *ports = engines
    with pytest.raises(AssertionError, match="decoder-only"):
        RefScheduler(ref, prompt_cap=PROMPT)
    for eng in ports:
        with pytest.raises(AssertionError, match="decoder-only"):
            SlotScheduler(eng, prompt_cap=PROMPT)
        lens = np.array([PROMPT, 0, 0], np.int32)
        err = AssertionError if eng.cfg.encoder is not None else ValueError
        with pytest.raises(err):
            eng.admit_fn(eng.params["train"], eng.state,
                         np.ones((SLOTS, PROMPT), np.int32), lens)


def test_graphed_step_reads_enc_kv_written_by_prefill(engines, monkeypatch):
    """The fused engine's step captured (the fake factory runs it under
    the capture rules) on its own state: two ``generate`` batches, the
    second on other frames, whose prefill rewrites ``enc_kv`` in place,
    give the eager step's tokens on a twin engine; a state whose
    ``enc_kv`` is a new tensor raises."""
    _, _, _, fused = engines
    cfg = fused.cfg

    def fake_capture(step, device, pool=None):
        with _capture_rules():
            step()

        def replay():
            with _capture_rules():
                step()
        return replay

    monkeypatch.setattr(step_graph, "capture_graph", fake_capture)
    twin = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu",
                             train_params=fused.params["train"],
                             options=EngineOptions(backend="pallas"))
    graph = StepGraph(cfg, twin.scfg, twin.params["serve"], twin.state)
    rng = np.random.default_rng(18)
    st_g, st_e = twin.state, fused.state
    for seed in (19, 20):
        prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT)).astype(
            np.int32)
        fe = torch.from_numpy(_frontend(cfg, seed))
        got, st_g = generate(twin.params, twin.prefill_fn, graph, st_g,
                             prompts, 5, fe)
        want, st_e = generate(fused.params, fused.prefill_fn,
                              fused.decode_fn, st_e, prompts, 5, fe)
        assert torch.equal(got, want), seed
    assert graph.replays == 8
    if cfg.encoder is not None:
        moved = dict(st_g, enc_kv={n: t.clone()
                                   for n, t in st_g["enc_kv"].items()})
        with pytest.raises(ValueError, match="caches"):
            graph(twin.params["serve"], moved, torch.zeros(SLOTS,
                                                           dtype=torch.int32))
