"""The GQA dense models of the port — Granite-8B (32/8 heads, tied
embeddings) and Minitron-4B (24/8 heads, an ungated squared-ReLU FFN) —
held against the JAX package at reduced size, with the same weights
carried across by ``from_reference_params``.

``reduced()`` turns both into MQA 4/1 (it keeps ``n_heads // q_per_kv``
kv heads of 4), so every model-level test here also sets a true GQA
ratio on both sides with ``dataclasses.replace``: 8/2 heads (``q_per_kv``
4) for Granite and 6/2 (3) for Minitron.

* the configs, field for field;
* B1 (``fused_decode``) at ``q_per_kv`` 3 and 4 and B2 (``fused_ffn``)
  ungated ``relu2`` and gated ``gelu_tanh``: the plain versions against
  the interpret-mode Pallas kernels and their ``ref.py`` oracles (f32
  to 1e-5: summation order only; bf16 compared in f32 to 2e-2);
* the f32 train-path forward and head: hidden states and logits to 1e-5,
  the greedy token of every position exact;
* the port's ``"pallas"`` and ``"xla"`` engines against the reference's
  XLA engine (built once per model): teacher-forced bf16 greedy tokens
  on at least 90 % of (step, slot), every difference a near-tie (ROADMAP
  C2), and a staggered trace event for event;
* on the fused tied model, B3's table is ``embed`` itself;
* the loose head (``models/layers.py:lm_head_logits``) against the f64
  sum (ROADMAP C3: the top-8 indices exact, values within 4 f32 ulps),
  and no f32 tensor it creates is the table's size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.fused_decode.fused_decode import \
    fused_decode_attention as jax_fused_decode
from repro.kernels.fused_decode.ref import fused_decode_attention_ref
from repro.kernels.fused_ffn.fused_ffn import fused_ffn_block as jax_ffn
from repro.kernels.fused_ffn.ref import fused_ffn_block_ref
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
from repro_torch.launch.serve import build_engine_full
from repro_torch.models import layers
from repro_torch.models.transformer import (forward, from_reference_params,
                                            head_table)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.sampling import head_candidates
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

ARCHS = ("granite-8b", "minitron-4b")
GQA = {"granite-8b": dict(n_heads=8, n_kv_heads=2),     # q_per_kv 4
       "minitron-4b": dict(n_heads=6, n_kv_heads=2)}    # q_per_kv 3
SLOTS, MAX_SEQ, PROMPT_CAP = 3, 48, 16
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()


def _configs(arch):
    """(reference, port) reduced configs at the arch's true GQA ratio."""
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                **GQA[arch]),
            dataclasses.replace(reduced(get_config(arch)), **GQA[arch]))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, bf16: bool):
    if a.dtype.kind != "f" or not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_reference(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced(get_config(arch)),
                       ref_reduced(ref_get_config(arch))), _configs(arch)[::-1]):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.q_per_kv == ref.q_per_kv
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == {
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "minitron-4b": (32, 3072, 24, 8, 9216, 256000)}[arch]


# ---------------------------------------------------------------------------
# B1 at q_per_kv 3 and 4, B2 ungated relu2 and gated gelu_tanh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nq,nkv", [(6, 2), (8, 2)])
def test_fused_decode_gqa_plain_vs_pallas_and_ref(nq, nkv, bf16):
    """Ragged lengths (−1 = free, 0, 1, a block edge) with stale entries
    past each live prefix, the new token counted where the slot is live:
    every query head of a kv head attends that head's rows."""
    rng = np.random.default_rng(20 + nq)
    B, D, S, hd = 4, 64, 32, 16
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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("act,gated", [("relu2", False), ("gelu_tanh", True)])
def test_fused_ffn_variants_plain_vs_pallas_and_ref(act, gated, bf16):
    rng = np.random.default_rng(7)
    B, D, F = 3, 64, 96
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = [f(B, D), f(B, D), f(D, F, sc=D ** -0.5),
            f(D, F, sc=D ** -0.5) if gated else None, f(F, D, sc=F ** -0.5),
            f(D, sc=0.1)]
    j, t = zip(*((None, None) if a is None else _both(a, bf16 and i != 5)
                 for i, a in enumerate(arrs)))
    got = b2.fused_ffn_block(*t, add_r=1.0, act=act, eps=1e-6)
    kw = dict(act=act, eps=1e-6)
    for want in (jax_ffn(*j[:5], j[5], None, jnp.float32(1.0), block_f=32,
                         interpret=True, **kw),
                 fused_ffn_block_ref(*j[:5], j[5], None, 1.0, **kw)):
        for name, g, w in zip(("o", "r"), got, want):
            assert g.dtype == t[0].dtype
            np.testing.assert_allclose(_np(g), _np(w), **(BF16 if bf16
                                                           else F32),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# The f32 forward, and the engines against the reference's XLA engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    """(reference on "xla", port on "xla", port on "pallas"), all on the
    reference's weights; the reference engine is built once per model."""
    cfg, port_cfg = _configs(request.param)
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    ports = [build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                               device="cpu", train_params=train,
                               options=EngineOptions(backend=b))
             for b in ("xla", "pallas")]
    return (ref, *ports)


def test_f32_forward_and_head_match_reference(engines):
    """The train-path forward and the loose head on the reference engine's
    weights upcast to f32 on both sides: hidden states and logits to
    1e-5, every position's greedy token exact."""
    ref, unfused, _ = engines
    cfg, port_cfg = ref.cfg, unfused.cfg
    tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32),
                        ref.params["train"])
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    local = unwrap_local(tree)
    want = jax.jit(lambda p, t: ref_forward(CTX, cfg, p, t, remat=False))(
        local, jnp.asarray(toks))
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.lm_head_logits(head_table(port_cfg, params), got)
    lw = ref_layers.lm_head_logits(
        CTX, local["embed" if cfg.tie_embeddings else "lm_head"], want)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(lg), _np(lw), **F32)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(lw).argmax(-1))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x)).reshape(-1)


def _forced(eng, prompts, forced, *, ref=False):
    if ref:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                                 None)
    else:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts)
    out = [_host(tok)]
    for t in range(len(forced)):
        f = forced[t] if ref else torch.from_numpy(forced[t])
        tok, st = eng.decode_fn(eng.params["serve"], st, f)
        out.append(_host(tok))
    return np.stack(out)


def test_serve_layout_and_launches(engines):
    """``"pallas"``: 2·L + 1 kernel calls a step (B1 at the GQA ratio, B2
    ungated on Minitron, B3), and on the tied Granite B3's table is
    ``embed`` itself (no copy); ``"xla"``: one B5 call a layer."""
    _, unfused, fused = engines
    cfg = fused.cfg
    serve = fused.params["serve"]
    table, embed = serve["head"].table, fused.params["train"]["embed"]
    if cfg.tie_embeddings:
        assert table is embed
        assert table.untyped_storage().data_ptr() == \
            embed.untyped_storage().data_ptr()
    else:
        assert table is fused.params["train"]["lm_head"]
    assert (serve["blocks"][0]["ffn"].w_gate is None) == (not cfg.ffn_gated)
    for eng, want in ((fused, {"fused_decode": cfg.n_layers,
                               "fused_ffn": cfg.n_layers, "fused_head": 1}),
                      (unfused, {"flash_decode": cfg.n_layers})):
        nxt, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 np.ones((SLOTS, 4), np.int32))
        tracecount.reset()
        eng.decode_fn(eng.params["serve"], st, nxt)
        calls = {k: n for k, n in tracecount.calls().items() if n}
        assert calls == want


def test_teacher_forced_decode_matches_reference(engines, monkeypatch):
    """Both port engines against the reference's XLA engine, the same
    prompts and forced tokens: ≥ 0.9 of (step, slot) agree, each
    difference a near-tie among the port's candidates; and the port's
    two backends against each other."""
    ref, unfused, fused = engines
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, fused.cfg.vocab_size, (SLOTS, 10)).astype(
        np.int32)
    forced = rng.integers(0, fused.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    want = _forced(ref, prompts, forced, ref=True)
    toks = {}
    cands = []
    for tail in ("_loose_head_tail", "_fused_head_tail"):
        # every decode step's head candidates, loose (B5 path) or B3's
        real = getattr(engine_mod, tail)
        monkeypatch.setattr(engine_mod, tail, lambda *a, _r=real:
                            cands.append(_r(*a)) or cands[-1])
    for name, eng in (("xla", unfused), ("pallas", fused)):
        cands.clear()
        got = _forced(eng, prompts, forced)
        assert len(cands) == len(forced)
        assert (got == want).mean() >= 0.9, (name, got, want)
        for t, b in zip(*np.nonzero(got[1:] != want[1:])):
            vals, ids = (c[b].numpy() for c in cands[t])
            assert want[1 + t, b] in ids, (name, t, b, ids)
            gap = vals[0] - vals[list(ids).index(want[1 + t, b])]
            assert gap <= NEAR_TIE, (name, t, b, gap)
        toks[name] = got
    assert (toks["xla"] == toks["pallas"]).mean() >= 0.9


def test_staggered_trace_matches_reference(engines):
    """4 requests on 3 slots through the scheduler (one slot re-admitted):
    events equal to the reference's on both backends, tokens ≥ 0.9."""
    ref, *ports = engines
    rng = np.random.default_rng(10)
    spec = [(0, 5, 3), (0, 7, 8), (1, 4, 6), (2, 9, 5)]  # arrival, len, new
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


# ---------------------------------------------------------------------------
# The loose head without an f32 copy of the table
# ---------------------------------------------------------------------------
class _F32Sizes(TorchDispatchMode):
    """The element counts of every f32 tensor an op creates."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.sizes.append(t.numel())
        return out


@pytest.mark.parametrize("V,D", [(10000, 64), (9000, 192)])
def test_lm_head_logits_without_a_table_copy(V, D):
    """bf16 table and rows: the top-8 candidates of the f32 logits hold
    to the f64 sum (indices exact, values within 4 f32 ulps), and the
    largest f32 tensor the call creates is a vocabulary tile's or the
    ``[B, V]`` logits, never ``V·D`` elements."""
    rng = np.random.default_rng(V)
    table = torch.from_numpy((rng.standard_normal((V, D)) * D ** -0.5)
                             .astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32)
                         ).to(torch.bfloat16)
    x[0] = torch.sign(x[0]) * 0.5           # a slot with a clear winner
    with _F32Sizes() as seen:
        got = layers.lm_head_logits(table, x)
    assert got.dtype == torch.float32 and got.shape == (8, V)
    assert seen.sizes and max(seen.sizes) < V * D
    assert max(seen.sizes) <= max(layers.HEAD_TILE_ROWS * D, 8 * V)
    want = (x.double() @ table.double().T).float()
    (gv, gi), (wv, wi) = head_candidates(got, 8), head_candidates(want, 8)
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    ulp = np.spacing(np.abs(wv.numpy()))
    assert (np.abs(gv.numpy() - wv.numpy()) <= 4 * ulp).all()
