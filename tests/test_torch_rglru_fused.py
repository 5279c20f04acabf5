"""RecurrentGemma-9B's fused arm in the port (``backend="pallas"``, and
``"auto"``, which resolves to it) held against the JAX package's fused
engine on the same weights.

The reduced RecurrentGemma-9B config with ``n_layers=5`` (kinds R, R, L
and a tail of R, R; ``d_model`` 128, window 64) is set on both sides to
16 query heads over one KV head (``dataclasses.replace``: ``reduced()``
makes it 4/1), so the local layer runs B1 at ``q_per_kv`` 16, the
geometry of the full model's MQA 16/1 of ``head_dim`` 256.  The port's
weights are the reference's, carried by ``from_reference_params``; the
reference's fused engine (interpret-mode Pallas, prepacked, the fused
head) is built once for the module.  On the CPU B1, B2, B3 and B6 take
their plain versions.

* B1's plain version at ``q_per_kv`` 16 against the interpret-mode
  Pallas kernel and its ``ref.py``, at ``head_dim`` 16 and 256 with a
  narrow ``d_model``, on a wrapped ring with the window and on a linear
  cache, ragged with a free slot: f32 to 1e-5 (summation order only),
  bf16 compared in f32 to 2e-2;
* ``cluster_plan`` at the full shapes: 8 clusters of 8 CTAs with two
  query heads each at 16/1 of 256 (4 and 2 clusters at a mesh rank's 8/1
  and 4/1), ``(0, 0)`` for other ``q_per_kv`` at ``head_dim`` 256, and
  the wrapper's launch carrying the plan;
* the serve tree with a tail: the RG-LRU blocks and tail layers alias
  the train tree, the local layer is packed (its train q/k/v views of
  ``wqkv``), and an attention layer in a tail (Gemma-2 at 3 layers) is
  packed as a group's and served;
* the launches a step (1 B1, 1 B2, 4 B6, 1 B3) (the backend gate,
  ``"auto"`` → ``"pallas"`` and ``"pallas"`` with prepack off raising:
  ``tests/test_torch_rglru.py``);
* greedy tokens, teacher-forced and through two ``generate`` batches
  (the second past the 64-row window), against the reference's fused
  engine and against the port's own ``"xla"`` engine: at least 90 % of
  (step, slot) agree and every difference is a near-tie (ROADMAP C2).
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
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.launch.serve import generate as ref_generate
from repro.serving.engine import EngineOptions as RefOptions

from test_torch_kernels import _record_launch
from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.core.dataflow import (PackedFFNWeights, PackedHeadWeights,
                                       PackedSplitTokenWeights)
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models.transformer import from_reference_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions

ARCH = "recurrentgemma-9b"
N_LAYERS = 5                      # one group of (R, R, L) and a tail R, R
SLOTS, MAX_SEQ = 3, 128
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread


def _configs():
    """(reference, port) reduced configs at MQA 16/1."""
    heads = dict(n_heads=16, n_kv_heads=1)
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH),
                                            n_layers=N_LAYERS), **heads),
            dataclasses.replace(reduced(get_config(ARCH),
                                        n_layers=N_LAYERS), **heads))


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
    """Ring row ``r`` of a slot holding ``length`` positions: the largest
    ``p < length`` with ``p ≡ r (mod S)``, else −1."""
    r = np.arange(S)
    p = r + np.maximum(length - 1 - r, 0) // S * S
    return np.where(r < length, p, -1).astype(np.int32)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x))


# ---------------------------------------------------------------------------
# B1 at q_per_kv 16; the plan at the full shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("hd", [16, 256])
def test_fused_decode_mqa16_plain_vs_pallas_and_ref(hd, ring, bf16):
    """16 query heads over one KV head, ``d_model`` 64.  Ring (``S`` =
    window = 16, no softcap, as RecurrentGemma's local layers): a free
    slot whose rows hold a stale occupant's positions, a slot of 5, a
    full ring whose row 0 holds ``cache_len − window`` (masked) and a
    ring wrapped at 37 whose row ``37 mod 16`` holds 21 (masked).
    Linear (``S`` 32, window 8, softcap 50: the mode's general path):
    −1, 0, 9, 31 with stale entries past each live prefix."""
    rng = np.random.default_rng(40 + ring + 2 * (hd == 256))
    B, D, nq, nkv = 4, 64, 16, 1
    P = (nq + 2 * nkv) * hd
    if ring:
        S = window = 16
        lens = np.array([-1, 5, 16, 37], np.int32)
        pos = np.stack([_ring_pos(S, n) for n in (20, 5, 16, 37)], axis=1)
        inc = (lens >= 0).astype(np.int32)
        pos_base, cap = -1, 0.0
        assert pos[37 % S, 3] == 37 - window
    else:
        S, window = 32, 8
        lens = np.array([-1, 0, 9, 31], np.int32)
        pos = np.where(np.arange(S)[:, None] < lens[None, :] + 3,
                       np.arange(S)[:, None], -1).astype(np.int32)
        inc = ((lens >= 0) & (lens < S)).astype(np.int32)
        pos_base, cap = 0, 50.0
    ang = lens.astype(np.float32)[:, None] * (
        10000.0 ** (-np.arange(hd // 2, dtype=np.float32) / (hd // 2)))
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = dict(x=f(B, D), wqkv=f(D, P, sc=3 * D ** -0.5),
                wo=f(nq, hd, D, sc=(nq * hd) ** -0.5), ln1=f(D, sc=0.1),
                kc=f(S, B * nkv, hd, sc=3.0 * (16 / hd) ** 0.5),
                vc=f(S, B * nkv, hd), pos=pos, lens=lens, inc=inc,
                cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, bf16 and k not in ("ln1", "cos", "sin"))
    mode = dict(window=window, attn_softcap=cap)
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
    # the window changed the result of the wrapped or long slot
    alt = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq, kv_heads=nkv,
        norm_eps=1e-6, **dict(mode, window=0))
    assert not torch.allclose(alt[0][3], got[0][3])


@pytest.mark.parametrize("heads,kv,D,hd,plan", [
    (16, 1, 4096, 256, (8, 2)),       # RecurrentGemma-9B: 64 CTAs
    (16, 1, 512, 256, (8, 2)),        # 64 rows a rank
    (32, 2, 4096, 256, (4, 2)),       # 16 clusters of 4, 1024 rows a rank
    (16, 1, 16384, 256, (0, 0)),      # 2048 rows a rank: no room
    (8, 1, 4096, 256, (8, 2)),        # a mesh rank's 8/1: 4 clusters
    (4, 1, 4096, 256, (8, 2)),        # a mesh rank's 4/1: 2 clusters
    (32, 1, 4096, 256, (0, 0)),       # q_per_kv 32
    (6, 1, 4096, 256, (0, 0)),        # q_per_kv 6
    (16, 1, 4096, 128, (0, 0)),       # MQA 16/1 at head_dim 128
    (16, 1, 128, 32, (0, 0)),         # the reduced model's head_dim
    (32, 32, 4096, 128, (4, 1))])     # Llama2-7B, as before
def test_cluster_plan_at_head_dim_256(monkeypatch, heads, kv, D, hd, plan):
    """The plan from the shapes alone: at ``head_dim`` 256 only MQA 16/1
    and the 8/1 and 4/1 of a mesh rank have one — two query heads a
    cluster, 8, 4 or 2 clusters of 8 CTAs of 512 rows —; any other pair
    is ``(0, 0)``, and the CUDA wrapper then
    raises ``NotImplementedError`` (never the plain version); at a
    narrow ``d_model`` (512) the one library call carries the plan."""
    assert b1.cluster_plan(heads, kv, D, hd) == plan
    calls = _record_launch(monkeypatch)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    B, S, Dn = 2, 8, min(D, 512)          # no 70 MB weights here
    plan = b1.cluster_plan(heads, kv, Dn, hd)
    args = (torch.zeros(B, Dn, dtype=bf),
            torch.zeros(Dn, (heads + 2 * kv) * hd, dtype=bf),
            torch.zeros(heads, hd, Dn, dtype=bf), torch.zeros(Dn, dtype=f32),
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
    assert got[17:25] == (B, Dn, S, heads, kv, hd, *plan)  # after bqkv


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    """(reference fused engine, port on "pallas", port on "xla"), all on
    the reference's weights; the reference engine (interpret-mode
    Pallas, prepacked, the fused head) is built once for the module."""
    cfg, port_cfg = _configs()
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS,
                    options=RefOptions(backend="pallas", interpret=True,
                                       prepack="on", fuse_head=True))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    ports = [build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                               device="cpu", train_params=train,
                               options=EngineOptions(backend=b))
             for b in ("pallas", "xla")]
    return (ref, *ports)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def test_serve_tree_with_a_tail(engines):
    """The serve tree on ``"pallas"``: the RG-LRU blocks of the group and
    the two RG-LRU tail layers are the train tree's own dicts (their
    leaves share storage); the local layer's attention is packed (``wqkv
    [1, 128, 18·32]``, ``wo`` per head) and the train tree's ``wq``,
    ``wk``, ``wv`` are views of that ``wqkv``; its FFN is B2's bundle of
    the train tensors; the head is B3's on ``embed`` itself."""
    _, fused, _ = engines
    train, serve = fused.params["train"], fused.params["serve"]
    assert (fused.scfg.backend, fused.scfg.prepack) == ("pallas", True)
    assert len(serve["tail"]) == 2
    for s_blk, t_blk in zip(serve["tail"] + serve["blocks"][:2],
                            train["tail"] + train["blocks"][:2]):
        assert s_blk is t_blk and "rglru" in s_blk
        for name, leaf in s_blk["rglru"].items():
            assert _storage(leaf) == _storage(t_blk["rglru"][name])
    local = serve["blocks"][2]
    assert isinstance(local["attn"], PackedSplitTokenWeights)
    assert tuple(local["attn"].wqkv.shape) == (1, 128, 18 * 32)
    assert tuple(local["attn"].wo.shape) == (1, 16, 32, 128)
    for name in ("wq", "wk", "wv"):
        assert _storage(train["blocks"][2]["attn"][name]) == \
            _storage(local["attn"].wqkv)
    assert isinstance(local["ffn"], PackedFFNWeights)
    assert local["ffn"].w_in is train["blocks"][2]["ffn"]["w_in"]
    assert isinstance(serve["head"], PackedHeadWeights)
    assert serve["head"].table is train["embed"]


def test_an_attention_tail_is_packed_and_served():
    """Gemma-2 at 3 layers (a group of local and global attention and a
    tail of one local layer): the tail's attention is packed as a
    group's, unstacked (``wqkv [D, P]``, its train q/k/v views of it),
    and the fused engine's greedy tokens agree with the unfused one's on
    ≥ 0.9 of (step, slot) over 40-token prompts and 30 steps (past the
    64-row ring)."""
    cfg = reduced(get_config("gemma2-27b"), n_layers=3)
    engs = {b: build_engine_full(cfg, max_seq=96, batch_global=SLOTS,
                                 device="cpu", seed=3,
                                 options=EngineOptions(backend=b))
            for b in ("pallas", "xla")}
    fused = engs["pallas"]
    (tail,) = fused.params["serve"]["tail"]
    assert isinstance(tail["attn"], PackedSplitTokenWeights)
    assert tail["attn"].wqkv.dim() == 2 and tail["attn"].wo.dim() == 3
    t_attn = fused.params["train"]["tail"][0]["attn"]
    for name in ("wq", "wk", "wv"):
        assert t_attn[name].dim() == 3
        assert _storage(t_attn[name]) == _storage(tail["attn"].wqkv)
    tracecount.reset()
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (SLOTS, 40)).astype(np.int32)
    toks = {b: generate(e.params, e.prefill_fn, e.decode_fn, e.state,
                        torch.from_numpy(prompts), 30)[0].numpy()
            for b, e in engs.items()}
    assert tracecount.calls()["fused_decode"] == 29 * cfg.n_layers
    assert (toks["pallas"] == toks["xla"]).mean() >= 0.9, toks


def test_fused_step_launches(engines):
    """A fused decode step at the reduced size makes one B1 and one B2
    call (the local layer), one B6 per RG-LRU layer (two in the group,
    two in the tail) and one B3: nothing else."""
    _, fused, _ = engines
    nxt, st = fused.prefill_fn(fused.params["train"], fused.state,
                               np.ones((SLOTS, 4), np.int32))
    tracecount.reset()
    fused.decode_fn(fused.params["serve"], st, nxt)
    calls = {k: n for k, n in tracecount.calls().items() if n}
    assert calls == {"fused_decode": 1, "fused_ffn": 1, "rglru_scan": 4,
                     "fused_head": 1}
    assert sum(tracecount.launches().values()) == 0     # CPU: no kernels


def _capture_fused_head(monkeypatch):
    """Every decode step's B3 candidates ``(values, ids)``."""
    cands = []
    real = engine_mod._fused_head_tail
    monkeypatch.setattr(engine_mod, "_fused_head_tail",
                        lambda *a: cands.append(real(*a)) or cands[-1])
    return cands


def _near_ties(got, want, cands, first=1):
    """Every difference past the first ``first`` rows of ``got`` is the
    reference's token among the port's candidates within ``NEAR_TIE`` of
    its best (``cands[i]`` scores row ``first + i``)."""
    for t, b in zip(*np.nonzero(got[first:] != want[first:])):
        vals, ids = (c[b].numpy() for c in cands[t])
        assert want[first + t, b] in ids, (t, b, ids)
        gap = vals[0] - vals[list(ids).index(want[first + t, b])]
        assert gap <= NEAR_TIE, (t, b, gap)


def test_teacher_forced_decode_matches_reference(engines, monkeypatch):
    """70-token prompts (the ring wraps in prefill), then 8 forced input
    tokens on the reference's fused engine and both port engines: the
    fused port's greedy tokens agree with the reference's on ≥ 0.9 of
    (step, slot), every difference a near-tie among B3's candidates;
    the ring ``pos`` exactly; and the port's fused and unfused engines
    agree with each other on ≥ 0.9."""
    ref, fused, unfused = engines
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, fused.cfg.vocab_size, (SLOTS, 70)).astype(
        np.int32)
    forced = rng.integers(0, fused.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    r_tok, r_st = ref.prefill_fn(ref.params["train"], ref.state, prompts,
                                 None)
    want = [_host(r_tok).reshape(-1)]
    for t in range(len(forced)):
        r_tok, r_st = ref.decode_fn(ref.params["serve"], r_st, forced[t])
        want.append(_host(r_tok).reshape(-1))
    want = np.stack(want)
    toks = {}
    cands = _capture_fused_head(monkeypatch)
    for name, eng in (("pallas", fused), ("xla", unfused)):
        cands.clear()
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts)
        out = [_host(tok)]
        for t in range(len(forced)):
            tok, st = eng.decode_fn(eng.params["serve"], st,
                                    torch.from_numpy(forced[t]))
            out.append(_host(tok))
        toks[name] = np.stack(out)
        if name == "pallas":
            assert len(cands) == len(forced)
            assert (toks[name] == want).mean() >= 0.9, (toks[name], want)
            _near_ties(toks[name], want, cands)
            ring = _host(st["layers"][2].pos)[0]
            np.testing.assert_array_equal(
                ring, _host(r_st["layers"][2].pos).reshape(ring.shape))
    assert (toks["pallas"] == toks["xla"]).mean() >= 0.9


def test_two_generate_batches_match_reference(engines, monkeypatch):
    """Two lockstep batches on one fused engine, the second from what the
    first left: 70-token prompts and 4 new tokens (the ring wraps in
    prefill), then 60-token prompts and 8 new tokens (it wraps in
    decode, over the first batch's stale rows).  Each slot's stream
    equals the reference fused engine's up to its first difference, and
    there the reference's token is a near-tie among B3's candidates;
    the ring ``pos`` and ``cache_lens`` match after each batch."""
    ref, fused, _ = engines
    rng = np.random.default_rng(9)
    r_st, p_st = ref.state, fused.state
    cands = _capture_fused_head(monkeypatch)
    for n_prompt, n_new in ((70, 4), (60, 8)):
        prompts = rng.integers(0, fused.cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        r_toks, r_st = ref_generate(ref.cfg, ref.params, ref.prefill_fn,
                                    ref.decode_fn, r_st, prompts, n_new)
        cands.clear()
        got, p_st = generate(fused.params, fused.prefill_fn,
                             fused.decode_fn, p_st,
                             torch.from_numpy(prompts), n_new)
        got, want = got.numpy(), _host(r_toks).reshape(SLOTS, n_new)
        assert got[:, 0].tolist() == want[:, 0].tolist()   # the prefill's
        for b in range(SLOTS):
            diff = np.nonzero(got[b] != want[b])[0]
            if len(diff):
                vals, ids = (c[b].numpy() for c in cands[diff[0] - 1])
                assert want[b, diff[0]] in ids, (b, diff, ids)
                gap = vals[0] - vals[list(ids).index(want[b, diff[0]])]
                assert gap <= NEAR_TIE, (b, diff, gap)
        ring = _host(p_st["layers"][2].pos)[0]
        np.testing.assert_array_equal(
            ring, _host(r_st["layers"][2].pos).reshape(ring.shape))
        assert _host(p_st["cache_lens"]).tolist() == \
            [n_prompt + n_new - 1] * SLOTS
