"""Qwen2-72B in the port: its config field for field, B1's q/k/v bias
(``bqkv``) at q_per_kv 8 — the plain version against the interpret-mode
Pallas kernel and ``ref.py`` —, the plans of B1, B2 and B3 at its full
and per-rank shapes, and the f32 forward and both port engines against
the JAX package on one device, the reference's weights carried across
with seeded random biases (its init makes them zero), at 8/1 heads
(``dataclasses.replace``d on both sides: ``reduced()`` makes it 4/1).

Tolerances as ``tests/test_torch_gqa.py``: f32 to 1e-5, bf16 to 2e-2;
engine tokens in bf16 ≥ 0.9 of (step, slot), each difference a near-tie
among the port's candidates (ROADMAP C2).
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
from repro.models import layers as ref_layers
from repro.models.ctx import ParallelCtx
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import unwrap_local
from repro.serving.engine import EngineOptions as RefOptions

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.kernels.fused_ffn import fused_ffn as b2
from repro_torch.kernels.fused_head import fused_head as b3
from repro_torch.launch.serve import build_engine_full
from repro_torch.models import layers
from repro_torch.models.transformer import (forward, from_reference_params,
                                            head_table)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions

ARCH = "qwen2-72b"
HEADS = dict(n_heads=8, n_kv_heads=1)      # q_per_kv 8
SLOTS, MAX_SEQ = 3, 32
NEAR_TIE = 0.05
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()


def _configs():
    return (dataclasses.replace(ref_reduced(ref_get_config(ARCH)), **HEADS),
            dataclasses.replace(reduced(get_config(ARCH)), **HEADS))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, bf16: bool):
    if a.dtype.kind != "f" or not bf16:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def test_config_mirrors_reference():
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (reduced(get_config(ARCH)),
                       ref_reduced(ref_get_config(ARCH))), _configs()[::-1]):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
            cfg.rope_theta) == (80, 8192, 64, 8, 128, 29568, 152064, True,
                                1e6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nq,nkv", [(8, 1), (16, 2)])
def test_fused_decode_bias_plain_vs_pallas_and_ref(nq, nkv, bf16):
    """B1 with ``bqkv`` at q_per_kv 8 (a rank's 8/1 and 16/2 of an 8- and
    a 4-GPU mesh): ragged lengths (−1 = free, 0, 1, a block edge), stale
    entries past each live prefix, the bias added to q, k and v before
    RoPE (``fused_decode.py:103``)."""
    rng = np.random.default_rng(40 + nq)
    B, D, S, hd = 4, 64, 32, 16
    P = (nq + 2 * nkv) * hd
    lens = np.array([-1, 0, 9, 31], np.int32)
    pos = np.where(np.arange(S)[:, None] < lens[None, :] + 3,
                   np.arange(S)[:, None], -1).astype(np.int32)
    inc = (lens >= 0).astype(np.int32)
    ang = lens.astype(np.float32)[:, None] * (
        10000.0 ** (-np.arange(hd // 2, dtype=np.float32) / (hd // 2)))
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = dict(x=f(B, D), wqkv=f(D, P, sc=D ** -0.5), bqkv=f(P, sc=0.5),
                wo=f(nq, hd, D, sc=(nq * hd) ** -0.5), ln1=f(D, sc=0.1),
                kc=f(S, B * nkv, hd), vc=f(S, B * nkv, hd), pos=pos,
                lens=lens, inc=inc, cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, bf16 and k not in ("ln1", "cos", "sin"))
    got = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq, kv_heads=nkv,
        norm_eps=1e-6, bqkv=t["bqkv"])
    no_bias = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=nq, kv_heads=nkv,
        norm_eps=1e-6)
    assert not torch.allclose(got[1], no_bias[1])
    kc, vc = (j[k].reshape(S, B, nkv, hd) for k in ("kc", "vc"))

    def one(use_ref, xb, kb, vb, cl, cb, sb, pb, ib):
        kw = dict(q_heads=nq, kv_heads=nkv, fuse_out="partial_o", pos=pb,
                  include_new=ib, norm_scale=j["ln1"], norm_eps=1e-6)
        if use_ref:
            out = fused_decode_attention_ref(xb[None], j["wqkv"], j["bqkv"],
                                             j["wo"], kb, vb, cl, cb, sb,
                                             **kw)
        else:
            out = jax_fused_decode(xb[None], j["wqkv"], j["bqkv"], j["wo"],
                                   kb, vb, cl, cb, sb, block_s=8,
                                   interpret=True, pos_base=jnp.int32(0),
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


def test_plans_at_qwen2_shapes():
    """B1: two of a kv head's 8 query heads a cluster, clusters of 8 of
    1024 rows a rank at d_model 8192 — 32 clusters on one card, 8 and 4
    for a rank of 4 and 8 GPUs; B2: 15 clusters of 8 of 1024 rows (the
    1024-row instances) at each d_ff a rank holds; B3: a plan at the
    whole vocabulary and at a rank's shard."""
    assert b1.cluster_plan(64, 8, 8192) == (8, 2)
    assert b1.cluster_plan(16, 2, 8192) == (8, 2)
    assert b1.cluster_plan(8, 1, 8192) == (8, 2)
    for F in (29568, 7392, 3696):
        assert b2.cluster_plan(8192, F) == (15, 8)
    for V in (152064, 38016, 19008):
        G, C = b3.cluster_plan(V, 8192)
        assert G * C > 0


def test_wide_ffn_instances_are_gated_silu_only(monkeypatch):
    """Past 640 rows a rank B2 has instances for the gated silu FFN alone
    (Qwen2-72B's): that reaches the library, the other activations and
    the ungated form raise ``NotImplementedError`` before it."""
    from repro_torch.kernels import _build

    def library(*_a, **_k):
        raise AssertionError("library")

    monkeypatch.setattr(_build, "function", library)
    bf = torch.bfloat16
    D, F = 8192, 16
    z = lambda *s: torch.zeros(s, dtype=bf)
    for act, gated, reaches in (("silu", True, True),
                                ("gelu_tanh", True, False),
                                ("silu", False, False)):
        with pytest.raises(AssertionError if reaches
                           else NotImplementedError,
                           match="library" if reaches else "Queue B: B2"):
            b2.fused_ffn_cuda(z(1, D), z(1, D), z(D, F),
                              z(D, F) if gated else None, z(F, D),
                              torch.zeros(D), add_r=1.0, act=act)


def _with_biases(tree, seed):
    """The reference tree with seeded random q/k/v biases in place of the
    init's zeros."""
    rng = np.random.default_rng(seed)

    def blk(b):
        a = b["attn"]
        return dict(b, attn=a._replace(**{
            n: jnp.asarray(rng.standard_normal(getattr(a, n).shape) * 0.5,
                           getattr(a, n).dtype) for n in ("bq", "bk", "bv")}))

    return dict(tree, blocks=[blk(b) for b in tree["blocks"]],
                tail=[blk(b) for b in tree["tail"]])


@pytest.fixture(scope="module")
def engines():
    """(reference "xla" engine and its biased tree, port "xla", port
    "pallas"), all on the reference's weights."""
    cfg, port_cfg = _configs()
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    tree = _with_biases(ref.params["train"], 3)
    train = lambda: from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                          device="cpu")
    ports = [build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                               device="cpu", train_params=train(),
                               options=EngineOptions(backend=b))
             for b in ("xla", "pallas")]
    return ref, tree, ports


def test_f32_forward_and_head_match_reference(engines):
    ref, tree, _ = engines
    cfg, port_cfg = _configs()
    tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32), tree)
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    local = unwrap_local(tree)
    want = jax.jit(lambda p, t: ref_forward(CTX, cfg, p, t, remat=False))(
        local, jnp.asarray(toks))
    got = forward(port_cfg, params, torch.from_numpy(toks))
    lg = layers.lm_head_logits(head_table(port_cfg, params), got)
    lw = ref_layers.lm_head_logits(CTX, local["lm_head"], want)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(lg), _np(lw), **F32)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(lw).argmax(-1))


def test_engines_match_reference_teacher_forced(engines, monkeypatch):
    """Both port backends (the fused one: B1 with ``bqkv`` at 8/1, B2, B3)
    against the reference's XLA engine, prompts then forced tokens."""
    ref, tree, ports = engines
    rng = np.random.default_rng(4)
    vocab = ports[0].cfg.vocab_size
    prompts = rng.integers(0, vocab, (SLOTS, 10)).astype(np.int32)
    forced = rng.integers(0, vocab, (6, SLOTS)).astype(np.int32)
    tok, st = ref.prefill_fn(tree, ref.state, prompts, None)
    want = [np.asarray(tok).reshape(-1)]
    for f in forced:
        tok, st = ref.decode_fn(tree, st, f)
        want.append(np.asarray(tok).reshape(-1))
    want = np.stack(want)
    cands = []
    for tail in ("_loose_head_tail", "_fused_head_tail"):
        real = getattr(engine_mod, tail)
        monkeypatch.setattr(engine_mod, tail, lambda *a, _r=real:
                            cands.append(_r(*a)) or cands[-1])
    for port in ports:
        cands.clear()
        tok, st = port.prefill_fn(port.params["train"], port.state, prompts)
        got = [tok.numpy()]
        for f in forced:
            tok, st = port.decode_fn(port.params["serve"], st, f)
            got.append(tok.numpy())
        got = np.stack(got)
        assert (got == want).mean() >= 0.9, (port.scfg.backend, got, want)
        for t, s in zip(*np.nonzero(got[1:] != want[1:])):
            vals, ids = (c[s].numpy() for c in cands[t])
            assert want[1 + t, s] in ids
            gap = vals[0] - vals[list(ids).index(want[1 + t, s])]
            assert gap <= NEAR_TIE, (port.scfg.backend, t, s, gap)
