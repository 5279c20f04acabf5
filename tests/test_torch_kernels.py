"""The port's kernels (``repro_torch.kernels``) held against the JAX
package's Pallas kernels in interpret mode and against their ``ref.py``
oracles, on the same numpy inputs made from a seed.

On this machine the wrappers take their plain PyTorch versions (the
tensors lie on the CPU); the CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 inputs ``rtol = atol = 1e-5`` (summation order only);
bf16 inputs compared in f32 at ``2e-2`` (a value on a bf16 rounding
boundary may round the other way under another summation order); head
candidates: indices exact, values within 4 f32 ulps (ROADMAP fault C1).
B4 (MLA): 1e-5 against the Pallas kernel in both dtypes, the file's
tolerances against ``ref.py``, which attends the new token unrounded
(ROADMAP C4); its unnormalized ``o`` relative to each slot's largest
element.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_decode.fused_decode import \
    fused_decode_attention as jax_fused_decode
from repro.kernels.fused_decode.ref import fused_decode_attention_ref
from repro.kernels.fused_ffn.fused_ffn import fused_ffn_block as jax_ffn
from repro.kernels.fused_ffn.ref import fused_ffn_block_ref
from repro.kernels.fused_head import topk as jax_topk
from repro.kernels.fused_head.fused_head import fused_head_block as jax_head
from repro.kernels.fused_head.ref import fused_head_ref
from repro.kernels.fused_mla_decode.fused_mla_decode import \
    fused_mla_decode_attention as jax_mla
from repro.kernels.fused_mla_decode.ref import fused_mla_decode_attention_ref

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.kernels.fused_ffn import fused_ffn as b2
from repro_torch.kernels.fused_head import fused_head as b3
from repro_torch.kernels.fused_head import topk as port_topk
from repro_torch.kernels.fused_mla_decode import fused_mla_decode as b4

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=1e-5, atol=1e-5)


def _np(t) -> np.ndarray:
    """torch or jax array → f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a: np.ndarray, dt: str):
    """The same values on both sides (f32 → bf16 rounds to nearest even
    in both frameworks, so bf16 inputs are bit-identical)."""
    if a.dtype.kind != "f":
        return jnp.asarray(a), torch.from_numpy(a)
    jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close_ulps(got, want, n=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= n * ulp).all(), (got, want)


# ---------------------------------------------------------------------------
# B1 fused_decode (partial_o, fused ln1, ragged)
# ---------------------------------------------------------------------------
B1_SHAPE = dict(B=4, D=64, S=32, nq=4, nkv=4, hd=16)


def _b1_inputs(lens, include, dt, seed=0):
    rng = np.random.default_rng(seed)
    B, D, S, nq, nkv, hd = (B1_SHAPE[k] for k in
                            ("B", "D", "S", "nq", "nkv", "hd"))
    P = (nq + 2 * nkv) * hd
    lens = np.asarray(lens, np.int32)
    s = np.arange(S, dtype=np.int32)[:, None]
    # linear cache; a few stale entries past each live prefix
    pos = np.where(s < lens[None, :] + 3, s, -1).astype(np.int32)
    inc = ((lens >= 0) if include == "owner"
           else np.zeros(B, bool)).astype(np.int32)
    ang = np.asarray(lens, np.float32)[:, None] * (
        10000.0 ** (-np.arange(hd // 2, dtype=np.float32) / (hd // 2)))
    f = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    arrs = dict(x=f(B, D), wqkv=f(D, P, sc=D ** -0.5),
                wo=f(nq, hd, D, sc=(nq * hd) ** -0.5),
                ln1=f(D, sc=0.1), kc=f(S, B * nkv, hd), vc=f(S, B * nkv, hd),
                pos=pos, lens=lens, inc=inc, cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, "f32" if k in ("ln1", "cos", "sin") else dt)
    return j, t


def _jax_b1(j, *, use_ref):
    B, S, nq, nkv, hd = (B1_SHAPE[k] for k in ("B", "S", "nq", "nkv", "hd"))
    kc = j["kc"].reshape(S, B, nkv, hd)
    vc = j["vc"].reshape(S, B, nkv, hd)

    def one(xb, kb, vb, cl, cb, sb, pb, ib):
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

    return jax.jit(jax.vmap(one, in_axes=(0, 1, 1, 0, 0, 0, 1, 0)))(
        j["x"], kc, vc, j["lens"], j["cos"], j["sin"], j["pos"], j["inc"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("include", ["owner", "none"])
@pytest.mark.parametrize("lens", [(-1, 0, 1, 31), (7, 8, 23, 16)])
def test_fused_decode_plain_vs_pallas_and_ref(lens, include, dt):
    """Ragged per-slot lengths (−1 = free, 0, 1, S−1, block boundaries),
    the new token counted (``include_new`` = owner) or not."""
    j, t = _b1_inputs(lens, include, dt)
    got = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=B1_SHAPE["nq"],
        kv_heads=B1_SHAPE["nkv"], norm_eps=1e-6)
    for use_ref in (False, True):
        want = _jax_b1(j, use_ref=use_ref)
        for name, g, w in zip(("o", "k_new", "v_new", "m", "l"), got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            np.testing.assert_allclose(_np(g), _np(w), **_tol(dt),
                                       err_msg=f"{name} ref={use_ref}")
    # a free slot ends with l = 1 (m starts at −1e30, not −inf): no NaN
    o, _, _, m, l = got
    assert torch.isfinite(o).all()
    if lens[0] == -1:
        assert torch.all(l[0] == 1.0)


def test_fused_decode_unported_modes_raise():
    _, t = _b1_inputs((1, 2, 3, 4), "owner", "f32")
    args = (t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"],
            t["pos"], t["lens"], t["inc"], t["cos"], t["sin"])
    kw = dict(q_heads=4, kv_heads=4)
    for bad in (dict(fuse_out=True), dict(fuse_out=False), dict(window=8),
                dict(ring=True), dict(attn_softcap=30.0),
                dict(bqkv=torch.zeros(12 * 16))):
        with pytest.raises(NotImplementedError):
            b1.fused_decode_attention(*args, **kw, **bad)
    with pytest.raises(NotImplementedError):
        b1.fused_decode_attention(*args[:3], None, *args[4:], **kw)


# ---------------------------------------------------------------------------
# B4 fused_mla_decode (partial_o through wproj, fused ln1, ragged)
# ---------------------------------------------------------------------------
B4_SHAPE = dict(B=5, D=64, S=32, nq=4, nope=16, rope=8, l=32)


def _b4_inputs(lens, include, dt, seed=4):
    rng = np.random.default_rng(seed)
    B, D, S, nq, nope, rope, lr_ = (B4_SHAPE[k] for k in
                                    ("B", "D", "S", "nq", "nope", "rope", "l"))
    lr = lr_ + rope
    lens = np.asarray(lens, np.int32)
    s = np.arange(S, dtype=np.int32)[:, None]
    # linear cache; a few stale entries past each live prefix
    pos = np.where(s < lens[None, :] + 3, s, -1).astype(np.int32)
    inc = (((lens >= 0) & (lens < S)) if include == "owner"
           else np.zeros(B, bool)).astype(np.int32)
    ang = np.asarray(lens, np.float32)[:, None] * (
        10000.0 ** (-np.arange(rope // 2, dtype=np.float32) / (rope // 2)))
    f = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    arrs = dict(x=f(B, D), wq=f(D, nq * (nope + rope), sc=D ** -0.5),
                wdkv=f(D, lr, sc=D ** -0.5), wuk=f(nq, nope, lr_, sc=0.3),
                wproj=f(nq, lr_, D, sc=0.3 * lr_ ** -0.5), ln1=f(D, sc=0.1),
                cc=f(S, B, lr), pos=pos, lens=lens, inc=inc,
                cos=np.cos(ang), sin=np.sin(ang))
    j, t = {}, {}
    for k, a in arrs.items():
        j[k], t[k] = _both(a, "f32" if k in ("ln1", "cos", "sin") else dt)
    return j, t


def _jax_b4(j, *, use_ref):
    nq, nope, rope, lr_, D = (B4_SHAPE[k] for k in
                              ("nq", "nope", "rope", "l", "D"))
    wo_unused = jnp.zeros((1, 1), j["x"].dtype)

    def one(xb, cb, cl, cosb, sinb, pb, ib):
        kw = dict(q_heads=nq, nope=nope, rope_d=rope, l_rank=lr_, v_dim=D,
                  fuse_out="partial_o", pos=pb, include_new=ib,
                  norm_scale=j["ln1"], norm_eps=1e-6)
        fn = fused_mla_decode_attention_ref if use_ref else functools.partial(
            jax_mla, block_s=8, interpret=True, pos_base=jnp.int32(0))
        out = fn(xb[None], j["wq"], j["wdkv"], j["wuk"], j["wproj"],
                 wo_unused, cb, cl, cosb, sinb, **kw)
        return tuple(o[0] for o in out)

    return jax.jit(jax.vmap(one, in_axes=(0, 1, 0, 0, 0, 1, 0)))(
        j["x"], j["cc"], j["lens"], j["cos"], j["sin"], j["pos"], j["inc"])


def _call_b4(t, **kw):
    return b4.fused_mla_decode_attention(
        t["x"], t["wq"], t["wdkv"], t["wuk"], t["wproj"], t["ln1"], t["cc"],
        t["pos"], t["lens"], t["inc"], t["cos"], t["sin"],
        q_heads=B4_SHAPE["nq"], nope=B4_SHAPE["nope"], rope_d=B4_SHAPE["rope"],
        l_rank=B4_SHAPE["l"], norm_eps=1e-6, **kw)


# B4's plain version and the Pallas kernel compute in f32 from the same
# inputs in either dtype: held to 1e-5 (measured ≤ 6e-7).  ref.py attends
# the new token with its f32 entry where the Pallas kernel (and the port)
# read it back rounded to the cache dtype, so in bf16 ref.py is held only
# to the file's bf16 tolerance (measured ≤ 2.2e-3).  The unnormalized o is
# compared relative to each slot's largest element.
B4_PALLAS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("include", ["owner", "none"])
@pytest.mark.parametrize("lens", [(-1, 0, 1, 31, 32), (7, 8, 23, 16, 2)])
def test_fused_mla_decode_plain_vs_pallas_and_ref(lens, include, dt):
    """Ragged per-slot lengths (−1 = free, 0, 1, S−1, a full cache S,
    block boundaries), the new token counted where the append rule owns
    it (``include_new`` = owner) or nowhere.  Against the interpret-mode
    Pallas kernel: ``B4_PALLAS_TOL`` in both dtypes; against ``ref.py``:
    the tolerances of this file (looser in bf16: the new-token
    rounding)."""
    j, t = _b4_inputs(lens, include, dt)
    got = _call_b4(t)
    for use_ref in (False, True):
        want = _jax_b4(j, use_ref=use_ref)
        tol = _tol(dt) if use_ref else B4_PALLAS_TOL
        for name, g, w in zip(("o", "c_new", "m", "l"), got, want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            g, w = _np(g), _np(w)
            if name == "o":
                scale = np.abs(w).max(axis=(1, 2), keepdims=True)
                g, w = g / scale, w / scale
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=f"{name} ref={use_ref}")
    o, c_new, m, l = got
    assert o.dtype == torch.float32 and c_new.dtype == t["cc"].dtype
    assert torch.isfinite(o).all()
    if lens[0] == -1:
        # a free slot ends with l = 1 and acc = c_new[:l] (m from −1e30)
        assert torch.all(l[0] == 1.0) and torch.all(m[0] == -1e30)
        acc = c_new[0, :B4_SHAPE["l"]].float()
        want_o = torch.einsum("l,qld->qd", acc, t["wproj"].float())
        torch.testing.assert_close(o[0], want_o, rtol=1e-5, atol=1e-5)


def test_fused_mla_decode_unported_modes_raise():
    _, t = _b4_inputs((1, 2, 3, 4, 5), "owner", "f32")
    for bad in (dict(fuse_out=True), dict(fuse_out=False),
                dict(pos_base=-1), dict(pos_base=32)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _call_b4(t, **bad)
    t["ln1"] = None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _call_b4(t)


# ---------------------------------------------------------------------------
# B2 fused_ffn (gated SiLU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("add_r", [0.0, 1.0])
def test_fused_ffn_plain_vs_pallas_and_ref(add_r, dt):
    rng = np.random.default_rng(1)
    B, D, F = 3, 64, 96
    f = lambda *shape, sc=1.0: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    arrs = [f(B, D), f(B, D), f(D, F, sc=D ** -0.5), f(D, F, sc=D ** -0.5),
            f(F, D, sc=F ** -0.5), f(D, sc=0.1)]
    j, t = zip(*(_both(a, "f32" if i == 5 else dt)
                 for i, a in enumerate(arrs)))
    x, a, wi, wg, wo, ln2 = t
    got = b2.fused_ffn_block(x, a, wi, wg, wo, ln2, add_r=add_r, act="silu",
                             eps=1e-6)
    kw = dict(act="silu", eps=1e-6)
    wants = [jax_ffn(*j[:5], j[5], None, jnp.float32(add_r), block_f=32,
                     interpret=True, **kw),
             fused_ffn_block_ref(*j[:5], j[5], None, add_r, **kw)]
    for want in wants:
        for name, g, w in zip(("o", "r"), got, want):
            assert g.dtype == x.dtype
            np.testing.assert_allclose(_np(g), _np(w), **_tol(dt),
                                       err_msg=name)


def test_fused_ffn_unported_variants_raise():
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(NotImplementedError):
        b2.fused_ffn_block(x, x, w, None, w, torch.zeros(8))
    with pytest.raises(NotImplementedError):
        b2.fused_ffn_block(x, x, w, w, w, torch.zeros(8),
                           post_ln1=torch.zeros(8))
    with pytest.raises(NotImplementedError):
        b2.fused_ffn_block(x, x, w, w, w, torch.zeros(8), act="gelu")


# ---------------------------------------------------------------------------
# B3 fused_head (+ select_topk / topk_pair_merge)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_head_plain_vs_pallas_and_ref_with_ties(dt):
    """Equal logits placed in different vocab tiles (and inside one):
    the lower index must win, exactly as in the reference."""
    rng = np.random.default_rng(2)
    B, D, V = 3, 64, 96
    x = rng.standard_normal((B, D)).astype(np.float32)
    table = (rng.standard_normal((V, D)) * D ** -0.5).astype(np.float32)
    strong = np.sign(x[0]) * 0.2                  # slot 0's best row
    for r in (5, 6, 40, 95):                      # tiles 0, 0, 1, 2
        table[r] = strong
    table[70] = table[11]                         # a tie further down
    ln = (rng.standard_normal(D) * 0.1).astype(np.float32)
    (jx, jt, jl), (tx, tt, tl) = zip(*(_both(a, "f32" if i == 2 else dt)
                                       for i, a in enumerate((x, table, ln))))
    gv, gi = b3.fused_head_block(tx, tt, tl, eps=1e-6, k=8)
    assert gi[0, :4].tolist() == [5, 6, 40, 95]
    for wv, wi in (jax_head(jx, jt, jl, eps=1e-6, block_v=32, k=8,
                            interpret=True),
                   fused_head_ref(jx, jt, jl, eps=1e-6, k=8)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _close_ulps(gv.numpy(), wv)


def test_fused_head_softcap_raises():
    with pytest.raises(NotImplementedError):
        b3.fused_head_block(torch.zeros(1, 8), torch.zeros(4, 8),
                            torch.zeros(8), logit_softcap=30.0)


def test_select_topk_and_pair_merge_match_reference():
    rng = np.random.default_rng(3)
    vals = rng.integers(-3, 3, (4, 40)).astype(np.float32)   # many ties
    ids = np.stack([rng.permutation(1000)[:40] for _ in range(4)]
                   ).astype(np.int32)
    gv, gi = port_topk.select_topk(torch.from_numpy(vals),
                                   torch.from_numpy(ids), 8)
    wv, wi = jax_topk.select_topk(jnp.asarray(vals), jnp.asarray(ids), 8)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    a = (gv[:2], gi[:2])
    b = (gv[2:], gi[2:] + 1000)                    # disjoint index sets
    mv, mi = port_topk.topk_pair_merge(a, b)
    jv, ji = jax_topk.topk_pair_merge((jnp.asarray(a[0].numpy()),
                                       jnp.asarray(a[1].numpy())),
                                      (jnp.asarray(b[0].numpy()),
                                       jnp.asarray(b[1].numpy())))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    rv, ri = port_topk.topk_pair_merge(b, a)       # commutative
    assert torch.equal(rv, mv) and torch.equal(ri, mi)


# ---------------------------------------------------------------------------
# The CUDA wrappers: plain path only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: it takes the wrappers down
    their CUDA path on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def _cuda_calls():
    bf = torch.bfloat16
    D, hd, S = 128, 128, 4
    z = lambda *s, dt=bf: torch.zeros(s, dtype=dt)
    i32 = torch.int32
    return {
        "fused_decode": lambda c: b1.fused_decode_attention(
            c(z(1, D)), z(D, 3 * hd), z(1, hd, D), z(D, dt=torch.float32),
            z(S, 1, hd), z(S, 1, hd), z(S, 1, dt=i32), z(1, dt=i32),
            z(1, dt=i32), z(1, hd // 2, dt=torch.float32),
            z(1, hd // 2, dt=torch.float32), q_heads=1, kv_heads=1),
        "fused_ffn": lambda c: b2.fused_ffn_block(
            c(z(1, 8)), z(1, 8), z(8, 4), z(8, 4), z(4, 8),
            z(8, dt=torch.float32)),
        "fused_head": lambda c: b3.fused_head_block(
            c(z(1, 8)), z(4, 8), z(8, dt=torch.float32)),
        "fused_mla_decode": lambda c: b4.fused_mla_decode_attention(
            c(z(1, 16)), z(16, 4 * 24), z(16, 40), z(4, 16, 32),
            z(4, 32, 16), z(16, dt=torch.float32), z(S, 1, 40),
            z(S, 1, dt=i32), z(1, dt=i32), z(1, dt=i32),
            z(1, 4, dt=torch.float32), z(1, 4, dt=torch.float32),
            q_heads=4, nope=16, rope_d=8, l_rank=32),
    }


KERNEL_NAMES = ["fused_decode", "fused_ffn", "fused_head", "fused_mla_decode"]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_cuda_path_raises_when_the_library_cannot_be_built(
        name, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build.shutil, "which",
                        lambda _: str(tmp_path / "no-nvcc"))
    tracecount.reset()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_calls()[name](lambda t: t.as_subclass(_OnCard))
    assert tracecount.calls()[name] == 1
    assert tracecount.launches()[name] == 0


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_plain_path_only_for_cpu_tensors(name, monkeypatch):
    def no_library(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "function", no_library)
    tracecount.reset()
    _cuda_calls()[name](lambda t: t)                    # CPU: plain version
    assert tracecount.calls()[name] == 1
    assert tracecount.launches()[name] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        _cuda_calls()[name](lambda t: t.to("meta"))
