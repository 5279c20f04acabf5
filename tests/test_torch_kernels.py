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
element.  B7 (WKV scan): f32 only (the model path's dtype), 1e-5.
B5 (flash decode): f32 to 2e-5 against the Pallas kernel and
``ref.py`` (the reference's own ``test_flash_decode_sweep`` tolerance:
the Pallas kernel's online softmax over blocks sums in another order),
bf16 compared in f32 at 2e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.flash_decode import \
    flash_decode_attention as jax_flash_decode
from repro.kernels.flash_decode.ref import flash_decode_attention_ref
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
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan_kernel

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import flash_decode as b5
from repro_torch.kernels.fused_decode import fused_decode as b1
from repro_torch.kernels.fused_ffn import fused_ffn as b2
from repro_torch.kernels.fused_head import fused_head as b3
from repro_torch.kernels.fused_head import topk as port_topk
from repro_torch.kernels.fused_mla_decode import fused_mla_decode as b4
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as b7

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


def _b1_inputs(lens, include, dt, seed=0, S=None):
    rng = np.random.default_rng(seed)
    B, D, nq, nkv, hd = (B1_SHAPE[k] for k in ("B", "D", "nq", "nkv", "hd"))
    S = S or B1_SHAPE["S"]
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
    B, nq, nkv, hd = (B1_SHAPE[k] for k in ("B", "nq", "nkv", "hd"))
    S = j["kc"].shape[0]
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


@pytest.mark.parametrize("lens", [(63, 64, 65, 128), (-1, 127, 129, 192)])
def test_fused_decode_plain_at_rank_split_edges(lens):
    """The CUDA kernel cuts the live rows of all slots, laid end to end,
    into equal runs of 64-row tiles that stop at a slot's edge: lengths
    on tile edges ± 1 and slots that end where a run does (4 slots of
    128 rows over 4 ranks), bf16 against the Pallas kernel and ref.py."""
    j, t = _b1_inputs(lens, "owner", "bf16", S=192)
    got = b1.fused_decode_attention(
        t["x"], t["wqkv"], t["wo"], t["ln1"], t["kc"], t["vc"], t["pos"],
        t["lens"], t["inc"], t["cos"], t["sin"], q_heads=B1_SHAPE["nq"],
        kv_heads=B1_SHAPE["nkv"], norm_eps=1e-6)
    for use_ref in (False, True):
        want = _jax_b1(j, use_ref=use_ref)
        for name, g, w in zip(("o", "k_new", "v_new", "m", "l"), got, want):
            np.testing.assert_allclose(_np(g), _np(w), **_tol("bf16"),
                                       err_msg=f"{name} ref={use_ref}")


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
# B7 rwkv6_scan (the WKV recurrence, f32 state)
# ---------------------------------------------------------------------------
B7_SHAPE = dict(B=2, H=4, hd=16)


def _b7_inputs(S, seed=5):
    """r, k, v, w, u, s0 as f32 numpy (the scales of
    ``tests/test_kernels.py::test_rwkv6_scan_sweep``), s0 nonzero."""
    rng = np.random.default_rng(seed)
    B, H, hd = (B7_SHAPE[k] for k in ("B", "H", "hd"))
    f = lambda *shape, sc: (rng.standard_normal(shape) * sc).astype(
        np.float32)
    r, k, v = (f(B, S, H, hd, sc=0.3) for _ in range(3))
    w = (0.4 + 0.5 / (1 + np.exp(-f(B, S, H, hd, sc=1.0)))).astype(
        np.float32)
    return r, k, v, w, f(H, hd, sc=0.1), f(B, H, hd, hd, sc=0.1)


@pytest.mark.parametrize("S", [1, 32])
def test_rwkv6_scan_plain_vs_pallas_and_ref(S):
    """The plain version against the interpret-mode Pallas kernel
    (``block_t=16, block_h=2``: S % min(16, S) and H % 2 hold) and
    ``ref.py`` (the model's ``_wkv_scan``), from a random nonzero s0.
    Measured ≤ 1.2e-7 at S = 32."""
    arrs = _b7_inputs(S)
    got = b7.rwkv6_scan(*(torch.from_numpy(a) for a in arrs))
    j = [jnp.asarray(a) for a in arrs]
    for want in (rwkv6_scan_kernel(*j, block_t=16, block_h=2,
                                   interpret=True),
                 rwkv6_scan_ref(*j)):
        for name, g, w in zip(("o", "s_fin"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            np.testing.assert_allclose(_np(g), _np(w), **_tol("f32"),
                                       err_msg=name)


def test_rwkv6_scan_updates_the_state_in_place():
    """``s_out = s0``: the final state lands in the state passed in, the
    same values as into a fresh tensor (the engine's in-place update)."""
    t = [torch.from_numpy(a) for a in _b7_inputs(7)]
    o, s_fin = b7.rwkv6_scan(*t)
    s0 = t[5].clone()
    o2, s_alias = b7.rwkv6_scan(*t[:5], s0, s_out=s0)
    assert s_alias.data_ptr() == s0.data_ptr()
    assert torch.equal(o2, o) and torch.equal(s0, s_fin)


def test_rwkv6_scan_unsupported_inputs_raise():
    """On the card the kernel takes f32 and hd = 64 only; other inputs
    raise naming ROADMAP, never falling back to the plain version."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _b7_inputs(2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        b7.rwkv6_scan_cuda(r, k, v, w, u, s0)              # hd = 16
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    x = z(1, 2, 1, 64, dt=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="float32"):
        b7.rwkv6_scan_cuda(x, x, x, x, z(1, 64), z(1, 1, 64, 64))


# ---------------------------------------------------------------------------
# B5 flash_decode (the unfused baseline's attention core)
# ---------------------------------------------------------------------------
def _b5_inputs(S, q_loc, kv_loc, hd, B=2, per_slot=False, seed=6):
    """q ``[B, q_loc, hd]`` and a cache ``[S, kv_loc, hd]`` (or
    ``[S, B, kv_loc, hd]`` per slot) at the scale of
    ``tests/test_kernels.py::test_flash_decode_sweep`` (0.3)."""
    rng = np.random.default_rng(seed)
    cache = (S, B, kv_loc, hd) if per_slot else (S, kv_loc, hd)
    f = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return f(B, q_loc, hd), f(*cache), f(*cache)


@pytest.mark.parametrize("S,q_loc,kv_loc,hd,clen,cap,window", [
    (512, 4, 2, 32, 77, 0.0, 0), (256, 8, 1, 64, 256, 0.0, 0),
    (1024, 2, 2, 16, 1000, 0.0, 0),          # the reference's sweep
    (512, 4, 2, 32, 77, 0.5, 0),             # softcap: |scores| ≤ 0.6,
                                             # the cap bends the largest
    (256, 8, 1, 64, 200, 0.0, 70),           # window, GQA 8:1
    (1024, 2, 2, 16, 1000, 0.5, 300)])       # both
def test_flash_decode_plain_vs_pallas_and_ref(S, q_loc, kv_loc, hd, clen,
                                              cap, window):
    """The Pallas signature (one cache, a scalar length) against the
    interpret-mode kernel (``block_s=128``) and ``ref.py``, f32 to 2e-5."""
    q, kc, vc = _b5_inputs(S, q_loc, kv_loc, hd)
    kw = dict(attn_softcap=cap, window=window)
    got = b5.flash_decode_attention(*(torch.from_numpy(a) for a in
                                      (q, kc, vc)), clen, **kw)
    j = [jnp.asarray(a) for a in (q, kc, vc)]
    for want in (jax_flash_decode(*j, clen, block_s=128, interpret=True,
                                  **kw),
                 flash_decode_attention_ref(*j, clen, **kw)):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_decode_per_slot_matches_vmapped_pallas(window, dt):
    """The engine's per-slot form (cache ``[S, B, kv, hd]``, lengths
    ``[B]``) against ``jax.vmap`` of the interpret-mode Pallas kernel
    over slots, as ``tests/test_ragged_decode.py:94`` runs it, at lengths
    0, 17, 40 and S: slot b sees only its own column and length, and a
    length-0 slot gives exactly zeros.  f32 to 2e-5, bf16 to 2e-2."""
    B, S, q_loc, kv_loc, hd = 4, 64, 4, 2, 16
    q, kc, vc = _b5_inputs(S, q_loc, kv_loc, hd, B=B, per_slot=True)
    lens = np.array([0, 17, 40, S], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in (q, kc, vc))
    got = b5.flash_decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                    window=window)
    want = jax.vmap(lambda qb, kb, vb, cl: jax_flash_decode(
        qb[None], kb, vb, cl, window=window, block_s=16,
        interpret=True)[0], in_axes=(0, 1, 1, 0))(jq, jk, jv,
                                                  jnp.asarray(lens))
    assert got.dtype == tq.dtype and got.shape == (B, q_loc, hd)
    assert not got[0].any()                         # length 0: zeros
    tol = _tol(dt) if dt == "bf16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("lens", [(512, 512, 512, 512),       # full rings
                                  (0, 1, 63, 64), (65, 255, 256, 257),
                                  (127, 128, 384, 511)])
def test_flash_decode_hd256_sixteen_rows_on_one_kv_head(lens):
    """RecurrentGemma's shape class: 16 query heads on one kv head of
    256, per slot, against ``jax.vmap`` of the interpret-mode Pallas
    kernel and ``ref.py``, on full caches and at the edges of the CUDA
    kernel's 64-row tiles and of its ranks' runs (a 512-row cache over 8
    ranks: one tile each).  f32 to 2e-5."""
    B, S, q_loc, hd = 4, 512, 16, 256
    q, kc, vc = _b5_inputs(S, q_loc, 1, hd, B=B, per_slot=True, seed=7)
    lens = np.asarray(lens, np.int32)
    got = b5.flash_decode_attention(*(torch.from_numpy(a) for a in
                                      (q, kc, vc)), torch.from_numpy(lens))
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, kc, vc, lens))
    want = jax.vmap(lambda qb, kb, vb, cl: jax_flash_decode(
        qb[None], kb, vb, cl, block_s=128, interpret=True)[0],
        in_axes=(0, 1, 1, 0))(jq, jk, jv, jl)
    ref = jax.vmap(lambda qb, kb, vb, cl: flash_decode_attention_ref(
        qb[None], kb, vb, cl)[0], in_axes=(0, 1, 1, 0))(jq, jk, jv, jl)
    live = lens > 0               # ref.py's softmax of no row is NaN
    assert not got[~torch.from_numpy(live)].any()
    for w in (want, ref):
        np.testing.assert_allclose(_np(got)[live], _np(w)[live], rtol=2e-5,
                                   atol=2e-5)


def test_flash_decode_unsupported_inputs_raise(monkeypatch):
    """On the card: head dims 64/128/256, bf16 or f32 with q, k and v of
    one dtype, at most 32 query rows per (cache, kv head); anything else
    raises before a build, never falling back to the plain version."""
    def no_library(*_a, **_k):
        raise AssertionError("an unsupported input reached the library")

    monkeypatch.setattr(_build, "function", no_library)
    z = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt)
    lens = torch.zeros(2, dtype=torch.int32)
    bad = [(z(2, 4, 32), z(8, 2, 2, 32), z(8, 2, 2, 32), lens),   # hd 32
           (z(2, 4, 64), z(8, 2, 2, 64, dt=torch.float32),
            z(8, 2, 2, 64, dt=torch.float32), lens),              # dtypes
           (z(2, 4, 64, dt=torch.float16), z(8, 2, 2, 64, dt=torch.float16),
            z(8, 2, 2, 64, dt=torch.float16), lens),              # fp16
           (z(2, 66, 64), z(8, 2, 64), z(8, 2, 64), 3),           # 66 rows
           (z(2, 4, 64), z(8, 2, 2, 64), z(8, 2, 2, 64), 3)]      # [B] lens
    for args in bad:
        with pytest.raises(NotImplementedError, match="flash_decode"):
            b5.flash_decode_cuda(*args)


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
    """``post_ln1`` (gated or not: the Gemma-2 slice) and an activation
    outside the reference's table raise; the ungated form and the table's
    activations are ported (``tests/test_torch_gqa.py``)."""
    x = torch.zeros(2, 8)
    w = torch.zeros(8, 8)
    with pytest.raises(NotImplementedError, match="post_ln1"):
        b2.fused_ffn_block(x, x, w, None, w, torch.zeros(8),
                           post_ln1=torch.zeros(8), act="relu2")
    with pytest.raises(NotImplementedError, match="post_ln1"):
        b2.fused_ffn_block(x, x, w, w, w, torch.zeros(8),
                           post_ln1=torch.zeros(8))
    with pytest.raises(NotImplementedError, match="geglu"):
        b2.fused_ffn_block(x, x, w, w, w, torch.zeros(8), act="geglu")


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
            c(z(1, 16)), z(1, 16), z(16, 16), z(16, 16), z(16, 16),
            z(16, dt=torch.float32)),
        "fused_head": lambda c: b3.fused_head_block(
            c(z(1, 8)), z(4, 8), z(8, dt=torch.float32)),
        # MLA's geometry (nope 128, rope 64, latent 512), one head
        "fused_mla_decode": lambda c: _mla_call(
            b4.fused_mla_decode_attention, c, 1, 512, S, 1)[1],
        "flash_decode": lambda c: b5.flash_decode_attention(
            c(z(2, 4, 64)), z(S, 2, 2, 64), z(S, 2, 2, 64),
            z(2, dt=i32)),
        "rwkv6_scan": lambda c: b7.rwkv6_scan(
            c(z(1, 2, 1, 64, dt=torch.float32)), *(
                z(1, 2, 1, 64, dt=torch.float32) for _ in range(3)),
            z(1, 64, dt=torch.float32), z(1, 1, 64, 64, dt=torch.float32)),
    }


def _mla_call(fn, c, B, D, S, heads, nope=128, rope=64, lat=512):
    """``fn`` (a B4 entry) on zeros of ``B`` slots, ``d_model`` ``D``, a
    cache of ``S`` rows and ``heads`` heads, ``x`` passed through ``c``;
    returns the arguments and the result."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    z = lambda *s, dt=bf: torch.zeros(s, dtype=dt)
    args = (c(z(B, D)), z(D, heads * (nope + rope)), z(D, lat + rope),
            z(heads, nope, lat), z(heads, lat, D), z(D, dt=f32),
            z(S, B, lat + rope), z(S, B, dt=i32), z(B, dt=i32), z(B, dt=i32),
            z(B, rope // 2, dt=f32), z(B, rope // 2, dt=f32))
    return args, fn(*args, q_heads=heads, nope=nope, rope_d=rope,
                    l_rank=lat, norm_eps=1e-6)


KERNEL_NAMES = ["fused_decode", "fused_ffn", "fused_head", "fused_mla_decode",
                "rwkv6_scan", "flash_decode"]


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


# ---------------------------------------------------------------------------
# The cluster kernels' wrappers: what reaches the library
# ---------------------------------------------------------------------------
def _record_launch(monkeypatch):
    """Replace the library with a recorder of each call's arguments."""
    calls = []

    def fake_function(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, len(args))
            calls.append(args)
            return 0
        return fn

    monkeypatch.setattr(_build, "function", fake_function)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    return calls


@pytest.mark.parametrize("shape,plan", [
    ((8, 16, 256, 2048, 1), (1, 8)),     # RecurrentGemma's ring
    ((8, 32, 128, 1024, 32), (4, 4)),    # Llama2-7B's per-slot decode
    ((8, 32, 128, 1024, 8), (1, 4))])    # GQA 32/8
def test_flash_decode_wrapper_passes_no_workspace(monkeypatch, shape, plan):
    """One launch, five pointers (q, k, v, lengths, o — no f32
    workspace) and the cluster plan (GB groups a cluster, C CTAs) that
    the shape alone decides."""
    calls = _record_launch(monkeypatch)
    B, q_loc, hd, S, kv = shape
    bf = torch.bfloat16
    q = torch.zeros(B, q_loc, hd, dtype=bf)
    kc = torch.zeros(S, B, kv, hd, dtype=bf)
    lens = torch.zeros(B, dtype=torch.int32)
    o = b5.flash_decode_cuda(q, kc, kc.clone(), lens)
    (args,) = calls
    ptrs, ints = args[:5], args[5:14]
    assert ptrs[:4] == (q.data_ptr(), kc.data_ptr(), ptrs[2],
                        lens.data_ptr()) and ptrs[4] == o.data_ptr()
    G, GB, NB, S_, kv_, qpk, hd_, is_f32, C = ints
    assert (G, NB, S_, kv_, qpk, hd_, is_f32) == (B, 1, S, kv, q_loc // kv,
                                                  hd, 0)
    assert (GB, C) == plan == b5.cluster_plan(S, B, kv, q_loc // kv)
    assert C in (1, 2, 4, 8) and G % GB == 0


@pytest.mark.parametrize("heads,kv,D,C,H", [
    (32, 32, 256, 4, 1), (4, 4, 512, 8, 1),
    (32, 32, 4096, 4, 1),                   # Llama2-7B
    (32, 8, 4096, 8, 4),                    # Granite-8B
    (24, 8, 3072, 8, 3),                    # Minitron-4B
    (8, 2, 256, 4, 4), (6, 2, 256, 4, 3)])  # reduced GQA 8/2 and 6/2
def test_fused_decode_wrapper_cluster_size(monkeypatch, heads, kv, D, C, H):
    """The plan follows the heads and d_model alone: ``H`` = q_per_kv
    query heads a cluster (a kv head's 1, 3 or 4), clusters of ``C`` ≤ 8
    CTAs bringing the grid to about 128 CTAs (Llama2-7B's 32 heads: 4; 8
    kv heads: 8), each rank 64–1024 rows of wqkv.  One library call
    carries the plan."""
    assert b1.cluster_plan(heads, kv, D) == (C, H)
    assert b1.cluster_size(kv, D) == C
    if D > 512:
        return                              # no 100 MB weights here
    calls = _record_launch(monkeypatch)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    B, S, hd = 2, 8, 128
    b1.fused_decode_cuda(
        torch.zeros(B, D, dtype=bf),
        torch.zeros(D, (heads + 2 * kv) * hd, dtype=bf),
        torch.zeros(heads, hd, D, dtype=bf), torch.zeros(D, dtype=f32),
        torch.zeros(S, B * kv, hd, dtype=bf),
        torch.zeros(S, B * kv, hd, dtype=bf), torch.zeros(S, B, dtype=i32),
        torch.zeros(B, dtype=i32), torch.zeros(B, dtype=i32),
        torch.zeros(B, hd // 2, dtype=f32), torch.zeros(B, hd // 2, dtype=f32),
        q_heads=heads, kv_heads=kv, scale=hd ** -0.5, norm_eps=1e-6)
    (args,) = calls
    assert args[16:24] == (B, D, S, heads, kv, hd, C, H)


def _record_empty(monkeypatch):
    """Record the shape and dtype of every ``torch.empty`` a wrapper
    makes (its outputs and any workspace)."""
    made = []
    real = torch.empty

    def empty(*shape, **kw):
        t = real(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    return made


@pytest.mark.parametrize("D,F,plan", [(4096, 11008, (15, 8)),   # Llama2-7B
                                      (2048, 10944, (15, 8)),   # DeepSeek
                                      (64, 96, (6, 4)),
                                      (256, 1024, (15, 8))])
def test_fused_ffn_wrapper_one_launch_with_cluster_workspace(
        monkeypatch, D, F, plan):
    """B2's plan follows (d_model, d_ff) alone: 15 clusters of 8 at both
    paths' widths (no weights allocated there).  At a small width the
    wrapper makes one library call with the ten pointers (x, a, w_in,
    w_gate, w_out, ln2, the f32 ``[G, B, D]`` cluster partials, the
    arrival counters, o, r) and that plan, and allocates no other
    workspace: no per-tile ``[n_tiles, B, D]`` partials."""
    assert b2.cluster_plan(D, F) == plan
    if D > 256:
        return                              # no 270 MB weights here
    calls = _record_launch(monkeypatch)
    made = _record_empty(monkeypatch)
    bf = torch.bfloat16
    B = 3
    x, a = torch.zeros(B, D, dtype=bf), torch.zeros(B, D, dtype=bf)
    w_in, w_gate = torch.zeros(D, F, dtype=bf), torch.zeros(D, F, dtype=bf)
    w_out, ln2 = torch.zeros(F, D, dtype=bf), torch.zeros(D)
    o, r = b2.fused_ffn_cuda(x, a, w_in, w_gate, w_out, ln2, add_r=1.0)
    (args,) = calls
    G, C = plan
    ptrs, ints = args[:10], args[10:15]
    assert ptrs[:6] == tuple(t.data_ptr() for t in (x, a, w_in, w_gate,
                                                    w_out, ln2))
    arrivals = _build.arrival_counters("fused_ffn", x.device)
    assert ptrs[7] == arrivals.data_ptr()
    assert ptrs[8:] == (o.data_ptr(), r.data_ptr())
    assert ints == (B, D, F, G, C)
    assert made == [((G, B, D), torch.float32)]    # o, r: empty_like
    assert arrivals.dtype == torch.int32 and arrivals.numel() >= C
    assert not arrivals.any()               # the kernel leaves them at 0


@pytest.mark.parametrize("heads,D,plan", [(16, 2048, (16, 8)),  # DeepSeek
                                          (2, 512, (2, 8)),
                                          (1, 4096, (1, 8))])
def test_fused_mla_decode_wrapper_one_launch_no_workspace(
        monkeypatch, heads, D, plan):
    """B4's plan follows the heads and d_model alone: a cluster of 8 CTAs
    per head (DeepSeek-V2-Lite: 16 clusters, no weights allocated
    there).  At a small width the wrapper makes one library call with
    its twelve inputs and four outputs (o, c_new, m, l) and no f32
    workspace: it allocates the outputs alone.  The library's two device
    launches (c_new, then the head clusters) hand c_new over in the
    output itself; the five launches' f32 stage workspace is gone."""
    assert b4.cluster_plan(heads, D) == plan
    if D > 512:
        return
    calls = _record_launch(monkeypatch)
    made = _record_empty(monkeypatch)
    B, S = 3, 8
    args, (o, c_new, m, l) = _mla_call(b4.fused_mla_decode_cuda,
                                       lambda t: t, B, D, S, heads)
    (rec,) = calls
    assert rec[:12] == tuple(t.data_ptr() for t in args)
    assert rec[12:16] == tuple(t.data_ptr() for t in (o, c_new, m, l))
    assert rec[16:24] == (B, D, S, heads, 128, 64, 512, plan[1])
    f32 = torch.float32
    # o, c_new, m (l: empty_like of m)
    assert made == [((B, heads, D), f32), ((B, 576), torch.bfloat16),
                    ((B, heads), f32)]


@pytest.mark.parametrize("V,D,plan", [(32000, 4096, (15, 8)),    # Llama2-7B
                                      (102400, 2048, (15, 8)),   # DeepSeek
                                      (65536, 2560, (15, 8)),    # RWKV-6 3B
                                      (32011, 4096, (15, 8)),    # ragged
                                      (96, 64, (1, 4)),
                                      (4, 8, (1, 1))])
def test_fused_head_wrapper_one_launch_with_cluster_partials(
        monkeypatch, V, D, plan):
    """B3's plan follows (vocab, d_model) alone: 15 clusters of 8 at the
    three paths' widths and at a ragged vocabulary (no table allocated
    there), every CTA at least one 16-row vocabulary unit.  At a small
    width the wrapper makes one library call — no tile-count query —
    with its eight pointers (x, table, ln, the ``[G, B, k]`` cluster
    partials, the arrival counters, the outputs) and that plan, and
    allocates no other workspace: no ``[n_tiles, B, k]`` partials.  The
    counters are int32 and left at 0."""
    assert b3.cluster_plan(V, D) == plan
    G, C = plan
    assert G * C <= -(-V // 16) and C in (1, 2, 4, 8)
    if V * D > 1 << 20:
        return                              # no 262 MB tables here
    calls = _record_launch(monkeypatch)
    made = _record_empty(monkeypatch)
    B, k = 3, 5
    x = torch.zeros(B, D, dtype=torch.bfloat16)
    table = torch.zeros(V, D, dtype=torch.bfloat16)
    ln = torch.zeros(D)
    vals, idx = b3.fused_head_cuda(x, table, ln, eps=1e-5, k=k)
    (args,) = calls
    ptrs, ints = args[:8], args[8:14]
    assert ptrs[:3] == (x.data_ptr(), table.data_ptr(), ln.data_ptr())
    arrivals = _build.arrival_counters("fused_head", x.device)
    assert ptrs[5] == arrivals.data_ptr()
    assert ptrs[6:] == (vals.data_ptr(), idx.data_ptr())
    assert ints == (B, D, V, k, G, C)
    assert args[14] == pytest.approx(1e-5)
    f32, i32 = torch.float32, torch.int32
    assert made == [((G, B, k), f32), ((G, B, k), i32), ((B, k), f32),
                    ((B, k), i32)]
    assert arrivals.dtype == i32 and arrivals.numel() >= C
    assert not arrivals.any()               # the kernel leaves them at 0


def test_fused_head_refuses_unported_shapes(monkeypatch):
    """More than 8 slots, k outside 1..8, a width not a multiple of 8 or
    wider than the kernel's shared memory holds raise before the
    library is reached, naming ROADMAP."""
    def no_library(*_a, **_k):
        raise AssertionError("an unsupported input reached the library")

    monkeypatch.setattr(_build, "function", no_library)
    bf = torch.bfloat16
    for B, D, k in ((9, 64, 8), (2, 64, 9), (2, 64, 0), (2, 60, 8),
                    (2, 9224, 8)):
        assert b3.cluster_plan(32, D) == ((0, 0) if D in (60, 9224)
                                          else (1, 2))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            b3.fused_head_cuda(torch.zeros(B, D, dtype=bf),
                               torch.zeros(32, D, dtype=bf), torch.zeros(D),
                               k=k)


@pytest.mark.parametrize("alias", [False, True])
def test_rwkv6_scan_wrapper_passes_its_pointers(monkeypatch, alias):
    """One library call with the eight pointers (r, k, v, w, u, s0, o,
    s_fin) and (B, S, H, hd); with ``s_out = s0`` the final state's
    pointer is the state's own (the engine's in-place update), else a
    fresh ``[B, H, hd, hd]`` tensor.  No workspace."""
    calls = _record_launch(monkeypatch)
    made = _record_empty(monkeypatch)
    B, S, H, hd = 2, 17, 3, 64
    f = lambda *s: torch.zeros(s)
    r, k, v, w = (f(B, S, H, hd) for _ in range(4))
    u, s0 = f(H, hd), f(B, H, hd, hd)
    o, s_fin = b7.rwkv6_scan_cuda(r, k, v, w, u, s0,
                                  s_out=s0 if alias else None)
    (args,) = calls
    assert args[:8] == tuple(t.data_ptr() for t in (r, k, v, w, u, s0, o,
                                                    s_fin))
    assert args[8:12] == (B, S, H, hd)
    assert (s_fin.data_ptr() == s0.data_ptr()) == alias
    assert made == [((B, S, H, hd), torch.float32)]   # o; s_fin: empty_like


def test_cluster_kernels_refuse_unported_shapes(monkeypatch):
    """B1 at head_dim 256 (GQA 8/2: the Gemma-2 slice's), a d_model no
    cluster size splits into 64-row multiples, query heads that are no
    multiple of the kv heads, and q_per_kv 2 and 8 (no instance) raise
    before the library is reached; so
    do B2 shapes its plan cannot
    split (d_ff not a multiple of 16, d_model not a multiple of 16 or
    over 512 rows a rank) and B4 shapes outside MLA's geometry or with a
    d_model whose eighth is not a multiple of 64 up to 512."""
    def no_library(*_a, **_k):
        raise AssertionError("an unsupported input reached the library")

    monkeypatch.setattr(_build, "function", no_library)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    for heads, kv, D, hd in ((8, 2, 256, 256), (4, 4, 72, 128),
                             (6, 4, 256, 128), (8, 4, 256, 128),
                             (16, 2, 512, 128)):
        B, S = 1, 4
        with pytest.raises(NotImplementedError, match="fused_decode"):
            b1.fused_decode_cuda(
                torch.zeros(B, D, dtype=bf),
                torch.zeros(D, (heads + 2 * kv) * hd, dtype=bf),
                torch.zeros(heads, hd, D, dtype=bf), torch.zeros(D, dtype=f32),
                torch.zeros(S, B * kv, hd, dtype=bf),
                torch.zeros(S, B * kv, hd, dtype=bf),
                torch.zeros(S, B, dtype=i32), torch.zeros(B, dtype=i32),
                torch.zeros(B, dtype=i32), torch.zeros(B, hd // 2, dtype=f32),
                torch.zeros(B, hd // 2, dtype=f32), q_heads=heads,
                kv_heads=kv, scale=hd ** -0.5, norm_eps=1e-6)
    for D, F in ((64, 100), (8, 16), (5120, 13824)):
        assert b2.cluster_plan(D, F) == (0, 0)
        z = lambda *s: torch.zeros(s, dtype=bf)
        with pytest.raises(NotImplementedError, match="fused_ffn"):
            b2.fused_ffn_cuda(z(1, D), z(1, D), z(D, F), z(D, F), z(F, D),
                              torch.zeros(D, dtype=f32), add_r=1.0)
    for D, geometry in ((512, dict(nope=64)), (512, dict(lat=256)),
                        (256, {}), (4608, {})):
        with pytest.raises(NotImplementedError, match="fused_mla_decode"):
            _mla_call(b4.fused_mla_decode_cuda, lambda t: t, 1, D, 4, 1,
                      **geometry)
    assert b4.cluster_plan(1, 256) == b4.cluster_plan(1, 4608) == (0, 0)


@pytest.mark.parametrize("name", ["flash_decode", "fused_decode",
                                  "fused_ffn", "fused_mla_decode",
                                  "fused_head", "rwkv6_scan"])
@pytest.mark.parametrize("header", ["cluster.cuh", "common.cuh"])
def test_lib_path_hashes_every_header(name, header, monkeypatch, tmp_path):
    """A changed header names another library, so a stale one built from
    the old header is never loaded (no nvcc needed: its version is
    stubbed)."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_nvcc_version", lambda nvcc: "nvcc 12.x")
    before = _build.lib_path(name, "nvcc")
    assert before == _build.lib_path(name, "nvcc")
    with open(tmp_path / header, "a") as fh:
        fh.write("\n// changed\n")
    assert _build.lib_path(name, "nvcc") != before
