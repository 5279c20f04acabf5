"""B1 — fused RMSNorm + QKV-Projection + RoPE + ragged decode attention +
per-head Output-Projection (``fuse_out="partial_o"``).

Replaces ``repro/kernels/fused_decode/fused_decode.py:fused_decode_attention``
(``pallas_call`` at line 374), in the mode the serving path runs: fused
``ln1``, linear cache, no bias, window, ring or softcap, MHA, GQA or MQA
at ``head_dim`` 128.  The other modes raise ``NotImplementedError``
(ROADMAP.md, the Gemma-2 slice).

CUDA kernel: ``csrc/fused_decode.cu``.  What bounds it on an H100: bytes.
At Llama2-7B widths one layer streams ``wqkv`` (100.7 MB) and ``wo``
(33.6 MB) plus each slot's live KV, against ~2·B·(D·P + q·hd·D) FLOPs —
a few FLOPs per byte, far under the ~295 FLOP/byte ridge.  The design
reads every weight byte ONCE per launch for the whole batch (the JAX
path vmaps the Pallas kernel per slot, so on the TPU each slot re-reads
``wqkv``/``wo``), and is the paper's: one thread-block cluster of ``C``
CTAs per kv head, holding its ``H`` = ``q_per_kv`` query heads
(:func:`cluster_plan`: ``C`` 4 and ``H`` 1 at Llama2-7B, 128 CTAs; ``C``
8 and ``H`` 4 and 3 at Granite-8B and Minitron-4B, 64 CTAs: clusters of
16 or a kv head split over two clusters took a second wave and were
slower, PERF.md §6).
Each rank projects its ``D/C`` rows of the cluster's ``wqkv`` columns
(its query heads, then the kv head's k and v), the partials are summed over
distributed shared memory in rank order, each rank attends its share of
every slot's live rows for the cluster's query heads (each K/V row read
once for all of them), the ``(m, l, acc)`` partials merge on chip in
rank order, and each rank projects every head through its ``D/C``
columns of that head's ``wo``.
Attention covers only each slot's live prefix (``cache_len`` ragged,
``−1`` = free slot: no KV read at all).

Numerics follow the Pallas kernel: x rounds to the model dtype after
the norm (``fused_decode.py:100``); q/k/v stay f32; the new token
attends with the f32 rotated k and v while ``k_new``/``v_new`` leave
rounded (``:117-121``); ``m`` starts at −1e30 (``:122``), so a free slot
ends with ``l = 1`` and ``o = v_new·wo`` rather than NaN.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.models.layers import rope_freqs

_MAX_B = 8           # slots per launch (the kernel's template range)
_HEAD_DIMS = (128,)  # head dims the CUDA kernel is instantiated for
_MAX_CLUSTER = 8     # the portable thread-block cluster size
_TARGET_CTAS = 128   # about one CTA per SM of an H100 (132)
_MAX_ROWS = 1024     # wqkv rows a rank may hold (csrc MAX_NTO · 64)
_HEADS = (1, 3, 4)   # query heads a cluster the kernel is instantiated for


def _rows_ok(rows: int) -> bool:
    """Rows of ``wqkv`` a rank may hold (csrc ``rows_ok``): a multiple of
    64 (eight warps' 8-column tiles of ``wo``), 64 … 1024."""
    return 64 <= rows <= _MAX_ROWS and rows % 64 == 0


def cluster_size(kv_heads: int, d_model: int) -> int:
    """CTAs in the cluster of one kv head: the power of two ≤ 8 that
    brings the grid to about ``_TARGET_CTAS`` (Llama2-7B's 32 heads: 4;
    8 kv heads: 8), halved until each rank's ``d_model / C`` rows are
    ones the kernel takes; 0 if none is."""
    c = 1
    while c < _MAX_CLUSTER and kv_heads * c < _TARGET_CTAS:
        c *= 2
    while c >= 1:
        if d_model % c == 0 and _rows_ok(d_model // c):
            return c
        c //= 2
    return 0


def cluster_plan(q_heads: int, kv_heads: int, d_model: int):
    """``(C, H)`` from the shapes alone: ``H`` = ``q_per_kv`` query heads
    a cluster (MHA 1, Minitron-4B 3, Granite-8B 4: the kernel's
    instances), ``C`` CTAs a cluster for the ``kv_heads`` clusters
    (:func:`cluster_size`); ``(0, 0)`` where no plan fits (another
    ``q_per_kv``: ROADMAP.md)."""
    if kv_heads < 1 or q_heads % kv_heads or q_heads // kv_heads not in _HEADS:
        return (0, 0)
    c = cluster_size(kv_heads, d_model)
    return (c, q_heads // kv_heads) if c else (0, 0)


def _check_mode(fuse_out, bqkv, window, ring, attn_softcap, norm_scale):
    if (fuse_out != "partial_o" or bqkv is not None or window or ring
            or attn_softcap or norm_scale is None):
        raise NotImplementedError(
            "the port's fused_decode runs fuse_out='partial_o' with a fused "
            "ln1 and no bias, window, ring or softcap; the other modes are "
            "the Gemma-2 slice (ROADMAP.md)")


def fused_decode_attention(
    x: torch.Tensor,              # [B, D] raw residual stream (model dtype)
    wqkv: torch.Tensor,           # [D, (q + 2 kv)·hd]
    wo: torch.Tensor,             # [q, hd, D] per-head full-width rows
    norm_scale: Optional[torch.Tensor],   # [D] f32 ln1 scale
    k_cache: torch.Tensor,        # [S, B·kv, hd]
    v_cache: torch.Tensor,        # [S, B·kv, hd]
    pos: torch.Tensor,            # [S, B] int32 slot positions (−1 empty)
    cache_lens: torch.Tensor,     # [B] int32 (−1 = free slot)
    include_new: torch.Tensor,    # [B] int32: count the new token
    cos: torch.Tensor,            # [B, hd/2] f32 RoPE at cache_lens
    sin: torch.Tensor,
    *,
    q_heads: int,
    kv_heads: int,
    scale: Optional[float] = None,
    norm_eps: float = 1e-6,
    fuse_out="partial_o",
    bqkv: Optional[torch.Tensor] = None,
    window: int = 0,
    ring: bool = False,
    attn_softcap: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(o [B, q, D] f32, k_new [B, kv, hd], v_new [B, kv, hd],
    m [B, q] f32, l [B, q] f32)``: unnormalized per-head projected
    partials, the new token's rounded k/v, and the softmax stats.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    _check_mode(fuse_out, bqkv, window, ring, attn_softcap, norm_scale)
    tracecount.call("fused_decode")
    hd = k_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    args = (x, wqkv, wo, norm_scale, k_cache, v_cache, pos, cache_lens,
            include_new, cos, sin)
    kw = dict(q_heads=q_heads, kv_heads=kv_heads, scale=scale,
              norm_eps=norm_eps)
    if x.is_cuda:
        return fused_decode_cuda(*args, **kw)
    if x.device.type == "cpu":
        return fused_decode_plain(*args, **kw)
    raise ValueError(f"fused_decode_attention: unsupported device {x.device}")


def fused_decode_plain(x, wqkv, wo, norm_scale, k_cache, v_cache, pos,
                       cache_lens, include_new, cos, sin, *, q_heads,
                       kv_heads, scale, norm_eps):
    """Plain PyTorch version (the reference's ``ref.py`` batched over
    slots): full f32 softmax over every cached position with
    ``pos ≥ 0 and pos < cache_len``, plus the new token."""
    B, D = x.shape
    S, _, hd = k_cache.shape
    q_loc, kv_loc = q_heads, kv_heads
    qpk = q_loc // kv_loc
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + norm_eps) * (1.0 + norm_scale.float())
    xf = xf.to(x.dtype).float()
    qkv = xf @ wqkv.float()
    q = qkv[:, :q_loc * hd].reshape(B, q_loc, hd)
    k_new = qkv[:, q_loc * hd:(q_loc + kv_loc) * hd].reshape(B, kv_loc, hd)
    v_new = qkv[:, (q_loc + kv_loc) * hd:].reshape(B, kv_loc, hd)
    half = hd // 2
    c, s_ = cos.float()[:, None, :], sin.float()[:, None, :]

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * c - t2 * s_, t2 * c + t1 * s_], dim=-1)

    q, k_new = rope(q), rope(k_new)
    kc = k_cache.reshape(S, B, kv_loc, hd).float()
    vc = v_cache.reshape(S, B, kv_loc, hd).float()
    qg = q.reshape(B, kv_loc, qpk, hd)
    s_cache = torch.einsum("bkqh,sbkh->bkqs", qg, kc) * scale
    s_self = torch.einsum("bkqh,bkh->bkq", qg, k_new) * scale
    # −1e30 (not −inf) keeps m finite for a free slot, as the reference
    s_self = torch.where(include_new[:, None, None] > 0, s_self, -1e30)
    valid = (pos >= 0) & (pos < cache_lens[None, :])           # [S, B]
    s_cache = torch.where(valid.T[:, None, None, :], s_cache, -torch.inf)
    s_all = torch.cat([s_cache, s_self[..., None]], dim=-1)
    m = s_all.amax(dim=-1)
    p = torch.exp(s_all - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkqs,sbkh->bkqh", p[..., :-1], vc) \
        + p[..., -1][..., None] * v_new[:, :, None, :]
    o = torch.einsum("bqh,qhd->bqd", acc.reshape(B, q_loc, hd), wo.float())
    return (o, k_new.to(k_cache.dtype), v_new.to(v_cache.dtype),
            m.reshape(B, q_loc), l.reshape(B, q_loc))


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def fused_decode_cuda(x, wqkv, wo, norm_scale, k_cache, v_cache, pos,
                      cache_lens, include_new, cos, sin, *, q_heads,
                      kv_heads, scale, norm_eps):
    """Launch ``csrc/fused_decode.cu`` on the current stream (one launch
    for the whole batch, ``kv_heads`` clusters of ``C`` CTAs)."""
    B, D = x.shape
    S, rows, hd = k_cache.shape
    C, H = cluster_plan(q_heads, kv_heads, D)
    if (hd not in _HEAD_DIMS or B > _MAX_B or rows != B * kv_heads
            or not C or wqkv.shape != (D, (q_heads + 2 * kv_heads) * hd)
            or wo.shape != (q_heads, hd, D) or pos.shape != (S, B)):
        raise NotImplementedError(
            f"fused_decode CUDA kernel: head_dim in {_HEAD_DIMS}, "
            f"q_per_kv in {_HEADS}, B ≤ {_MAX_B}, d_model split "
            f"into 64–{_MAX_ROWS} rows a rank (a multiple of 64); got x "
            f"{tuple(x.shape)}, cache {tuple(k_cache.shape)}, wqkv "
            f"{tuple(wqkv.shape)}, heads {q_heads}/{kv_heads}, plan "
            f"{(C, H)} (other head dims and q_per_kv: ROADMAP.md)")
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tensors = dict(x=x, wqkv=wqkv, wo=wo, ln1=norm_scale, k_cache=k_cache,
                   v_cache=v_cache, pos=pos, cache_lens=cache_lens,
                   include_new=include_new, cos=cos, sin=sin)
    _build.require("fused_decode", tensors, dict(
        x=bf, wqkv=bf, wo=bf, ln1=f32, k_cache=bf, v_cache=bf, pos=i32,
        cache_lens=i32, include_new=i32, cos=f32, sin=f32))
    fn = _build.function("fused_decode", "fused_decode_launch", _ARGTYPES)
    o = torch.empty((B, q_heads, D), dtype=f32, device=x.device)
    k_new = torch.empty((B, kv_heads, hd), dtype=bf, device=x.device)
    v_new = torch.empty_like(k_new)
    m = torch.empty((B, q_heads), dtype=f32, device=x.device)
    l = torch.empty_like(m)
    err = fn(*(t.data_ptr() for t in tensors.values()),
             o.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, D, S, q_heads, kv_heads, hd, C,
             H, scale, norm_eps, _build.stream_ptr(x))
    _build.check(err, "fused_decode")
    tracecount.launch("fused_decode")
    return o, k_new, v_new, m, l


def rope_at(position: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin at per-slot decode positions ``[B]`` → ``[B, hd/2]`` each
    (``repro/kernels/fused_decode/ops.py:34``)."""
    ang = position.float()[..., None] * rope_freqs(head_dim, theta,
                                                   position.device)
    return torch.cos(ang), torch.sin(ang)
