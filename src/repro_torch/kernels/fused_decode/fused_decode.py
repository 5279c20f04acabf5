"""B1 — fused RMSNorm + QKV-Projection + RoPE + ragged decode attention +
per-head Output-Projection (``fuse_out="partial_o"``).

Replaces ``repro/kernels/fused_decode/fused_decode.py:fused_decode_attention``
(``pallas_call`` at line 374), in the mode the serving path runs: fused
``ln1``, an optional q/k/v bias ``bqkv`` (Qwen2-72B's, added in f32 after
the projection and before RoPE, ``fused_decode.py:103``),
``fuse_out="partial_o"``, MHA, GQA or MQA up to 4 query heads a kv head
and GQA 8 (Qwen2-72B's 64/8) at ``head_dim`` 128, MQA 16/1 at
``head_dim`` 256 (RecurrentGemma-9B's local layers, and the 8/1 and 4/1
a rank of them holds on a mesh at ``heads_sub`` 2 and 4) and MHA at
``head_dim`` 64 (SeamlessM4T-medium's decoder), on a linear cache or —
the local layers of Gemma-2 and RecurrentGemma — a sliding window over
a ring cache, with or without the attention softcap; on one device or
on one rank's shard of a cluster across devices (``pos_base``, below).
The other modes (other ``head_dim``/``q_per_kv`` pairs, ``fuse_out``
``True``/``False``, more than 8 slots) raise ``NotImplementedError``
(ROADMAP.md, Queue B: B1).

CUDA kernel: ``csrc/fused_decode.cu``.  What bounds it on an H100: bytes.
At Llama2-7B widths one layer streams ``wqkv`` (100.7 MB) and ``wo``
(33.6 MB) plus each slot's live KV, against ~2·B·(D·P + q·hd·D) FLOPs —
a few FLOPs per byte, far under the ~295 FLOP/byte ridge.  The design
reads every weight byte ONCE per launch for the whole batch (the JAX
path vmaps the Pallas kernel per slot, so on the TPU each slot re-reads
``wqkv``/``wo``), and is the paper's: one thread-block cluster of ``C``
CTAs per group of ``H`` query heads of one kv head (:func:`cluster_plan`).
At ``head_dim`` 128 ``H`` = ``q_per_kv``, one cluster a kv head: ``C`` 4
and ``H`` 1 at Llama2-7B, 128 CTAs; ``C`` 8 and ``H`` 4 and 3 at
Granite-8B and Minitron-4B, 64 CTAs: clusters of 16 or a kv head split
over two clusters took a second wave and were slower, PERF.md §6; ``C``
4 and ``H`` 2 at Gemma-2 27B's 16 kv heads, 64 CTAs of 1152 rows: its 16
clusters of 8 would be one more than the 15 an H100 runs at once, and
were slower, PERF.md §6; ``H`` 2 of a kv head's 8 query heads at
Qwen2-72B's GQA 8 (64/8 at ``D`` 8192: 32 clusters of 8 CTAs of 1024 rows,
more than one wave; a rank of a 4- or 8-GPU mesh, 16/2 or 8/1: 8 or 4
clusters): one cluster of all 8 heads would need about 273 KB of shared
memory (its 1280-column ``wqkv`` ring and the per-head partials), and
two clusters of 4 at 1024 rows a rank need a two-stage ``wo`` ring,
which ran 1.5 % faster on one card but 26–29 % slower at a rank's 16/2
and 8/1 (PERF.md §6), so each of the kv head's four clusters projects k
and v again and reads its rows again.  At
``head_dim`` 256 and MQA 16/1
(RecurrentGemma-9B) one cluster for all 16 query heads would need about
740 KB of shared memory for its ``wqkv`` ring and stream the layer on 8
SMs, so the kv head's heads split into 8 clusters of 8 CTAs holding 2
heads each (64 CTAs, 512 rows a rank): each cluster projects the kv
head's k and v again and attends the same rows, reads that mostly hit
L2 (the plans measured: PERF.md §6); a mesh rank's 8/1 and 4/1 take the
same instance, 4 and 2 clusters of 8 CTAs (32 and 16 CTAs: a simple
correct plan, not tuned).  At ``head_dim`` 64 and MHA
(SeamlessM4T-medium, 16/16 at ``D`` 1024) one cluster a head: 16 clusters
of 4 CTAs, 64 CTAs of 256 rows.
Each rank projects its ``D/C`` rows of the cluster's ``wqkv`` columns
(its query heads, then the kv head's k and v), the partials are summed over
distributed shared memory in rank order, each rank attends its share of
every slot's live rows for the cluster's query heads (each K/V row read
once for all of them), the ``(m, l, acc)`` partials merge on chip in
rank order, and each rank projects every head through its ``D/C``
columns of that head's ``wo``.
Attention covers only each slot's rows that may be live: the first
``clamp(cache_len − max(pos_base, 0), 0, S)`` (``cache_len`` ragged,
``−1`` = free slot: no KV read at all; ``pos_base`` the first position
of this rank's shard of a cluster across devices — ``r·S`` on rank
``r`` of a linear cache, the reference's ``_append_slot``; 0 on one
device; −1 on a ring shard, where offsets are not positions and every
row up to ``cache_len`` may hold one), each masked by its stored ``pos``
— RoPE stays at the global ``cache_len`` — ``0 ≤ pos <
cache_len`` and, with a window, ``pos > cache_len − window``, which on
a wrapped ring masks the row the coming append overwrites (it still
holds ``cache_len − S``).  No row is culled by its offset (on a ring
offsets are not positions).  The softcap ``tanh(s/cap)·cap`` applies
to the f32 scores, the new token's included, before the online
softmax (``fused_decode.py:163``, ``:188``).

Numerics follow the Pallas kernel: x rounds to the model dtype after
the norm (``fused_decode.py:100``); q/k/v stay f32; the new token
attends with the f32 rotated k and v while ``k_new``/``v_new`` leave
rounded (``:117-121``); ``m`` starts at −1e30 (``:122``), so a free slot
ends with ``l = 1`` and ``o = v_new·wo`` rather than NaN.  So does a
live slot on a rank of a cluster that holds none of its rows and does
not own its new token (``include_new = 0``), as the reference's kernel
does (``m`` −1e30 from ``:122``, the gated new token at ``exp(0) = 1``,
``:213–219``): the combine over the ranks weighs that partial
``exp(−1e30 − m) = 0``.
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
_MAX_CLUSTER = 8     # the portable thread-block cluster size
_TARGET_CTAS = 128   # about one CTA per SM of an H100 (132)
_WAVE_CLUSTERS = _build.WAVE_CTAS // _MAX_CLUSTER   # clusters of 8 at once
# the kernel's instances: head dim → {q_per_kv: query heads a cluster}
# (hd 128: a kv head's 1-4 query heads in one cluster; hd 256: MQA 16/1,
# RecurrentGemma-9B's, and a mesh rank's 8/1 and 4/1 of it, in clusters
# of two query heads; hd 64: MHA, SeamlessM4T-medium's, a cluster a head)
_HEADS = {64: {1: 1}, 128: {1: 1, 2: 2, 3: 3, 4: 4, 8: 2},
          256: {16: 2, 8: 2, 4: 2}}
# wqkv rows a rank may hold, by (head dim, query heads a cluster): csrc
# MAX_NTO · 64 — 1152 for two heads (Gemma-2 27B's 4608 over 4 ranks),
# else 1024 — and at hd 256 1024, what the shared memory leaves room for
_MAX_ROWS = {(64, 1): 1024, (128, 1): 1024, (128, 2): 1152,
             (128, 3): 1024, (128, 4): 1024, (256, 2): 1024}


def _rows_ok(rows: int, heads: int, head_dim: int = 128) -> bool:
    """Rows of ``wqkv`` a rank may hold (csrc ``rows_ok`` and the shared
    memory's room): a multiple of 64 (eight warps' 8-column tiles of
    ``wo``) up to ``_MAX_ROWS``."""
    return (64 <= rows <= _MAX_ROWS.get((head_dim, heads), 0)
            and rows % 64 == 0)


def cluster_size(clusters: int, d_model: int, heads: int = 1,
                 head_dim: int = 128) -> int:
    """CTAs in each of ``clusters`` clusters of ``heads`` query heads: the
    power of two ≤ 8 that brings the grid to about ``_TARGET_CTAS``
    (Llama2-7B's 32 heads: 4; 8 clusters: 8) — clusters of 8 only where
    all of them run at once (15 of 8 on an H100: Gemma-2 27B's 16 take
    4) —, halved until each rank's ``d_model / C`` rows are ones the
    kernel takes, else doubled from there up to 8 (Qwen2-72B's 8192 rows
    need 8 ranks, past one wave); 0 if none is."""
    c = 1
    while (c < _MAX_CLUSTER and clusters * c < _TARGET_CTAS
           and (2 * c < _MAX_CLUSTER or clusters <= _WAVE_CLUSTERS)):
        c *= 2
    down = [c >> i for i in range(c.bit_length())]           # c … 1
    up = [2 * c << i for i in range((_MAX_CLUSTER // c).bit_length() - 1)]
    for size in down + up:
        if d_model % size == 0 and _rows_ok(d_model // size, heads,
                                            head_dim):
            return size
    return 0


def cluster_plan(q_heads: int, kv_heads: int, d_model: int,
                 head_dim: int = 128):
    """``(C, H)`` from the shapes alone: ``H`` query heads a cluster — at
    ``head_dim`` 128 a kv head's ``q_per_kv`` (MHA 1, Gemma-2 27B 2,
    Minitron-4B 3, Granite-8B 4), at 256 two of MQA 16/1's sixteen
    (RecurrentGemma-9B: 8 clusters), at 64 MHA's one (SeamlessM4T-medium:
    16 clusters of 4) —, ``C`` CTAs a cluster
    (:func:`cluster_size` of the ``q_heads / H`` clusters); ``(0, 0)``
    where no plan fits (another ``q_per_kv`` or head dim: ROADMAP.md)."""
    if kv_heads < 1 or q_heads % kv_heads:
        return (0, 0)
    h = _HEADS.get(head_dim, {}).get(q_heads // kv_heads)
    if h is None:
        return (0, 0)
    c = cluster_size(q_heads // h, d_model, h, head_dim)
    return (c, h) if c else (0, 0)


def _check_mode(fuse_out, norm_scale, pos_base):
    if fuse_out != "partial_o" or norm_scale is None:
        raise NotImplementedError(
            "the port's fused_decode runs fuse_out='partial_o' with a fused "
            "ln1; fuse_out True/False and an unfused norm are ROADMAP "
            "Queue B: B1 item 3")
    if int(pos_base) < -1:
        raise ValueError(f"fused_decode: pos_base ≥ −1, got {pos_base}")


def span(cache_lens: torch.Tensor, S: int, pos_base: int) -> torch.Tensor:
    """Each slot's rows of this rank's shard that may be live:
    ``clamp(cache_len − max(pos_base, 0), 0, S)`` (B1's and B4's rule,
    the reference's rank-local live span, ``fused_decode.py:147``)."""
    return torch.clamp(cache_lens - max(int(pos_base), 0), 0, S)


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
    bqkv: Optional[torch.Tensor] = None,   # [(q + 2 kv)·hd] model dtype
    window: int = 0,
    attn_softcap: float = 0.0,
    pos_base: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(o [B, q, D] f32, k_new [B, kv, hd], v_new [B, kv, hd],
    m [B, q] f32, l [B, q] f32)``: unnormalized per-head projected
    partials, the new token's rounded k/v, and the softmax stats.  The
    reference's ``ring`` flag has no counterpart: it stops the Pallas
    kernel culling blocks by their offset, and the port culls no row by
    its offset (the mask by stored ``pos`` is exact on a ring or not).

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    _check_mode(fuse_out, norm_scale, pos_base)
    tracecount.call("fused_decode")
    hd = k_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    args = (x, wqkv, wo, norm_scale, k_cache, v_cache, pos, cache_lens,
            include_new, cos, sin)
    kw = dict(q_heads=q_heads, kv_heads=kv_heads, scale=scale,
              norm_eps=norm_eps, bqkv=bqkv, window=window,
              attn_softcap=attn_softcap, pos_base=int(pos_base))
    if x.is_cuda:
        return fused_decode_cuda(*args, **kw)
    if x.device.type == "cpu":
        return fused_decode_plain(*args, **kw)
    raise ValueError(f"fused_decode_attention: unsupported device {x.device}")


def fused_decode_plain(x, wqkv, wo, norm_scale, k_cache, v_cache, pos,
                       cache_lens, include_new, cos, sin, *, q_heads,
                       kv_heads, scale, norm_eps, bqkv=None, window=0,
                       attn_softcap=0.0, pos_base=0):
    """Plain PyTorch version (the reference's ``ref.py`` batched over
    slots): the bias added to the f32 projection, full f32 softmax over
    every cached position of the slot's :func:`span` with ``pos ≥ 0 and
    pos < cache_len`` (and ``pos > cache_len − window``), plus the new
    token, the scores softcapped first."""
    B, D = x.shape
    S, _, hd = k_cache.shape
    q_loc, kv_loc = q_heads, kv_heads
    qpk = q_loc // kv_loc
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + norm_eps) * (1.0 + norm_scale.float())
    xf = xf.to(x.dtype).float()
    qkv = xf @ wqkv.float()
    if bqkv is not None:
        qkv = qkv + bqkv.float()
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
    if attn_softcap > 0:
        s_cache = torch.tanh(s_cache / attn_softcap) * attn_softcap
        s_self = torch.tanh(s_self / attn_softcap) * attn_softcap
    # −1e30 (not −inf) keeps m finite for a free slot, as the reference
    s_self = torch.where(include_new[:, None, None] > 0, s_self, -1e30)
    valid = (pos >= 0) & (pos < cache_lens[None, :])           # [S, B]
    if window > 0:
        valid &= pos > cache_lens[None, :] - window
    if pos_base:
        valid &= torch.arange(S, device=x.device)[:, None] < span(
            cache_lens, S, pos_base)[None, :]
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


_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 \
    + [ctypes.c_float] * 3 + [ctypes.c_void_p]


def fused_decode_cuda(x, wqkv, wo, norm_scale, k_cache, v_cache, pos,
                      cache_lens, include_new, cos, sin, *, q_heads,
                      kv_heads, scale, norm_eps, bqkv=None, window=0,
                      attn_softcap=0.0, pos_base=0):
    """Launch ``csrc/fused_decode.cu`` on the current stream (one launch
    for the whole batch, ``q_heads / H`` clusters of ``C`` CTAs)."""
    B, D = x.shape
    S, rows, hd = k_cache.shape
    C, H = cluster_plan(q_heads, kv_heads, D, hd)
    if (B > _MAX_B or rows != B * kv_heads
            or not C or wqkv.shape != (D, (q_heads + 2 * kv_heads) * hd)
            or wo.shape != (q_heads, hd, D) or pos.shape != (S, B)
            or (bqkv is not None and bqkv.shape != (wqkv.shape[1],))):
        raise NotImplementedError(
            f"fused_decode CUDA kernel: (head_dim, q_per_kv) in "
            f"{[(d, q) for d, qs in _HEADS.items() for q in qs]}, "
            f"B ≤ {_MAX_B}, d_model split into multiples of 64 rows a "
            f"rank, at most {_MAX_ROWS} by (head_dim, heads a cluster); "
            f"got x {tuple(x.shape)}, cache {tuple(k_cache.shape)}, wqkv "
            f"{tuple(wqkv.shape)}, heads {q_heads}/{kv_heads}, plan "
            f"{(C, H)} (other head dims and q_per_kv: ROADMAP.md)")
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tensors = dict(x=x, wqkv=wqkv, wo=wo, ln1=norm_scale, k_cache=k_cache,
                   v_cache=v_cache, pos=pos, cache_lens=cache_lens,
                   include_new=include_new, cos=cos, sin=sin)
    if bqkv is not None:
        tensors["bqkv"] = bqkv
    _build.require("fused_decode", tensors, dict(
        x=bf, wqkv=bf, wo=bf, ln1=f32, k_cache=bf, v_cache=bf, pos=i32,
        cache_lens=i32, include_new=i32, cos=f32, sin=f32, bqkv=bf))
    fn = _build.function("fused_decode", "fused_decode_launch", _ARGTYPES)
    o = torch.empty((B, q_heads, D), dtype=f32, device=x.device)
    k_new = torch.empty((B, kv_heads, hd), dtype=bf, device=x.device)
    v_new = torch.empty_like(k_new)
    m = torch.empty((B, q_heads), dtype=f32, device=x.device)
    l = torch.empty_like(m)
    ptrs = [t.data_ptr() for t in tensors.values()]
    if bqkv is None:
        ptrs.append(None)
    err = fn(*ptrs,
             o.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, D, S, q_heads, kv_heads, hd, C,
             H, int(window), int(pos_base), scale, norm_eps,
             float(attn_softcap),
             _build.stream_ptr(x))
    _build.check(err, "fused_decode")
    tracecount.launch("fused_decode")
    return o, k_new, v_new, m, l


def rope_at(position: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin at per-slot decode positions ``[B]`` → ``[B, hd/2]`` each
    (``repro/kernels/fused_decode/ops.py:34``)."""
    ang = position.float()[..., None] * rope_freqs(head_dim, theta,
                                                   position.device)
    return torch.cos(ang), torch.sin(ang)
