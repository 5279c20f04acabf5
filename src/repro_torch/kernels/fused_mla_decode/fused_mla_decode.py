"""B4 — fused MLA decode with weight absorption (paper Alg. 4): RMSNorm +
Q-Projection + KV down-projection + K-up absorption + RoPE + ragged
flash decode in latent space + the folded value-up/Output-Projection
(``fuse_out="partial_o"``).

Replaces ``fused_mla_decode_attention`` of
``repro/kernels/fused_mla_decode/fused_mla_decode.py`` (``pallas_call`` at
line 261) in the mode the serving path runs
(``core/dataflow.py:_mla_attention_pallas_packed``): ``partial_o``
through the prepacked ``wproj = W_UV·W_O``, a fused ``ln1``, a linear
latent cache with per-slot ``pos``, ``include_new`` from the append rule
and ``pos_base`` the first position of this rank's shard (0 on one
device, ``r·S`` on rank ``r`` of a cluster across devices): each slot
reads the rows ``[0, clamp(cache_len − pos_base, 0, S))``, RoPE at the
global ``cache_len``; a live slot on a rank that holds none of its rows
and does not own its new token ends as a free slot does (``m`` −1e30,
``l = 1``), weighed 0 by the combine over the ranks.  The other modes
raise ``NotImplementedError`` (ROADMAP.md); they never fall back to the
plain version.

CUDA kernel: ``csrc/fused_mla_decode.cu``.  What bounds it on an H100:
bytes.  At DeepSeek-V2-Lite widths one layer reads ``wq`` (12.6 MB),
``wdkv`` (2.4 MB), ``wuk`` (2.1 MB) and ``wproj`` (33.6 MB, 61 % of the
layer) plus each slot's live latent rows (1152 bytes a position, shared
by all 16 heads), at a few FLOPs per byte.  Design, the paper's Alg. 4
on thread-block clusters of 8 CTAs, in two launches: the first computes
the new latent entry ``c_new`` (``x·wdkv``, RoPE, rounded) once for all
heads, 9 clusters of 64 columns; the second runs one cluster per head
(:func:`cluster_plan`).  Its ranks split ``d_model`` for ``x·wq``
(tensor cores) and sum their partials over distributed shared memory in
rank order, split the 512 latent columns for ``q_lat``, attend equal
runs of all slots' live latent rows, merge their ``(m, l, acc)`` over
distributed shared memory in rank order, and split the output columns
of ``acc·wproj[h]``.  No f32 workspace; every weight byte is read once
from HBM per call for all slots (the JAX path vmaps the kernel per
slot).  The kernel is built for MLA's geometry of DeepSeek-V2/V3:
``nope`` 128, ``rope`` 64 and a 512-wide latent.

Numerics follow the Pallas kernel: x rounds to the model dtype after the
norm (``fused_mla_decode.py:69``); q, ``q_lat`` and the rotated
``q_rope`` stay f32; the new entry ``c_new`` leaves in the cache dtype
and the new token is attended with that ROUNDED entry
(``fused_mla_decode.py:146``) — ``ref.py`` attends the f32 ``c_lat``
instead, and B1 attends its new token in f32 (ROADMAP C4); ``m`` starts
at −1e30 (``:100``), so a free slot ends with ``l = 1`` and
``acc = c_new[:l]`` rather than NaN.  ``o`` is the UNNORMALIZED
projected accumulator in f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build

_MAX_B = 8           # slots per launch (the kernel's template range)
_GEOMETRY = (128, 64, 512)   # (nope, rope, latent) the kernel is built for
_CLUSTER = 8         # CTAs a head: a rank's q_lat block is a warp's columns
_MAX_ROWS = 512      # d_model rows a rank may hold (csrc MAX_NTO · 64)


@functools.lru_cache(maxsize=None)
def cluster_plan(q_heads: int, d_model: int) -> Tuple[int, int]:
    """``(G, C)``: one cluster of ``C = 8`` CTAs per head (``G`` =
    ``q_heads``), each rank ``d_model / 8`` rows, a multiple of 64 up to
    512 (DeepSeek-V2-Lite: 16 clusters, 128 CTAs, 256 rows a rank);
    ``(0, 0)`` where ``d_model`` does not split so."""
    rows, rem = divmod(d_model, _CLUSTER)
    if q_heads < 1 or rem or rows % 64 or not 64 <= rows <= _MAX_ROWS:
        return 0, 0
    return q_heads, _CLUSTER


def _check_mode(fuse_out, norm_scale, pos_base):
    if fuse_out != "partial_o" or norm_scale is None:
        raise NotImplementedError(
            "the port's fused_mla_decode runs fuse_out='partial_o' with a "
            "fused ln1; fuse_out=True/False and an unfused norm are later "
            "work (ROADMAP.md, Queue B: B4)")
    if int(pos_base) < 0:
        raise ValueError(
            f"fused_mla_decode: pos_base ≥ 0 (a linear latent cache; the "
            f"reference's MLA cache has no ring), got {pos_base}")


def fused_mla_decode_attention(
    x: torch.Tensor,              # [B, D] raw residual stream (model dtype)
    wq: torch.Tensor,             # [D, q·(nope+rope)]
    wdkv: torch.Tensor,           # [D, l+rope]
    wuk: torch.Tensor,            # [q, nope, l]
    wproj: torch.Tensor,          # [q, l, D] prepacked W_UV·W_O per head
    norm_scale: Optional[torch.Tensor],   # [D] f32 ln1 scale
    c_cache: torch.Tensor,        # [S, B, l+rope] latent cache
    pos: torch.Tensor,            # [S, B] int32 slot positions (−1 empty)
    cache_lens: torch.Tensor,     # [B] int32 (−1 = free slot)
    include_new: torch.Tensor,    # [B] int32: count the new token
    cos: torch.Tensor,            # [B, rope/2] f32 RoPE at cache_lens
    sin: torch.Tensor,
    *,
    q_heads: int,
    nope: int,
    rope_d: int,
    l_rank: int,
    norm_eps: float = 1e-6,
    fuse_out="partial_o",
    pos_base: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Returns ``(o [B, q, D] f32, c_new [B, l+rope], m [B, q] f32,
    l [B, q] f32)``: unnormalized per-head projected partials, the new
    latent entry in the cache dtype, and the softmax stats.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    _check_mode(fuse_out, norm_scale, pos_base)
    tracecount.call("fused_mla_decode")
    args = (x, wq, wdkv, wuk, wproj, norm_scale, c_cache, pos, cache_lens,
            include_new, cos, sin)
    kw = dict(q_heads=q_heads, nope=nope, rope_d=rope_d, l_rank=l_rank,
              norm_eps=norm_eps, pos_base=int(pos_base))
    if x.is_cuda:
        return fused_mla_decode_cuda(*args, **kw)
    if x.device.type == "cpu":
        return fused_mla_decode_plain(*args, **kw)
    raise ValueError(
        f"fused_mla_decode_attention: unsupported device {x.device}")


def fused_mla_decode_plain(x, wq, wdkv, wuk, wproj, norm_scale, c_cache, pos,
                           cache_lens, include_new, cos, sin, *, q_heads,
                           nope, rope_d, l_rank, norm_eps, pos_base=0):
    """Plain PyTorch version: the reference's ``ref.py`` batched over
    slots (full f32 softmax over every cached position of the slot's
    span with ``pos ≥ 0 and pos < cache_len``, plus the new token),
    changed in one
    place to follow the Pallas kernel: the new token is attended with
    ``c_new`` ROUNDED to the cache dtype, where ``ref.py`` uses the f32
    ``c_lat``/``c_rope`` (ROADMAP C4)."""
    B, D = x.shape
    S, _, lr = c_cache.shape
    scale = 1.0 / math.sqrt(nope + rope_d)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + norm_eps) * (1.0 + norm_scale.float())
    xf = xf.to(x.dtype).float()
    q = (xf @ wq.float()).reshape(B, q_heads, nope + rope_d)
    c = xf @ wdkv.float()
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_lat, c_rope = c[..., :l_rank], c[..., l_rank:]
    q_lat = torch.einsum("bqn,qnl->bql", q_nope, wuk.float())
    half = rope_d // 2
    cc, ss = cos.float(), sin.float()

    def rope(t, cc, ss):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cc - t2 * ss, t2 * cc + t1 * ss], dim=-1)

    q_rope = rope(q_rope, cc[:, None, :], ss[:, None, :])
    c_rope = rope(c_rope, cc, ss)
    c_new = torch.cat([c_lat, c_rope], dim=-1).to(c_cache.dtype)
    qq = torch.cat([q_lat, q_rope], dim=-1)                 # [B, q, l+rope]
    cache = c_cache.float()                                 # [S, B, l+rope]
    s_cache = torch.einsum("bqk,sbk->bqs", qq, cache) * scale
    s_self = torch.einsum("bqk,bk->bq", qq, c_new.float()) * scale
    # −1e30 (not −inf) keeps m finite for a free slot, as the reference
    s_self = torch.where(include_new[:, None] > 0, s_self, -1e30)
    valid = (pos >= 0) & (pos < cache_lens[None, :])        # [S, B]
    if pos_base:
        valid &= torch.arange(S, device=x.device)[:, None] < torch.clamp(
            cache_lens - pos_base, 0, S)[None, :]
    s_cache = torch.where(valid.T[:, None, :], s_cache, -torch.inf)
    s_all = torch.cat([s_cache, s_self[..., None]], dim=-1)
    m = s_all.amax(dim=-1)
    p = torch.exp(s_all - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bqs,sbl->bql", p[..., :-1], cache[..., :l_rank]) \
        + p[..., -1][..., None] * c_new.float()[:, None, :l_rank]
    o = torch.einsum("bql,qld->bqd", acc, wproj.float())
    return o, c_new, m, l


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def fused_mla_decode_cuda(x, wq, wdkv, wuk, wproj, norm_scale, c_cache, pos,
                          cache_lens, include_new, cos, sin, *, q_heads,
                          nope, rope_d, l_rank, norm_eps, pos_base=0):
    """Launch ``csrc/fused_mla_decode.cu`` on the current stream: one C
    entry, two device launches (``c_new``, then one cluster per head as
    ``cluster_plan`` says) for the whole batch."""
    B, D = x.shape
    S, slots, lr = c_cache.shape
    nq = q_heads
    _, C = cluster_plan(nq, D)
    if (B > _MAX_B or slots != B or not C
            or (nope, rope_d, l_rank) != _GEOMETRY or lr != l_rank + rope_d
            or wq.shape != (D, nq * (nope + rope_d))
            or wdkv.shape != (D, lr) or wuk.shape != (nq, nope, l_rank)
            or wproj.shape != (nq, l_rank, D) or pos.shape != (S, B)
            or cos.shape != (B, rope_d // 2)):
        raise NotImplementedError(
            f"fused_mla_decode CUDA kernel: B ≤ {_MAX_B}, (nope, rope, "
            f"latent) = {_GEOMETRY}, d_model / {_CLUSTER} a multiple of 64 "
            f"up to {_MAX_ROWS}; got x {tuple(x.shape)}, cache "
            f"{tuple(c_cache.shape)}, wq {tuple(wq.shape)}, wuk "
            f"{tuple(wuk.shape)}")
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tensors = dict(x=x, wq=wq, wdkv=wdkv, wuk=wuk, wproj=wproj,
                   ln1=norm_scale, c_cache=c_cache, pos=pos,
                   cache_lens=cache_lens, include_new=include_new, cos=cos,
                   sin=sin)
    _build.require("fused_mla_decode", tensors, dict(
        x=bf, wq=bf, wdkv=bf, wuk=bf, wproj=bf, ln1=f32, c_cache=bf,
        pos=i32, cache_lens=i32, include_new=i32, cos=f32, sin=f32))
    fn = _build.function("fused_mla_decode", "fused_mla_decode_launch",
                         _ARGTYPES)
    o = torch.empty((B, nq, D), dtype=f32, device=x.device)
    c_new = torch.empty((B, lr), dtype=bf, device=x.device)
    m = torch.empty((B, nq), dtype=f32, device=x.device)
    l = torch.empty_like(m)
    err = fn(*(t.data_ptr() for t in tensors.values()), o.data_ptr(),
             c_new.data_ptr(), m.data_ptr(), l.data_ptr(), B, D, S, nq, nope,
             rope_d, l_rank, C, int(pos_base),
             1.0 / math.sqrt(nope + rope_d), norm_eps,
             _build.stream_ptr(x))
    _build.check(err, "fused_mla_decode")
    tracecount.launch("fused_mla_decode")
    return o, c_new, m, l
