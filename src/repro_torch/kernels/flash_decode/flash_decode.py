"""B5 — flash decode: GQA attention of q against a KV cache clamped by a
length, with the optional attention softcap and sliding window; q in,
the normalized output out (the paper's unfused baseline: projections,
RoPE and the output projection run as separate products around it).

Replaces ``repro/kernels/flash_decode/flash_decode.py:flash_decode_attention``
(``pallas_call`` at line 100; oracle ``ref.py``).  Two forms:

* the Pallas signature: ``q [B, q_loc, hd]``, one cache
  ``k_cache``/``v_cache [S, kv_loc, hd]`` and a scalar ``cache_len``
  shared by all B rows;
* the per-slot form the engine runs, ``jax.vmap`` of the Pallas kernel
  over slots (``tests/test_ragged_decode.py:94``): the cache is
  ``[S, B, kv_loc, hd]`` and ``cache_len`` an int32 ``[B]`` tensor; slot
  b attends only to its own cache column and length, with no host sync.

Position ``s`` is valid iff ``s < cache_len`` and, with ``window > 0``,
``s > cache_len − window`` (by index).  GQA groups are ``q_loc //
kv_loc``.  Scores, the softmax statistics and the accumulator are f32
and ``p`` stays f32 for ``p·v`` (``flash_decode.py:44–64``); the output
leaves in ``q.dtype``.  ``l`` is clamped to 1e-30 (``:68``), so a
length-0 slot returns zeros, where ``ref.py``'s softmax gives NaN.
``block_s`` has no counterpart: the CUDA kernel masks its ragged last
chunk.

The rank-local mode (``pos`` given; a cluster across devices, where each
rank holds a shard of every slot's KV sequence) takes the per-slot form
with the stored positions ``pos [S, B]``: row ``s`` is valid iff ``0 ≤
pos ≤ cache_len`` and, with a window, ``pos > cache_len − window`` — the
reference's mask of the unfused path (``core/dataflow.py:551–555``),
exact on a ring shard, whose offsets are not positions —, and only the
rank-local span ``[0, clamp(cache_len + 1 − max(pos_base, 0), 0, S))``
is read (``pos_base`` ``r·S`` on rank ``r`` of a linear cache, −1 on a
ring).  It returns the rank's partial ``(o, m, l)``: the UNNORMALIZED
f32 accumulator and the f32 softmax stats, the contract of the
reference's ``bucketed_flash_attention`` (``dataflow.py:264``), which
``cluster_flash_combine`` merges over the ranks; a rank with no valid
row of a slot holds ``(−1e30, 0, 0)``.  Only a cluster above 1 uses it;
on the card it has kernel instances of its own (bf16, the caches' dtype,
at head dim 128: every attention decoder the port shards; and at head
dim 256 with 16, 8 or 4 query rows a slot: RecurrentGemma-9B's local
layers on a ring shard, a rank's heads at the picks that take a
cluster across devices) and the one-device instances are unchanged.

CUDA kernel: ``csrc/flash_decode.cu``.  What bounds it on an H100: the
bytes of the valid K/V rows, each read once for all query heads of its
group.  One thread-block cluster of ``C`` CTAs per kv head and block of
``GB`` groups (:func:`cluster_plan`, from the shapes alone) cuts each
group's live span into ``C`` equal runs, rank r taking run r (a group's
bits depend on its own span alone), streamed in tiles through a ``cp.async`` ring (bf16 with 16 or more
query rows a kv head on the tensor cores; up to 4 rows warp-split on
the CUDA cores; otherwise block-wide on the CUDA cores), and merges the
ranks' (m, l, acc) over distributed shared memory in rank order: one
device launch, no workspace.  It takes ``hd`` in
{64, 128, 256}, bf16 or f32 (q, k and v of one dtype) and at most 32
query rows per (cache, kv head); anything else raises
``NotImplementedError`` and never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build

_HEAD_DIMS = (64, 128, 256)   # the kernel's template instances
_MAX_ROWS = 32                # query rows per (cache, kv head)
# the rank-local mode's instances beside head dim 128's: (head dim,
# query rows a slot) of RecurrentGemma-9B's ring shards (csrc
# launch_pos256)
_RANK_LOCAL = ((256, 16), (256, 8), (256, 4))
_MAX_CLUSTER = 8              # the portable thread-block cluster size
_TILE_ROWS = 64               # cache rows a tile (csrc TR)
_TARGET_CLUSTERS = 64
_TARGET_CTAS = 256            # two CTAs an SM of an H100 (132)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len, *,
                           scale: Optional[float] = None,
                           attn_softcap: float = 0.0,
                           window: int = 0,
                           pos: Optional[torch.Tensor] = None,
                           pos_base: int = 0):
    """``q [B, q_loc, hd]`` against ``k_cache``/``v_cache [S, kv_loc, hd]``
    with a scalar ``cache_len``, or ``[S, B, kv_loc, hd]`` with an int32
    ``cache_len [B]`` → ``o [B, q_loc, hd]`` in ``q.dtype``; with ``pos
    [S, B]`` (the rank-local mode, per-slot form only) → ``(o [B, q_loc,
    hd], m [B, q_loc], l [B, q_loc])`` f32, ``o`` unnormalized.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    tracecount.call("flash_decode")
    kw = dict(scale=scale, attn_softcap=attn_softcap, window=window)
    if pos is not None:
        if k_cache.dim() != 4 or pos.shape != (k_cache.shape[0],
                                               k_cache.shape[1]):
            raise ValueError("flash_decode's rank-local mode takes the "
                             "per-slot cache [S, B, kv, hd] and pos [S, B]")
        if pos_base < -1:
            raise ValueError(f"pos_base ≥ −1, got {pos_base}")
        kw.update(pos=pos, pos_base=pos_base)
    if q.is_cuda:
        return flash_decode_cuda(q, k_cache, v_cache, cache_len, **kw)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len, **kw)
    raise ValueError(f"flash_decode_attention: unsupported device {q.device}")


def _lengths(cache_len, device) -> torch.Tensor:
    """``cache_len`` (int, 0-d or ``[B]``) as a 1-D int32 tensor."""
    return torch.as_tensor(cache_len, device=device).to(
        torch.int32).reshape(-1)


def _span(lens: torch.Tensor, S: int, pos_base: int) -> torch.Tensor:
    """The rank-local mode's rows a slot reads: ``clamp(cache_len + 1 −
    max(pos_base, 0), 0, S)`` (its newest row is ``cache_len``)."""
    return torch.clamp(lens + 1 - max(pos_base, 0), 0, S).to(torch.int32)


def flash_decode_plain(q, k_cache, v_cache, cache_len, *, scale=None,
                       attn_softcap=0.0, window=0, pos=None, pos_base=0):
    """Plain PyTorch version: one masked f32 softmax over every position,
    with the Pallas kernel's −1e30 mask and ``l`` clamp (zeros for an
    empty span); with ``pos``, the rank-local mode's masked pass and its
    unnormalized partial."""
    if pos is not None:
        return _rank_partial_plain(q, k_cache, v_cache, cache_len, pos,
                                   pos_base, scale, attn_softcap, window)
    B, q_loc, hd = q.shape
    S, kv_loc = k_cache.shape[0], k_cache.shape[-2]
    qpk = q_loc // kv_loc
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, kv_loc, qpk, hd)
    cache = "sbkh" if k_cache.dim() == 4 else "skh"
    s = torch.einsum(f"bkqh,{cache}->bkqs", qg, k_cache.float()) * scale
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    lens = _lengths(cache_len, q.device)[:, None]          # [B or 1, 1]
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < lens
    if window > 0:
        valid &= pos > lens - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum(f"bkqs,{cache}->bkqh", p, v_cache.float())
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, q_loc, hd).to(q.dtype)


def _rank_partial_plain(q, k_cache, v_cache, cache_len, pos, pos_base,
                        scale, attn_softcap, window):
    """The rank-local mode in plain torch: the reference's masked pass
    (``dataflow.py:bucketed_flash_attention``) over the slot's span, ``p``
    in f32."""
    B, q_loc, hd = q.shape
    S, _, kv_loc, _ = k_cache.shape
    qpk = q_loc // kv_loc
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    lens = _lengths(cache_len, q.device)
    qg = q.float().reshape(B, kv_loc, qpk, hd)
    s = torch.einsum("bkqh,sbkh->bkqs", qg, k_cache.float()) * scale
    if attn_softcap > 0:
        s = torch.tanh(s / attn_softcap) * attn_softcap
    cl = lens[None, :]
    valid = (pos >= 0) & (pos <= cl)                          # [S, B]
    if window > 0:
        valid &= pos > cl - window
    valid &= torch.arange(S, device=q.device)[:, None] < _span(lens, S,
                                                               pos_base)
    valid = valid.T[:, None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bkqs,sbkh->bkqh", p, v_cache.float())
    return (o.reshape(B, q_loc, hd), m.reshape(B, q_loc),
            p.sum(dim=-1).reshape(B, q_loc))


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def cluster_plan(S: int, G: int, kv: int, rows: int):
    """``(GB, C)``: each cluster takes ``GB`` groups of one kv head (each
    live span split over the ranks) on ``C`` CTAs, from the shape only.
    ``GB`` is the largest power of two dividing ``G`` (with ``GB·rows``
    query rows within ``_MAX_ROWS``) that leaves ``_TARGET_CLUSTERS``
    clusters; ``C`` brings the grid to ``_TARGET_CTAS`` (two CTAs an SM),
    at most 8 and at most one a 64-row tile of the ``GB·S`` rows.
    Clusters of 4 pack the card's GPCs better than clusters of 8, hence
    the many clusters.  Llama2-7B's per-slot decode (S 1024, G 8, kv 32,
    1 row): (4, 4); RecurrentGemma's ring (S 2048, G 8, kv 1, 16 rows):
    (1, 8)."""
    gb = 1
    while (G % (2 * gb) == 0 and 2 * gb * rows <= _MAX_ROWS
           and (G // (2 * gb)) * kv >= _TARGET_CLUSTERS):
        gb *= 2
    clusters = (G // gb) * kv
    C = min(_MAX_CLUSTER, _pow2_at_least(-(-_TARGET_CTAS // clusters)),
            _pow2_at_least(-(-gb * S // _TILE_ROWS)))
    return gb, C


def flash_decode_cuda(q, k_cache, v_cache, cache_len, *, scale=None,
                      attn_softcap=0.0, window=0, pos=None, pos_base=0):
    """Launch ``csrc/flash_decode.cu`` on the current stream: one device
    launch of ``C``-CTA clusters, one per kv head and block of ``GB``
    groups (:func:`cluster_plan`)."""
    B, q_loc, hd = q.shape
    per_slot = k_cache.dim() == 4
    S, kv_loc = k_cache.shape[0], k_cache.shape[-2]
    lens = _lengths(cache_len, q.device)
    want_cache = (S, B, kv_loc, hd) if per_slot else (S, kv_loc, hd)
    G, NB = (B, 1) if per_slot else (1, B)
    qpk = q_loc // max(kv_loc, 1)
    if (hd not in _HEAD_DIMS or q.dtype not in (torch.bfloat16, torch.float32)
            or k_cache.shape != want_cache or v_cache.shape != want_cache
            or q_loc != qpk * kv_loc or NB * qpk > _MAX_ROWS
            or lens.shape != (G,) or window < 0 or attn_softcap < 0
            or kv_loc * G > 65535
            or (pos is not None and (q.dtype != torch.bfloat16
                                     or (hd, qpk) not in _RANK_LOCAL
                                     and hd != 128))):
        raise NotImplementedError(
            f"flash_decode CUDA kernel: head dim in {_HEAD_DIMS}, bf16 or "
            f"f32, q [B, q_loc, hd] with q_loc a multiple of kv_loc, cache "
            f"[S, kv_loc, hd] with a scalar length or [S, B, kv_loc, hd] "
            f"with lengths [B] (the rank-local mode: bf16 at head dim "
            f"128, or at 256 with {sorted(q for _, q in _RANK_LOCAL)} "
            f"query heads a kv head), at most "
            f"{_MAX_ROWS} query rows per cache and "
            f"kv head; got q {tuple(q.shape)} {q.dtype}, cache "
            f"{tuple(k_cache.shape)}, lengths {tuple(lens.shape)}")
    tensors = dict(q=q, k_cache=k_cache, v_cache=v_cache, cache_len=lens)
    _build.require("flash_decode", tensors, dict(
        q=q.dtype, k_cache=q.dtype, v_cache=q.dtype, cache_len=torch.int32))
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise NotImplementedError(
            "flash_decode CUDA kernel: q and the caches must start on a "
            "16-byte boundary")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    GB, C = cluster_plan(S, G, kv_loc, NB * qpk)
    fn = _build.function("flash_decode", "flash_decode_launch", _ARGTYPES)
    if pos is None:
        o = torch.empty_like(q)
        extra = [None] * 5
    else:
        _build.require("flash_decode", dict(pos=pos), dict(pos=torch.int32))
        clens, lens = lens, _span(lens, S, pos_base)
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        extra = [pos.data_ptr(), clens.data_ptr(), o.data_ptr(),
                 m.data_ptr(), l.data_ptr()]
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lens.data_ptr(), o.data_ptr(), G, GB, NB, S, kv_loc, qpk, hd,
             int(q.dtype == torch.float32), C, scale, attn_softcap, window,
             *extra, _build.stream_ptr(q))
    _build.check(err, "flash_decode")
    tracecount.launch("flash_decode")
    return o if pos is None else (o, m, l)
