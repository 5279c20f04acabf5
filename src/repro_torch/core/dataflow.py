"""Decode dataflow at cluster size 1 — the port of the parts of
``repro/core/dataflow.py`` the two serving backends run.

Inside a rank the cluster is 1, and the paper's ClusterGather and the
flash combine over it are the identity.  On the prepacked ``"pallas"``
path one layer is: the attention kernel for all slots (B1
``fused_decode``, with the fused ``bqkv`` where the model has q/k/v
biases, or B4 ``fused_mla_decode`` for MLA), the append of the new k/v
(or latent entry) into the cache, and the normalize + head sum of the
per-head partials — the last two plain torch, as they are XLA ops in
the reference.  On the unfused ``"xla"`` path (:func:`split_token_attention`,
the paper's baseline) the q/k/v products (and biases), RoPE, the append
(into a ring cache on sliding-window layers) and the output projection
are plain torch around B5 ``flash_decode``; its MLA layer
(:func:`mla_attention`) is plain torch and cuBLAS throughout, as the
reference's XLA branch runs around no Pallas kernel.

On a mesh (a :class:`ClusterSpec`, ``spec``) each rank runs its own
heads, and the layer's output meets the other ranks' in
``spec.heads_reduce``: the paper's tree ClusterReduce over the heads
sub-axis, in the model dtype, as the reference's
(``dataflow.py:49–95``, ``:569``, ``:764``, ``:954``, ``:1098``).

The port updates the KV cache in place (the reference rebuilt it).
The reference's ``_fit_block_s`` has no counterpart: it fits Pallas
block sizes to divisors of the cache and of ``d_ff``, while the CUDA
kernels mask their ragged last tile instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import primitives as prim
from repro_torch.core.primitives import Axis
from repro_torch.kernels.flash_decode.flash_decode import (
    flash_decode_attention)
from repro_torch.kernels.fused_decode.fused_decode import (
    fused_decode_attention, rope_at)
from repro_torch.kernels.fused_mla_decode.fused_mla_decode import (
    fused_mla_decode_attention)


@dataclass(frozen=True, eq=False)
class ClusterSpec:
    """How the model axis is factored for the dataflow
    (``dataflow.py:49``): the ``heads`` sub-axis.  The cluster is 1
    inside a rank here (a cluster across devices is ROADMAP A.5b), so
    only the heads reduce moves data."""

    heads: Axis

    def heads_reduce(self, x):
        """The output's sum over the heads ranks (the paper's atomicAdd):
        the tree over the heads sub-axis (``dataflow.py:88``)."""
        return prim.cluster_reduce(x, self.heads, "sum")


def _heads_reduce(spec: Optional[ClusterSpec], x: torch.Tensor
                  ) -> torch.Tensor:
    return x if spec is None else spec.heads_reduce(x)


class KVBlock(NamedTuple):
    """One layer's KV cache: ``k``/``v [S, B·kv, hd]`` and per-slot
    positions ``pos [S, B]`` (−1 ⇒ empty).  Stacked over layers, each
    leaf gains a leading layer axis.  For MLA ``k [S, B, l+rope]`` holds
    the latent entries and ``v [S, B, 1]`` only their first column (the
    reference's layout; no kernel reads it)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class SplitTokenWeights(NamedTuple):
    """Train-layout attention weights the unfused path reads
    (``dataflow.py:332`` at cluster size 1, where each rank's head-dim
    segment is the whole head): ``wq [D, q, hd]``, ``wk``/``wv [D, kv,
    hd]``, ``wo [q·hd, D]`` and the optional biases ``bq [q, hd]``,
    ``bk``/``bv [kv, hd]``."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


class MLAWeights(NamedTuple):
    """Train-layout MLA weights the unfused path reads (``dataflow.py:842``
    at cluster size 1, where every rank segment is the whole tensor):
    ``wq [D, q, nope+rope]``, ``wdkv [D, l+rope]``, ``wuk [q, nope, l]``,
    ``wuv [q, l, v]``, ``wo [q·v, D]``."""

    wq: torch.Tensor
    wdkv: torch.Tensor
    wuk: torch.Tensor
    wuv: torch.Tensor
    wo: torch.Tensor


class PackedSplitTokenWeights(NamedTuple):
    """Serve-layout attention weights: ``wqkv [D, (q + 2kv)·hd]``,
    per-head full-width ``wo [q, hd, D]``, optional fused bias ``bqkv``
    and the fused pre-attention norm scale ``ln1 [D]``."""

    wqkv: torch.Tensor
    wo: torch.Tensor
    bqkv: Optional[torch.Tensor] = None
    ln1: Optional[torch.Tensor] = None


class PackedMLAWeights(NamedTuple):
    """Serve-layout MLA weights: ``wq [D, q·(nope+rope)]`` (a view of the
    train ``wq``), ``wdkv [D, l+rope]`` and ``wuk [q, nope, l]`` (aliases),
    ``wproj [q, l, D]`` — the per-head ``W_UV·W_O`` fold, the one copy
    the pack makes — and the fused pre-attention norm scale
    ``ln1 [D]``."""

    wq: torch.Tensor
    wdkv: torch.Tensor
    wuk: torch.Tensor
    wproj: torch.Tensor
    ln1: Optional[torch.Tensor] = None


class PackedFFNWeights(NamedTuple):
    """Serve-layout dense-FFN bundle — aliases of the train tensors."""

    w_in: torch.Tensor
    w_out: torch.Tensor
    ln2: torch.Tensor
    w_gate: Optional[torch.Tensor] = None
    post_ln1: Optional[torch.Tensor] = None


class PackedHeadWeights(NamedTuple):
    """Serve-layout LM-head bundle: ``table [V, D]`` (aliases ``lm_head``)
    and ``ln [D]`` (aliases ``final_norm``)."""

    table: torch.Tensor
    ln: torch.Tensor


def _appends(S: int, cache_lens: torch.Tensor) -> torch.Tensor:
    """``repro/core/dataflow.py:_append_slot`` at cluster size 1 on a
    linear cache, where the one rank owns every position below ``S``:
    slot b appends (and attends to its new token) iff
    ``0 ≤ cache_lens[b] < S``.  A free slot (−1) and a full cache append
    nothing.  The owner rank, the shard-local slot and ``pos_base`` of a
    cluster across devices are ROADMAP A.5b."""
    return (cache_lens >= 0) & (cache_lens < S)


def append_rows(S: int, position: torch.Tensor, *, ring: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where this step's append lands: ``(own [B] bool, row [B] int64)``.
    Slot b writes row ``position[b]`` when :func:`_appends` holds for it
    — or, on a ring (a sliding-window layer, ``dataflow.py:_append_slot``
    with ``window > 0``), row ``position[b] mod S`` whenever
    ``position[b] ≥ 0``; a slot that does not own its row rewrites it
    with its own contents.  The incremental KV fingerprint
    (``serving/integrity.py:kv_rows_bitsum``) reads the same rows before
    and after the step."""
    if ring:
        return position >= 0, torch.remainder(position, S).long()
    return _appends(S, position), torch.clamp(position, 0, S - 1).long()


def _insert_kv_ragged(cache: KVBlock, k_new: torch.Tensor,
                      v_new: torch.Tensor, position: torch.Tensor, *,
                      ring: bool = False) -> None:
    """Per-slot predicated append, IN PLACE: slot b writes its
    ``k_new[b]``/``v_new[b]`` and ``pos = position[b]`` at the row
    :func:`append_rows` gives it.  No host sync: the other slots rewrite
    a row with its own contents."""
    S = cache.k.shape[0]
    B = position.shape[0]
    own, idx = append_rows(S, position, ring=ring)
    b = torch.arange(B, device=position.device)
    for full, new in ((cache.k, k_new), (cache.v, v_new)):
        f3 = full.view(S, B, -1)
        n2 = new.reshape(B, -1).to(full.dtype)
        f3[idx, b] = torch.where(own[:, None], n2, f3[idx, b])
    cache.pos[idx, b] = torch.where(own, position.to(torch.int32),
                                    cache.pos[idx, b])


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """``dataflow.py:180`` at per-slot positions: ``x [B, H, hd]`` rotated
    in f32 by ``cos``/``sin [B, hd/2]`` (:func:`rope_at`) and cast back."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def split_token_attention(x: torch.Tensor, w: SplitTokenWeights,
                          cache: KVBlock, cache_lens: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor, *,
                          window: int = 0, attn_softcap: float = 0.0,
                          scale: Optional[float] = None,
                          kernel=flash_decode_attention,
                          spec: Optional[ClusterSpec] = None) -> torch.Tensor:
    """One attention layer of the unfused dataflow (the XLA branch of
    ``split_token_attention``, ``dataflow.py:500–571``, at cluster 1):
    ``x [B, D]`` already normed → ``[B, D]`` in ``x.dtype``; the new k/v
    is appended to ``cache`` in place.

    Stages: ``x·wq``, ``x·wk``, ``x·wv`` as torch products (+ bias); RoPE
    at ``cache_lens`` (``cos``/``sin``, the absolute position); the
    append; B5 over each slot's own cache column with length
    ``min(cache_len + 1, S)``, 0 for a free slot, and no window of its
    own; ``att·wo``.  The flash combine and the heads reduce are the
    identity at cluster 1.

    That length is exactly the reference's mask by stored ``pos``
    (``0 ≤ pos ≤ cache_len``, and ``pos > cache_len − window`` on a
    sliding-window layer, ``:553–556``):

    * linear cache (``window = 0``): rows below a slot's length hold
      ``pos = row``, and a stale row past it holds ``row`` or −1;
    * ring cache (``window > 0``: ``S = min(window, max_seq)`` rows, the
      append at row ``cache_len mod S`` storing ``pos = cache_len``):
      prefill's ring fill rewrites all ``S`` rows of an admitted slot
      (row ``r`` holds the largest prompt position ``≡ r mod S``, or −1
      and zeros), and decode then appends in order, so the valid rows are
      exactly the first ``min(cache_len + 1, S)`` ring rows — the newest
      ``S`` positions ``cache_len − S + 1 … cache_len``, all inside the
      window once the ring has wrapped, and nothing stale.  B5's own
      window masks by row index, which is wrong on a wrapped ring, so it
      gets ``window = 0``.

    B5 keeps ``p`` in f32 for ``p·v``, where the reference's XLA branch
    rounds q and p to the cache dtype (``dataflow.py:552``, ``:320``):
    the two agree to bf16 tolerance (ROADMAP C5).  ``kernel`` is the B5
    entry point (its plain version to hold the kernel against it on the
    card)."""
    B, D = x.shape
    q_loc, hd = w.wq.shape[1], w.wq.shape[2]
    kv_loc = w.wk.shape[1]
    q = (x @ w.wq.reshape(D, q_loc * hd)).view(B, q_loc, hd)
    k = (x @ w.wk.reshape(D, kv_loc * hd)).view(B, kv_loc, hd)
    v = (x @ w.wv.reshape(D, kv_loc * hd)).view(B, kv_loc, hd)
    if w.bq is not None:
        q, k, v = q + w.bq, k + w.bk, v + w.bv
    q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    _insert_kv_ragged(cache, k, v, cache_lens, ring=window > 0)
    S = cache.k.shape[0]
    lens = torch.clamp(cache_lens + 1, 0, S).to(torch.int32)
    att = kernel(q, cache.k.view(S, B, kv_loc, hd),
                 cache.v.view(S, B, kv_loc, hd), lens, scale=scale,
                 attn_softcap=attn_softcap)
    return _heads_reduce(spec, att.reshape(B, q_loc * hd).to(x.dtype) @ w.wo)


def split_token_attention_packed(x: torch.Tensor,
                                 w: PackedSplitTokenWeights, cache: KVBlock,
                                 cache_lens: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, *, window: int = 0,
                                 attn_softcap: float = 0.0,
                                 norm_eps: float = 1e-6,
                                 scale: Optional[float] = None,
                                 kernel=fused_decode_attention,
                                 spec: Optional[ClusterSpec] = None
                                 ) -> torch.Tensor:
    """One attention layer on prepacked weights
    (``_split_token_attention_pallas_packed`` at cluster 1): returns the
    full ``[B, D]`` output in ``x.dtype`` and appends the new k/v to
    ``cache`` in place.  ``cos``/``sin`` are :func:`rope_at` of
    ``cache_lens`` (shared by every layer of a step).  ``kernel`` is the
    B1 entry point (its plain version to hold the kernel against it on
    the card).

    A sliding-window layer (``window > 0``) runs on a ring cache: B1
    attends BEFORE the append, masking each row by its stored ``pos``
    (``0 ≤ pos < cache_len`` and ``pos > cache_len − window``: the row
    the append will overwrite still holds ``cache_len − S``, outside the
    window), counts the new token whenever the slot is live (the ring
    always has room: ``dataflow.py:_append_slot``), and the append then
    writes row ``cache_len mod S`` (``ring=True``)."""
    B, D = x.shape
    q_loc, hd, d_out = w.wo.shape
    kv_loc = (w.wqkv.shape[1] // hd - q_loc) // 2
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    ring = window > 0
    live = (cache_lens >= 0) if ring else _appends(cache.k.shape[0],
                                                   cache_lens)
    o, k_new, v_new, m, l = kernel(
        x, w.wqkv, w.wo, w.ln1, cache.k, cache.v, cache.pos, cache_lens,
        live.to(torch.int32), cos, sin, q_heads=q_loc, kv_heads=kv_loc,
        scale=scale, norm_eps=norm_eps, bqkv=w.bqkv, window=window,
        attn_softcap=attn_softcap)
    _insert_kv_ragged(cache, k_new, v_new, cache_lens, ring=ring)
    o_full = (o / torch.clamp(l[..., None], min=1e-30)).sum(dim=1)
    return _heads_reduce(spec, o_full.to(x.dtype))


def mla_attention(x: torch.Tensor, w: MLAWeights, cache: KVBlock,
                  cache_lens: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, *, nope_dim: int, rope_dim: int,
                  spec: Optional[ClusterSpec] = None) -> torch.Tensor:
    """One MLA layer of the unfused dataflow (the XLA branch of
    ``mla_attention``, ``dataflow.py:896–955``, at cluster 1): ``x [B,
    D]`` already normed → ``[B, D]`` in ``x.dtype``; the latent entry is
    appended to ``cache`` in place.

    Stages, rounded where the reference rounds: ``q = x·wq`` and ``c =
    x·wdkv`` in the model dtype; ``q_lat = q_nope·W_UK`` per head in the
    model dtype; RoPE on ``q_rope`` and ``c_rope`` at ``cache_lens``
    (``cos``/``sin`` of width ``rope_dim``); the entry ``c_lat ++ c_rope``
    appended (to ``k``, its first column to ``v``, as the fused path
    does); then attention in f32 over the latent cache — keys ``l +
    rope`` wide, values the ``l`` latent columns, scale
    ``1/√(nope + rope)``, valid rows ``0 ≤ pos ≤ cache_len``; normalized
    by ``max(l, 1e-30)``; ``·W_UV`` per head in f32; then rounded to the
    model dtype and ``·wo``.

    The reference's ``bucketed_flash_attention`` (``dataflow.py:264``)
    skips buckets with no live row and merges the rest online; its result
    is one masked pass, which :func:`latent_attention` computes over all
    ``S`` rows (static shapes, as a CUDA graph needs).  A free slot (``cache_len = −1``)
    has no valid row and gets zeros, as there."""
    B, D = x.shape
    q_loc, nope_w, l_rank = w.wuk.shape
    hr = w.wq.shape[2]
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    q = (x @ w.wq.reshape(D, q_loc * hr)).view(B, q_loc, hr)
    c = x @ w.wdkv                                          # [B, l+rope]
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    c_lat, c_rope = c[:, :l_rank], c[:, l_rank:]
    q_lat = torch.bmm(q_nope.transpose(0, 1), w.wuk).transpose(0, 1)
    q_rope = _apply_rope(q_rope, cos, sin)
    c_rope = _apply_rope(c_rope[:, None, :], cos, sin)[:, 0]
    entry = torch.cat([c_lat, c_rope], dim=-1)              # [B, l+rope]
    _insert_kv_ragged(cache, entry, entry[:, :1], cache_lens)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)              # [B, q, l+r]
    a_lat = latent_attention(q_cat, cache, cache_lens, l_rank, scale)
    o_head = torch.bmm(a_lat.transpose(0, 1), w.wuv.float())  # [q, B, v]
    v_dim = w.wuv.shape[2]
    return _heads_reduce(spec, o_head.transpose(0, 1).reshape(
        B, q_loc * v_dim).to(x.dtype) @ w.wo)


def latent_attention(q_cat: torch.Tensor, cache: KVBlock,
                     cache_lens: torch.Tensor, l_rank: int, scale: float
                     ) -> torch.Tensor:
    """The unfused MLA layer's attention core, one masked pass in f32:
    ``q_cat [B, q, l+rope]`` against every row of the latent cache
    ``cache.k [S, B, l+rope]`` (keys: all columns; values: the first
    ``l_rank``), valid rows ``0 ≤ pos ≤ cache_len`` → the normalized
    ``a_lat [B, q, l_rank]`` f32 (zeros where a slot has no valid row)."""
    S, B = cache.pos.shape
    cc = cache.k.view(S, B, -1).transpose(0, 1).to(
        torch.float32, memory_format=torch.contiguous_format)  # [B,S,l+r]
    valid = ((cache.pos >= 0) & (cache.pos <= cache_lens)).T[:, None, :]
    s = torch.bmm(q_cat.float(), cc.transpose(1, 2)) * scale  # [B, q, S]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.bmm(p, cc[..., :l_rank])                      # [B, q, l]
    return o / torch.clamp(l_sum, min=1e-30)


def mla_attention_packed(x: torch.Tensor, w: PackedMLAWeights,
                         cache: KVBlock, cache_lens: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor, *,
                         nope_dim: int, rope_dim: int,
                         norm_eps: float = 1e-6,
                         kernel=fused_mla_decode_attention,
                         spec: Optional[ClusterSpec] = None) -> torch.Tensor:
    """One MLA layer on prepacked weights (``_mla_attention_pallas_packed``
    at cluster 1): the B4 kernel for all slots, the latent entry appended
    in place (rounded, as the kernel emits it: the entry to ``k`` and its
    first column to ``v``, ``dataflow.py:1088``), then
    ``(o / max(l, 1e-30))`` summed over heads in ``x.dtype``.
    ``cos``/``sin`` are :func:`rope_at` of ``cache_lens`` at the RoPE
    width ``rope_dim``.  ``kernel`` is the B4 entry point (its plain
    version to hold the kernel against it on the card)."""
    q_loc, _, l_rank = w.wuk.shape
    include_new = _appends(cache.k.shape[0], cache_lens).to(torch.int32)
    o, c_new, m, l = kernel(
        x, w.wq, w.wdkv, w.wuk, w.wproj, w.ln1, cache.k, cache.pos,
        cache_lens, include_new, cos, sin, q_heads=q_loc, nope=nope_dim,
        rope_d=rope_dim, l_rank=l_rank, norm_eps=norm_eps)
    _insert_kv_ragged(cache, c_new, c_new[:, :1], cache_lens)
    o_full = (o / torch.clamp(l[..., None], min=1e-30)).sum(dim=1)
    return _heads_reduce(spec, o_full.to(x.dtype))


__all__ = ["ClusterSpec", "KVBlock", "SplitTokenWeights", "MLAWeights",
           "PackedSplitTokenWeights", "PackedMLAWeights", "PackedFFNWeights",
           "PackedHeadWeights", "split_token_attention",
           "split_token_attention_packed", "mla_attention",
           "latent_attention",
           "mla_attention_packed", "rope_at"]
