"""Fused decode dataflow at cluster size 1 — the port of the parts of
``repro/core/dataflow.py`` the prepacked serving path runs.

At cluster size 1 the paper's ClusterGather/ClusterReduce are the
identity, so one layer is: the B1 kernel (``fused_decode``) for all
slots, the append of the new k/v into the cache, and the normalize +
head sum of the per-head partials — the last two plain torch, as they
are XLA ops in the reference.

The port updates the KV cache in place (the reference rebuilt it).
The reference's ``_fit_block_s`` has no counterpart: it fits Pallas
block sizes to divisors of the cache and of ``d_ff``, while the CUDA
kernels mask their ragged last tile instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.fused_decode.fused_decode import (
    fused_decode_attention, rope_at)


class KVBlock(NamedTuple):
    """One layer's KV cache: ``k``/``v [S, B·kv, hd]`` and per-slot
    positions ``pos [S, B]`` (−1 ⇒ empty).  Stacked over layers, each
    leaf gains a leading layer axis."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class PackedSplitTokenWeights(NamedTuple):
    """Serve-layout attention weights: ``wqkv [D, (q + 2kv)·hd]``,
    per-head full-width ``wo [q, hd, D]``, optional fused bias ``bqkv``
    and the fused pre-attention norm scale ``ln1 [D]``."""

    wqkv: torch.Tensor
    wo: torch.Tensor
    bqkv: Optional[torch.Tensor] = None
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
    nothing.  The owner rank and shard-local slot come back with the
    multi-GPU slice."""
    return (cache_lens >= 0) & (cache_lens < S)


def _insert_kv_ragged(cache: KVBlock, k_new: torch.Tensor,
                      v_new: torch.Tensor, position: torch.Tensor) -> None:
    """Per-slot predicated append, IN PLACE: slot b writes its
    ``k_new[b]``/``v_new[b]`` at row ``position[b]`` only when
    :func:`_appends` holds for it.  No host sync: the other slots
    rewrite a row with its own contents."""
    S = cache.k.shape[0]
    B = position.shape[0]
    own = _appends(S, position)
    idx = torch.clamp(position, 0, S - 1).long()
    b = torch.arange(B, device=position.device)
    for full, new in ((cache.k, k_new), (cache.v, v_new)):
        f3 = full.view(S, B, -1)
        n2 = new.reshape(B, -1).to(full.dtype)
        f3[idx, b] = torch.where(own[:, None], n2, f3[idx, b])
    cache.pos[idx, b] = torch.where(own, position.to(torch.int32),
                                    cache.pos[idx, b])


def split_token_attention_packed(x: torch.Tensor,
                                 w: PackedSplitTokenWeights, cache: KVBlock,
                                 cache_lens: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, *, norm_eps: float = 1e-6,
                                 scale: Optional[float] = None,
                                 kernel=fused_decode_attention
                                 ) -> torch.Tensor:
    """One attention layer on prepacked weights
    (``_split_token_attention_pallas_packed`` at cluster 1): returns the
    full ``[B, D]`` output in ``x.dtype`` and appends the new k/v to
    ``cache`` in place.  ``cos``/``sin`` are :func:`rope_at` of
    ``cache_lens`` (shared by every layer of a step).  ``kernel`` is the
    B1 entry point (its plain version to hold the kernel against it on
    the card)."""
    B, D = x.shape
    q_loc, hd, d_out = w.wo.shape
    kv_loc = (w.wqkv.shape[1] // hd - q_loc) // 2
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    include_new = _appends(cache.k.shape[0], cache_lens).to(torch.int32)
    o, k_new, v_new, m, l = kernel(
        x, w.wqkv, w.wo, w.ln1, cache.k, cache.v, cache.pos, cache_lens,
        include_new, cos, sin, q_heads=q_loc, kv_heads=kv_loc,
        scale=scale, norm_eps=norm_eps)
    _insert_kv_ragged(cache, k_new, v_new, cache_lens)
    o_full = (o / torch.clamp(l[..., None], min=1e-30)).sum(dim=1)
    return o_full.to(x.dtype)


__all__ = ["KVBlock", "PackedSplitTokenWeights", "PackedFFNWeights",
           "PackedHeadWeights", "split_token_attention_packed", "rope_at"]
