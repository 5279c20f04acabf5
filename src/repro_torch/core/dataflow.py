"""Decode dataflow — the port of the parts of ``repro/core/dataflow.py``
the two serving backends run, and of its Alg. 5 ``split_head_attention``.

On one device, and on a mesh whose cluster sub-axis is 1 (heads over the
whole model axis), the paper's ClusterGather and the flash combine over
the cluster are the identity.  On the prepacked ``"pallas"``
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

A cluster sub-axis of ``n > 1`` (a cluster across devices, the paper's
Alg. 3 and 4 with N > 1) splits each cache's sequence over the ``n``
ranks of a cluster: rank ``r`` holds ``S/n`` rows of every cache —
positions ``r·S/n …`` of a linear one, ring slots ``r·S/n …`` of the
``n·S/n``-slot ring of a sliding-window layer — and the new token lands
on its owner rank only (:func:`_append_slot`).  Each rank computes its
partial over its shard (B1 or B4 with ``pos_base``, B5 in its rank-local
mode, or the plain latent pass), and the partials merge in the flash
combine over the cluster (``prim.cluster_flash_combine``):
:func:`split_token_attention_packed` and :func:`mla_attention_packed`
run one fused ``(m, l, o)`` ClusterReduce over the per-head projected
partials, then normalize, sum the rank's heads and reduce over the
heads; the unfused :func:`split_token_attention` gathers its q/k/v
head-dim segments (``gather_tiled``), ropes after the gather, combines,
projects through its ``D/n`` column tile of ``wo``, reduces over the
heads and gathers the tiles; the unfused :func:`mla_attention` gathers
its q and latent segments and the absorbed ``q_lat``, combines, takes
its rank's ``l/n`` slice of the latent output for ``W_UV``, reduces the
value partials over the cluster, then ``wo``'s column tile, the heads
reduce and the gather (reference ``:447–571``, ``:684–768``,
``:859–955``, ``:1036–1100``).

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
    (``dataflow.py:49–98``): the ``heads`` sub-axis, whose ranks hold
    other heads and meet in the output's sum, and the ``cluster``
    sub-axis (None or size 1: no cluster across devices), whose ranks
    share one head group and split its KV sequence.  ``fused_combine``:
    the adapter paths' flash combine as one tree with the flash-merge
    operator, not the paper's three reduces (the packed paths always
    use the one tree)."""

    heads: Axis
    cluster: Optional[Axis] = None
    fused_combine: bool = False

    @property
    def n_cluster(self) -> int:
        return 1 if self.cluster is None else prim._axis_size(self.cluster)

    def cluster_index(self) -> int:
        return 0 if self.cluster is None else prim.axis_index(self.cluster)

    def reduce(self, x, op="sum"):
        """ClusterReduce over the cluster (``dataflow.py:78``)."""
        if self.n_cluster == 1:
            return x
        return prim.cluster_reduce(x, self.cluster, op)

    def gather_tiled(self, x, dim: int):
        """ClusterGather over the cluster, tiles along ``dim``
        (``dataflow.py:83``)."""
        if self.n_cluster == 1:
            return x
        return prim.cluster_gather_tiled(x, self.cluster, dim=dim)

    def heads_reduce(self, x):
        """The output's sum over the heads ranks (the paper's atomicAdd):
        the tree over the heads sub-axis (``dataflow.py:88``)."""
        return prim.cluster_reduce(x, self.heads, "sum")

    def flash_combine(self, m, l, o):
        """The ranks' flash partials merged over the cluster
        (``dataflow.py:93``)."""
        return prim.cluster_flash_combine(m, l, o, self.cluster,
                                          fused=self.fused_combine)


def _heads_reduce(spec: Optional[ClusterSpec], x: torch.Tensor
                  ) -> torch.Tensor:
    return x if spec is None else spec.heads_reduce(x)


def _n(spec: Optional[ClusterSpec]) -> int:
    return 1 if spec is None else spec.n_cluster


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
    (``dataflow.py:332``): ``wq [D, q, hd/n]``, ``wk``/``wv [D, kv,
    hd/n]`` — each rank's head-dim segment, the whole head at cluster
    ``n`` 1 —, ``wo [q·hd, D/n]`` (its column tile) and the optional
    biases ``bq [q, hd/n]``, ``bk``/``bv [kv, hd/n]``."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


class MLAWeights(NamedTuple):
    """Train-layout MLA weights the unfused path reads (``dataflow.py:842``;
    at cluster size 1 every rank segment is the whole tensor):
    ``wq [D, q, (nope+rope)/n]``, ``wdkv [D, (l+rope)/n]``, ``wuk [q,
    nope, l/n]``, ``wuv [q, l/n, v]``, ``wo [q·v, D/n]``."""

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


class AppendSlot(NamedTuple):
    """Where this step's new KV entry lands on a cluster-sharded cache and
    the kernels' gating it implies (the reference's ``_AppendSlot``,
    ``dataflow.py:217``): per slot ``own`` (bool: this rank writes it),
    the row ``local_slot`` (int64) in the owner rank's shard and
    ``include_new`` (``own`` as int32, the kernels' gate: the new token
    counts once a cluster); this rank's ``pos_base`` (``rank·s_blk`` on
    a linear cache, its positions from there in order; −1 on a ring,
    where offsets are not positions).  It depends on ``cache_lens``
    alone, so a decode step makes it once for every layer of a kind
    (``serving/engine.py:decode_step``); the incremental KV fingerprint
    (``serving/integrity.py:kv_rows_bitsum``) reads its rows before and
    after the step."""

    own: torch.Tensor
    local_slot: torch.Tensor
    include_new: torch.Tensor
    pos_base: int


def _append_slot(spec: Optional[ClusterSpec], s_blk: int,
                 cache_lens: torch.Tensor, *, window: int = 0
                 ) -> AppendSlot:
    """THE slot/owner/gating formula (``dataflow.py:_append_slot``,
    ``:234–262``), elementwise over the per-slot ``cache_lens [B]``: a
    linear cache appends position ``cache_len`` at global row
    ``cache_len`` (owner ``cache_len // s_blk``; at or past ``n·s_blk``
    no rank owns it), a sliding-window layer's ring of ``n·s_blk`` slots
    at ``cache_len mod n·s_blk``.  A free slot (−1) owns nothing.  At
    cluster 1 this is the whole cache on the one rank: slot b appends iff
    ``0 ≤ cache_len < S``, or on a ring iff ``cache_len ≥ 0``."""
    n, rank = _n(spec), (0 if spec is None else spec.cluster_index())
    slot = torch.remainder(cache_lens, n * s_blk) if window > 0 \
        else cache_lens
    owner = torch.div(slot, s_blk, rounding_mode="floor")
    own = (owner == rank) & (cache_lens >= 0)
    return AppendSlot(own, torch.remainder(slot, s_blk).long(),
                      own.to(torch.int32),
                      -1 if window > 0 else rank * s_blk)


def _insert_kv_ragged(cache: KVBlock, k_new: torch.Tensor,
                      v_new: torch.Tensor, position: torch.Tensor, *,
                      ring: bool = False,
                      spec: Optional[ClusterSpec] = None,
                      ap: Optional[AppendSlot] = None) -> None:
    """Per-slot owner-gated append, IN PLACE (``dataflow.py:148–178``):
    slot b writes its ``k_new[b]``/``v_new[b]`` and ``pos = position[b]``
    at its row of :func:`_append_slot` (``ap``, made here if not given;
    ``ring``: a sliding-window layer's ring), on the owner rank only and
    only while live (``position ≥ 0``).  No host sync: the other slots
    rewrite a row with its own contents."""
    S = cache.k.shape[0]
    B = position.shape[0]
    if ap is None:
        ap = _append_slot(spec, S, position, window=int(ring))
    own, idx = ap.own, ap.local_slot
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
                          spec: Optional[ClusterSpec] = None,
                          ap: Optional[AppendSlot] = None) -> torch.Tensor:
    """One attention layer of the unfused dataflow (the XLA branch of
    ``split_token_attention``, ``dataflow.py:500–571``): ``x [B, D]``
    already normed → ``[B, D]`` in ``x.dtype``; the new k/v is appended
    to ``cache`` in place.

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
    card).

    At cluster ``n > 1`` (``spec``) the weights are the rank's head-dim
    segments and ``wo``'s ``D/n`` column tile: the q/k/v segments are
    gathered over the cluster before RoPE, the owner rank appends, B5's
    rank-local mode gives this rank's f32 partial over its shard (masked
    by stored ``pos``, offsets are not positions on a ring shard), the
    partials merge in the flash combine, and the normalized heads go
    through the column tile, the heads reduce and the gather of the
    tiles (``dataflow.py:528–571``).  ``ap``: the step's
    :func:`_append_slot` for this cache (made here if not given)."""
    B, D = x.shape
    q_loc, hd_n = w.wq.shape[1], w.wq.shape[2]
    kv_loc = w.wk.shape[1]
    n = _n(spec)
    q = (x @ w.wq.reshape(D, q_loc * hd_n)).view(B, q_loc, hd_n)
    k = (x @ w.wk.reshape(D, kv_loc * hd_n)).view(B, kv_loc, hd_n)
    v = (x @ w.wv.reshape(D, kv_loc * hd_n)).view(B, kv_loc, hd_n)
    if w.bq is not None:
        q, k, v = q + w.bq, k + w.bk, v + w.bv
    if n > 1:
        q, k, v = (spec.gather_tiled(t, dim=2) for t in (q, k, v))
    hd = hd_n * n
    q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    S = cache.k.shape[0]
    if ap is None:
        ap = _append_slot(spec, S, cache_lens, window=window)
    _insert_kv_ragged(cache, k, v, cache_lens, ap=ap)
    kc, vc = (t.view(S, B, kv_loc, hd) for t in (cache.k, cache.v))
    if n == 1:
        lens = torch.clamp(cache_lens + 1, 0, S).to(torch.int32)
        att = kernel(q, kc, vc, lens, scale=scale, attn_softcap=attn_softcap)
        return _heads_reduce(spec, att.reshape(B, q_loc * hd).to(x.dtype)
                             @ w.wo)
    o, m, l = kernel(q, kc, vc, cache_lens, scale=scale,
                     attn_softcap=attn_softcap, window=window,
                     pos=cache.pos, pos_base=ap.pos_base)
    qpk = q_loc // kv_loc
    _, l_g, o_g = spec.flash_combine(m.view(B, kv_loc, qpk),
                                     l.view(B, kv_loc, qpk),
                                     o.view(B, kv_loc, qpk, hd))
    att = (o_g / torch.clamp(l_g[..., None], min=1e-30)).reshape(
        B, q_loc * hd).to(x.dtype)
    o_seg = spec.heads_reduce(att @ w.wo)                   # [B, D/n]
    return spec.gather_tiled(o_seg, dim=1)


def split_token_attention_packed(x: torch.Tensor,
                                 w: PackedSplitTokenWeights, cache: KVBlock,
                                 cache_lens: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, *, window: int = 0,
                                 attn_softcap: float = 0.0,
                                 norm_eps: float = 1e-6,
                                 scale: Optional[float] = None,
                                 kernel=fused_decode_attention,
                                 spec: Optional[ClusterSpec] = None,
                                 ap: Optional[AppendSlot] = None
                                 ) -> torch.Tensor:
    """One attention layer on prepacked weights
    (``_split_token_attention_pallas_packed``): returns the full ``[B,
    D]`` output in ``x.dtype`` and appends the new k/v to ``cache`` in
    place.  ``cos``/``sin`` are :func:`rope_at` of ``cache_lens`` (shared
    by every layer of a step).  ``kernel`` is the B1 entry point (its
    plain version to hold the kernel against it on the card).

    A sliding-window layer (``window > 0``) runs on a ring cache: B1
    attends BEFORE the append, masking each row by its stored ``pos``
    (``0 ≤ pos < cache_len`` and ``pos > cache_len − window``: the row
    the append will overwrite still holds ``cache_len − S``, outside the
    window), counts the new token whenever the slot is live (the ring
    always has room: ``dataflow.py:_append_slot``), and the append then
    writes row ``cache_len mod S`` (``ring=True``).

    At cluster ``n > 1`` (``spec``) the cache is this rank's shard:
    ``wqkv`` holds whole heads (gathered at load), B1 attends the shard
    (``pos_base`` ``rank·S``, −1 on a ring shard) and counts the new
    token on its owner rank only, the owner appends, and one fused
    ``(m, l, o)`` ClusterReduce over the per-head projected partials
    precedes the normalize, the rank's head sum and the heads reduce
    (``dataflow.py:736–768``).  At cluster 1 the combine is the
    identity and is not run.  ``ap``: the step's :func:`_append_slot`
    for this cache (made here if not given)."""
    B, D = x.shape
    q_loc, hd, d_out = w.wo.shape
    kv_loc = (w.wqkv.shape[1] // hd - q_loc) // 2
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if ap is None:
        ap = _append_slot(spec, cache.k.shape[0], cache_lens, window=window)
    n = _n(spec)
    o, k_new, v_new, m, l = kernel(
        x, w.wqkv, w.wo, w.ln1, cache.k, cache.v, cache.pos, cache_lens,
        ap.include_new, cos, sin, q_heads=q_loc, kv_heads=kv_loc,
        scale=scale, norm_eps=norm_eps, bqkv=w.bqkv, window=window,
        attn_softcap=attn_softcap, pos_base=ap.pos_base if n > 1 else 0)
    _insert_kv_ragged(cache, k_new, v_new, cache_lens, ap=ap)
    if n > 1:
        _, l, o = prim.cluster_flash_combine(m, l, o, spec.cluster,
                                             fused=True)
    o_full = (o / torch.clamp(l[..., None], min=1e-30)).sum(dim=1)
    return _heads_reduce(spec, o_full.to(x.dtype))


def mla_attention(x: torch.Tensor, w: MLAWeights, cache: KVBlock,
                  cache_lens: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, *, nope_dim: int, rope_dim: int,
                  spec: Optional[ClusterSpec] = None,
                  ap: Optional[AppendSlot] = None) -> torch.Tensor:
    """One MLA layer of the unfused dataflow (the XLA branch of
    ``mla_attention``, ``dataflow.py:896–955``): ``x [B, D]`` already
    normed → ``[B, D]`` in ``x.dtype``; the latent entry is appended to
    ``cache`` in place.

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
    has no valid row and gets zeros, as there.

    At cluster ``n > 1`` (``spec``) the weights are the rank's segments
    (``wq``'s and ``wdkv``'s columns, ``wuk``'s and ``wuv``'s ``l/n``
    latent slice, ``wo``'s column tile): the q and latent segments are
    gathered, ``q_nope·W_UK`` is formed on the rank's ``l/n`` columns and
    gathered, the owner appends, :func:`latent_partial` over the rank's
    shard merges in the flash combine, the rank's ``l/n`` slice of the
    normalized latent output goes through its ``W_UV`` rows and the value
    partials are summed over the cluster, then ``wo``'s tile, the heads
    reduce and the gather (``dataflow.py:896–955``).  ``ap``: the step's
    :func:`_append_slot` for this cache (made here if not given)."""
    B, D = x.shape
    q_loc, nope_w, l_n = w.wuk.shape
    n = _n(spec)
    l_rank = l_n * n
    hr = w.wq.shape[2]
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    q = (x @ w.wq.reshape(D, q_loc * hr)).view(B, q_loc, hr)
    c = x @ w.wdkv                                          # [B, l+rope]
    if n > 1:
        q, c = spec.gather_tiled(q, dim=2), spec.gather_tiled(c, dim=1)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    c_lat, c_rope = c[:, :l_rank], c[:, l_rank:]
    q_lat = torch.bmm(q_nope.transpose(0, 1), w.wuk).transpose(0, 1)
    if n > 1:
        q_lat = spec.gather_tiled(q_lat, dim=2)
    q_rope = _apply_rope(q_rope, cos, sin)
    c_rope = _apply_rope(c_rope[:, None, :], cos, sin)[:, 0]
    entry = torch.cat([c_lat, c_rope], dim=-1)              # [B, l+rope]
    _insert_kv_ragged(cache, entry, entry[:, :1], cache_lens, spec=spec,
                      ap=ap)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)              # [B, q, l+r]
    v_dim = w.wuv.shape[2]
    if n == 1:
        a_lat = latent_attention(q_cat, cache, cache_lens, l_rank, scale)
    else:
        _, l_g, o_g = spec.flash_combine(*latent_partial(
            q_cat, cache, cache_lens, l_rank, scale))
        a_lat = o_g / torch.clamp(l_g[..., None], min=1e-30)
        r = spec.cluster_index()
        a_lat = a_lat[..., r * l_n:(r + 1) * l_n]
    o_head = torch.bmm(a_lat.transpose(0, 1), w.wuv.float())  # [q, B, v]
    if n > 1:
        o_head = spec.reduce(o_head, "sum")
    o_seg = _heads_reduce(spec, o_head.transpose(0, 1).reshape(
        B, q_loc * v_dim).to(x.dtype) @ w.wo)
    return o_seg if n == 1 else spec.gather_tiled(o_seg, dim=1)


def _latent_scores(q_cat, cache, cache_lens, scale):
    S, B = cache.pos.shape
    cc = cache.k.view(S, B, -1).transpose(0, 1).to(
        torch.float32, memory_format=torch.contiguous_format)  # [B,S,l+r]
    valid = ((cache.pos >= 0) & (cache.pos <= cache_lens)).T[:, None, :]
    s = torch.bmm(q_cat.float(), cc.transpose(1, 2)) * scale  # [B, q, S]
    return cc, valid, torch.where(valid, s, -1e30)


def latent_attention(q_cat: torch.Tensor, cache: KVBlock,
                     cache_lens: torch.Tensor, l_rank: int, scale: float
                     ) -> torch.Tensor:
    """The unfused MLA layer's attention core, one masked pass in f32:
    ``q_cat [B, q, l+rope]`` against every row of the latent cache
    ``cache.k [S, B, l+rope]`` (keys: all columns; values: the first
    ``l_rank``), valid rows ``0 ≤ pos ≤ cache_len`` → the normalized
    ``a_lat [B, q, l_rank]`` f32 (zeros where a slot has no valid row)."""
    cc, valid, s = _latent_scores(q_cat, cache, cache_lens, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.bmm(p, cc[..., :l_rank])                      # [B, q, l]
    return o / torch.clamp(l_sum, min=1e-30)


def latent_partial(q_cat: torch.Tensor, cache: KVBlock,
                   cache_lens: torch.Tensor, l_rank: int, scale: float):
    """:func:`latent_attention`'s pass over this rank's shard, left as the
    flash partial ``(m [B, q], l [B, q], o [B, q, l_rank])`` f32 for the
    combine over the cluster; a slot with no valid row here holds
    ``(−1e30, 0, 0)`` (``dataflow.py:bucketed_flash_attention``)."""
    cc, valid, s = _latent_scores(q_cat, cache, cache_lens, scale)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.bmm(p, cc[..., :l_rank])


def mla_attention_packed(x: torch.Tensor, w: PackedMLAWeights,
                         cache: KVBlock, cache_lens: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor, *,
                         nope_dim: int, rope_dim: int,
                         norm_eps: float = 1e-6,
                         kernel=fused_mla_decode_attention,
                         spec: Optional[ClusterSpec] = None,
                         ap: Optional[AppendSlot] = None) -> torch.Tensor:
    """One MLA layer on prepacked weights (``_mla_attention_pallas_packed``):
    the B4 kernel for all slots, the latent entry appended in place
    (rounded, as the kernel emits it: the entry to ``k`` and its first
    column to ``v``, ``dataflow.py:1088``), then ``(o / max(l, 1e-30))``
    summed over heads in ``x.dtype``.  ``cos``/``sin`` are :func:`rope_at`
    of ``cache_lens`` at the RoPE width ``rope_dim``.  ``kernel`` is the
    B4 entry point (its plain version to hold the kernel against it on
    the card).  At cluster ``n > 1`` B4 attends this rank's shard
    (``pos_base = rank·S``), the new token counts on its owner rank, and
    one fused ``(m, l, o)`` ClusterReduce merges the ranks' projected
    partials before the normalize (``dataflow.py:1072–1100``).  ``ap``:
    the step's :func:`_append_slot` for this cache (made here if not
    given)."""
    q_loc, _, l_rank = w.wuk.shape
    if ap is None:
        ap = _append_slot(spec, cache.k.shape[0], cache_lens)
    n = _n(spec)
    o, c_new, m, l = kernel(
        x, w.wq, w.wdkv, w.wuk, w.wproj, w.ln1, cache.k, cache.pos,
        cache_lens, ap.include_new, cos, sin, q_heads=q_loc, nope=nope_dim,
        rope_d=rope_dim, l_rank=l_rank, norm_eps=norm_eps,
        pos_base=ap.pos_base if n > 1 else 0)
    _insert_kv_ragged(cache, c_new, c_new[:, :1], cache_lens, ap=ap)
    if n > 1:
        _, l, o = prim.cluster_flash_combine(m, l, o, spec.cluster,
                                             fused=True)
    o_full = (o / torch.clamp(l[..., None], min=1e-30)).sum(dim=1)
    return _heads_reduce(spec, o_full.to(x.dtype))


# ---------------------------------------------------------------------------
# Paper Alg. 5 — SplitHead (App. B.2; the reference's dataflow comparison)
# ---------------------------------------------------------------------------
class SplitHeadWeights(NamedTuple):
    """``wq``/``wk``/``wv [D, q|kv, hd/n]``; ``wo [q·hd/n, D]``
    (``dataflow.py:771``)."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor


def split_head_attention(spec: ClusterSpec, x: torch.Tensor,
                         w: SplitHeadWeights, cache: KVBlock, cache_len: int,
                         *, rope_theta: float = 10000.0,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, KVBlock]:
    """Alg. 5 (``dataflow.py:780–839``), lockstep (one ``cache_len`` for
    every slot): the head dim partitioned in all three stages over the
    cluster, the cache HEAD-DIM-partitioned (``[S, B·kv, hd/n]``, every
    rank appending the slot), the full ``[B, kv, qpk, S]`` score matrix
    ClusterReduced (traffic ∝ S), then the partial output projection
    over the whole ``D`` ClusterReduced and the heads reduce.  Returns
    ``(o [B, D], cache)`` with the cache updated in place.

    RoPE rotates across the head's halves, which a split head dim cannot
    do locally; as the reference states, this rotates WITHIN each rank's
    segment (frequencies of width ``hd/n``), a deviation from RoPE kept
    here because the reference's dataflow comparison, the only user of
    this function there, runs it so; no serving path calls it."""
    n = spec.n_cluster
    B, D = x.shape
    q_loc, hd_n = w.wq.shape[1], w.wq.shape[2]
    kv_loc = w.wk.shape[1]
    qpk = q_loc // kv_loc
    scale = scale if scale is not None else 1.0 / math.sqrt(hd_n * n)
    q = torch.einsum("bd,dqh->bqh", x, w.wq)
    k = torch.einsum("bd,dkh->bkh", x, w.wk)
    v = torch.einsum("bd,dkh->bkh", x, w.wv)
    pos = torch.full((B,), int(cache_len), dtype=torch.int32,
                     device=x.device)
    cos, sin = rope_at(pos, hd_n, rope_theta)
    q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    S = cache.k.shape[0]
    row = min(max(int(cache_len), 0), S - 1)
    cache.k[row] = k.reshape(B * kv_loc, hd_n).to(cache.k.dtype)
    cache.v[row] = v.reshape(B * kv_loc, hd_n).to(cache.v.dtype)
    cache.pos[row] = int(cache_len)
    kc = cache.k.view(S, B, kv_loc, hd_n).float()
    vc = cache.v.view(S, B, kv_loc, hd_n).float()
    qf = q.view(B, kv_loc, qpk, hd_n).float()
    s_full = spec.reduce(torch.einsum("bkqh,sbkh->bkqs", qf, kc) * scale,
                         "sum")
    valid = (cache.pos >= 0) & (cache.pos <= int(cache_len))
    s_full = torch.where(valid[None, None, None, :], s_full, -torch.inf)
    p = torch.softmax(s_full, dim=-1)
    a_seg = torch.einsum("bkqs,sbkh->bkqh", p, vc).reshape(
        B, q_loc * hd_n).to(x.dtype)
    o_full = spec.reduce(a_seg @ w.wo, "sum")
    return spec.heads_reduce(o_full), cache


# ---------------------------------------------------------------------------
# Traffic totals per dataflow (paper §3.2 + App. B), bytes — the
# reference's ``dataflow.py:1104–1130``, which its cluster tuner reads
# ---------------------------------------------------------------------------
def traffic_split_token(head_dim: int, model_dim: int, n: int,
                        bytes_per_el: int = 2, batch: int = 1) -> float:
    """Alg. 3: ``Traffic_Gather(3h/N) + Traffic_Reduce(h)``."""
    h_seg = head_dim / n * 3 * bytes_per_el * batch
    red = head_dim * bytes_per_el * batch
    return prim.traffic_gather(h_seg, n) + prim.traffic_reduce(red, n)


def traffic_split_head(seq_len: int, model_dim: int, n: int,
                       bytes_per_el: int = 4, batch: int = 1) -> float:
    """Alg. 5: ``Traffic_Reduce(S) + Traffic_Reduce(D)``."""
    return (prim.traffic_reduce(seq_len * bytes_per_el * batch, n)
            + prim.traffic_reduce(model_dim * bytes_per_el * batch, n))


def traffic_mla(head_dim: int, l_rank: int, total_head_dim: int, n: int,
                bytes_per_el: int = 2, batch: int = 1) -> float:
    """Alg. 4: ``Gather(h) + 2·Gather(l) + Reduce(l) + Reduce(H)``."""
    b = bytes_per_el * batch
    return (prim.traffic_gather(head_dim / n * b, n)
            + 2 * prim.traffic_gather(l_rank / n * b, n)
            + prim.traffic_reduce(l_rank * b, n)
            + prim.traffic_reduce(total_head_dim * b, n))


__all__ = ["ClusterSpec", "KVBlock", "SplitTokenWeights", "MLAWeights",
           "PackedSplitTokenWeights", "PackedMLAWeights", "PackedFFNWeights",
           "PackedHeadWeights", "SplitHeadWeights", "AppendSlot",
           "split_token_attention", "split_token_attention_packed",
           "mla_attention", "latent_attention", "latent_partial",
           "mla_attention_packed", "split_head_attention", "rope_at"]
