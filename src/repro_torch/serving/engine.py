"""Decode engine — the port of ``repro/serving/engine.py`` on one GPU,
for its two backends (``ServeConfig.backend``, resolved by
``core/autotune.py``).

On the fused, prepacked ``"pallas"`` path one decode step of an
attention model is the embedding, then per layer the attention kernel
— B1 (``fused_decode``, with its fused ``ln1`` and per-head output
projection) or, for MLA, B4 (``fused_mla_decode``, with its fused ``ln1``
and the folded ``W_UV·W_O`` projection) — and the B2 kernel
(``fused_ffn``, the block tail), then the B3 kernel (``fused_head``,
final norm + LM head + top-k): ``2·L + 1`` kernel calls.  Plain torch
runs only where the reference ran XLA ops: the embedding, ``rope_at``,
the KV append, the normalize-and-head sum, the greedy finalize and the
``cache_lens`` update.

On the unfused ``"xla"`` path (the reference's default, the paper's
baseline) the serve tree is the train tree, and a layer is
``rms_norm(ln1)``, the q/k/v products, RoPE, the append, B5
(``flash_decode``) over each slot's live prefix, the ``wo`` product, the
residual add, ``rms_norm(ln2)``, the FFN products and the second add;
the head is loose (``final_norm``, full f32 logits, softcap, top-k):
``L`` kernel calls a step.  Its MLA layer (``core/dataflow.py:
mla_attention``) runs no kernel of the port's: the projections, the
latent append and the f32 latent attention are torch and cuBLAS, as the
reference's XLA branch runs around no Pallas kernel.

On a MoE model (DeepSeek-V2-Lite as the reference registers it) every
layer's FFN is the expert dispatch of ``models/moe.py`` in torch and
cuBLAS on both backends, after the attention's residual add and
``rms_norm(ln2)``: on ``"pallas"`` a step is ``L`` B4 launches and one
B3 (no B2: its block tail has no MoE form, as the reference's packed
FFN has none), on ``"xla"`` no kernel launch at all.  Capacity couples
the slots, so MoE models serve lockstep (``launch/serve.py:generate``),
as the reference's scheduler asserts.

On RWKV-6 a step is the embedding, then per layer the reference's
``rwkv6_step`` + ``rwkv6_channel_step`` in plain torch around one B7
launch (``rwkv6_scan`` at ``S = 1``, the WKV recurrence), then the head
— B3 on ``"pallas"``, the loose head on ``"xla"`` (``"auto"``'s choice
for an attention-free model): ``L + 1`` or ``L`` kernel calls.  Its
per-slot state is the recurrence's f32 matrix and the two shift rows of
every layer, not a KV cache; it is served lockstep
(``launch/serve.py:generate``) and does not mask free slots, as the
reference does not.

On RecurrentGemma a step is the embedding times ``√d_model`` (tied
embeddings), then per RG-LRU layer the reference's ``rglru_block_step``
in plain torch around one B6 launch (``rglru_scan`` at ``S = 1``) and
the unfused FFN on both backends, per local-attention layer — on a ring
cache of ``min(window, max_seq)`` rows — B1 (its window over the ring,
``head_dim`` 256, MQA 16/1) and B2 on ``"pallas"`` or the unfused layer
above on ``"xla"``, the ``tail`` layers after the groups, and B3 or the
loose head on the embedding table: ``L_rec + 2·L_local + 1`` kernel
calls fused (51 at full depth), ``L`` unfused.  Its RG-LRU state is
``h`` and the conv tail of every recurrent layer; it is served lockstep
like RWKV-6.

On SeamlessM4T-medium (an encoder-decoder) prefill encodes the stub
frontend's frames once and writes every decoder layer's cross-attention
k and v into ``state["enc_kv"]``; a decode step's layer is then the
self-attention (B1 with its fused ``ln1`` on ``"pallas"``, the unfused
layer around B5 on ``"xla"``), ``x + a``, :func:`_cross_decode` over all
``P`` frames in torch and cuBLAS (the reference computes it in XLA
einsums, outside any Pallas kernel), and the unfused FFN on both
backends (the reference's ``decode_block`` never takes the fused tail
beside an encoder, ``engine.py:428``): ``L + 1`` kernel calls fused,
``L`` unfused.  InternVL2-2B is a GQA decoder once its prefill has
spliced the patch embeddings into the prompt.

On a mesh (``ctx``, ``models/ctx.py``) a rank runs its own heads,
``d_ff`` columns, experts and vocabulary shard, and the partials meet as
in the reference: the embedding's ``psum_model``; each attention layer's
output in the heads reduce (``core/dataflow.py:ClusterSpec``, the tree)
— with a cluster sub-axis above 1 (a cluster across devices: the
``heads_sub`` ranks of a group share its heads, each holding ``1/n`` of
every cache's rows, ``ServeConfig.cluster_size``) after the layer's
flash combine over the cluster (``core/dataflow.py``); on the fused path
B2's partial (``add_r`` on model rank 0 only) in the tree ClusterReduce
over the model axis (``psum_model`` on an axis that is not a power of
two), on the unfused path the FFN's ``psum_model``; the MoE's
``psum_model``; an RG-LRU layer's ``psum_model`` over the rank's
channels; an RWKV-6 time mix's ``psum_heads`` over the rank's heads and
its channel mix's ``psum_model``; a cross-attention's ``psum_heads``
over the rank's heads of the static ``enc_kv``; the head's per-rank
top-``CAND_K`` (ids offset by the rank's first vocabulary row) merged by
the tree with the commutative ``topk_pair_merge``, so every rank holds
the same candidates.

Decode is ragged on attention models: ``state["cache_lens"] [B]`` lets
every slot advance on its own, and ``−1`` marks a free slot (no KV
write, no attention work, frozen position).  The KV caches and the
RWKV-6 states in ``state`` are updated IN PLACE (the reference rebuilt
them): a state passed to :func:`decode_step` or to ``prefill`` shares
those tensors with the state returned.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, RWKV6, ModelConfig
from repro_torch.core import primitives as prim
from repro_torch.core.dataflow import (ClusterSpec, KVBlock, MLAWeights,
                                       PackedFFNWeights, PackedHeadWeights,
                                       PackedMLAWeights,
                                       PackedSplitTokenWeights,
                                       SplitTokenWeights, mla_attention,
                                       mla_attention_packed,
                                       split_token_attention,
                                       split_token_attention_packed)
from repro_torch.core.dataflow import AppendSlot, _append_slot
from repro_torch.core.device import resolve_device
from repro_torch.core.tracecount import live_attend_blocks
from repro_torch.kernels.flash_decode.flash_decode import (
    flash_decode_attention, flash_decode_plain)
from repro_torch.kernels.fused_decode.fused_decode import (
    fused_decode_attention, fused_decode_plain, rope_at)
from repro_torch.kernels.fused_ffn.fused_ffn import (fused_ffn_block,
                                                     fused_ffn_plain)
from repro_torch.kernels.fused_head.fused_head import (fused_head_block,
                                                       fused_head_plain)
from repro_torch.kernels.fused_head.topk import topk_pair_merge
from repro_torch.kernels.fused_mla_decode.fused_mla_decode import (
    fused_mla_decode_attention, fused_mla_decode_plain)
from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                       rglru_scan_plain)
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (rwkv6_scan,
                                                       rwkv6_scan_plain)
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.layers import lm_head_logits, rms_norm, softcap
from repro_torch.models.rglru import rglru_block_step, rglru_state_init
from repro_torch.models.rwkv6 import (rwkv6_channel_step, rwkv6_state_init,
                                      rwkv6_step)
from repro_torch.models.transformer import (block_ffn, embed_tokens,
                                            head_table, post_norm)
from repro_torch.serving.integrity import kv_rows_bitsum, wrap_i32
from repro_torch.serving.sampling import (CAND_K, advance_sampling_step,
                                          finalize_candidates,
                                          greedy_candidates,
                                          head_candidates,
                                          init_sampling_state)


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int                   # cache capacity (positions)
    batch_local: int               # slots
    # the ranks sharding the heads (ParallelCtx.heads_size): a rank's
    # caches hold max(1, n_kv / heads_size) kv heads
    heads_size: int = 1
    # the cluster sub-axis (ParallelCtx.cluster_size): a rank's caches
    # hold 1/cluster_size of the sequence (engine.py:143–167)
    cluster_size: int = 1
    # "xla" = the unfused dataflow around B5; "pallas" = the fused kernels
    # (resolved from "auto" by core/autotune.py, as in the reference)
    backend: str = "xla"
    # serve-layout prepack (serving/prepack.py): on for "pallas"; on
    # "xla" at model size 1 the serve tree is the train tree either way
    prepack: bool = False
    # per-slot integrity sentinel: state["nonfinite"] counts, per slot,
    # the steps whose residual row or head value was non-finite or whose
    # token fell outside [0, vocab) (the reference's check_finite)
    check_finite: bool = False
    # per-slot attend-step counters: state["work_blocks"] adds every
    # attention layer's live blocks of WORK_BLOCK_S rows each step
    # (core/tracecount.live_attend_blocks)
    track_work: bool = False
    # per-slot KV-cache checksums (serving/integrity.py):
    # state["kv_fp"] / state["kv_fp_tail"], updated in place with the
    # caches — by the step for the rows it appends, by the admit for an
    # admitted slot's whole entry
    kv_fingerprint: bool = False
    # the (pre-head residual, winning logit, token) triple each step
    # stashes per slot — state["head_resid"/"head_val"/"head_tok"] — for
    # the shadow probe
    shadow_head: bool = False


@dataclass(frozen=True)
class EngineOptions:
    """Construction options for ``launch/serve.py:build_engine_full``, with
    the reference's defaults: ``backend`` ``"xla"`` | ``"pallas"`` |
    ``"auto"`` and ``prepack`` ``"auto"`` | ``"on"`` | ``"off"``
    (``core/autotune.py``); ``check_finite``, ``track_work``,
    ``kv_fingerprint`` and ``shadow_head`` add their state leaves
    (:class:`ServeConfig`); ``cluster``: the serve cluster on a mesh
    (None: ``launch/specs.py:serving_layout``'s pick; ``n``: the layout
    ``Layout(ms, ms // n)``, as the reference's ``serve.py:181–183``);
    ``fused_combine``: the unfused paths' flash combine over the cluster
    as one tree (``engine.py:125``)."""
    fused_combine: bool = False
    cluster: Optional[int] = None
    backend: str = "xla"
    prepack: Any = "auto"
    check_finite: bool = False
    track_work: bool = False
    kv_fingerprint: bool = False
    shadow_head: bool = False


class Kernels(NamedTuple):
    """The B1–B7 entry points a decode step calls (``decode`` for GQA
    attention, ``mla`` for MLA, ``wkv`` for RWKV-6's recurrence,
    ``flash`` for the unfused path's attention core, ``rglru`` for the
    RG-LRU recurrence).  ``PLAIN_KERNELS``
    holds the kernels against their plain versions end to end on the
    card (``chip_smoke.py``); the wrappers take the plain versions on the
    CPU anyway."""
    decode: Callable
    ffn: Callable
    head: Callable
    mla: Callable
    wkv: Callable
    flash: Callable
    rglru: Callable


KERNELS = Kernels(fused_decode_attention, fused_ffn_block, fused_head_block,
                  fused_mla_decode_attention, rwkv6_scan,
                  flash_decode_attention, rglru_scan)
PLAIN_KERNELS = Kernels(fused_decode_plain, fused_ffn_plain, fused_head_plain,
                        fused_mla_decode_plain, rwkv6_scan_plain,
                        flash_decode_plain, rglru_scan_plain)


def init_decode_state(cfg: ModelConfig, scfg: ServeConfig, *,
                      device="cuda") -> Dict[str, Any]:
    """``cache_lens [B]`` (0: a fresh lockstep batch), the sampling leaves,
    ``gumbel [B, max_seq, CAND_K]`` f32 (each slot's noise by emit
    offset, written by the admit in place), and per block-pattern
    position one state stacked over the layer
    groups (``engine.py:143–220``): a :class:`KVBlock` ``k``/``v [G, S,
    B·kv, hd]`` bf16, ``pos [G, S, B]`` with ``S = max_seq``, or ``S =
    min(window, max_seq)`` ring rows on a local-attention layer — for MLA
    the latent cache ``k [G, S, B, l+rope]``, ``v [G, S, B, 1]``; for
    RWKV-6 an ``RWKV6State``, ``s [G, B, H, hd, hd]`` f32 and
    ``x_prev_t``/``x_prev_c [G, B, D]`` bf16; for RG-LRU an
    ``RGLRUState``, ``h [G, B, C]`` and ``conv [G, B, width − 1, C]`` f32.
    ``tail``: one unstacked state per tail layer.  With an encoder,
    ``enc_kv``: ``k``/``v [L, P, B·kv, hd]`` bf16, each decoder layer's
    cross-attention keys and values over the ``P`` encoder frames
    (``engine.py:236–243``), written by prefill in place.  The leaves of
    the flags (``engine.py:191–235``): ``nonfinite``, ``work_blocks``,
    ``head_val`` and ``head_tok`` ``[B]``, ``head_resid [B, D]`` bf16,
    ``kv_fp`` (one ``[G, B]`` int32 per block-pattern position) and
    ``kv_fp_tail`` (one ``[B]`` per tail layer).  On a mesh ``B`` is the
    rank's slots and ``kv`` its kv heads, ``max(1, n_kv /
    scfg.heads_size)`` (``enc_kv``'s too), a cache holds its cluster
    rank's ``S / n`` rows, ``n`` = ``scfg.cluster_size``, an RG-LRU
    state the rank's ``C / ms`` channels and an RWKV-6 state its ``H /
    heads_size`` heads (``engine.py:144–243``)."""
    dev = resolve_device(device)
    B, S = scfg.batch_local, scfg.max_seq
    n = scfg.cluster_size
    kv_loc = max(1, cfg.n_kv_heads // scfg.heads_size)
    ms = scfg.heads_size * n
    period = len(cfg.block_pattern)
    G = cfg.n_layers // period

    def state_for(kind, lead):
        if kind == RWKV6:
            hd = cfg.rwkv_head_dim
            return rwkv6_state_init(B, cfg.d_model // hd // scfg.heads_size,
                                    hd, cfg.d_model, lead=lead, device=dev)
        if kind == RECURRENT:
            return rglru_state_init(B, (cfg.rglru_d_state or cfg.d_model)
                                    // ms, cfg.conv1d_width, lead=lead,
                                    device=dev)
        if cfg.mla is not None:
            k_shape = (S // n, B,
                       cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
            v_shape = (S // n, B, 1)
        else:
            span = min(cfg.sliding_window, S) if kind == ATTN_LOCAL else S
            k_shape = v_shape = (max(1, span // n), B * kv_loc,
                                 cfg.resolved_head_dim)
        return KVBlock(
            k=torch.zeros(lead + k_shape, dtype=torch.bfloat16, device=dev),
            v=torch.zeros(lead + v_shape, dtype=torch.bfloat16, device=dev),
            pos=torch.full(lead + k_shape[:1] + (B,), -1, dtype=torch.int32,
                           device=dev))

    state = {"cache_lens": torch.zeros((B,), dtype=torch.int32, device=dev),
             "sampling": init_sampling_state(B, dev),
             # each slot's positional noise by emit offset, written by the
             # admit in place (serving/sampling.py:gumbel_table)
             "gumbel": torch.zeros((B, S, CAND_K), dtype=torch.float32,
                                   device=dev),
             "layers": [state_for(kind, (G,)) for kind in cfg.block_pattern],
             "tail": [state_for(kind, ())
                      for kind in cfg.layer_kinds[G * period:]]}
    if scfg.check_finite:
        state["nonfinite"] = torch.zeros((B,), dtype=torch.int32, device=dev)
    if scfg.track_work:
        state["work_blocks"] = torch.zeros((B,), dtype=torch.int32,
                                           device=dev)
    if scfg.kv_fingerprint:
        # one int32 checksum per slot and cache entry (zeros, untouched,
        # for the recurrent kinds), parallel to "layers" and "tail"
        state["kv_fp"] = [torch.zeros((G, B), dtype=torch.int32, device=dev)
                          for _ in cfg.block_pattern]
        state["kv_fp_tail"] = [torch.zeros((B,), dtype=torch.int32,
                                           device=dev)
                               for _ in cfg.layer_kinds[G * period:]]
    if scfg.shadow_head:
        state["head_resid"] = torch.zeros((B, cfg.d_model),
                                          dtype=torch.bfloat16, device=dev)
        state["head_val"] = torch.zeros((B,), dtype=torch.float32,
                                        device=dev)
        state["head_tok"] = torch.zeros((B,), dtype=torch.int32, device=dev)
    if cfg.encoder is not None:
        shape = (cfg.n_layers, cfg.frontend.num_positions,
                 B * kv_loc, cfg.resolved_head_dim)
        state["enc_kv"] = {
            n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            for n in ("k", "v")}
    return state


def reset_decode_state(cfg: ModelConfig, scfg: ServeConfig,
                       state: Dict[str, Any]) -> Dict[str, Any]:
    """Put every leaf of ``state`` back, in place, to what
    :func:`init_decode_state` makes — zero caches, ``pos`` −1, zero
    checksums and flags — and return it.  The reference gets a fresh
    state by keeping the initial one (its steps return new trees); the
    port's steps write the caches in place, so a fresh start is this.
    A fresh state of one cache row is broadcast along the rows (every
    row starts alike; a full-size one would double the caches)."""
    def copy(dst, src):
        if torch.is_tensor(dst):
            dst.copy_(src)
        elif isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        else:                          # lists and named tuples
            for d, s in zip(dst, src):
                copy(d, s)

    copy(state, init_decode_state(
        cfg, dataclasses.replace(scfg, max_seq=1),
        device=state["cache_lens"].device))
    return state


def _finite_violations(cfg: ModelConfig, resid: torch.Tensor,
                       head_val: torch.Tensor, nxt: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """int32 ``[B]``: 1 where an ACTIVE slot's step output is corrupt —
    a non-finite residual row or head value, or a token outside
    ``[0, vocab)``.  Tensor arithmetic only, no host sync."""
    bad = ~torch.isfinite(resid.float()).all(dim=-1)
    bad |= ~torch.isfinite(head_val.float())
    bad |= (nxt < 0) | (nxt >= cfg.vocab_size)
    return (bad & active).to(torch.int32)


def _fused_ffn_tail(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
                    a: torch.Tensor, kernels: Kernels,
                    ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """Block tail in one B2 launch: ``x + a + FFN(rms(x + a, ln2))``
    (``add_r = 1`` on model rank 0, the residual folded into one rank's
    partial; 0 on the others), ``a`` first normed by ``post_ln1`` inside
    the kernel where the bundle has it; on a mesh the ranks' partials
    then meet in the tree ClusterReduce over the model axis
    (``psum_model`` where the axis is not a power of two).  With
    ``post_ln2`` (Gemma-2) the kernel adds no residual (``add_r = 0``)
    and the second add runs after it on its ``r``: ``r + rms(f,
    post_ln2)`` (``engine.py:339–373``)."""
    w: PackedFFNWeights = blk["ffn"]
    post2 = "post_ln2" in blk
    add_r = 0.0 if post2 or ctx.model_index() != 0 else 1.0
    o, r = kernels.ffn(x, a, w.w_in, w.w_gate, w.w_out, w.ln2,
                       post_ln1=w.post_ln1, add_r=add_r,
                       act=cfg.ffn_act, eps=cfg.norm_eps)
    n = ctx.model_size
    if ctx.model is not None:
        o = (ctx.psum_model(o) if n & (n - 1)
             else prim.cluster_reduce(o, ctx.model, "sum"))
    return r + post_norm(blk, "post_ln2", o, cfg.norm_eps) if post2 else o


def _merge_vocab_shards(ctx: ParallelCtx, v_loc: int, vals: torch.Tensor,
                        ids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's top-``CAND_K`` over its vocabulary shard → the whole
    vocabulary's on every rank: ids offset by the shard's first row, then
    the tree with the commutative ``topk_pair_merge`` (``engine.py:533–
    540``); the identity off a mesh."""
    if ctx.model is None:
        return vals, ids
    ids = ids + ctx.model_index() * v_loc
    return prim.cluster_reduce_pairs((vals, ids), ctx.model, topk_pair_merge)


def _fused_head_tail(cfg: ModelConfig, w: PackedHeadWeights, x: torch.Tensor,
                     kernels: Kernels, ctx: ParallelCtx = SINGLE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final norm + LM head + logit softcap + top-``CAND_K`` in one B3
    launch over the rank's vocabulary (``engine.py:497–540``)."""
    vals, ids = kernels.head(x, w.table, w.ln, eps=cfg.norm_eps,
                             logit_softcap=cfg.logit_softcap, k=CAND_K)
    return _merge_vocab_shards(ctx, w.table.shape[0], vals, ids)


def _loose_head_tail(cfg: ModelConfig, params: Dict[str, Any],
                     x: torch.Tensor, ctx: ParallelCtx = SINGLE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused head (``engine.py:664–672``): final norm, full f32
    logits of the rank's vocabulary, softcap, then the top-``CAND_K``
    candidates (``sampling.py:head_candidates``)."""
    xh = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = head_table(cfg, params)
    logits = softcap(lm_head_logits(table, xh), cfg.logit_softcap)
    return _merge_vocab_shards(ctx, table.shape[0],
                               *head_candidates(logits, CAND_K))


def _spec(ctx: ParallelCtx) -> Optional[ClusterSpec]:
    """The dataflow's axes (``engine.py:320``); None off a mesh."""
    if ctx.model is None:
        return None
    return ClusterSpec(heads=ctx.heads, cluster=ctx.cluster,
                       fused_combine=ctx.fused_combine)


def _tile(t: Optional[torch.Tensor], ctx: ParallelCtx, dim: int):
    """Cluster rank ``c``'s ``1/n`` slice ``c`` of ``t`` along ``dim`` (a
    view); ``t`` itself at cluster 1."""
    n = ctx.cluster_size
    if t is None or n == 1:
        return t
    w = t.shape[dim] // n
    return t.narrow(dim, ctx.cluster_index() * w, w)


def _split_token_weights(a: Dict[str, torch.Tensor],
                         ctx: ParallelCtx = SINGLE) -> SplitTokenWeights:
    """Train-layout attention → the unfused dataflow's weights
    (``engine.py:250–271``): the train layout already holds the rank's
    heads and head-dim segments; ``wo`` (``[q·hd, D]``, replicated over
    the cluster) gives the cluster rank's ``D/n`` column tile, a view.
    At cluster 1 this only names the train tensors."""
    return SplitTokenWeights(wq=a["wq"], wk=a["wk"], wv=a["wv"],
                             wo=_tile(a["wo"], ctx, -1),
                             bq=a.get("bq"), bk=a.get("bk"),
                             bv=a.get("bv"))


def _mla_weights(a: Dict[str, torch.Tensor],
                 ctx: ParallelCtx = SINGLE) -> MLAWeights:
    """Train-layout MLA → the unfused dataflow's weights (``engine.py:274–
    290``): the cluster rank's ``l/n`` latent slice of ``wuk`` (columns)
    and ``wuv`` (rows) and ``D/n`` column tile of ``wo``, views; at
    cluster 1 the train tensors themselves."""
    return MLAWeights(wq=a["wq"], wdkv=a["wdkv"], wuk=_tile(a["wuk"], ctx, -1),
                      wuv=_tile(a["wuv"], ctx, -2), wo=_tile(a["wo"], ctx, -1))


def hoist_serve_weights(params: Dict[str, Any],
                        ctx: ParallelCtx = SINGLE) -> Dict[str, Any]:
    """The per-step weight adapters, once per step outside the layer loop
    (``engine.py:303``): every train-layout attention block's ``attn``
    becomes :class:`SplitTokenWeights` or, for MLA, :class:`MLAWeights`
    (the rank's column tiles on a cluster across devices, the train
    tensors at cluster 1), in the groups and the tail; packed blocks,
    RG-LRU blocks and RWKV-6 blocks pass through."""
    def adapt(blk):
        a = blk.get("attn")
        if isinstance(a, dict) and "wk" in a:
            return dict(blk, attn=_split_token_weights(a, ctx))
        if isinstance(a, dict) and "wdkv" in a:
            return dict(blk, attn=_mla_weights(a, ctx))
        return blk

    return dict(params, blocks=[adapt(b) for b in params["blocks"]],
                tail=[adapt(b) for b in params["tail"]])


def decode_block(cfg: ModelConfig, kind: str, blk: Dict[str, Any],
                 x: torch.Tensor, cache, cache_lens: torch.Tensor, cos, sin,
                 kernels: Kernels = KERNELS, cross=None, enc_kv=None,
                 ctx: ParallelCtx = SINGLE,
                 appends: Optional[Dict[Any, AppendSlot]] = None
                 ) -> torch.Tensor:
    """One layer, ``x [B, D] → [B, D]``; the reference's ``decode_block``
    at cluster size 1.

    Prepacked attention: B1 (attention with its fused ``ln1`` and
    per-head output projection; on a local layer its window over the
    ring cache, and the attention softcap) — or B4 for MLA — with the
    cache append, then B2 (both residual adds and the FFN, with Gemma-2's
    ``post_ln1`` inside and ``post_ln2`` after it); a MoE block (whose FFN the
    pack leaves unbundled) falls through to ``x + a``, ``rms_norm(ln2)``
    and ``moe_apply``, as the reference does when the FFN is not packed.
    :class:`SplitTokenWeights` (the unfused ``"xla"`` path,
    ``engine.py:377–478``, after :func:`hoist_serve_weights`):
    ``rms_norm(ln1)``, :func:`split_token_attention` around B5,
    ``x + a``, ``rms_norm(ln2)``, the FFN (dense or MoE), ``x + f`` — on
    a ring cache for a local-attention layer, with the post-norms where
    the block has them (:func:`_ffn_tail`); :class:`MLAWeights` the
    same around the unfused :func:`mla_attention`.  The MoE branch is
    the reference's ``engine.py:437–448`` without ``dff_shard`` (A.5b): the
    slots' ``B`` tokens share one capacity.  RG-LRU (``engine.py:390–392``):
    ``rglru_block_step`` with its recurrence in one B6 launch in place of
    the attention, the same FFN tail; the layer's ``RGLRUState`` is
    updated in place (``h`` by the kernel, the conv tail by a copy).
    RWKV-6 (``engine.py:382–389``): the time mix with its recurrence in
    one B7 launch, then the channel mix; the layer's ``RWKV6State``
    ``cache`` is updated in place (``s`` by the kernel, the shift rows by
    a copy).  ``appends``: the step's append slots by (cache rows, ring)
    (:func:`_step_appends`; made per layer where not given)."""
    eps = cfg.norm_eps
    if kind == RWKV6:
        p = blk["rwkv"]
        a, _, st = rwkv6_step(p, rms_norm(x, blk["ln1"], eps),
                              cfg.rwkv_head_dim, cache, scan=kernels.wkv,
                              s_out=cache.s, ctx=ctx)
        x = x + a
        c, st = rwkv6_channel_step(p, rms_norm(x, blk["ln2"], eps), st, ctx)
        cache.x_prev_t.copy_(st.x_prev_t)
        cache.x_prev_c.copy_(st.x_prev_c)
        return x + c
    if kind == RECURRENT:
        a, st = rglru_block_step(blk["rglru"], rms_norm(x, blk["ln1"], eps),
                                 cache, scan=kernels.rglru, h_out=cache.h,
                                 ctx=ctx)
        cache.conv.copy_(st.conv)
        return _ffn_tail(cfg, blk, x, a, ctx=ctx)
    w = blk["attn"]
    window = _window(cfg, kind)
    spec = _spec(ctx)
    ap = (appends or {}).get((cache.k.shape[0], window > 0))
    if isinstance(w, PackedMLAWeights):
        a = mla_attention_packed(x, w, cache, cache_lens, cos, sin,
                                 nope_dim=cfg.mla.nope_head_dim,
                                 rope_dim=cfg.mla.rope_head_dim,
                                 norm_eps=eps, kernel=kernels.mla, spec=spec,
                                 ap=ap)
    elif isinstance(w, PackedSplitTokenWeights):
        a = split_token_attention_packed(x, w, cache, cache_lens, cos, sin,
                                         window=window,
                                         attn_softcap=cfg.attn_softcap,
                                         norm_eps=eps, kernel=kernels.decode,
                                         spec=spec, ap=ap)
    elif isinstance(w, MLAWeights):
        a = mla_attention(rms_norm(x, blk["ln1"], eps), w, cache,
                          cache_lens, cos, sin,
                          nope_dim=cfg.mla.nope_head_dim,
                          rope_dim=cfg.mla.rope_head_dim, spec=spec, ap=ap)
    else:
        a = split_token_attention(
            rms_norm(x, blk["ln1"], eps), w, cache, cache_lens, cos, sin,
            window=window, attn_softcap=cfg.attn_softcap, kernel=kernels.flash,
            spec=spec, ap=ap)
    if isinstance(blk["ffn"], PackedFFNWeights) and enc_kv is None:
        return _fused_ffn_tail(cfg, blk, x, a, kernels, ctx)
    return _ffn_tail(cfg, blk, x, a, cross, enc_kv, ctx)


def _ffn_tail(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
              a: torch.Tensor, cross=None, enc_kv=None,
              ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """The unfused block tail (``engine.py:430–452``): ``x + a`` (``a``
    normed by ``post_ln1`` first where the block has it), the
    cross-attention's ``x + ca`` where the layer has one,
    ``rms_norm(ln2)``, the FFN (dense or MoE), ``post_ln2`` on its
    output where the block has it, the second add."""
    eps = cfg.norm_eps
    x = x + post_norm(blk, "post_ln1", a, eps)
    if enc_kv is not None:
        x = x + _cross_decode(cross, x, enc_kv, cfg, ctx)
    f = block_ffn(cfg, blk["ffn"], rms_norm(x, blk["ln2"], eps), ctx)
    return x + post_norm(blk, "post_ln2", f, eps)


def _cross_decode(cross: Dict[str, Any], x: torch.Tensor, enc_kv,
                  cfg: ModelConfig, ctx: ParallelCtx = SINGLE
                  ) -> torch.Tensor:
    """Decoder cross-attention of ``x [B, D]`` against the layer's static
    encoder keys and values ``(k, v)``, ``[P, B·kv, hd]`` each
    (``engine.py:456–477``): ``rms_norm(ln)``, ``q = h·wq``, an f32
    softmax over all ``P`` frames, ``o·wo`` in the model dtype; on a mesh
    the rank's heads (``q``'s head-dim segments gathered over a cluster
    above 1; ``enc_kv`` holds whole heads), summed by ``psum_heads``."""
    p = cross["attn"]
    B = x.shape[0]
    q_loc, hd = p["wq"].shape[1], p["wq"].shape[2] * ctx.cluster_size
    h = rms_norm(x, cross["ln"], cfg.norm_eps)
    q = ctx.gather_cluster(torch.einsum("bd,dqh->bqh", h, p["wq"]), 2)
    k, v = enc_kv
    P = k.shape[0]
    kv_loc = k.shape[1] // B
    qg = q.reshape(B, kv_loc, q_loc // kv_loc, hd).float()
    kc = k.reshape(P, B, kv_loc, hd).float()
    vc = v.reshape(P, B, kv_loc, hd).float()
    s = torch.einsum("bkqh,pbkh->bkqp", qg, kc) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkqp,pbkh->bkqh", pr, vc).reshape(B, q_loc * hd)
    return ctx.psum_heads(o.to(x.dtype) @ p["wo"])


def _check_not_param_pair(params: Any, want: str) -> None:
    if isinstance(params, dict) and {"train", "serve"} <= params.keys():
        raise ValueError(
            "got the full {'train', 'serve'} param pair; pass "
            f"params[{want!r}] — decode_step consumes the serve layout, "
            "prefill the training layout")


def _layer(tree, g: int):
    """Layer ``g`` of a stacked block or state — dicts, NamedTuples,
    tensors — as views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(t, g) for t in tree))
    return None if tree is None else tree[g]


def _window(cfg: ModelConfig, kind: str) -> int:
    """The sliding window of a layer of ``kind`` (0: a linear cache)."""
    return cfg.sliding_window if kind == ATTN_LOCAL else 0


def _step_appends(cfg: ModelConfig, kinds, cache_lens: torch.Tensor,
                  spec: Optional[ClusterSpec]) -> Dict[Any, AppendSlot]:
    """This step's append slot (``core/dataflow.py:_append_slot``) for
    each kind of attention cache, keyed by (its rows, ring): it depends
    on ``cache_lens`` alone, so the step makes it once for every layer."""
    out: Dict[Any, AppendSlot] = {}
    for kind, cache in kinds:
        if isinstance(cache, KVBlock):
            window = _window(cfg, kind)
            key = (cache.k.shape[-3], window > 0)
            if key not in out:
                out[key] = _append_slot(spec, key[0], cache_lens,
                                        window=window)
    return out


def _appended_rows(cfg: ModelConfig, kind: str, cache,
                   appends: Dict[Any, AppendSlot]):
    """For an attention entry: ``(own [B], row [B], bit sum [G, B] of the
    rows before the step)`` — the rows this step's append overwrites on
    this rank (its :func:`_step_appends` slot; a ring on a local layer);
    ``None`` for a recurrent state."""
    if not isinstance(cache, KVBlock):
        return None
    ap = appends[(cache.k.shape[-3], _window(cfg, kind) > 0)]
    return ap.own, ap.local_slot, kv_rows_bitsum(cache, ap.local_slot)


# the KV block ``work_blocks`` counts in: the reference's default
# ``ServeConfig.block_s``, which its Pallas kernels tile by
WORK_BLOCK_S = 256


def _step_work(cfg: ModelConfig, kinds, cache_lens: torch.Tensor,
               rank: int = 0) -> torch.Tensor:
    """Per-slot attend-step count of one step, summed over the attention
    layers (``engine.py:583–592``): each block-pattern entry counts once
    per layer group, a tail entry once; ``rank`` is this process's
    cluster rank, whose shard's live span it counts."""
    G = cfg.n_layers // len(cfg.block_pattern)
    work = torch.zeros_like(cache_lens)
    for i, (kind, cache) in enumerate(kinds):
        if not isinstance(cache, KVBlock):
            continue
        window = (cfg.sliding_window if kind == ATTN_LOCAL
                  and cfg.mla is None else 0)
        s_blk = cache.k.shape[-3]
        n = live_attend_blocks(cache_lens, s_blk=s_blk,
                               block_s=_fit_block_s(s_blk, WORK_BLOCK_S),
                               rank=rank, window=window, ring=window > 0)
        work = work + n * (G if i < len(cfg.block_pattern) else 1)
    return work


def _fit_block_s(S: int, block_s: int) -> int:
    """The largest divisor of ``S`` not above ``block_s`` — ``S`` itself
    when that divisor is more than 8× smaller (the reference's
    ``dataflow.py:_fit_block_s``, which sizes its Pallas blocks)."""
    b = min(block_s, S)
    while b > 1 and S % b:
        b -= 1
    return b if b * 8 > min(block_s, S) else S


def decode_step(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens,
                *, kernels: Kernels = KERNELS, sampled: bool = False,
                ctx: ParallelCtx = SINGLE
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One ragged decode step: tokens ``[B]`` → ``(next tokens [B] int32,
    new state)``: the layer groups, then the tail layers
    (``engine.py:643–650``); with an encoder each layer also reads its
    ``cross_attn`` and its slice of ``state["enc_kv"]``.  The KV caches,
    their ``kv_fp`` checksums and the recurrent states are updated in
    place; ``cache_lens``, the sampling leaves and the other flags'
    leaves are new tensors in the returned dict.  The checksum update
    (``engine.py:678–693``) reads the rows each entry's append
    overwrites before the layers run and again after: the difference of
    their bit sums is the entry's change, for a linear append and a ring
    wrap alike — the reference's old/new delta, taken before the
    in-place append destroys the old rows.  ``sampled``: some live slot
    has temperature > 0 (the caller knows its requests), so the step
    draws from the candidates (``finalize_candidates`` with the slots'
    noise); otherwise every slot takes candidate 0, the same tokens
    with none of the sampler's arithmetic.  ``tokens`` already on the
    state's device is taken as is (no copy: a CUDA graph captures the
    step on a fixed token buffer).  ``ctx``: this rank's mesh axes (the
    rank's slots, tokens ``[B_loc]``); every rank of the model axis must
    run the step together."""
    _check_not_param_pair(params, "serve")
    params = hoist_serve_weights(params, ctx)
    cache_lens = state["cache_lens"]
    dev = cache_lens.device
    if not (torch.is_tensor(tokens) and tokens.device == dev):
        tokens = torch.as_tensor(tokens, device=dev)
    x = embed_tokens(cfg, params["embed"], tokens, ctx)
    cos = sin = None
    if not cfg.is_attention_free:
        # RoPE spans the head dim, or only MLA's rope part (64, not 128)
        rope_dim = (cfg.mla.rope_head_dim if cfg.mla is not None
                    else cfg.resolved_head_dim)
        cos, sin = rope_at(cache_lens, rope_dim, cfg.rope_theta)
    period = len(cfg.block_pattern)
    G = cfg.n_layers // period
    kinds = (list(zip(cfg.block_pattern, state["layers"]))
             + list(zip(cfg.layer_kinds[G * period:], state["tail"])))
    appends = _step_appends(cfg, kinds, cache_lens, _spec(ctx))
    rows = ([_appended_rows(cfg, kind, cache, appends)
             for kind, cache in kinds] if scfg.kv_fingerprint else [])
    enc = state.get("enc_kv")
    for g in range(G):
        for i, (kind, blk, caches) in enumerate(zip(
                cfg.block_pattern, params["blocks"], state["layers"])):
            cross = enc_kv = None
            if enc is not None:             # engine.py:600–637
                li = g * period + i
                cross = _layer(params["cross_attn"], li)
                enc_kv = (enc["k"][li], enc["v"][li])
            x = decode_block(cfg, kind, _layer(blk, g), x,
                             _layer(caches, g), cache_lens, cos, sin,
                             kernels, cross, enc_kv, ctx, appends)
    for kind, blk, cache in zip(cfg.layer_kinds[G * period:],
                                params["tail"], state["tail"]):
        x = decode_block(cfg, kind, blk, x, cache, cache_lens, cos, sin,
                         kernels, ctx=ctx, appends=appends)
    samp = state["sampling"]
    if isinstance(params.get("head"), PackedHeadWeights):
        cand_v, cand_i = _fused_head_tail(cfg, params["head"], x, kernels,
                                          ctx)
    else:
        cand_v, cand_i = _loose_head_tail(cfg, params, x, ctx)
    if sampled:
        gumbel = state["gumbel"]
        noise = gumbel[torch.arange(gumbel.shape[0], device=dev),
                       torch.clamp(samp["step"], 0, gumbel.shape[1] - 1)]
        nxt, head_val = finalize_candidates(cand_v, cand_i, samp, noise)
    else:
        nxt, head_val = greedy_candidates(cand_v, cand_i)
    new_state = dict(state)
    new_state["sampling"] = advance_sampling_step(samp, cache_lens >= 0)
    if scfg.check_finite:
        new_state["nonfinite"] = state["nonfinite"] + _finite_violations(
            cfg, x, head_val, nxt, cache_lens >= 0)
    if scfg.track_work:
        new_state["work_blocks"] = state["work_blocks"] + _step_work(
            cfg, kinds, cache_lens, ctx.cluster_index())
    if scfg.kv_fingerprint:
        for (kind, cache), entry, fp in zip(
                kinds, rows, state["kv_fp"] + state["kv_fp_tail"]):
            if entry is not None:
                own, idx, before = entry
                delta = kv_rows_bitsum(cache, idx) - before
                fp.copy_(wrap_i32(fp.to(torch.int64) + torch.where(
                    own, delta, torch.zeros_like(delta))))
    if scfg.shadow_head:
        # the atomic (residual, winning logit, token) triple per slot
        new_state["head_resid"] = x.to(torch.bfloat16)
        new_state["head_val"] = head_val.float()
        new_state["head_tok"] = nxt
    new_state["cache_lens"] = torch.where(cache_lens >= 0, cache_lens + 1,
                                          cache_lens)
    return nxt, new_state
