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
``L`` kernel calls a step.

On RWKV-6 a step is the embedding, then per layer the reference's
``rwkv6_step`` + ``rwkv6_channel_step`` in plain torch around one B7
launch (``rwkv6_scan`` at ``S = 1``, the WKV recurrence), then the head
— B3 on ``"pallas"``, the loose head on ``"xla"`` (``"auto"``'s choice
for an attention-free model): ``L + 1`` or ``L`` kernel calls.  Its
per-slot state is the recurrence's f32 matrix and the two shift rows of
every layer, not a KV cache; it is served lockstep
(``launch/serve.py:generate``) and does not mask free slots, as the
reference does not.

RecurrentGemma serves on ``"xla"`` only (``"pallas"`` raises, ROADMAP
item 10): the embedding times ``√d_model`` (tied embeddings), then per
RG-LRU layer the reference's ``rglru_block_step`` in plain torch around
one B6 launch (``rglru_scan`` at ``S = 1``) and the FFN, per local
attention layer the unfused layer above on a ring cache of
``min(window, max_seq)`` rows, the ``tail`` layers after the groups,
and the loose head on the embedding table: ``L`` kernel calls.  Its
RG-LRU state is ``h`` and the conv tail of every recurrent layer; it is
served lockstep like RWKV-6.

Decode is ragged on attention models: ``state["cache_lens"] [B]`` lets
every slot advance on its own, and ``−1`` marks a free slot (no KV
write, no attention work, frozen position).  The KV caches and the
RWKV-6 states in ``state`` are updated IN PLACE (the reference rebuilt
them): a state passed to :func:`decode_step` or to ``prefill`` shares
those tensors with the state returned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, RWKV6, ModelConfig
from repro_torch.core.dataflow import (KVBlock, PackedFFNWeights,
                                       PackedHeadWeights, PackedMLAWeights,
                                       PackedSplitTokenWeights,
                                       SplitTokenWeights,
                                       mla_attention_packed,
                                       split_token_attention,
                                       split_token_attention_packed)
from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_decode.flash_decode import (
    flash_decode_attention, flash_decode_plain)
from repro_torch.kernels.fused_decode.fused_decode import (
    fused_decode_attention, fused_decode_plain, rope_at)
from repro_torch.kernels.fused_ffn.fused_ffn import (fused_ffn_block,
                                                     fused_ffn_plain)
from repro_torch.kernels.fused_head.fused_head import (fused_head_block,
                                                       fused_head_plain)
from repro_torch.kernels.fused_mla_decode.fused_mla_decode import (
    fused_mla_decode_attention, fused_mla_decode_plain)
from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_scan,
                                                       rglru_scan_plain)
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (rwkv6_scan,
                                                       rwkv6_scan_plain)
from repro_torch.models.layers import (ffn_apply, lm_head_logits, rms_norm,
                                       softcap)
from repro_torch.models.rglru import rglru_block_step, rglru_state_init
from repro_torch.models.rwkv6 import (rwkv6_channel_step, rwkv6_state_init,
                                      rwkv6_step)
from repro_torch.models.transformer import embed_tokens, head_table
from repro_torch.serving.sampling import (CAND_K, advance_sampling_step,
                                          finalize_candidates,
                                          head_candidates,
                                          init_sampling_state)


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int                   # cache capacity (positions)
    batch_local: int               # slots
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


@dataclass(frozen=True)
class EngineOptions:
    """Construction options for ``launch/serve.py:build_engine_full``, with
    the reference's defaults: ``backend`` ``"xla"`` | ``"pallas"`` |
    ``"auto"`` and ``prepack`` ``"auto"`` | ``"on"`` | ``"off"``
    (``core/autotune.py``); ``check_finite`` adds the per-slot sentinel
    (:class:`ServeConfig`)."""
    backend: str = "xla"
    prepack: Any = "auto"
    check_finite: bool = False


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
    and per block-pattern position one state stacked over the layer
    groups (``engine.py:143–220``): a :class:`KVBlock` ``k``/``v [G, S,
    B·kv, hd]`` bf16, ``pos [G, S, B]`` with ``S = max_seq``, or ``S =
    min(window, max_seq)`` ring rows on a local-attention layer — for MLA
    the latent cache ``k [G, S, B, l+rope]``, ``v [G, S, B, 1]``; for
    RWKV-6 an ``RWKV6State``, ``s [G, B, H, hd, hd]`` f32 and
    ``x_prev_t``/``x_prev_c [G, B, D]`` bf16; for RG-LRU an
    ``RGLRUState``, ``h [G, B, C]`` and ``conv [G, B, width − 1, C]`` f32.
    ``tail``: one unstacked state per tail layer."""
    dev = resolve_device(device)
    B, S = scfg.batch_local, scfg.max_seq
    period = len(cfg.block_pattern)
    G = cfg.n_layers // period

    def state_for(kind, lead):
        if kind == RWKV6:
            hd = cfg.rwkv_head_dim
            return rwkv6_state_init(B, cfg.d_model // hd, hd, cfg.d_model,
                                    lead=lead, device=dev)
        if kind == RECURRENT:
            return rglru_state_init(B, cfg.rglru_d_state or cfg.d_model,
                                    cfg.conv1d_width, lead=lead, device=dev)
        if cfg.mla is not None:
            k_shape = (S, B, cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
            v_shape = (S, B, 1)
        else:
            span = min(cfg.sliding_window, S) if kind == ATTN_LOCAL else S
            k_shape = v_shape = (span, B * cfg.n_kv_heads,
                                 cfg.resolved_head_dim)
        return KVBlock(
            k=torch.zeros(lead + k_shape, dtype=torch.bfloat16, device=dev),
            v=torch.zeros(lead + v_shape, dtype=torch.bfloat16, device=dev),
            pos=torch.full(lead + k_shape[:1] + (B,), -1, dtype=torch.int32,
                           device=dev))

    state = {"cache_lens": torch.zeros((B,), dtype=torch.int32, device=dev),
             "sampling": init_sampling_state(B, dev),
             "layers": [state_for(kind, (G,)) for kind in cfg.block_pattern],
             "tail": [state_for(kind, ())
                      for kind in cfg.layer_kinds[G * period:]]}
    if scfg.check_finite:
        state["nonfinite"] = torch.zeros((B,), dtype=torch.int32, device=dev)
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


def _fused_ffn_tail(cfg: ModelConfig, w: PackedFFNWeights, x: torch.Tensor,
                    a: torch.Tensor, kernels: Kernels) -> torch.Tensor:
    """Block tail in one B2 launch: ``x + a + FFN(rms(x + a, ln2))``
    (``add_r = 1`` on the single rank)."""
    o, _ = kernels.ffn(x, a, w.w_in, w.w_gate, w.w_out, w.ln2, add_r=1.0,
                       act=cfg.ffn_act, eps=cfg.norm_eps)
    return o


def _fused_head_tail(cfg: ModelConfig, w: PackedHeadWeights, x: torch.Tensor,
                     kernels: Kernels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final norm + LM head + top-``CAND_K`` in one B3 launch."""
    return kernels.head(x, w.table, w.ln, eps=cfg.norm_eps, k=CAND_K)


def _loose_head_tail(cfg: ModelConfig, params: Dict[str, Any],
                     x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused head (``engine.py:664–672``): final norm, full f32
    logits, softcap, then the top-``CAND_K`` candidates."""
    xh = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = softcap(lm_head_logits(head_table(cfg, params), xh),
                     cfg.logit_softcap)
    return head_candidates(logits, CAND_K)


def _split_token_weights(a: Dict[str, torch.Tensor]) -> SplitTokenWeights:
    """Train-layout attention → the unfused dataflow's weights
    (``engine.py:250``): at cluster size 1 every rank slice is the whole
    tensor, so this only names the train tensors (no copy)."""
    return SplitTokenWeights(wq=a["wq"], wk=a["wk"], wv=a["wv"], wo=a["wo"],
                             bq=a.get("bq"), bk=a.get("bk"),
                             bv=a.get("bv"))


def hoist_serve_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """The per-step weight adapters, once per step outside the layer loop
    (``engine.py:303``): every train-layout attention block's ``attn``
    becomes :class:`SplitTokenWeights` (the identity at cluster 1), in
    the groups and the tail; packed blocks, MLA blocks, RG-LRU blocks and
    RWKV-6 blocks pass through."""
    def adapt(blk):
        a = blk.get("attn")
        if isinstance(a, dict) and "wk" in a:
            return dict(blk, attn=_split_token_weights(a))
        return blk

    return dict(params, blocks=[adapt(b) for b in params["blocks"]],
                tail=[adapt(b) for b in params["tail"]])


def decode_block(cfg: ModelConfig, kind: str, blk: Dict[str, Any],
                 x: torch.Tensor, cache, cache_lens: torch.Tensor, cos, sin,
                 kernels: Kernels = KERNELS) -> torch.Tensor:
    """One layer, ``x [B, D] → [B, D]``; the reference's ``decode_block``
    at cluster size 1.

    Prepacked attention: B1 (attention with its fused ``ln1`` and
    per-head output projection) — or B4 for MLA — with the cache append,
    then B2 (both residual adds and the FFN).  :class:`SplitTokenWeights`
    (the unfused ``"xla"`` path, ``engine.py:377–478``, after
    :func:`hoist_serve_weights`):
    ``rms_norm(ln1)``, :func:`split_token_attention` around B5,
    ``x + a``, ``rms_norm(ln2)``, ``ffn_apply``, ``x + f`` — on a ring
    cache for a local-attention layer.  RG-LRU (``engine.py:390–392``):
    ``rglru_block_step`` with its recurrence in one B6 launch in place of
    the attention, the same FFN tail; the layer's ``RGLRUState`` is
    updated in place (``h`` by the kernel, the conv tail by a copy).
    RWKV-6 (``engine.py:382–389``): the time mix with its recurrence in
    one B7 launch, then the channel mix; the layer's ``RWKV6State``
    ``cache`` is updated in place (``s`` by the kernel, the shift rows by
    a copy)."""
    eps = cfg.norm_eps
    if kind == RWKV6:
        p = blk["rwkv"]
        a, _, st = rwkv6_step(p, rms_norm(x, blk["ln1"], eps),
                              cfg.rwkv_head_dim, cache, scan=kernels.wkv,
                              s_out=cache.s)
        x = x + a
        c, st = rwkv6_channel_step(p, rms_norm(x, blk["ln2"], eps), st)
        cache.x_prev_t.copy_(st.x_prev_t)
        cache.x_prev_c.copy_(st.x_prev_c)
        return x + c
    if kind == RECURRENT:
        a, st = rglru_block_step(blk["rglru"], rms_norm(x, blk["ln1"], eps),
                                 cache, scan=kernels.rglru, h_out=cache.h)
        cache.conv.copy_(st.conv)
        x = x + a
        return x + ffn_apply(blk["ffn"], rms_norm(x, blk["ln2"], eps),
                             cfg.ffn_act)
    w = blk["attn"]
    if isinstance(w, PackedMLAWeights):
        a = mla_attention_packed(x, w, cache, cache_lens, cos, sin,
                                 nope_dim=cfg.mla.nope_head_dim,
                                 rope_dim=cfg.mla.rope_head_dim,
                                 norm_eps=eps, kernel=kernels.mla)
        return _fused_ffn_tail(cfg, blk["ffn"], x, a, kernels)
    if isinstance(w, PackedSplitTokenWeights):
        a = split_token_attention_packed(x, w, cache, cache_lens, cos, sin,
                                         norm_eps=eps, kernel=kernels.decode)
        return _fused_ffn_tail(cfg, blk["ffn"], x, a, kernels)
    if cfg.mla is not None:
        raise NotImplementedError(
            "the XLA-backend MLA path (train-layout MLA weights) is ROADMAP "
            "item 4b")
    a = split_token_attention(
        rms_norm(x, blk["ln1"], eps), w, cache, cache_lens, cos, sin,
        window=cfg.sliding_window if kind == ATTN_LOCAL else 0,
        attn_softcap=cfg.attn_softcap, kernel=kernels.flash)
    x = x + a
    return x + ffn_apply(blk["ffn"], rms_norm(x, blk["ln2"], eps),
                         cfg.ffn_act)


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


def decode_step(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens,
                *, kernels: Kernels = KERNELS
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One ragged decode step: tokens ``[B]`` → ``(next tokens [B] int32,
    new state)``: the layer groups, then the tail layers
    (``engine.py:643–650``).  The KV caches and recurrent states are
    updated in place; ``cache_lens`` and the sampling leaves are new
    tensors in the returned dict."""
    _check_not_param_pair(params, "serve")
    params = hoist_serve_weights(params)
    cache_lens = state["cache_lens"]
    dev = cache_lens.device
    tokens = torch.as_tensor(tokens, device=dev)
    x = embed_tokens(cfg, params["embed"], tokens)
    cos = sin = None
    if not cfg.is_attention_free:
        # RoPE spans the head dim, or only MLA's rope part (64, not 128)
        rope_dim = (cfg.mla.rope_head_dim if cfg.mla is not None
                    else cfg.resolved_head_dim)
        cos, sin = rope_at(cache_lens, rope_dim, cfg.rope_theta)
    period = len(cfg.block_pattern)
    G = cfg.n_layers // period
    for g in range(G):
        for kind, blk, caches in zip(cfg.block_pattern, params["blocks"],
                                     state["layers"]):
            x = decode_block(cfg, kind, _layer(blk, g), x,
                             _layer(caches, g), cache_lens, cos, sin,
                             kernels)
    for kind, blk, cache in zip(cfg.layer_kinds[G * period:],
                                params["tail"], state["tail"]):
        x = decode_block(cfg, kind, blk, x, cache, cache_lens, cos, sin,
                         kernels)
    samp = state["sampling"]
    if isinstance(params.get("head"), PackedHeadWeights):
        cand_v, cand_i = _fused_head_tail(cfg, params["head"], x, kernels)
    else:
        cand_v, cand_i = _loose_head_tail(cfg, params, x)
    nxt, head_val = finalize_candidates(cand_v, cand_i, samp)
    new_state = dict(state)
    new_state["sampling"] = advance_sampling_step(samp, cache_lens >= 0)
    if scfg.check_finite:
        new_state["nonfinite"] = state["nonfinite"] + _finite_violations(
            cfg, x, head_val, nxt, cache_lens >= 0)
    new_state["cache_lens"] = torch.where(cache_lens >= 0, cache_lens + 1,
                                          cache_lens)
    return nxt, new_state
