"""Decode engine — the port of ``repro/serving/engine.py`` for the fused,
prepacked path on one GPU.

One decode step is the embedding, then per layer the attention kernel
— B1 (``fused_decode``, with its fused ``ln1`` and per-head output
projection) or, for MLA, B4 (``fused_mla_decode``, with its fused ``ln1``
and the folded ``W_UV·W_O`` projection) — and the B2 kernel
(``fused_ffn``, the block tail), then the B3 kernel (``fused_head``,
final norm + LM head + top-k): ``2·L + 1`` kernel calls.  Plain torch
runs only where the reference ran XLA ops: the embedding, ``rope_at``,
the KV append, the normalize-and-head sum, the greedy finalize and the
``cache_lens`` update.

Decode is ragged: ``state["cache_lens"] [B]`` lets every slot advance on
its own, and ``−1`` marks a free slot (no KV write, no attention work,
frozen position).  The KV caches in ``state`` are updated IN PLACE (the
reference rebuilt them): a state passed to :func:`decode_step` or to
``prefill`` shares its cache tensors with the state returned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dataflow import (KVBlock, PackedFFNWeights,
                                       PackedHeadWeights,
                                       mla_attention_packed,
                                       split_token_attention_packed)
from repro_torch.core.device import resolve_device
from repro_torch.kernels.fused_decode.fused_decode import (
    fused_decode_attention, fused_decode_plain, rope_at)
from repro_torch.kernels.fused_ffn.fused_ffn import (fused_ffn_block,
                                                     fused_ffn_plain)
from repro_torch.kernels.fused_head.fused_head import (fused_head_block,
                                                       fused_head_plain)
from repro_torch.kernels.fused_mla_decode.fused_mla_decode import (
    fused_mla_decode_attention, fused_mla_decode_plain)
from repro_torch.models.layers import embed_lookup
from repro_torch.serving.sampling import (CAND_K, advance_sampling_step,
                                          finalize_candidates,
                                          init_sampling_state)


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int                   # cache capacity (positions)
    batch_local: int               # slots
    # per-slot integrity sentinel: state["nonfinite"] counts, per slot,
    # the steps whose residual row or head value was non-finite or whose
    # token fell outside [0, vocab) (the reference's check_finite)
    check_finite: bool = False


@dataclass(frozen=True)
class EngineOptions:
    """Construction options for ``launch/serve.py:build_engine_full``:
    ``check_finite`` adds the per-slot sentinel (:class:`ServeConfig`)."""
    check_finite: bool = False


class Kernels(NamedTuple):
    """The B1–B4 entry points a decode step calls (``decode`` for GQA
    attention, ``mla`` for MLA).  ``PLAIN_KERNELS`` holds the kernels
    against their plain versions end to end on the card
    (``chip_smoke.py``); the wrappers take the plain versions on the CPU
    anyway."""
    decode: Callable
    ffn: Callable
    head: Callable
    mla: Callable


KERNELS = Kernels(fused_decode_attention, fused_ffn_block, fused_head_block,
                  fused_mla_decode_attention)
PLAIN_KERNELS = Kernels(fused_decode_plain, fused_ffn_plain, fused_head_plain,
                        fused_mla_decode_plain)


def init_decode_state(cfg: ModelConfig, scfg: ServeConfig, *,
                      device="cuda") -> Dict[str, Any]:
    """``cache_lens [B]`` (0: a fresh lockstep batch), the sampling leaves,
    and per block-pattern position one :class:`KVBlock` stacked over the
    layer groups: ``k``/``v [G, S, B·kv, hd]`` bf16, ``pos [G, S, B]`` —
    for MLA the latent cache ``k [G, S, B, l+rope]``, ``v [G, S, B, 1]``
    (``engine.py:153–157``)."""
    dev = resolve_device(device)
    B, S = scfg.batch_local, scfg.max_seq
    G = cfg.n_layers // len(cfg.block_pattern)
    if cfg.mla is not None:
        k_shape = (G, S, B, cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
        v_shape = (G, S, B, 1)
    else:
        k_shape = v_shape = (G, S, B * cfg.n_kv_heads, cfg.resolved_head_dim)

    def cache():
        return KVBlock(
            k=torch.zeros(k_shape, dtype=torch.bfloat16, device=dev),
            v=torch.zeros(v_shape, dtype=torch.bfloat16, device=dev),
            pos=torch.full((G, S, B), -1, dtype=torch.int32, device=dev))

    state = {"cache_lens": torch.zeros((B,), dtype=torch.int32, device=dev),
             "sampling": init_sampling_state(B, dev),
             "layers": [cache() for _ in cfg.block_pattern]}
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


def decode_block(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
                 cache: KVBlock, cache_lens: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, kernels: Kernels = KERNELS
                 ) -> torch.Tensor:
    """One attention layer, ``x [B, D] → [B, D]``: B1 (attention with its
    fused ``ln1`` and per-head output projection) — or B4 for MLA — with
    the cache append, then B2 (both residual adds and the FFN).  The
    reference's ``decode_block`` on the prepacked path at cluster size
    1."""
    if cfg.mla is not None:
        a = mla_attention_packed(x, blk["attn"], cache, cache_lens, cos, sin,
                                 nope_dim=cfg.mla.nope_head_dim,
                                 rope_dim=cfg.mla.rope_head_dim,
                                 norm_eps=cfg.norm_eps, kernel=kernels.mla)
    else:
        a = split_token_attention_packed(x, blk["attn"], cache, cache_lens,
                                         cos, sin, norm_eps=cfg.norm_eps,
                                         kernel=kernels.decode)
    return _fused_ffn_tail(cfg, blk["ffn"], x, a, kernels)


def _check_not_param_pair(params: Any, want: str) -> None:
    if isinstance(params, dict) and {"train", "serve"} <= params.keys():
        raise ValueError(
            "got the full {'train', 'serve'} param pair; pass "
            f"params[{want!r}] — decode_step consumes the serve layout, "
            "prefill the training layout")


def _layer(tree, g: int):
    """Layer ``g`` of a stacked NamedTuple bundle (views, no copies)."""
    return type(tree)(*(None if t is None else t[g] for t in tree))


def decode_step(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
                state: Dict[str, Any], tokens,
                *, kernels: Kernels = KERNELS
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One ragged decode step: tokens ``[B]`` → ``(next tokens [B] int32,
    new state)``.  The KV caches are updated in place; ``cache_lens`` and
    the sampling leaves are new tensors in the returned dict."""
    _check_not_param_pair(params, "serve")
    cache_lens = state["cache_lens"]
    dev = cache_lens.device
    tokens = torch.as_tensor(tokens, device=dev)
    x = embed_lookup(params["embed"], tokens)
    # RoPE spans the head dim, or only MLA's rope part (64, not head_dim)
    rope_dim = (cfg.mla.rope_head_dim if cfg.mla is not None
                else cfg.resolved_head_dim)
    cos, sin = rope_at(cache_lens, rope_dim, cfg.rope_theta)
    for g in range(cfg.n_layers // len(cfg.block_pattern)):
        for blk, caches in zip(params["blocks"], state["layers"]):
            layer = {"attn": _layer(blk["attn"], g),
                     "ffn": _layer(blk["ffn"], g)}
            x = decode_block(cfg, layer, x, _layer(caches, g), cache_lens,
                             cos, sin, kernels)
    samp = state["sampling"]
    cand_v, cand_i = _fused_head_tail(cfg, params["head"], x, kernels)
    nxt, head_val = finalize_candidates(cand_v, cand_i, samp)
    new_state = dict(state)
    new_state["sampling"] = advance_sampling_step(samp, cache_lens >= 0)
    if scfg.check_finite:
        new_state["nonfinite"] = state["nonfinite"] + _finite_violations(
            cfg, x, head_val, nxt, cache_lens >= 0)
    new_state["cache_lens"] = torch.where(cache_lens >= 0, cache_lens + 1,
                                          cache_lens)
    return nxt, new_state
