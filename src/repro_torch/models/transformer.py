"""Model assembly — the port of ``repro/models/transformer.py`` for dense
attention decoders and RWKV-6 on one device.

The reference's ``ParallelCtx`` (``repro/models/ctx.py``) is dropped:
on one GPU the model axis is 1 and every collective it wraps is the
identity, so the port's functions take no context argument.

Parameter tree (the train layout; leaves are tensors):

* ``embed [V, D]``, ``lm_head [V, D]`` (model dtype), ``final_norm [D]``
  (f32);
* ``blocks``: one dict per block-pattern position with the layer-group
  axis leading, as the reference's scanned groups: ``ln1``/``ln2
  [G, D]`` f32, ``attn`` = ``wq [G, D, q, hd]``, ``wk``/``wv
  [G, D, kv, hd]``, ``wo [G, q·hd, D]`` — or, for MLA, ``wq [G, D, q,
  nope+rope]``, ``wdkv [G, D, l+rope]``, ``wuk [G, q, nope, l]``, ``wuv
  [G, q, l, v]``, ``wo [G, q·v, D]``; ``ffn`` = ``w_in``/``w_gate
  [G, D, F]``, ``w_out [G, F, D]``; an RWKV-6 block holds ``ln1``,
  ``ln2`` and ``rwkv`` (the ``RWKV6Params`` fields, ``models/rwkv6.py``,
  each with the group axis leading) and no ``attn`` or ``ffn``.  The
  reference's ``tail`` list (layers past the last whole group) is always
  empty for the one-kind patterns the port runs, so the port has none.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      RWKV6, ModelConfig)
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (embed_lookup, ffn_apply, rms_norm,
                                       seeded_normal)


def _check_supported(cfg: ModelConfig) -> None:
    """The port runs global-attention decoders with dense FFNs: GQA/MHA
    (Llama-style) or MLA (the dense-MLA arm of DeepSeek-V2-Lite) — and
    the all-RWKV-6 pattern (RWKV-6 3B).  RG-LRU and local-attention
    blocks, MoE, encoders and frontends are later slices (ROADMAP.md)."""
    kinds = set(cfg.layer_kinds)
    if RECURRENT in kinds:
        raise NotImplementedError(
            f"{cfg.name}: RG-LRU blocks are ROADMAP item 15b (after the "
            "Gemma-2 features of item 10)")
    if ATTN_LOCAL in kinds:
        raise NotImplementedError(
            f"{cfg.name}: local attention and ring caches are ROADMAP "
            "item 10")
    if RWKV6 in kinds:
        if (cfg.block_pattern != (RWKV6,) or cfg.encoder or cfg.frontend
                or cfg.tie_embeddings or cfg.use_post_norm or cfg.moe):
            raise NotImplementedError(
                f"{cfg.name}: the port runs RWKV-6 as the only block kind, "
                "with an untied head (ROADMAP.md item 15a)")
        return
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE is ROADMAP item 13; serve the dense arm, "
            "dataclasses.replace(cfg, moe=None)")
    if (any(k != ATTN_GLOBAL for k in cfg.layer_kinds) or cfg.encoder
            or cfg.frontend or cfg.use_post_norm or cfg.tie_embeddings
            or cfg.qkv_bias):
        raise NotImplementedError(
            f"{cfg.name}: the port runs global-attention decoders only "
            "(window/ring, softcap, post-norm, tied embeddings, bias, "
            "encoders and recurrent blocks are later slices)")


# ---------------------------------------------------------------------------
# Seeded init (the scales of repro's init_logical_block)
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random train-layout params made on ``device`` from ``seed``.

    The scales are the reference's (``init_logical_block``): 1/√D for
    the q/k/v and up/gate projections, 1/√(q·hd) for ``wo``, 1/√F for
    the down projection, 0.02 for the embedding, 1/√D for the LM head,
    zero norm scales — so many random layers stay finite.  MLA: 1/√D
    for ``wq`` and ``wdkv``, 0.05 for ``wuk`` and ``wuv``, 1/√(q·v) for
    ``wo`` (``transformer.py:94–107``).  RWKV-6: ``rwkv6_init``'s scales
    per layer, zero ``ln1``/``ln2``, an untied ``lm_head``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    L, nq, nkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale):
        return seeded_normal(gen, shape, scale, dtype)

    s_in = 1.0 / math.sqrt(d)
    if cfg.block_pattern == (RWKV6,):
        blk = {"ln1": torch.zeros((L, d), device=dev),
               "ln2": torch.zeros((L, d), device=dev),
               "rwkv": rwkv_mod.rwkv6_init(
                   gen, d, cfg.rwkv_head_dim, d // cfg.rwkv_head_dim, F,
                   lead=(L,), dtype=dtype)}
        return {"embed": dense((cfg.vocab_size, d), 0.02),
                "lm_head": dense((cfg.vocab_size, d), s_in),
                "final_norm": torch.zeros((d,), device=dev),
                "blocks": [blk]}
    if cfg.mla is not None:
        m = cfg.mla
        attn = {
            "wq": dense((L, d, nq, m.nope_head_dim + m.rope_head_dim), s_in),
            "wdkv": dense((L, d, m.kv_lora_rank + m.rope_head_dim), s_in),
            "wuk": dense((L, nq, m.nope_head_dim, m.kv_lora_rank), 0.05),
            "wuv": dense((L, nq, m.kv_lora_rank, m.v_head_dim), 0.05),
            "wo": dense((L, nq * m.v_head_dim, d),
                        1.0 / math.sqrt(nq * m.v_head_dim)),
        }
    else:
        attn = {
            "wq": dense((L, d, nq, hd), s_in),
            "wk": dense((L, d, nkv, hd), s_in),
            "wv": dense((L, d, nkv, hd), s_in),
            "wo": dense((L, nq * hd, d), 1.0 / math.sqrt(nq * hd)),
        }
    blk = {
        "ln1": torch.zeros((L, d), device=dev),
        "ln2": torch.zeros((L, d), device=dev),
        "attn": attn,
        "ffn": {
            "w_in": dense((L, d, F), s_in),
            "w_gate": dense((L, d, F), s_in),
            "w_out": dense((L, F, d), 1.0 / math.sqrt(F)),
        },
    }
    return {
        "embed": dense((cfg.vocab_size, d), 0.02),
        "lm_head": dense((cfg.vocab_size, d), s_in),
        "final_norm": torch.zeros((d,), device=dev),
        "blocks": [blk],
    }


# ---------------------------------------------------------------------------
# Carrying the reference's weights across
# ---------------------------------------------------------------------------
def _leaf_to_torch(arr, device) -> torch.Tensor:
    """numpy leaf → torch tensor; bf16 arrives through an int16 view so
    no ``ml_dtypes`` import is needed."""
    arr = np.array(arr)                     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_reference_params(cfg: ModelConfig, tree: Dict[str, Any], *,
                          device="cuda") -> Dict[str, Any]:
    """The JAX package's device-major train params at model size 1 —
    as nested dicts / lists of numpy arrays, NamedTuple fields
    (``AttnParams``, ``MLAAttnParams``, …) turned into dict keys and the
    leading device axis (size 1) kept — → the
    port's train params (same tree, device axis stripped)."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node.shape[0] != 1:
            raise ValueError(
                f"expected a leading model axis of size 1, got {node.shape}")
        return _leaf_to_torch(node[0], dev)

    if tree.get("tail"):
        raise NotImplementedError("reference params with tail layers")
    out = conv({k: tree[k] for k in ("embed", "lm_head", "final_norm",
                                     "blocks")})
    out["embed"] = out["embed"][:cfg.vocab_size]
    out["lm_head"] = out["lm_head"][:cfg.vocab_size]
    return out


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def layer_params(params: Dict[str, Any], cfg: ModelConfig
                 ) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked block tree, in layer order."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    out: List[Dict[str, Any]] = []

    def pick(node, g):
        if isinstance(node, dict):
            return {k: pick(v, g) for k, v in node.items()}
        return node[g]

    for g in range(n_groups):
        for p in range(period):
            out.append(pick(params["blocks"][p], g))
    return out


def apply_block(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor, *,
                return_kv: bool = False):
    """One layer of the train-path forward.  With ``return_kv`` the
    second result is what prefill caches: ``(k, v)`` of GQA attention,
    or MLA's latent entries ``[B, S, l + rope]`` (None for RWKV-6, whose
    prefill state comes from ``serving/prefill.py``)."""
    eps = cfg.norm_eps
    if "rwkv" in blk:                  # transformer.py:473–479
        return rwkv_mod.rwkv6_block(blk["rwkv"], x, cfg.rwkv_head_dim,
                                    blk["ln1"], blk["ln2"], eps), None
    h = rms_norm(x, blk["ln1"], eps)
    if cfg.mla is not None:
        a, kv = attn_mod.mla_attention_train(blk["attn"], h, cfg,
                                             return_kv=return_kv)
    else:
        a, kv = attn_mod.attention_train(blk["attn"], h, cfg, ATTN_GLOBAL,
                                         return_kv=return_kv)
    x = x + a
    h = rms_norm(x, blk["ln2"], eps)
    return x + ffn_apply(blk["ffn"], h, cfg.ffn_act), kv


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor
            ) -> torch.Tensor:
    """Tokens [B, S] → final normed hidden states [B, S, D]."""
    x = embed_lookup(params["embed"], tokens)
    for blk in layer_params(params, cfg):
        x, _ = apply_block(cfg, blk, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
