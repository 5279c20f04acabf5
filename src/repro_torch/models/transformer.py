"""Model assembly — the port of ``repro/models/transformer.py`` for dense
attention decoders on one device.

The reference's ``ParallelCtx`` (``repro/models/ctx.py``) is dropped:
on one GPU the model axis is 1 and every collective it wraps is the
identity, so the port's functions take no context argument.

Parameter tree (the train layout; leaves are tensors):

* ``embed [V, D]``, ``lm_head [V, D]`` (model dtype), ``final_norm [D]``
  (f32);
* ``blocks``: one dict per block-pattern position with the layer-group
  axis leading, as the reference's scanned groups: ``ln1``/``ln2
  [G, D]`` f32, ``attn`` = ``wq [G, D, q, hd]``, ``wk``/``wv
  [G, D, kv, hd]``, ``wo [G, q·hd, D]``; ``ffn`` = ``w_in``/``w_gate
  [G, D, F]``, ``w_out [G, F, D]``.  The reference's ``tail`` list (layers
  past the last whole group) is always empty for the one-kind pattern
  this slice runs, so the port has none.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (embed_lookup, ffn_apply, rms_norm)


def _check_supported(cfg: ModelConfig) -> None:
    """This port slice runs dense global-attention decoders (Llama-style);
    every other block kind, MoE, MLA, encoders and frontends are later
    slices (ROADMAP.md)."""
    if (any(k != ATTN_GLOBAL for k in cfg.layer_kinds) or cfg.moe
            or cfg.mla or cfg.encoder or cfg.frontend or cfg.use_post_norm
            or cfg.tie_embeddings or cfg.qkv_bias):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense global-attention decoders "
            "only (window/ring, softcap, post-norm, tied embeddings, bias, "
            "MoE, MLA, encoders and recurrent blocks are later slices)")


# ---------------------------------------------------------------------------
# Seeded init (the scales of repro's init_logical_block)
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random train-layout params made on ``device`` from ``seed``.

    The scales are the reference's (``init_logical_block``): 1/√D for
    the q/k/v and up/gate projections, 1/√(q·hd) for ``wo``, 1/√F for
    the down projection, 0.02 for the embedding, 1/√D for the LM head,
    zero norm scales — so many random layers stay finite."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    L, nq, nkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale):
        # drawn in slabs of rows, so the f32 scratch stays ≤ 64 MB
        out = torch.empty(shape, dtype=dtype, device=dev)
        rows = out.view(-1, shape[-1])
        step = max(1, (1 << 24) // shape[-1])
        for i in range(0, rows.shape[0], step):
            slab = rows[i:i + step]
            slab.copy_(torch.randn(slab.shape, generator=gen, device=dev)
                       * scale)
        return out

    s_in = 1.0 / math.sqrt(d)
    blk = {
        "ln1": torch.zeros((L, d), device=dev),
        "ln2": torch.zeros((L, d), device=dev),
        "attn": {
            "wq": dense((L, d, nq, hd), s_in),
            "wk": dense((L, d, nkv, hd), s_in),
            "wv": dense((L, d, nkv, hd), s_in),
            "wo": dense((L, nq * hd, d), 1.0 / math.sqrt(nq * hd)),
        },
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
    as nested dicts / lists of numpy arrays, NamedTuple fields turned
    into dict keys and the leading device axis (size 1) kept — → the
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
    eps = cfg.norm_eps
    a, kv = attn_mod.attention_train(blk["attn"], rms_norm(x, blk["ln1"], eps),
                                     cfg, ATTN_GLOBAL, return_kv=return_kv)
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
