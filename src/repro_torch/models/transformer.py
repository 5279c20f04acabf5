"""Model assembly — the port of ``repro/models/transformer.py`` for
attention decoders with dense or MoE FFNs, RWKV-6 and the
RG-LRU/local-attention hybrid (RecurrentGemma) on one device.

The reference's ``ParallelCtx`` (``repro/models/ctx.py``) is dropped:
on one GPU the model axis is 1 and every collective it wraps is the
identity, so the port's functions take no context argument.

Parameter tree (the train layout; leaves are tensors):

* ``embed [V, D]``, ``lm_head [V, D]`` (model dtype; absent with tied
  embeddings, where the head reads ``embed``), ``final_norm [D]`` (f32);
* ``blocks``: one dict per block-pattern position with the layer-group
  axis leading, as the reference's scanned groups: ``ln1``/``ln2
  [G, D]`` f32 (post-norm models also ``post_ln1``/``post_ln2``),
  ``attn`` = ``wq [G, D, q, hd]``, ``wk``/``wv
  [G, D, kv, hd]``, ``wo [G, q·hd, D]`` — or, for MLA, ``wq [G, D, q,
  nope+rope]``, ``wdkv [G, D, l+rope]``, ``wuk [G, q, nope, l]``, ``wuv
  [G, q, l, v]``, ``wo [G, q·v, D]``; ``ffn`` = ``w_in``/``w_gate
  [G, D, F]``, ``w_out [G, F, D]`` — or, on a MoE model, ``MoEParams``
  (``models/moe.py``: ``router [G, D, E]`` f32, ``w_in``/``w_gate [G, E,
  D, F]``, ``w_out [G, E, F, D]``); an RG-LRU block holds ``rglru`` (the
  ``RGLRUParams`` fields, ``models/rglru.py``) in place of ``attn``; an
  RWKV-6 block holds ``ln1``, ``ln2`` and ``rwkv`` (the ``RWKV6Params``
  fields, ``models/rwkv6.py``) and no ``attn`` or ``ffn``;
* ``tail``: the layers past the last whole group (RecurrentGemma-9B's
  38 = 12·3 + 2), one unstacked block dict each, as the reference's
  ``tail`` list; empty for the other models.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, RECURRENT, RWKV6,
                                      ModelConfig)
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (embed_lookup, ffn_apply, rms_norm,
                                       seeded_normal)


def _check_supported(cfg: ModelConfig) -> None:
    """The port runs decoders whose layers are global attention — MHA or
    GQA (Llama-style, Granite-8B, Minitron-4B) or MLA (DeepSeek-V2-Lite)
    —, local (sliding-window) attention and RG-LRU blocks
    (RecurrentGemma, Gemma-2), with dense FFNs (gated or not) or MoE FFNs
    (DeepSeek-V2-Lite's 64 experts), tied embeddings or not, post-norms
    on attention models or not (Gemma-2), and the all-RWKV-6 pattern
    (RWKV-6 3B).  q/k/v biases, encoders and frontends are later slices
    (ROADMAP.md)."""
    kinds = set(cfg.layer_kinds)
    if RWKV6 in kinds:
        if (cfg.block_pattern != (RWKV6,) or cfg.encoder or cfg.frontend
                or cfg.tie_embeddings or cfg.use_post_norm or cfg.moe):
            raise NotImplementedError(
                f"{cfg.name}: the port runs RWKV-6 as the only block kind, "
                "with an untied head and no post-norms (ROADMAP.md item "
                "15a)")
        return
    if cfg.use_post_norm and RECURRENT in kinds:
        raise NotImplementedError(
            f"{cfg.name}: post-norms beside RG-LRU layers (no registered "
            "model has them; ROADMAP item 10 ported Gemma-2's, on "
            "attention layers)")
    if cfg.encoder or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoders and frontends are ROADMAP item 14")
    if cfg.qkv_bias or (cfg.mla is not None and kinds != {ATTN_GLOBAL}):
        raise NotImplementedError(
            f"{cfg.name}: q/k/v biases (ROADMAP item 11, with qwen2-72b) "
            "and MLA beside other block kinds are later slices")


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
    ``wo`` (``transformer.py:94–107``).  MoE: ``moe_init``'s scales
    (``models/moe.py``) on every non-recurrent layer, as the reference's
    ``init_logical_block`` (:133–135).  RG-LRU: ``rglru_init``'s scales
    with the model's heads as gate blocks.  RWKV-6: ``rwkv6_init``'s
    scales per layer, zero ``ln1``/``ln2``, an untied ``lm_head``.  With
    tied embeddings there is no ``lm_head``."""
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
                "blocks": [blk], "tail": []}

    def block(kind, lead):
        def lin(shape, scale):
            return dense(lead + shape, scale)

        blk = {"ln1": torch.zeros(lead + (d,), device=dev),
               "ln2": torch.zeros(lead + (d,), device=dev)}
        if cfg.use_post_norm:              # transformer.py:89–91
            blk["post_ln1"] = torch.zeros(lead + (d,), device=dev)
            blk["post_ln2"] = torch.zeros(lead + (d,), device=dev)
        if kind == RECURRENT:
            blk["rglru"] = rglru_mod.rglru_init(
                gen, d, cfg.rglru_d_state or d, nq, cfg.conv1d_width,
                lead=lead, dtype=dtype)
        elif cfg.mla is not None:
            m = cfg.mla
            blk["attn"] = {
                "wq": lin((d, nq, m.nope_head_dim + m.rope_head_dim), s_in),
                "wdkv": lin((d, m.kv_lora_rank + m.rope_head_dim), s_in),
                "wuk": lin((nq, m.nope_head_dim, m.kv_lora_rank), 0.05),
                "wuv": lin((nq, m.kv_lora_rank, m.v_head_dim), 0.05),
                "wo": lin((nq * m.v_head_dim, d),
                          1.0 / math.sqrt(nq * m.v_head_dim)),
            }
        else:
            blk["attn"] = {
                "wq": lin((d, nq, hd), s_in),
                "wk": lin((d, nkv, hd), s_in),
                "wv": lin((d, nkv, hd), s_in),
                "wo": lin((nq * hd, d), 1.0 / math.sqrt(nq * hd)),
            }
        if cfg.moe is not None and kind != RECURRENT:
            blk["ffn"] = moe_mod.moe_init(gen, d, cfg.moe, cfg.ffn_gated,
                                          lead=lead, dtype=dtype)
            return blk
        blk["ffn"] = {"w_in": lin((d, F), s_in)}
        if cfg.ffn_gated:                   # ungated (relu2): no gate
            blk["ffn"]["w_gate"] = lin((d, F), s_in)
        blk["ffn"]["w_out"] = lin((F, d), 1.0 / math.sqrt(F))
        return blk

    period = len(cfg.block_pattern)
    G = L // period
    blocks = [block(kind, (G,)) for kind in cfg.block_pattern]
    tail = [block(kind, ()) for kind in cfg.layer_kinds[G * period:]]
    params = {"embed": dense((cfg.vocab_size, d), 0.02)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.vocab_size, d), s_in)
    params.update(final_norm=torch.zeros((d,), device=dev), blocks=blocks,
                  tail=tail)
    return params


def head_table(cfg: ModelConfig, params: Dict[str, Any]) -> torch.Tensor:
    """The LM head's ``[V, D]`` table: ``embed`` when tied."""
    return params["embed" if cfg.tie_embeddings else "lm_head"]


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The embedding, times ``√d_model`` rounded to the model dtype first
    when the embeddings are tied (``transformer.py:594–595``): bf16
    11.3125 at ``d_model`` 128, exactly 64 at 4096."""
    x = embed_lookup(table, tokens)
    if cfg.tie_embeddings:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


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
    (``AttnParams``, ``MLAAttnParams``, ``MoEParams``, ``RGLRUParams``,
    …) turned into dict keys and the leading device axis (size 1) kept —
    → the port's train params (same tree, device axis stripped — a MoE
    leaf keeps its expert axis behind it —, vocabulary padding cut)."""
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

    keys = ("embed", "final_norm", "blocks", "tail") + (
        () if cfg.tie_embeddings else ("lm_head",))
    out = conv({k: tree[k] for k in keys})
    for k in ("embed", "lm_head"):
        if k in out:
            out[k] = out[k][:cfg.vocab_size]
    return out


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def layer_params(params: Dict[str, Any], cfg: ModelConfig
                 ) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked block tree, in layer order (the
    groups, then the tail), parallel to ``cfg.layer_kinds``."""
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
    return out + list(params["tail"])


def apply_block(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor, *,
                kind: str = ATTN_GLOBAL, return_kv: bool = False):
    """One layer of the train-path forward.  With ``return_kv`` the
    second result is what prefill caches: ``(k, v)`` of GQA attention,
    or MLA's latent entries ``[B, S, l + rope]`` (None for RWKV-6 and
    RG-LRU, whose prefill states come from ``serving/prefill.py``)."""
    eps = cfg.norm_eps
    if "rwkv" in blk:                  # transformer.py:473–479
        return rwkv_mod.rwkv6_block(blk["rwkv"], x, cfg.rwkv_head_dim,
                                    blk["ln1"], blk["ln2"], eps), None
    h = rms_norm(x, blk["ln1"], eps)
    kv = None
    if kind == RECURRENT:              # transformer.py:480–482
        a = rglru_mod.rglru_block(blk["rglru"], h)
    elif cfg.mla is not None:
        a, kv = attn_mod.mla_attention_train(blk["attn"], h, cfg,
                                             return_kv=return_kv)
    else:
        a, kv = attn_mod.attention_train(blk["attn"], h, cfg, kind,
                                         return_kv=return_kv)
    x = x + post_norm(blk, "post_ln1", a, eps)
    f = block_ffn(cfg, blk["ffn"], rms_norm(x, blk["ln2"], eps))
    return x + post_norm(blk, "post_ln2", f, eps), kv


def post_norm(blk: Dict[str, Any], key: str, t: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """Gemma-2's post-attention (``post_ln1``) or post-FFN (``post_ln2``)
    norm of a block's branch output before its residual add
    (``transformer.py:491–503``); the identity on a block without it."""
    return rms_norm(t, blk[key], eps) if key in blk else t


def block_ffn(cfg: ModelConfig, ffn: Dict[str, Any], h: torch.Tensor
              ) -> torch.Tensor:
    """A block's FFN on its normed input ``h [..., D]``: the MoE
    (``moe_apply``, every token of ``h`` sharing one capacity) or the
    dense FFN (``transformer.py:499–501``)."""
    if moe_mod.is_moe(ffn):
        return moe_mod.moe_apply(ffn, h, cfg.ffn_act, cfg.moe)
    return ffn_apply(ffn, h, cfg.ffn_act)


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor
            ) -> torch.Tensor:
    """Tokens [B, S] → final normed hidden states [B, S, D]."""
    x = embed_tokens(cfg, params["embed"], tokens)
    for kind, blk in zip(cfg.layer_kinds, layer_params(params, cfg)):
        x, _ = apply_block(cfg, blk, x, kind=kind)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
