"""Model assembly — the port of ``repro/models/transformer.py`` for
attention decoders with dense or MoE FFNs, RWKV-6, the
RG-LRU/local-attention hybrid (RecurrentGemma) and the modality models
(a frontend spliced into the prompt, or feeding an encoder).

The functions that run on a mesh take a ``ctx`` (``models/ctx.py``),
the single-device context by default, where every collective is the
identity.  On a model axis of ``ms`` each rank holds its own slice of
the tree below, cut as the reference's device-major layout cuts it
(:func:`to_device_major`, ``transformer.py:226–456``): heads over the
``heads_sub`` ranks (with their kv heads, replicated where ``heads_sub``
exceeds them) and, on a cluster sub-axis above 1, each head's dims over
the cluster (MLA: ``wq``'s head dims and ``wdkv``'s latent columns),
``wo``'s rows of those heads (replicated over the cluster), ``d_ff /
ms`` FFN columns (and ``w_out`` rows), ``E / ms`` experts, ``V / ms``
vocabulary rows (padded to a multiple of ``ms`` with zero rows); an
RG-LRU block's ``d_state / ms`` channels of every tensor (its gate
blocks whole); an RWKV-6 block's heads over ``heads_sub`` and its
channel mix's ``d_ff`` over the axis; the encoder's attention on the
decoder's ``heads_sub × cluster`` factoring with the encoder's heads,
the cross-attention as the decoder's attention; everything else
replicated (``frontend_proj``, the norms, RWKV-6's ``mu``, ``lora_a``
and ``cm_r``).

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
  ``tail`` list; empty for the other models;
* with a frontend (SeamlessM4T-medium, InternVL2-2B) ``frontend_proj
  [F, D]``, which takes the stub frontend's ``[B, P, F]`` embeddings to
  the model width;
* with an encoder (SeamlessM4T-medium) ``encoder``: one block dict
  stacked over the encoder's layers (``ln1``/``ln2``, ``attn`` with the
  encoder's heads of ``D / n_heads``, ``ffn``), ``enc_final_norm [D]``,
  and ``cross_attn``: ``ln [L, D]`` and ``attn`` (``wq [L, D, q, hd]``,
  ``wk``/``wv [L, D, kv, hd]``, ``wo [L, q·hd, D]``), one per decoder
  layer (``transformer.py:193–219``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, RECURRENT, RWKV6,
                                      ModelConfig)
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.ctx import SINGLE, ParallelCtx, pick_heads_sub
from repro_torch.models.layers import (embed_lookup, ffn_apply, padded_vocab,
                                       rms_norm, seeded_normal)
from repro_torch.models.rglru import RGLRU_RULES
from repro_torch.models.rwkv6 import RWKV_RULES


def _check_supported(cfg: ModelConfig) -> None:
    """The port runs decoders whose layers are global attention — MHA or
    GQA (Llama-style, Granite-8B, Minitron-4B), with q/k/v biases or not
    (Qwen2-72B), or MLA (DeepSeek-V2-Lite) —, local (sliding-window)
    attention and RG-LRU blocks (RecurrentGemma, Gemma-2), with dense
    FFNs (gated or not) or MoE FFNs (DeepSeek-V2-Lite's 64 experts), tied
    embeddings or not, post-norms on attention models or not (Gemma-2),
    and the all-RWKV-6 pattern (RWKV-6 3B); a frontend that splices its
    embeddings into the prompt (InternVL2-2B) or feeds an encoder whose
    output every decoder layer cross-attends (SeamlessM4T-medium: global
    attention, dense FFNs, no post-norms).  No registered model has the
    other combinations: an encoder without a frontend has no input
    (``encode`` projects the frontend's embeddings), and an encoder
    beside other layer kinds, MLA or MoE, MLA beside other block kinds
    and biases on MLA do not occur."""
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
    if cfg.encoder is not None and (
            cfg.frontend is None or kinds != {ATTN_GLOBAL}
            or cfg.mla is not None or cfg.moe is not None
            or cfg.use_post_norm):
        raise NotImplementedError(
            f"{cfg.name}: the port runs an encoder fed by a frontend beside "
            "global-attention decoder layers with dense FFNs and no "
            "post-norms (SeamlessM4T-medium); no registered model has "
            "another combination")
    if cfg.mla is not None and (kinds != {ATTN_GLOBAL} or cfg.qkv_bias):
        raise NotImplementedError(
            f"{cfg.name}: MLA beside other block kinds or with q/k/v "
            "biases (no registered model has either)")


# ---------------------------------------------------------------------------
# Device-major layout (the reference's transformer.py:49–456)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Layout:
    """Device-major layout of one model axis: ``model_size`` ranks,
    ``heads_sub`` of them sharding the heads, ``cluster`` the rest
    (``transformer.py:49``)."""

    model_size: int = 1
    _heads_sub: int = 0

    def __init__(self, model_size: int = 1, heads_sub: int = 0):
        object.__setattr__(self, "model_size", model_size)
        object.__setattr__(self, "_heads_sub", heads_sub or model_size)

    @property
    def heads_sub(self) -> int:
        return self._heads_sub

    @property
    def cluster(self) -> int:
        return self.model_size // self._heads_sub


def layout_for(cfg: ModelConfig, model_size: int) -> Layout:
    return Layout(model_size, pick_heads_sub(cfg.n_heads, cfg.n_kv_heads,
                                             model_size))


def _dm_replicate(x: torch.Tensor, ms: int) -> torch.Tensor:
    return x[None].expand((ms,) + tuple(x.shape))


def _dm_split(x: torch.Tensor, ms: int, axis: int) -> torch.Tensor:
    """``axis`` cut into ``ms`` shards → a leading device axis."""
    a = axis % x.ndim
    n = x.shape[a]
    if n % ms:
        raise ValueError(f"axis {a} of {tuple(x.shape)} does not split "
                         f"over {ms} ranks")
    shaped = x.reshape(x.shape[:a] + (ms, n // ms) + x.shape[a + 1:])
    return torch.movedim(shaped, a, 0)


def _dm_heads(x: torch.Tensor, lay: Layout, head_axis: int,
              hd_axis: Optional[int], n_kv_repl: int = 1) -> torch.Tensor:
    """``head_axis`` over ``heads_sub`` (each head repeated ``n_kv_repl``
    times first: GQA kv heads), ``hd_axis`` over ``cluster`` (or
    replicated over it); device order heads-major (``transformer.py:236``).
    Axes count from either end (a stacked group axis may lead)."""
    hs, cl, ms = lay.heads_sub, lay.cluster, lay.model_size
    ha = head_axis % x.ndim
    hda = None if hd_axis is None else hd_axis % x.ndim
    if n_kv_repl > 1:
        x = torch.repeat_interleave(x, n_kv_repl, dim=ha)
    nh = x.shape[ha]
    x = x.reshape(x.shape[:ha] + (hs, nh // hs) + x.shape[ha + 1:])
    x = torch.movedim(x, ha, 0)                          # [hs, ...]
    if hda is not None:
        a = hda + 1
        hdn = x.shape[a]
        x = x.reshape(x.shape[:a] + (cl, hdn // cl) + x.shape[a + 1:])
        x = torch.movedim(x, a, 1)                       # [hs, cl, ...]
    else:
        x = x[:, None].expand((hs, cl) + tuple(x.shape[1:]))
    return x.reshape((ms,) + tuple(x.shape[2:]))


def _dm(x: torch.Tensor, rule: str, cfg: ModelConfig, lay: Layout
        ) -> torch.Tensor:
    """One leaf → ``[ms, *local]`` by its rule: ``rep`` replicated;
    ``q`` heads on axis −2 and the head dim on −1 (``wq``, ``bq``, MLA's
    ``wq``); ``kv`` the same with GQA replication (``wk``, ``wv``,
    ``bk``, ``bv``); ``heads3`` heads on axis −3 (MLA's ``wuk``,
    ``wuv``); ``wo`` the rows of each head (``[q·v, D]``); ``dkv`` MLA's
    latent columns over the cluster, replicated over the heads; ``col``
    / ``row`` the last / second-last axis over the whole model axis (the
    FFN's ``d_ff``, RG-LRU's channels); ``vec`` a vector's channels;
    ``blocks`` RG-LRU's gate blocks; ``expert`` the expert axis;
    ``vocab`` the rows, padded to a multiple of ``ms``; ``hcol`` /
    ``hrow`` RWKV-6's channels / ``w_out`` rows by head; ``ekv`` /
    ``ewo`` ``kv`` / ``wo`` with the encoder's heads
    (``transformer.py:247–420``)."""
    ms = lay.model_size
    if rule in ("ekv", "ewo"):
        cfg, rule = _enc_view(cfg), rule[1:]
    if rule == "rep":
        return _dm_replicate(x, ms)
    if rule == "q":
        return _dm_heads(x, lay, -2, -1)
    if rule == "kv":
        return _dm_heads(x, lay, -2, -1,
                         max(1, lay.heads_sub // cfg.n_kv_heads))
    if rule == "heads3":
        return _dm_heads(x, lay, -3, None)
    if rule == "wo":
        nh, d = cfg.n_heads, x.shape[-1]
        w = x.reshape(x.shape[:-2] + (nh, x.shape[-2] // nh, d))
        out = _dm_heads(w, lay, -3, None)
        return out.reshape(out.shape[:-3] + (-1, d))
    if rule in ("hcol", "hrow"):
        hd = cfg.rwkv_head_dim
        a = -1 if rule == "hcol" else -2
        w = x.unflatten(a, (x.shape[a] // hd, hd))
        out = _dm_heads(w, lay, a - 1, None)
        return out.flatten(a - 1, a)
    if rule == "dkv":
        w = _dm_split(x, lay.cluster, -1)
        w = w[None].expand((lay.heads_sub,) + tuple(w.shape))
        return w.reshape((ms,) + tuple(w.shape[2:]))
    if rule in ("col", "vec"):
        return _dm_split(x, ms, -1)
    if rule == "row":
        return _dm_split(x, ms, -2)
    if rule in ("expert", "blocks"):
        return _dm_split(x, ms, -3)
    if rule == "vocab":
        v_pad = padded_vocab(cfg.vocab_size, ms)
        if x.shape[-2] < v_pad:
            x = torch.cat([x, x.new_zeros((v_pad - x.shape[-2],)
                                          + tuple(x.shape[-1:]))])
        return _dm_split(x, ms, -2)
    raise KeyError(rule)


_ATTN_RULES = {"wq": "q", "wk": "kv", "wv": "kv", "wo": "wo", "bq": "q",
               "bk": "kv", "bv": "kv"}
_ENC_ATTN_RULES = {"wq": "q", "wk": "ekv", "wv": "ekv", "wo": "ewo"}
_MLA_RULES = {"wq": "q", "wdkv": "dkv", "wuk": "heads3", "wuv": "heads3",
              "wo": "wo"}
_FFN_RULES = {"w_in": "col", "w_gate": "col", "w_out": "row"}
_MOE_RULES = {"router": "rep", "w_in": "expert", "w_gate": "expert",
              "w_out": "expert"}


def _block_rules(blk: Dict[str, Any], encoder: bool = False
                 ) -> Dict[str, Any]:
    """The rule of every leaf of a block (``transformer.py:354``); an
    encoder block's attention takes the encoder's heads."""
    out: Dict[str, Any] = {}
    for name, val in blk.items():
        if name.startswith("ln") or name.startswith("post_ln"):
            out[name] = "rep"
        elif name == "attn":
            rules = (_MLA_RULES if "wdkv" in val
                     else _ENC_ATTN_RULES if encoder else _ATTN_RULES)
            out[name] = {k: rules[k] for k in val}
        elif name == "ffn":
            if "router" in val:
                out[name] = {k: (dict(_FFN_RULES) if k == "dense"
                                 else _MOE_RULES[k]) for k in val}
            else:
                out[name] = {k: _FFN_RULES[k] for k in val}
        elif name == "rglru":
            out[name] = {k: RGLRU_RULES[k] for k in val}
        elif name == "rwkv":
            out[name] = {k: RWKV_RULES[k] for k in val}
        else:
            raise KeyError(name)
    return out


def _param_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    top = {"embed": "vocab", "lm_head": "vocab", "final_norm": "rep",
           "frontend_proj": "rep", "enc_final_norm": "rep"}
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k in top:
            out[k] = top[k]
        elif k in ("blocks", "tail"):
            out[k] = [_block_rules(b) for b in v]
        elif k in ("encoder", "cross_attn"):
            out[k] = _block_rules(v, encoder=k == "encoder")
        else:
            raise KeyError(k)
    return out


def _zip_map(fn, tree, rules):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, rules[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, t, r) for t, r in zip(tree, rules)]
    return fn(tree, rules)


def to_device_major(cfg: ModelConfig, lay: Layout, params: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """The logical train tree (model size 1) → every leaf ``[ms, *local]``
    (a stacked group leaf ``[ms, G, *local]``), the reference's
    ``to_device_major`` (``transformer.py:413``); views where the cut
    allows."""
    return _zip_map(lambda t, r: _dm(t, r, cfg, lay), params,
                    _param_rules(params))


def unwrap_local(params: Dict[str, Any], index: int = 0) -> Dict[str, Any]:
    """Rank ``index``'s slice of a device-major tree, each leaf a tensor
    of its own (``transformer.py:458``)."""
    if isinstance(params, dict):
        return {k: unwrap_local(v, index) for k, v in params.items()}
    if isinstance(params, list):
        return [unwrap_local(v, index) for v in params]
    return params[index].clone(memory_format=torch.contiguous_format)


def shard_params(cfg: ModelConfig, lay: Layout, params: Dict[str, Any],
                 rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of the logical train tree: the tree itself at
    model size 1."""
    if lay.model_size == 1:
        return params
    return unwrap_local(to_device_major(cfg, lay, params), rank)


# ---------------------------------------------------------------------------
# Seeded init (the scales of repro's init_logical_block)
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=torch.bfloat16, lay: Optional[Layout] = None,
                rank: int = 0) -> Dict[str, Any]:
    """Random train-layout params made on ``device`` from ``seed``; with a
    ``lay`` of model size > 1, rank ``rank``'s slice (:func:`shard_params`
    of the same model), each leaf cut as soon as it is drawn, so a rank
    holds one whole leaf at a time beside its slice.

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
    tied embeddings there is no ``lm_head``.  Frontend: ``frontend_proj``
    at 1/√F; encoder blocks at the decoder's scales with the encoder's
    heads (``init_logical_encoder_block``), cross-attention at the
    decoder attention's (``transformer.py:193–219``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    L, nq, nkv = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
    lay = lay or Layout()
    ms = lay.model_size

    def cut(t, rule):
        if ms == 1 or rule == "rep":
            return t
        return unwrap_local(_dm(t, rule, cfg, lay), rank)

    def dense(shape, scale, rule="rep"):
        return cut(seeded_normal(gen, shape, scale, dtype), rule)

    s_in = 1.0 / math.sqrt(d)
    if cfg.block_pattern == (RWKV6,):
        blk = {"ln1": torch.zeros((L, d), device=dev),
               "ln2": torch.zeros((L, d), device=dev),
               "rwkv": rwkv_mod.rwkv6_init(
                   gen, d, cfg.rwkv_head_dim, d // cfg.rwkv_head_dim, F,
                   lead=(L,), dtype=dtype, cut=cut)}
        return {"embed": dense((cfg.vocab_size, d), 0.02, "vocab"),
                "lm_head": dense((cfg.vocab_size, d), s_in, "vocab"),
                "final_norm": torch.zeros((d,), device=dev),
                "blocks": [blk], "tail": []}

    def block(kind, lead):
        def lin(shape, scale, rule="rep"):
            return dense(lead + shape, scale, rule)

        blk = {"ln1": torch.zeros(lead + (d,), device=dev),
               "ln2": torch.zeros(lead + (d,), device=dev)}
        if cfg.use_post_norm:              # transformer.py:89–91
            blk["post_ln1"] = torch.zeros(lead + (d,), device=dev)
            blk["post_ln2"] = torch.zeros(lead + (d,), device=dev)
        if kind == RECURRENT:
            blk["rglru"] = rglru_mod.rglru_init(
                gen, d, cfg.rglru_d_state or d, nq, cfg.conv1d_width,
                lead=lead, dtype=dtype, cut=cut)
        elif cfg.mla is not None:
            m = cfg.mla
            blk["attn"] = {
                "wq": lin((d, nq, m.nope_head_dim + m.rope_head_dim), s_in,
                          "q"),
                "wdkv": lin((d, m.kv_lora_rank + m.rope_head_dim), s_in,
                            "dkv"),
                "wuk": lin((nq, m.nope_head_dim, m.kv_lora_rank), 0.05,
                           "heads3"),
                "wuv": lin((nq, m.kv_lora_rank, m.v_head_dim), 0.05,
                           "heads3"),
                "wo": lin((nq * m.v_head_dim, d),
                          1.0 / math.sqrt(nq * m.v_head_dim), "wo"),
            }
        else:
            blk["attn"] = {
                "wq": lin((d, nq, hd), s_in, "q"),
                "wk": lin((d, nkv, hd), s_in, "kv"),
                "wv": lin((d, nkv, hd), s_in, "kv"),
                "wo": lin((nq * hd, d), 1.0 / math.sqrt(nq * hd), "wo"),
            }
            if cfg.qkv_bias:               # transformer.py:100–110: zeros
                q_loc = nq // lay.heads_sub
                kv_loc = max(1, nkv // lay.heads_sub)
                for name, n in (("bq", q_loc), ("bk", kv_loc),
                                ("bv", kv_loc)):
                    blk["attn"][name] = torch.zeros(
                        lead + (n, hd // lay.cluster), dtype=dtype,
                        device=dev)
        if cfg.moe is not None and kind != RECURRENT:
            blk["ffn"] = moe_mod.moe_init(gen, d, cfg.moe, cfg.ffn_gated,
                                          lead=lead, dtype=dtype, cut=cut)
            return blk
        blk["ffn"] = {"w_in": lin((d, F), s_in, "col")}
        if cfg.ffn_gated:                   # ungated (relu2): no gate
            blk["ffn"]["w_gate"] = lin((d, F), s_in, "col")
        blk["ffn"]["w_out"] = lin((F, d), 1.0 / math.sqrt(F), "row")
        return blk

    period = len(cfg.block_pattern)
    G = L // period
    blocks = [block(kind, (G,)) for kind in cfg.block_pattern]
    tail = [block(kind, ()) for kind in cfg.layer_kinds[G * period:]]
    params = {"embed": dense((cfg.vocab_size, d), 0.02, "vocab")}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((cfg.vocab_size, d), s_in, "vocab")
    params.update(final_norm=torch.zeros((d,), device=dev), blocks=blocks,
                  tail=tail)
    if cfg.frontend is not None:
        f_dim = cfg.frontend.feature_dim
        params["frontend_proj"] = dense((f_dim, d), 1.0 / math.sqrt(f_dim))
    if cfg.encoder is not None:
        e = cfg.encoder
        lead, ehd, eF = (e.n_layers,), d // e.n_heads, e.d_ff
        ffn = {"w_in": dense(lead + (d, eF), s_in, "col")}
        if cfg.ffn_gated:
            ffn["w_gate"] = dense(lead + (d, eF), s_in, "col")
        ffn["w_out"] = dense(lead + (eF, d), 1.0 / math.sqrt(eF), "row")
        params["encoder"] = {
            "ln1": torch.zeros(lead + (d,), device=dev),
            "ln2": torch.zeros(lead + (d,), device=dev),
            "attn": {"wq": dense(lead + (d, e.n_heads, ehd), s_in, "q"),
                     "wk": dense(lead + (d, e.n_kv_heads, ehd), s_in,
                                 "ekv"),
                     "wv": dense(lead + (d, e.n_kv_heads, ehd), s_in,
                                 "ekv"),
                     "wo": dense(lead + (e.n_heads * ehd, d),
                                 1.0 / math.sqrt(e.n_heads * ehd), "ewo")},
            "ffn": ffn}
        params["enc_final_norm"] = torch.zeros((d,), device=dev)
        params["cross_attn"] = {
            "ln": torch.zeros((L, d), device=dev),
            "attn": block(ATTN_GLOBAL, (L,))["attn"]}
    return params


def head_table(cfg: ModelConfig, params: Dict[str, Any]) -> torch.Tensor:
    """The LM head's ``[V, D]`` table: ``embed`` when tied."""
    return params["embed" if cfg.tie_embeddings else "lm_head"]


def embed_tokens(cfg: ModelConfig, table: torch.Tensor,
                 tokens: torch.Tensor, ctx: ParallelCtx = SINGLE
                 ) -> torch.Tensor:
    """The embedding (vocab-parallel on a mesh), times ``√d_model``
    rounded to the model dtype first when the embeddings are tied
    (``transformer.py:594–595``): bf16 11.3125 at ``d_model`` 128,
    exactly 64 at 4096."""
    x = embed_lookup(table, tokens, ctx)
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
                          lay: Optional[Layout] = None, rank: int = 0,
                          device="cuda") -> Dict[str, Any]:
    """The JAX package's device-major train params — as nested dicts /
    lists of numpy arrays, NamedTuple fields (``AttnParams``,
    ``MLAAttnParams``, ``MoEParams``, ``RGLRUParams``, …) turned into
    dict keys and the leading model axis (size ``lay.model_size``, 1 by
    default) kept — → model rank ``rank``'s train params in the port's
    tree (the device axis stripped — a MoE leaf keeps its expert axis
    behind it —; at model size 1 the vocabulary padding cut, on a mesh
    the rank's padded vocabulary shard kept)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    ms = (lay or Layout()).model_size

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items() if v is not None}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node.shape[0] != ms:
            raise ValueError(f"expected a leading model axis of size {ms}, "
                             f"got {node.shape}")
        return _leaf_to_torch(node[rank], dev)

    keys = ("embed", "final_norm", "blocks", "tail") + (
        () if cfg.tie_embeddings else ("lm_head",)) + tuple(
        k for k in ("frontend_proj", "encoder", "enc_final_norm",
                    "cross_attn") if k in tree)
    out = conv({k: tree[k] for k in keys})
    if ms == 1:
        for k in ("embed", "lm_head"):
            if k in out:
                out[k] = out[k][:cfg.vocab_size]
    return out


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def _pick(node, g):
    """Layer ``g`` of a stacked dict of tensors, as views."""
    if isinstance(node, dict):
        return {k: _pick(v, g) for k, v in node.items()}
    return node[g]


def layer_params(params: Dict[str, Any], cfg: ModelConfig
                 ) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked block tree, in layer order (the
    groups, then the tail), parallel to ``cfg.layer_kinds``."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    out: List[Dict[str, Any]] = []
    for g in range(n_groups):
        for p in range(period):
            out.append(_pick(params["blocks"][p], g))
    return out + list(params["tail"])


def cross_params(params: Dict[str, Any], cfg: ModelConfig
                 ) -> List[Optional[Dict[str, Any]]]:
    """Per-layer views of ``cross_attn``, parallel to
    :func:`layer_params`; ``None`` for every layer of a model without an
    encoder."""
    if cfg.encoder is None:
        return [None] * cfg.n_layers
    return [_pick(params["cross_attn"], i) for i in range(cfg.n_layers)]


def apply_block(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor, *,
                kind: str = ATTN_GLOBAL, return_kv: bool = False,
                enc_out: Optional[torch.Tensor] = None,
                cross_blk: Optional[Dict[str, Any]] = None,
                ctx: ParallelCtx = SINGLE):
    """One layer of the train-path forward.  With ``return_kv`` the
    second result is what prefill caches: ``(k, v)`` of GQA attention,
    or MLA's latent entries ``[B, S, l + rope]`` (None for RWKV-6 and
    RG-LRU, whose prefill states come from ``serving/prefill.py``).
    With ``enc_out [B, P, D]`` and ``cross_blk`` the layer cross-attends
    the encoder's output between the self-attention's residual add and
    ``ln2`` (``transformer.py:494–497``)."""
    eps = cfg.norm_eps
    if "rwkv" in blk:                  # transformer.py:473–479
        return rwkv_mod.rwkv6_block(blk["rwkv"], x, cfg.rwkv_head_dim,
                                    blk["ln1"], blk["ln2"], eps,
                                    ctx=ctx), None
    h = rms_norm(x, blk["ln1"], eps)
    kv = None
    if kind == RECURRENT:              # transformer.py:480–482
        a = rglru_mod.rglru_block(blk["rglru"], h, ctx=ctx)
    elif cfg.mla is not None:
        a, kv = attn_mod.mla_attention_train(blk["attn"], h, cfg,
                                             return_kv=return_kv, ctx=ctx)
    else:
        a, kv = attn_mod.attention_train(blk["attn"], h, cfg, kind,
                                         return_kv=return_kv, ctx=ctx)
    x = x + post_norm(blk, "post_ln1", a, eps)
    if cross_blk is not None and enc_out is not None:
        x = x + cross_attention(cross_blk["attn"],
                                rms_norm(x, cross_blk["ln"], eps), enc_out,
                                cfg, ctx)
    f = block_ffn(cfg, blk["ffn"], rms_norm(x, blk["ln2"], eps), ctx)
    return x + post_norm(blk, "post_ln2", f, eps), kv


def post_norm(blk: Dict[str, Any], key: str, t: torch.Tensor, eps: float
              ) -> torch.Tensor:
    """Gemma-2's post-attention (``post_ln1``) or post-FFN (``post_ln2``)
    norm of a block's branch output before its residual add
    (``transformer.py:491–503``); the identity on a block without it."""
    return rms_norm(t, blk[key], eps) if key in blk else t


def block_ffn(cfg: ModelConfig, ffn: Dict[str, Any], h: torch.Tensor,
              ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """A block's FFN on its normed input ``h [..., D]``: the MoE
    (``moe_apply``, every token of ``h`` sharing one capacity) or the
    dense FFN (``transformer.py:499–501``)."""
    if moe_mod.is_moe(ffn):
        return moe_mod.moe_apply(ffn, h, cfg.ffn_act, cfg.moe, ctx)
    return ffn_apply(ffn, h, cfg.ffn_act, ctx)


def cross_attention(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    enc_out: torch.Tensor, cfg: ModelConfig,
                    ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """Decoder cross-attention over a whole sequence (train and prefill,
    ``transformer.py:507``): q from ``x [B, S, D]``, k and v projected
    from ``enc_out [B, P, D]``, no RoPE and no mask, every query row
    attending all ``P`` frames.  On a mesh a rank projects its heads
    (their head-dim segments on a cluster above 1, gathered, and its
    query block of the sequence, the blocks gathered back) and the
    heads' partials meet in ``psum_heads``."""
    B, S, _ = x.shape
    n = ctx.cluster_size
    q_loc, hd = p["wq"].shape[1], p["wq"].shape[2] * n
    kv_loc = p["wk"].shape[1]
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    k = torch.einsum("bpd,dkh->bpkh", enc_out, p["wk"])
    v = torch.einsum("bpd,dkh->bpkh", enc_out, p["wv"])
    q, k, v = (ctx.gather_cluster(t, 3) for t in (q, k, v))
    s_blk, q_off = S // n, ctx.cluster_index() * (S // n)
    qg = q[:, q_off:q_off + s_blk].reshape(B, s_blk, kv_loc,
                                           q_loc // kv_loc, hd)
    out = attn_mod._flash(qg, k, v, q_offset=0, causal=False, window=0,
                          cap=0.0, scale=1.0 / math.sqrt(hd))
    y = ctx.psum_heads(out.reshape(B, s_blk, q_loc * hd) @ p["wo"])
    return ctx.gather_cluster(y, 1) if n > 1 else y


def _enc_view(cfg: ModelConfig) -> ModelConfig:
    """Config view of the encoder blocks (``transformer.py:538``): the
    encoder's heads of ``d_model / n_heads``, no softcap, no bias, no
    MLA."""
    e = cfg.encoder
    return dataclasses.replace(cfg, n_heads=e.n_heads, n_kv_heads=e.n_kv_heads,
                               attn_softcap=0.0, qkv_bias=False, mla=None,
                               head_dim=cfg.d_model // e.n_heads)


def encode(cfg: ModelConfig, params: Dict[str, Any],
           frontend_embeds: torch.Tensor, ctx: ParallelCtx = SINGLE
           ) -> torch.Tensor:
    """The encoder stack over the stub frontend's embeddings ``[B, P, F]``
    → ``[B, P, D]`` (``transformer.py:547``): the projection
    (replicated), then per block bidirectional attention (RoPE, no mask)
    and the FFN, each with its residual add — on a mesh the rank's heads
    and ``d_ff`` columns, as a decoder block's —, then
    ``enc_final_norm``."""
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name}: the encoder's frontend embeddings "
                         "are required")
    proj = params["frontend_proj"]
    x = frontend_embeds.to(proj.dtype) @ proj
    ecfg = _enc_view(cfg)
    eps = cfg.norm_eps
    for i in range(cfg.encoder.n_layers):
        blk = _pick(params["encoder"], i)
        a, _ = attn_mod.attention_train(blk["attn"],
                                        rms_norm(x, blk["ln1"], eps), ecfg,
                                        ATTN_GLOBAL, causal=False, ctx=ctx)
        x = x + a
        x = x + ffn_apply(blk["ffn"], rms_norm(x, blk["ln2"], eps),
                          cfg.ffn_act, ctx)
    return rms_norm(x, params["enc_final_norm"], eps)


def splice_frontend(cfg: ModelConfig, params: Dict[str, Any],
                    x: torch.Tensor, frontend_embeds) -> torch.Tensor:
    """A VLM's prompt embeddings ``x [B, S, D]`` with the first ``P``
    replaced by the projected frontend embeddings ``[B, P, F]``
    (``transformer.py:596–600``); ``x`` itself on a model without a
    frontend, or whose frontend feeds an encoder.  The prompt must hold
    the ``P`` positions."""
    if cfg.frontend is None or cfg.encoder is not None:
        return x
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name}: the frontend's embeddings "
                         f"[B, {cfg.frontend.num_positions}, "
                         f"{cfg.frontend.feature_dim}] are required")
    fe = frontend_embeds.to(x.dtype) @ params["frontend_proj"]
    if x.shape[1] < fe.shape[1]:
        raise ValueError(f"{cfg.name}: a prompt of {x.shape[1]} tokens "
                         f"cannot hold the frontend's {fe.shape[1]} "
                         "positions")
    return torch.cat([fe, x[:, fe.shape[1]:]], dim=1)


def forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """Tokens [B, S] (and the frontend's embeddings ``[B, P, F]`` on a
    model with a frontend) → final normed hidden states [B, S, D]."""
    x = splice_frontend(cfg, params, embed_tokens(cfg, params["embed"],
                                                  tokens, ctx),
                        frontend_embeds)
    enc_out = (encode(cfg, params, frontend_embeds, ctx)
               if cfg.encoder is not None else None)
    for kind, blk, cross in zip(cfg.layer_kinds, layer_params(params, cfg),
                                cross_params(params, cfg)):
        x, _ = apply_block(cfg, blk, x, kind=kind, enc_out=enc_out,
                           cross_blk=cross, ctx=ctx)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
