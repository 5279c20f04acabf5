"""Train layout → serve layout, once at load — the port of
``repro/serving/prepack.py`` at model size 1.

At model size 1 there is no cluster gather: ``_pack_attn`` concatenates
``wq|wk|wv`` into one ``wqkv [D, (q + 2kv)·hd]`` (the one copy the pack
makes) and views ``wo`` as per-head full-width rows ``[q, hd, D]``;
``_pack_mla`` views ``wq``, aliases ``wdkv``/``wuk`` and folds
``wproj = W_UV·W_O`` (its one copy); ``bundle_ffn`` and ``bundle_head``
only alias train tensors.  RWKV-6 blocks ride through unpacked, as in
the reference (``prepack.py:280–293``): the serve tree aliases them.

That is the ``"pallas"`` backend's serve layout.  On ``"xla"`` the
reference keeps the train-layout segments and only moves the rank
slices to load time (``prepack.py:84–90``), and at model size 1 every
slice is the whole tensor: the serve tree IS the train tree — no
``wqkv`` copy, no bundles, the loose head.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dataflow import (PackedFFNWeights, PackedHeadWeights,
                                       PackedMLAWeights,
                                       PackedSplitTokenWeights)


def _pack_attn(a: Dict[str, torch.Tensor], ln1: torch.Tensor
               ) -> PackedSplitTokenWeights:
    """Stacked train-layout attention (``wq [G, D, q, hd]``, …) → packed
    serve layout with the layer axis leading."""
    G, D, q_loc, hd = a["wq"].shape
    kv_loc = a["wk"].shape[2]
    wqkv = torch.cat([a["wq"].reshape(G, D, q_loc * hd),
                      a["wk"].reshape(G, D, kv_loc * hd),
                      a["wv"].reshape(G, D, kv_loc * hd)], dim=2)
    bqkv = None
    if a.get("bq") is not None:
        bqkv = torch.cat([a["bq"].reshape(G, -1), a["bk"].reshape(G, -1),
                          a["bv"].reshape(G, -1)], dim=1)
    wo = a["wo"].reshape(G, q_loc, hd, a["wo"].shape[-1])
    return PackedSplitTokenWeights(wqkv=wqkv, wo=wo, bqkv=bqkv, ln1=ln1)


def _pack_mla(a: Dict[str, torch.Tensor], ln1: torch.Tensor
              ) -> PackedMLAWeights:
    """Stacked train-layout MLA (``wq [G, D, q, nope+rope]``, …) → packed
    serve layout (``prepack.py:118–144`` at model size 1).  ``wproj[g, h]
    = wuv[g, h] · wo[g] rows of head h``, computed in f32 and rounded once
    to the weights' dtype, one layer at a time so the f32 scratch stays
    one layer's size."""
    G, D, q_loc, hr = a["wq"].shape
    v_dim = a["wuv"].shape[-1]
    wo4 = a["wo"].reshape(G, q_loc, v_dim, a["wo"].shape[-1])
    wproj = torch.empty(a["wuv"].shape[:3] + (wo4.shape[-1],),
                        dtype=a["wo"].dtype, device=a["wo"].device)
    for g in range(G):
        wproj[g] = torch.einsum("qlv,qvd->qld", a["wuv"][g].float(),
                                wo4[g].float()).to(wproj.dtype)
    return PackedMLAWeights(wq=a["wq"].reshape(G, D, q_loc * hr),
                            wdkv=a["wdkv"], wuk=a["wuk"], wproj=wproj,
                            ln1=ln1)


def bundle_ffn(blk: Dict[str, Any]) -> PackedFFNWeights:
    f = blk["ffn"]
    return PackedFFNWeights(w_in=f["w_in"], w_out=f["w_out"], ln2=blk["ln2"],
                            w_gate=f.get("w_gate"),
                            post_ln1=blk.get("post_ln1"))


def bundle_head(cfg: ModelConfig, params: Dict[str, Any]) -> PackedHeadWeights:
    key = "embed" if cfg.tie_embeddings else "lm_head"
    return PackedHeadWeights(table=params[key], ln=params["final_norm"])


def prepack_for_serving(cfg: ModelConfig, params: Dict[str, Any], *,
                        backend: str = "pallas") -> Dict[str, Any]:
    """Serve tree.  ``"pallas"``: every attention block's ``attn`` packed,
    ``ffn`` bundled, every other block (RWKV-6) aliased as it is, plus
    the ``head`` bundle (B3's table); ``embed`` aliases the train tensor.
    ``"xla"``: ``params`` itself — its RG-LRU, local- and global-attention
    blocks and its ``tail`` ride through as the train tree, and the
    engine names the attention weights per step
    (``engine.py:hoist_serve_weights``)."""
    if backend != "pallas":
        return params
    if params.get("tail"):
        raise NotImplementedError(
            "the fused serve layout of tail layers (past the last whole "
            "layer group) comes with the fused arm of ROADMAP item 10")
    pack_attn = _pack_mla if cfg.mla is not None else _pack_attn

    def pack_block(blk):
        if "attn" not in blk:
            return blk
        return {"attn": pack_attn(blk["attn"], blk["ln1"]),
                "ffn": bundle_ffn(blk)}

    return {"embed": params["embed"],
            "blocks": [pack_block(b) for b in params["blocks"]], "tail": [],
            "head": bundle_head(cfg, params)}
