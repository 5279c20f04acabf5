"""Train layout → serve layout, once at load — the port of
``repro/serving/prepack.py`` at model size 1.

At model size 1 there is no cluster gather: ``_pack_attn`` concatenates
``wq|wk|wv`` into one ``wqkv [D, (q + 2kv)·hd]`` (the one copy the pack
makes) and views ``wo`` as per-head full-width rows ``[q, hd, D]``;
``bundle_ffn`` and ``bundle_head`` only alias train tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dataflow import (PackedFFNWeights, PackedHeadWeights,
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


def bundle_ffn(blk: Dict[str, Any]) -> PackedFFNWeights:
    f = blk["ffn"]
    return PackedFFNWeights(w_in=f["w_in"], w_out=f["w_out"], ln2=blk["ln2"],
                            w_gate=f.get("w_gate"),
                            post_ln1=blk.get("post_ln1"))


def bundle_head(cfg: ModelConfig, params: Dict[str, Any]) -> PackedHeadWeights:
    key = "embed" if cfg.tie_embeddings else "lm_head"
    return PackedHeadWeights(table=params[key], ln=params["final_norm"])


def prepack_for_serving(cfg: ModelConfig, params: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """Serve tree: every block's ``attn`` packed, ``ffn`` bundled, plus
    the ``head`` bundle; ``embed`` aliases the train tensor."""
    def pack_block(blk):
        return {"attn": _pack_attn(blk["attn"], blk["ln1"]),
                "ffn": bundle_ffn(blk)}

    return {"embed": params["embed"],
            "blocks": [pack_block(b) for b in params["blocks"]],
            "head": bundle_head(cfg, params)}
