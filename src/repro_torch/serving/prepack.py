"""Train layout → serve layout, once at load — the port of
``repro/serving/prepack.py``, on each rank's own tree.

At cluster size 1 there is no cluster gather: ``_pack_attn`` concatenates
``wq|wk|wv`` into one ``wqkv [D, (q + 2kv)·hd]`` (the one copy the pack
makes; :func:`share_packed_qkv` then turns the train tree's ``wq``,
``wk`` and ``wv`` into views of it, so the two layouts hold one copy)
and views ``wo`` as per-head full-width rows ``[q, hd, D]`` — for the
layer groups' stacked blocks and the unstacked ``tail`` blocks alike;
``_pack_mla`` views ``wq``, aliases ``wdkv``/``wuk`` and folds
``wproj = W_UV·W_O`` (its one copy); ``bundle_ffn`` and ``bundle_head``
only alias train tensors.  RWKV-6 blocks ride through unpacked, as in
the reference (``prepack.py:280–293``): the serve tree aliases them, and
so do RG-LRU blocks (``_ffn_packable``, ``prepack.py:166–177``, packs only
attention-bearing blocks) — RecurrentGemma's groups and its two RG-LRU
``tail`` layers, which the reference's ``map_blocks`` walks like the
groups (``prepack.py:150–163``).  A
MoE block's FFN is not packable (``_ffn_packable``, ``prepack.py:167``:
the fused block tail has no expert dispatch), so its experts, router
and ``ln2`` ride through as the train tensors, aliased, while its
attention is packed for B4.  An encoder-decoder's FFN is not packable
either (``_ffn_packable``, ``prepack.py:171``: the cross-attention runs
between the block's residual adds), so SeamlessM4T's FFN and ``ln2``
ride through aliased while its self-attention is packed for B1
(``_pack_attn`` has no encoder check, ``prepack.py:84``); its
``cross_attn`` rides through aliased too.

That is the ``"pallas"`` backend's serve layout.  On ``"xla"`` the
reference keeps the train-layout segments and only moves the rank
slices to load time (``prepack.py:84–90``), and at cluster size 1 every
slice is the whole tensor: the serve tree IS the train tree — no
``wqkv`` copy, no bundles, the loose head.  (On a cluster across devices
the engine takes ``wo``'s, ``wuk``'s and ``wuv``'s rank slices as views
each step, ``serving/engine.py:hoist_serve_weights``: the reference's
non-prepacked adapter.)

On a cluster sub-axis of ``n > 1`` (``ctx``) the ``"pallas"`` pack
gathers each rank's head-dim segments of ``wq``/``wk``/``wv`` (and the
biases), and MLA's ``wq`` and ``wdkv`` columns, over the cluster once
here — the reference's ``_gather_seg`` (``prepack.py:56–70``), which
is what ``cluster_gather_tiled`` gives at run time — so every rank of a
cluster holds its heads whole; ``wo``, ``wuk`` and ``wuv`` are stored
replicated over the cluster already, so ``wo``'s per-head rows and the
fold ``wproj`` come from the rank's own tensors (``:116–144``).  The
train tree then keeps its own segments (no views of ``wqkv``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dataflow import (PackedFFNWeights, PackedHeadWeights,
                                       PackedMLAWeights,
                                       PackedSplitTokenWeights)
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.moe import is_moe


def _gather_seg(t, ctx: ParallelCtx):
    """The cluster's segments of ``t``'s last dim, gathered in cluster-rank
    order (``prepack.py:_gather_seg``); ``t`` itself at cluster 1."""
    if t is None or ctx.cluster_size == 1:
        return t
    return ctx.gather_cluster(t.contiguous(), t.dim() - 1)


def _pack_attn(a: Dict[str, torch.Tensor], ln1: torch.Tensor,
               ctx: ParallelCtx = SINGLE) -> PackedSplitTokenWeights:
    """Stacked train-layout attention (``wq [G, D, q, hd/n]``, …) → packed
    serve layout with the layer axis leading, the head dims gathered over
    the cluster."""
    a = {k: (t if k == "wo" else _gather_seg(t, ctx)) for k, t in a.items()}
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


def _pack_mla(a: Dict[str, torch.Tensor], ln1: torch.Tensor,
              ctx: ParallelCtx = SINGLE) -> PackedMLAWeights:
    """Stacked train-layout MLA (``wq [G, D, q, (nope+rope)/n]``, …) →
    packed serve layout (``prepack.py:118–144``): ``wq`` and ``wdkv``
    gathered over the cluster.  ``wproj[g, h] = wuv[g, h] · wo[g] rows of
    head h``, computed in f32 and rounded once to the weights' dtype, one
    layer at a time so the f32 scratch stays one layer's size."""
    a = dict(a, wq=_gather_seg(a["wq"], ctx),
             wdkv=_gather_seg(a["wdkv"], ctx))
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


def share_packed_qkv(train: Dict[str, Any], serve: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """``train`` with every packed block's (groups' and tail's) ``wq``,
    ``wk`` and ``wv`` replaced by views of the serve tree's ``wqkv`` (the
    same values) — and ``bq``, ``bk``, ``bv`` by views of ``bqkv`` —, so
    the train layout's own copies are released once nothing else holds
    them: at Gemma-2 27B's width they are 3.47 GB, room the 8 slots'
    caches need beside the 54.5 GB of weights on an 80 GB card.  Prefill
    reads the views as it read the copies (a view's rows are strided
    products, no copy)."""
    def share(blk, packed):
        a = packed.get("attn")
        if (not isinstance(a, PackedSplitTokenWeights)
                or a.wqkv.shape[-1] != sum(blk["attn"][n].shape[-2]
                                           * blk["attn"][n].shape[-1]
                                           for n in ("wq", "wk", "wv"))):
            return blk                 # (on a cluster: other head dims)
        views = {}
        for names, fused in ((("wq", "wk", "wv"), a.wqkv),
                             (("bq", "bk", "bv"), a.bqkv)):
            c0 = 0
            for name in names if fused is not None else ():
                shape = blk["attn"][name].shape  # [G, D, heads, hd]; tail [D, …]
                n = shape[-2] * shape[-1]
                views[name] = fused[..., c0:c0 + n].unflatten(-1, shape[-2:])
                c0 += n
        return dict(blk, attn=dict(blk["attn"], **views))

    return dict(train, **{part: [share(b, p) for b, p in
                                 zip(train[part], serve[part])]
                          for part in ("blocks", "tail")})


def bundle_head(cfg: ModelConfig, params: Dict[str, Any]) -> PackedHeadWeights:
    key = "embed" if cfg.tie_embeddings else "lm_head"
    return PackedHeadWeights(table=params[key], ln=params["final_norm"])


def prepack_for_serving(cfg: ModelConfig, params: Dict[str, Any], *,
                        backend: str = "pallas",
                        ctx: ParallelCtx = SINGLE) -> Dict[str, Any]:
    """Serve tree.  ``"pallas"``: every attention block's ``attn`` packed,
    its dense ``ffn`` bundled (with ``post_ln1``) — a MoE ``ffn`` and
    ``ln2`` aliased as they are —, a post-norm block's ``post_ln2``
    aliased (the second residual add runs after B2), local- and
    global-attention blocks alike, every other block (RWKV-6, RG-LRU)
    aliased as it is, in the layer groups and the ``tail`` alike (a tail
    block has no group axis: an attention block there is packed as a
    group of one, then unstacked), plus the ``head`` bundle (B3's
    table); ``embed`` aliases the train tensor.  ``"xla"``: ``params``
    itself — its RG-LRU, local- and global-attention blocks and its
    ``tail`` ride through as the train tree, and the engine names the
    attention weights per step (``engine.py:hoist_serve_weights``).
    ``ctx``: the rank's mesh axes (every rank of a cluster packs
    together: the gather is a collective)."""
    if backend != "pallas":
        return params
    pack_fn = _pack_mla if cfg.mla is not None else _pack_attn

    def pack_attn(a, ln1):
        return pack_fn(a, ln1, ctx)

    def pack_block(blk):
        if "attn" not in blk:
            return blk
        ffn = ({"ffn": blk["ffn"], "ln2": blk["ln2"]}
               if is_moe(blk["ffn"]) or cfg.encoder is not None
               else {"ffn": bundle_ffn(blk)})
        post = {"post_ln2": blk["post_ln2"]} if "post_ln2" in blk else {}
        return {"attn": pack_attn(blk["attn"], blk["ln1"]), **ffn, **post}

    def pack_tail(blk):
        if "attn" not in blk:
            return blk
        return _map(pack_block(_map(blk, lambda t: t[None])),
                    lambda t: t[0])

    cross = {"cross_attn": params["cross_attn"]} if cfg.encoder else {}
    return {"embed": params["embed"],
            "blocks": [pack_block(b) for b in params["blocks"]],
            "tail": [pack_tail(b) for b in params["tail"]],
            "head": bundle_head(cfg, params), **cross}


def _map(tree, fn):
    """``fn`` on every tensor of a dict or NamedTuple of tensors (None
    kept), as views: a block with or without its group axis."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_map(t, fn) for t in tree))
    return None if tree is None else fn(tree)


def head_view(cfg: ModelConfig, params: Dict[str, Any]) -> PackedHeadWeights:
    """The ``(table, ln)`` a decode step samples with
    (``prepack.py:225`` of the reference): the serve tree's ``head``
    bundle on ``"pallas"``, else the loose head's ``lm_head`` (tied:
    ``embed``) and ``final_norm``.  Takes the ``{"train", "serve"}``
    pair or one tree."""
    if isinstance(params, dict) and {"train", "serve"} <= params.keys():
        params = params["serve"]
    h = params.get("head")
    if isinstance(h, PackedHeadWeights):
        return h
    return bundle_head(cfg, params)
