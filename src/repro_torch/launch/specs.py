"""Serving layout selection — the port of the layout half of
``repro/launch/specs.py`` (``_cluster_ok`` :42, ``serving_layout`` :61,
``ctx_for`` :81).

The reference picks the serve cluster with its tuning model
(``core/autotune.py:tune_cluster``, a TPU cost model the port does not
carry over).  On every registered attention model that model picks a
cluster of 1 — heads over the whole model axis — up to a model axis of
8, and a cluster of 2 across devices first at 16 (qwen2-72b, arctic,
kimi-k2, Minitron-4B).  The port serves the head-parallel layout: the
head count must divide the model axis (:func:`_cluster_ok` at ``n`` 1),
and a layout that would put a cluster across devices — a model axis
past 8, or heads that do not divide it — raises ``NotImplementedError``
(ROADMAP A.5b: the KV sequence over cluster ranks).
"""
from __future__ import annotations

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ModelConfig)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.ctx import ParallelCtx, make_train_ctx
from repro_torch.models.transformer import Layout

# the widest model axis on which the reference's tuner keeps the cluster
# inside one device for every registered model
_HEAD_PARALLEL_MAX = 8


def _cluster_ok(cfg: ModelConfig, ms: int, n: int) -> bool:
    """Divisibility for a serve cluster of size ``n`` on a model axis of
    ``ms`` (``specs.py:42``)."""
    hs = ms // n
    if hs < 1 or cfg.n_heads % hs:
        return False
    hd = cfg.resolved_head_dim
    if hd % n or cfg.d_model % n:
        return False
    if cfg.mla is not None:
        m = cfg.mla
        if ((m.kv_lora_rank + m.rope_head_dim) % n or m.kv_lora_rank % n
                or (m.nope_head_dim + m.rope_head_dim) % n):
            return False
    if cfg.sliding_window % n:
        return False
    return True


def check_mesh_model(cfg: ModelConfig, ms: int) -> None:
    """Raise where the port does not serve ``cfg`` on a model axis of
    ``ms`` > 1: only attention decoders (dense FFNs or MoE) without a
    frontend or an encoder shard (ROADMAP A.5b)."""
    if ms == 1:
        return
    if (set(cfg.layer_kinds) - {ATTN_GLOBAL, ATTN_LOCAL}
            or cfg.frontend is not None or cfg.encoder is not None):
        raise NotImplementedError(
            f"{cfg.name}: recurrent, RWKV-6 and modality models on a model "
            f"axis of {ms} are ROADMAP A.5b; the port shards attention "
            "decoders with dense or MoE FFNs")


def serving_layout(cfg: ModelConfig, ms: int) -> Layout:
    """The head-parallel layout, ``heads_sub = ms`` and a cluster of 1;
    ``NotImplementedError`` (ROADMAP A.5b) where the reference would put
    a cluster across devices."""
    check_mesh_model(cfg, ms)
    if ms > _HEAD_PARALLEL_MAX or not _cluster_ok(cfg, ms, 1):
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {ms}: {cfg.n_heads} heads need "
            "a cluster across devices there (the KV sequence over cluster "
            "ranks, ROADMAP A.5b); the port serves heads over the whole "
            f"axis, up to {_HEAD_PARALLEL_MAX}")
    return Layout(ms, heads_sub=ms)


def ctx_for(mesh: Mesh, lay: Layout, **kw) -> ParallelCtx:
    """The context of ``lay`` on ``mesh`` (``specs.py:81``)."""
    return make_train_ctx(mesh.axes["model"], heads_sub=lay.heads_sub,
                          model_size=lay.model_size,
                          data=(mesh.axes["data"],), **kw)
