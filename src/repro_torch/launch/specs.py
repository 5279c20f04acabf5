"""Serving layout selection — the port of the layout half of
``repro/launch/specs.py`` (``_cluster_ok`` :42, ``serving_layout`` :61,
``ctx_for`` :81).

The serve cluster is picked as the reference picks it: its tuning model
(``core/autotune.py:tune_cluster``, carried over in the port's
``core/autotune.py`` as the reference's rule, TPU constants and all),
then halved until :func:`_cluster_ok` holds, falling back to the train
factoring (``layout_for``) where no cluster does, and taking it
outright for attention-free models (RWKV-6: the technique does not
apply).  On the registered models that model keeps the cluster inside
one device (heads over the whole model axis) up to a model axis of 8,
and picks a cluster of 2 across devices at 16 for Qwen2-72B,
Granite-8B, Minitron-4B and InternVL2-2B; RecurrentGemma-9B, its one
kv head at head dim 256, takes a cluster across devices at every
model axis above 1 (at ``max_seq`` 4096 every head on every rank, the
sequence over the axis).  An explicit ``cluster`` wins (the
reference's ``serve.py:181–183``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.autotune import tune_cluster
from repro_torch.launch.mesh import Mesh
from repro_torch.models.ctx import ParallelCtx, make_train_ctx
from repro_torch.models.transformer import Layout, layout_for


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


def serving_layout(cfg: ModelConfig, ms: int, *, seq_len: int, batch: int,
                   cluster: Optional[int] = None) -> Layout:
    """The serve layout on a model axis of ``ms`` for a cache of
    ``seq_len`` positions and ``batch`` slots (``specs.py:61–74``): the
    cluster ``tune_cluster`` picks, halved until :func:`_cluster_ok`,
    else ``layout_for``'s factoring; ``cluster`` given: ``Layout(ms, ms //
    cluster)``, which must divide the axis and pass :func:`_cluster_ok`
    (``ValueError`` otherwise); ``layout_for`` on an attention-free
    model (``specs.py:67–68``)."""
    if cluster is not None:
        if cluster < 1 or ms % cluster or not _cluster_ok(cfg, ms, cluster):
            raise ValueError(
                f"{cfg.name}: a serve cluster of {cluster} on a model axis "
                f"of {ms} does not divide its heads, head dim, d_model or "
                "window")
        return Layout(ms, heads_sub=ms // cluster)
    if cfg.is_attention_free:
        return layout_for(cfg, ms)
    best = tune_cluster(cfg, seq_len=seq_len, batch=max(1, batch),
                        model_axis=ms)
    n = best.cluster_size
    while n > 1 and not _cluster_ok(cfg, ms, n):
        n //= 2
    if not _cluster_ok(cfg, ms, n):
        return layout_for(cfg, ms)
    return Layout(ms, heads_sub=ms // n)


def ctx_for(mesh: Mesh, lay: Layout, **kw) -> ParallelCtx:
    """The context of ``lay`` on ``mesh`` (``specs.py:81``)."""
    return make_train_ctx(mesh.axes["model"], heads_sub=lay.heads_sub,
                          model_size=lay.model_size,
                          data=(mesh.axes["data"],), **kw)
