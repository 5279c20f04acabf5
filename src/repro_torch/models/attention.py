"""Training / prefill attention — the port of ``repro/models/attention.py``
for the dense GQA path (with the optional q/k/v biases) and MLA.  On a
mesh (``ctx``) a rank holds its heads' columns of ``wq``/``wk``/``wv``
(kv heads replicated where the heads outnumber them) and the rows of
``wo`` they project through; the partial outputs meet in ``psum_heads``
(``attention.py:185``).  With a cluster sub-axis of ``n > 1`` a rank
holds ``1/n`` of each head's dims (MLA: of ``wq``'s and ``wdkv``'s
columns): the segments are gathered over the cluster (ClusterGather)
before RoPE, the rank attends the query block ``cluster_index()·S/n …``
of the sequence against every key, and the blocks' outputs are gathered
back along the sequence (``attention.py:127–185``, ``:190–247``).

``_flash`` mirrors the reference's chunked online-softmax oracle in
plain torch ops (no fused library attention): prefill attention stays
outside the hand-written kernels, as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.layers import apply_rope, rope_cos_sin, softcap

# AttnParams is a dict: wq [D, q, hd], wk/wv [D, kv, hd], wo [q·hd, D],
# and with q/k/v biases bq [q, hd], bk/bv [kv, hd] (model dtype).
# MLAAttnParams is a dict: wq [D, q, nope+rope], wdkv [D, l+rope],
# wuk [q, nope, l], wuv [q, l, v], wo [q·v, D].


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_offset: int, causal: bool, window: int, cap: float,
           scale: float, kv_valid_len: Optional[torch.Tensor] = None,
           chunk: int = 512) -> torch.Tensor:
    """q: [B, Sq, KV, QPK, hd]; k/v: [B, Sk, KV, hd] → [B, Sq, KV, QPK, hd].

    Online softmax over KV chunks; ``window > 0`` restricts keys to
    ``(pos_q − window, pos_q]``."""
    B, Sq, KV, QPK, hd = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    n_chunks = (Sk + chunk - 1) // chunk
    dev = q.device
    q32 = q.float() * scale
    q_pos = (torch.arange(Sq, device=dev) + q_offset)[:, None]     # [Sq, 1]
    hd_v = v.shape[-1]
    m = torch.full((B, Sq, KV, QPK), -math.inf, device=dev)
    l = torch.zeros((B, Sq, KV, QPK), device=dev)
    o = torch.zeros((B, Sq, KV, QPK, hd_v), device=dev)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        n = kb.shape[1]
        if n < chunk:                         # zero padding, as reference
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, chunk - n))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, chunk - n))
        s = torch.einsum("bqkgh,bckh->bqkgc", q32, kb)
        s = softcap(s, cap)
        k_pos = c * chunk + torch.arange(chunk, device=dev)[None, :]
        valid = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            valid &= k_pos <= q_pos
        if window > 0:
            valid &= k_pos > q_pos - window
        if kv_valid_len is not None:
            valid &= k_pos < kv_valid_len
        valid &= k_pos < Sk
        s = torch.where(valid[None, :, None, None, :], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        fin = torch.isfinite(m)
        corr = torch.where(fin, torch.exp(torch.where(fin, m - m_safe,
                                                      -math.inf)), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vb)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    *, causal: bool = True, return_kv: bool = False,
                    ctx: ParallelCtx = SINGLE
                    ) -> Tuple[torch.Tensor,
                               Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Dense GQA attention block over a full sequence (prefill); with
    ``causal=False`` bidirectional, still with RoPE (the encoder's,
    ``attention.py:135``).  The biases add to q/k/v in the model dtype
    before RoPE (``attention.py:160``)."""
    B, S, D = x.shape
    n = ctx.cluster_size
    q_loc, hd = p["wq"].shape[1], p["wq"].shape[2] * n
    kv_loc = p["wk"].shape[1]
    qpk = q_loc // kv_loc
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if p.get("bq") is not None:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (ctx.gather_cluster(t, 3) for t in (q, k, v))
    cos, sin = rope_cos_sin(torch.arange(S, device=x.device), hd,
                            cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv_out = (k, v) if return_kv else None
    s_blk, q_off = S // n, ctx.cluster_index() * (S // n)
    qg = q[:, q_off:q_off + s_blk].reshape(B, s_blk, kv_loc, qpk, hd)
    out = _flash(qg, k, v, q_offset=q_off, causal=causal, window=window,
                 cap=cfg.attn_softcap, scale=1.0 / math.sqrt(hd))
    y = ctx.psum_heads(out.reshape(B, s_blk, q_loc * hd) @ p["wo"])
    return ctx.gather_cluster(y, 1) if n > 1 else y, kv_out


def mla_attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                        return_kv: bool = False, ctx: ParallelCtx = SINGLE
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """MLA over a full sequence (prefill), in the latent-space form of the
    reference (``attention.py:mla_attention_train``): ``q_nope`` absorbs
    ``W_UK`` into ``q_lat``, scores run over ``l + rope`` against the
    latent cache entries, and the values are ``c_lat``.  With
    ``return_kv`` it also returns those entries ``[B, S, l + rope]`` (RoPE
    applied), which prefill writes into the decode cache."""
    B, S, D = x.shape
    m = cfg.mla
    nope, rope_d, l_rank, v_dim = (m.nope_head_dim, m.rope_head_dim,
                                   m.kv_lora_rank, m.v_head_dim)
    q_loc = p["wq"].shape[1]
    n = ctx.cluster_size
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])       # [B,S,q,nope+rope]
    c = x @ p["wdkv"]                                    # [B,S,l+rope]
    q, c = ctx.gather_cluster(q, 3), ctx.gather_cluster(c, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    c_lat, c_rope = c[..., :l_rank], c[..., l_rank:]
    cos, sin = rope_cos_sin(torch.arange(S, device=x.device), rope_d,
                            cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_rope = apply_rope(c_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    kk = torch.cat([c_lat, c_rope], dim=-1)              # [B,S,l+rope]
    q_lat = torch.einsum("bsqn,qnl->bsql", q_nope, p["wuk"])
    s_blk, q_off = S // n, ctx.cluster_index() * (S // n)
    qq = torch.cat([q_lat, q_rope], dim=-1)[:, q_off:q_off + s_blk]
    out = _flash(qq[:, :, None], kk[:, :, None], c_lat[:, :, None],
                 q_offset=q_off, causal=True, window=0, cap=0.0,
                 scale=1.0 / math.sqrt(nope + rope_d))
    a_lat = out[:, :, 0]                                 # [B,s_blk,q,l]
    o_head = torch.einsum("bsql,qlv->bsqv", a_lat, p["wuv"])
    y = ctx.psum_heads(o_head.reshape(B, s_blk, q_loc * v_dim) @ p["wo"])
    return (ctx.gather_cluster(y, 1) if n > 1 else y,
            kk if return_kv else None)
