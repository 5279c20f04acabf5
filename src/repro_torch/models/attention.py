"""Training / prefill attention — the port of ``repro/models/attention.py``
for the dense GQA path at cluster size 1.

``_flash`` mirrors the reference's chunked online-softmax oracle in
plain torch ops (no fused library attention): prefill attention stays
outside the hand-written kernels, as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.models.layers import apply_rope, rope_cos_sin, softcap

# AttnParams is a dict: wq [D, q, hd], wk/wv [D, kv, hd], wo [q·hd, D]
# (no q/k/v biases: ``qkv_bias`` configs are a later slice).


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
                    *, return_kv: bool = False
                    ) -> Tuple[torch.Tensor,
                               Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Dense GQA attention block over a full sequence (prefill)."""
    B, S, D = x.shape
    q_loc, hd = p["wq"].shape[1], p["wq"].shape[2]
    kv_loc = p["wk"].shape[1]
    qpk = q_loc // kv_loc
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    q = torch.einsum("bsd,dqh->bsqh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    cos, sin = rope_cos_sin(torch.arange(S, device=x.device), hd,
                            cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv_out = (k, v) if return_kv else None
    qg = q.reshape(B, S, kv_loc, qpk, hd)
    out = _flash(qg, k, v, q_offset=0, causal=True, window=window,
                 cap=cfg.attn_softcap, scale=1.0 / math.sqrt(hd))
    y = out.reshape(B, S, q_loc * hd) @ p["wo"]
    return y, kv_out
