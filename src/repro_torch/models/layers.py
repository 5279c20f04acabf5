"""Shared layers — the port of ``repro/models/layers.py`` at model-axis
size 1 (every collective of the reference is the identity there).

Numerics follow the reference exactly: RMSNorm uses ``(1 + scale)`` in
f32 and casts back; RoPE rotates the two halves of the head dimension
(not interleaved pairs); LM-head logits are f32 from model-dtype
operands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def activation(name: str):
    """The reference's table: ``jax.nn.gelu`` defaults to the tanh
    approximation, so ``gelu`` and ``gelu_tanh`` are the same function."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


def seeded_normal(gen: torch.Generator, shape, scale: float,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """``N(0, scale²)`` of ``shape`` in ``dtype`` on ``gen``'s device, drawn
    in slabs of rows so the f32 scratch stays ≤ 64 MB at full width."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = out.view(-1, shape[-1])
    step = max(1, (1 << 24) // shape[-1])
    for i in range(0, rows.shape[0], step):
        slab = rows[i:i + step]
        slab.copy_(torch.randn(slab.shape, generator=gen, device=gen.device)
                   * scale)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    # a device-side scalar (no host copy: capturable in a CUDA graph)
    return torch.pow(torch.full((), theta, dtype=torch.float32, device=device),
                     -torch.arange(half, dtype=torch.float32,
                                   device=device) / half)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs              # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., S, H, head_dim]; cos/sin: [S, half] (broadcast over heads)."""
    half = x.shape[-1] // 2
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def ffn_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Dense FFN: ``act(x·Wg) ⊙ (x·Wi) · Wo`` (ungated: ``act(x·Wi)·Wo``)."""
    h = x @ p["w_in"]
    if p.get("w_gate") is not None:
        h = activation(act)(x @ p["w_gate"]) * h
    else:
        h = activation(act)(h)
    return h @ p["w_out"]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def lm_head_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x · tableᵀ``: model-dtype values are exact in f32, so
    this equals the reference's model-dtype product with f32
    accumulation."""
    return x.float() @ table.float().T


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap and cap > 0 else x
