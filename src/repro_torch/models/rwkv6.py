"""RWKV-6 "Finch" block (arXiv:2404.05892) — the port of
``repro/models/rwkv6.py`` at model size 1.

Time mix (per head, state S ∈ R^{hd×hd}):

    w_t = exp(−exp(w_base + tanh(x̃_t A_w) B_w))      (data-dependent decay)
    S_t = diag(w_t) S_{t−1} + k_tᵀ v_t
    o_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)

Channel mix: ``k = relu(x̃ W_k)²;  out = σ(x̃ W_r) ⊙ (k W_v)``.

The WKV recurrence — ``_wkv_scan`` over a sequence and the one step of
:func:`rwkv6_step` — runs through one scan entry, an argument that
defaults to the B7 wrapper (``kernels/rwkv6_scan``); the engine passes
its plain version to hold the two against each other on the card.
Parameters are a dict with the reference's ``RWKV6Params`` field names
(``mu``, ``w_r``, … ``cm_r``).

Numerics follow the reference: the token-shift lerps, the r/k/v/g
projections, the channel mix and the residual adds run in the model
dtype; r, k, v are cast to f32 after their projection; the decay runs in
f32 with ``lora_a``/``lora_b`` upcast; the per-head group norm uses
``eps = 1e-5`` and the population variance; its output is cast to the
model dtype before ``* g`` and ``@ w_out``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import rms_norm, seeded_normal

Params = Dict[str, torch.Tensor]
GROUP_NORM_EPS = 1e-5
LORA = 32                    # rank of the decay's LoRA (the reference's)


class RWKV6State(NamedTuple):
    s: torch.Tensor              # [B, H, hd, hd] f32 wkv state
    x_prev_t: torch.Tensor       # [B, D] last normed input (time-mix shift)
    x_prev_c: torch.Tensor       # [B, D] last normed input (channel-mix shift)


def _shift(x: torch.Tensor, x0: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """x_{t−1} along the sequence axis.  x: [B, S, D]."""
    pad = torch.zeros_like(x[:, :1]) if x0 is None else x0[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0,1): exp(−exp(·)), in f32."""
    delta = torch.tanh(xw.float() @ p["lora_a"].float()) \
        @ p["lora_b"].float()
    return torch.exp(-torch.exp(p["w_base"].float() + delta))


def _wkv_scan(r, k, v, w, u, s0, *, scan: Callable = rwkv6_scan,
              s_out: Optional[torch.Tensor] = None):
    """r/k/v/w: [B, S, H, hd]; u: [H, hd]; s0: [B, H, hd, hd] → (o [B, S,
    H, hd], s_final), through ``scan`` (B7 or its plain version)."""
    return scan(r, k, v, w, u, s0, s_out=s_out)


def _lerps(mu: torch.Tensor, x: torch.Tensor, xs: torch.Tensor, n: int):
    return [x + mu[i] * (xs - x) for i in range(n)]


def _group_norm(o: torch.Tensor, ln_scale: torch.Tensor) -> torch.Tensor:
    """Per-head group norm over the last axis of ``o [..., h, hd]``."""
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = (o - mean) * torch.rsqrt(var + GROUP_NORM_EPS)
    return o * ln_scale.reshape(o.shape[-2:])


def _heads(p: Params, head_dim: int) -> int:
    return p["w_r"].shape[1] // head_dim


def rwkv6_time_mix(p: Params, x: torch.Tensor, head_dim: int,
                   state: Optional[RWKV6State] = None, *,
                   s_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time mix over a full sequence.  x: [B, S, D] → ([B, S, D], s_fin);
    ``s_fin`` is written to ``s_out`` when given."""
    B, S, D = x.shape
    h = _heads(p, head_dim)
    xs = _shift(x, state.x_prev_t if state is not None else None)
    xr, xk, xv, xw, xg = _lerps(p["mu"], x, xs, 5)
    r = (xr @ p["w_r"]).reshape(B, S, h, head_dim).float()
    k = (xk @ p["w_k"]).reshape(B, S, h, head_dim).float()
    v = (xv @ p["w_v"]).reshape(B, S, h, head_dim).float()
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw).reshape(B, S, h, head_dim)
    u = p["u"].float().reshape(h, head_dim)
    s0 = (torch.zeros((B, h, head_dim, head_dim), dtype=torch.float32,
                      device=x.device)
          if state is None else state.s.float())
    o, s_fin = _wkv_scan(r, k, v, w, u, s0, s_out=s_out)
    o = _group_norm(o.float(), p["ln_scale"]).reshape(B, S, h * head_dim)
    return (o.to(x.dtype) * g) @ p["w_out"], s_fin


def rwkv6_channel_mix(p: Params, x: torch.Tensor,
                      x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    xs = _shift(x, x_prev)
    xk, xr = _lerps(p["mu_c"], x, xs, 2)
    k = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])


def rwkv6_block(p: Params, x: torch.Tensor, head_dim: int,
                ln1: torch.Tensor, ln2: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """Full RWKV-6 layer (train / prefill path) from the zero state."""
    a, _ = rwkv6_time_mix(p, rms_norm(x, ln1, eps), head_dim)
    x = x + a
    return x + rwkv6_channel_mix(p, rms_norm(x, ln2, eps))


def rwkv6_step(p: Params, x: torch.Tensor, head_dim: int,
               state: RWKV6State, *, scan: Callable = rwkv6_scan,
               s_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, RWKV6State]:
    """One decode step of the time mix.  x: [B, D] (normed).

    Returns (time-mix out, x, new state): the recurrence is the scan at
    ``S = 1``; ``s_out`` (may be ``state.s``) receives the new state."""
    B, D = x.shape
    h = _heads(p, head_dim)
    xr, xk, xv, xw, xg = _lerps(p["mu"], x, state.x_prev_t, 5)
    r = (xr @ p["w_r"]).reshape(B, 1, h, head_dim).float()
    k = (xk @ p["w_k"]).reshape(B, 1, h, head_dim).float()
    v = (xv @ p["w_v"]).reshape(B, 1, h, head_dim).float()
    g = F.silu(xg @ p["w_g"])
    w = _decay(p, xw).reshape(B, 1, h, head_dim)
    u = p["u"].float().reshape(h, head_dim)
    o, s_new = _wkv_scan(r, k, v, w, u, state.s.float(), scan=scan,
                         s_out=s_out)
    o = _group_norm(o[:, 0].float(), p["ln_scale"]).reshape(B, h * head_dim)
    y = (o.to(x.dtype) * g) @ p["w_out"]
    return y, x, RWKV6State(s=s_new.to(state.s.dtype), x_prev_t=x,
                            x_prev_c=state.x_prev_c)


def rwkv6_channel_step(p: Params, x: torch.Tensor, state: RWKV6State
                       ) -> Tuple[torch.Tensor, RWKV6State]:
    xk, xr = _lerps(p["mu_c"], x, state.x_prev_c, 2)
    k = torch.square(F.relu(xk @ p["cm_k"]))
    y = torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"])
    return y, state._replace(x_prev_c=x)


def rwkv6_init(gen: torch.Generator, d_model: int, head_dim: int,
               n_heads: int, d_ff: int, *, lead: Tuple[int, ...] = (),
               dtype=torch.bfloat16) -> Params:
    """Random params on ``gen``'s device with the reference's scales
    (``rwkv6.py:200–226`` at model size 1): ``mu``/``mu_c`` uniform in
    [0, 1), 1/√D for the projections and ``lora_a``, 0.01 for
    ``lora_b``, 1/√(H·hd) for ``w_out``, 1/√F for ``cm_v``,
    ``w_base = −0.5``, 0.1 for ``u``, ``ln_scale = 1``.  ``lead``: leading
    axes (the layer-group axis of a stacked block)."""
    d, dl, f = d_model, n_heads * head_dim, d_ff
    dev = gen.device
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale, dt=dtype):
        return seeded_normal(gen, lead + shape, scale, dt)

    def uniform(shape):
        return torch.rand(lead + shape, generator=gen, device=dev).to(dtype)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)

    return {
        "mu": uniform((5, d)),
        "w_r": normal((d, dl), s), "w_k": normal((d, dl), s),
        "w_v": normal((d, dl), s), "w_g": normal((d, dl), s),
        "w_out": normal((dl, d), 1.0 / math.sqrt(dl)),
        "w_base": full((dl,), -0.5),
        "lora_a": normal((d, LORA), s),
        "lora_b": normal((LORA, dl), 0.01),
        "u": normal((dl,), 0.1, torch.float32),
        "ln_scale": full((dl,), 1.0),
        "mu_c": uniform((2, d)),
        "cm_k": normal((d, f), s),
        "cm_v": normal((f, d), 1.0 / math.sqrt(f)),
        "cm_r": normal((d, d), s),
    }


def rwkv6_state_init(batch: int, n_heads: int, head_dim: int, d_model: int,
                     *, lead: Tuple[int, ...] = (), device="cuda"
                     ) -> RWKV6State:
    """Zero state on ``device`` (default CUDA; raises without a card unless
    the CPU is asked for); ``lead``: leading axes (the layer-group
    axis)."""
    device = resolve_device(device)
    return RWKV6State(
        s=torch.zeros(lead + (batch, n_heads, head_dim, head_dim),
                      dtype=torch.float32, device=device),
        x_prev_t=torch.zeros(lead + (batch, d_model), dtype=torch.bfloat16,
                             device=device),
        x_prev_c=torch.zeros(lead + (batch, d_model), dtype=torch.bfloat16,
                             device=device),
    )
