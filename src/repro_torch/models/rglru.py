"""Griffin / RecurrentGemma recurrent block (RG-LRU, arXiv:2402.19427) —
the port of ``repro/models/rglru.py``.

    x ─ linear ─ conv1d(width 4) ─ RG-LRU ─┐
                                            ⊙ ─ out-linear
    x ─ linear ───────────── gelu ─────────┘

RG-LRU, per channel (diagonal):

    r_t = σ(W_r u_t + b_r)          i_t = σ(W_i u_t + b_i)
    log a_t = −8 · softplus(Λ) · r_t
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t)

The gates, ``exp``/``sqrt`` and ``i ⊙ u`` run in torch; the recurrence
``h_t = exp(log a_t)·h_{t−1} + b_t`` — over a sequence in
:func:`rglru_scan`, one step in :func:`rglru_step` — runs through one
scan entry, an argument that defaults to the B6 wrapper
(``kernels/rglru_scan``); the engine passes its plain version to hold
the two against each other on the card.  The reference scans with an
associative scan and steps with one fused expression; the scan here is
sequential, so in f32 the two agree to summation order (about 1e-5 of
each row's largest element), not bit for bit.

Parameters are a dict with the reference's ``RGLRUParams`` field names:
``w_x``/``w_gate [D, C]``, ``conv_w [width, C]``, ``conv_b [C]``,
``w_r``/``w_i [nb, bs, bs]`` (block-diagonal gates, ``nb`` = the
model's heads), ``b_r``/``b_i``/``lam [C]`` f32, ``w_out [C, D]``.  On
a mesh (``ctx``) a rank holds ``C / ms`` channels of every tensor — its
whole gate blocks, since the channels are block-major — and the block's
output is the ranks' partials summed by ``psum_model``
(``rglru.py:131``, ``:145``): the recurrence is per channel, so it moves
nothing between ranks.

Numerics follow the reference: the projections, the causal conv and
``(h ⊙ gate) @ w_out`` run in the model dtype; the gates in f32 (the
reference's f32 ``u`` times bf16 ``w_r``/``w_i`` promotes to f32; the
port casts explicitly); the scan returns ``h`` in ``u``'s dtype; the
decode step's conv sums in f32 and rounds to the model dtype before the
bias, and its state ``h`` stays f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan as _b6
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.layers import seeded_normal

Params = Dict[str, torch.Tensor]
_C = 8.0                      # Griffin's fixed constant


# How a leaf splits over the model axis (``transformer.py:_layout_rglru``
# of the reference): every tensor on its channel axis — ``col`` the last
# (``w_x``, ``w_gate``, ``conv_w``), ``vec`` a vector's, ``blocks`` the
# gate blocks (whole), ``row`` ``w_out``'s rows.
RGLRU_RULES = {"w_x": "col", "w_gate": "col", "conv_w": "col",
               "conv_b": "vec", "w_r": "blocks", "b_r": "vec",
               "w_i": "blocks", "b_i": "vec", "lam": "vec", "w_out": "row"}


class RGLRUState(NamedTuple):
    h: torch.Tensor               # [B, C] f32 recurrent state
    conv: torch.Tensor            # [B, width − 1, C] f32 conv tail


def _block_linear(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Block-diagonal product: ``w [nb, bs, bs]``, ``u [..., nb·bs]`` in
    ``u``'s dtype."""
    nb, bs, _ = w.shape
    uu = u.reshape(u.shape[:-1] + (nb, bs))
    return torch.einsum("...nb,nbc->...nc", uu, w.to(u.dtype)).reshape(
        u.shape)


def _gates(p: Params, u: torch.Tensor):
    """``(log a, i)`` of f32 ``u``; ``log a ≤ 0``."""
    r = torch.sigmoid(_block_linear(p["w_r"], u) + p["b_r"])
    i = torch.sigmoid(_block_linear(p["w_i"], u) + p["b_i"])
    log_a = -_C * F.softplus(p["lam"].float()) * r
    return log_a, i


def _input_scale(log_a: torch.Tensor, i: torch.Tensor, u: torch.Tensor
                 ) -> torch.Tensor:
    """``b = √(max(1 − a², 1e-12)) · (i ⊙ u)`` in f32."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)


def rglru_scan(p: Params, u: torch.Tensor, *, scan: Callable = _b6
               ) -> torch.Tensor:
    """``u [B, S, C]`` → ``h [B, S, C]`` in ``u``'s dtype, from the zero
    state, through ``scan`` (B6 or its plain version)."""
    uf = u.float()
    log_a, i = _gates(p, uf)
    h0 = torch.zeros((u.shape[0], u.shape[2]), dtype=torch.float32,
                     device=u.device)
    h, _ = scan(log_a, _input_scale(log_a, i, uf), h0)
    return h.to(u.dtype)


def rglru_step(p: Params, u: torch.Tensor, h_prev: torch.Tensor, *,
               scan: Callable = _b6, h_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step, ``u [B, C]`` → ``(h in u's dtype, h in h_prev's
    dtype)``: the scan at ``S = 1``; ``h_out`` (may be ``h_prev``)
    receives the f32 state."""
    uf = u.float()
    log_a, i = _gates(p, uf)
    h, h_fin = scan(log_a[:, None], _input_scale(log_a, i, uf)[:, None],
                    h_prev.float(), h_out=h_out)
    return h[:, 0].to(u.dtype), h_fin.to(h_prev.dtype)


def _causal_conv(p: Params, x: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d over ``x [B, S, C]`` in ``x``'s dtype
    (``tail``: the last ``width − 1`` inputs before ``x``, else zeros)."""
    width = p["conv_w"].shape[0]
    S = x.shape[1]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if tail is None else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, :S] * p["conv_w"][0]
    for i in range(1, width):
        out = out + xp[:, i:i + S] * p["conv_w"][i]
    return out + p["conv_b"]


def _gate(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["w_gate"], approximate="tanh")


def rglru_block(p: Params, x: torch.Tensor, *, scan: Callable = _b6,
                ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """Full recurrent block (train / prefill) from the zero state.
    ``x [B, S, D]`` (normed) → ``[B, S, D]``, the ranks' channel partials
    summed on a mesh."""
    u = _causal_conv(p, x @ p["w_x"])
    h = rglru_scan(p, u, scan=scan)
    return ctx.psum_model((h * _gate(p, x)) @ p["w_out"])


def rglru_block_step(p: Params, x: torch.Tensor, state: RGLRUState, *,
                     scan: Callable = _b6,
                     h_out: Optional[torch.Tensor] = None,
                     ctx: ParallelCtx = SINGLE
                     ) -> Tuple[torch.Tensor, RGLRUState]:
    """Decode step, ``x [B, D]`` (normed) → ``([B, D], new state)``;
    ``h_out`` (may be ``state.h``) receives the new f32 ``h``; on a mesh
    the state is the rank's channels and the output the ranks' sum."""
    u = x @ p["w_x"]                                         # [B, C]
    hist = torch.cat([state.conv.float(), u[:, None].float()], dim=1)
    u_c = torch.einsum("bwd,wd->bd", hist, p["conv_w"].float()).to(
        u.dtype) + p["conv_b"]
    h, h_new = rglru_step(p, u_c, state.h, scan=scan, h_out=h_out)
    y = ctx.psum_model((h * _gate(p, x)) @ p["w_out"])
    return y, RGLRUState(h=h_new, conv=hist[:, 1:])


def rglru_init(gen: torch.Generator, d_model: int, d_state: int,
               n_blocks: int, width: int = 4, *,
               lead: Tuple[int, ...] = (), dtype=torch.bfloat16,
               cut: Callable = lambda t, rule: t) -> Params:
    """Random params on ``gen``'s device with the reference's scales
    (``rglru.py:149–170``): 1/√D for ``w_x``/``w_gate``, 0.2 for
    ``conv_w``, 1/√bs for ``w_r``/``w_i`` and ``w_out`` (``bs = d_state
    / n_blocks``), zero biases, and ``Λ`` such that ``a ∈ (0.9, 0.999)``
    at ``r = 0.5``.  ``lead``: leading axes (the layer-group axis);
    ``cut(tensor, rule)`` takes each leaf as drawn to a rank's slice
    (:data:`RGLRU_RULES`)."""
    dev = gen.device
    s, bs = 1.0 / math.sqrt(d_model), d_state // n_blocks
    sb = 1.0 / math.sqrt(bs)

    def normal(name, shape, scale):
        return cut(seeded_normal(gen, lead + shape, scale, dtype),
                   RGLRU_RULES[name])

    def zeros(dt):
        return cut(torch.zeros(lead + (d_state,), dtype=dt, device=dev),
                   "vec")

    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, d_state, device=dev)) * 2.0 / _C))
    return {
        "w_x": normal("w_x", (d_model, d_state), s),
        "w_gate": normal("w_gate", (d_model, d_state), s),
        "conv_w": normal("conv_w", (width, d_state), 0.2),
        "conv_b": zeros(dtype),
        "w_r": normal("w_r", (n_blocks, bs, bs), sb),
        "b_r": zeros(torch.float32),
        "w_i": normal("w_i", (n_blocks, bs, bs), sb),
        "b_i": zeros(torch.float32),
        "lam": cut(lam.expand(lead + (d_state,)).contiguous(), "vec"),
        "w_out": normal("w_out", (d_state, d_model), sb),
    }


def rglru_state_init(batch: int, d_state: int, width: int = 4, *,
                     lead: Tuple[int, ...] = (), device="cuda"
                     ) -> RGLRUState:
    """Zero state on ``device`` (default CUDA; raises without a card unless
    the CPU is asked for); ``lead``: leading axes (the layer-group
    axis)."""
    dev = resolve_device(device)
    return RGLRUState(
        h=torch.zeros(lead + (batch, d_state), dtype=torch.float32,
                      device=dev),
        conv=torch.zeros(lead + (batch, width - 1, d_state),
                         dtype=torch.float32, device=dev))
