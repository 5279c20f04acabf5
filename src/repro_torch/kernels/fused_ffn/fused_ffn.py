"""B2 — fused block tail: first residual add, pre-FFN RMSNorm, gated
SiLU FFN over d_ff tiles, second residual add.

Replaces ``repro/kernels/fused_ffn/fused_ffn.py:fused_ffn_block``
(``pallas_call`` at line 153), without ``post_ln1`` and gated SiLU only
(the other variants raise ``NotImplementedError``; ROADMAP.md).

CUDA kernel: ``csrc/fused_ffn.cu``.  What bounds it on an H100: bytes —
the three FFN matrices (270.5 MB at Llama2-7B) are read once per step
for all slots, at 2·B FLOPs per weight element.  Design: one launch of
``G`` thread-block clusters of ``C`` CTAs (:func:`cluster_plan`: 15 of 8
at Llama2-7B and DeepSeek-V2-Lite).  Cluster ``g`` owns a slice of
d_ff and each of its ranks ``D/C`` rows of ``w_in``/``w_gate`` (the
matching columns of ``w_out``); the ranks' ``u``/``g`` partials are
summed on chip over distributed shared memory in rank order, and the
down projection goes to an f32 ``[G, B, D]`` workspace.  The last
cluster to finish a column slice (an arrival counter, reset by the
kernel itself) sums the ``G`` partials in cluster order and adds the
residual — a fixed order, so token streams do not change from run to
run (no float atomics).  Tensor cores (``mma.sync``) do the products;
the slots are the MMA's n dimension.

Rounding points follow the reference exactly: ``r`` (``fused_ffn.py:75``),
the norm output (``:66``), ``u``, ``g`` and ``act(g)·u`` (``:84-94``) round
to the model dtype; accumulation is f32; the output rounds once
(``:101``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.models.layers import activation

_MAX_B = 8
_MAX_ROWS = 512       # d_model rows a rank may hold (csrc MAX_DT · 128)
_MAX_UNITS = 46       # 16-column units of d_ff a cluster may hold


@functools.lru_cache(maxsize=None)
def cluster_plan(d_model: int, d_ff: int) -> Tuple[int, int]:
    """``(G, C)``: ``G`` clusters of ``C`` CTAs for the shapes alone.
    ``C`` is the largest power of two ≤ 8 that leaves each rank a
    multiple of 16 rows of d_model, at most 512; ``G`` brings the grid to
    about ``_build.WAVE_CTAS``, enough that no cluster holds more than 46
    16-column units of d_ff, and no more than there are units.
    ``(0, 0)`` where no plan fits (d_ff not a multiple of 16, or d_model
    not split so)."""
    if d_ff % 16 or d_ff <= 0:
        return 0, 0
    c = _build.MAX_CLUSTER
    while c >= 1 and (d_model % (16 * c) or d_model // c > _MAX_ROWS):
        c //= 2
    if c < 1:
        return 0, 0
    units = d_ff // 16
    g = max(_build.WAVE_CTAS // c, -(-units // _MAX_UNITS))
    return min(g, units), c


def fused_ffn_block(
    x: torch.Tensor,                  # [B, D] raw residual stream
    a: torch.Tensor,                  # [B, D] attention output
    w_in: torch.Tensor,               # [D, F] up-projection columns
    w_gate: Optional[torch.Tensor],   # [D, F] gate columns
    w_out: torch.Tensor,              # [F, D] down rows
    ln2: torch.Tensor,                # [D] f32 pre-FFN norm scale
    post_ln1: Optional[torch.Tensor] = None,
    add_r: float = 1.0,
    *,
    act: str = "silu",
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, r)``: ``o = FFN(rms(r, ln2)) + add_r·r`` and the
    post-first-residual stream ``r = x + a``, both in ``x.dtype``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    if post_ln1 is not None or w_gate is None or act != "silu":
        raise NotImplementedError(
            "the port's fused_ffn runs the gated SiLU FFN without post_ln1; "
            "the other variants are later slices (ROADMAP.md)")
    tracecount.call("fused_ffn")
    args = (x, a, w_in, w_gate, w_out, ln2)
    if x.is_cuda:
        return fused_ffn_cuda(*args, add_r=add_r, eps=eps)
    if x.device.type == "cpu":
        return fused_ffn_plain(*args, add_r=add_r, act=act, eps=eps)
    raise ValueError(f"fused_ffn_block: unsupported device {x.device}")


def fused_ffn_plain(x, a, w_in, w_gate, w_out, ln2, *, add_r, act="silu",
                    eps=1e-6):
    """Plain PyTorch version (the reference's ``ref.py``): f32 matmuls,
    model-dtype rounding at the reference's op boundaries."""
    def rms(v, scale):
        var = torch.mean(v * v, dim=-1, keepdim=True)
        out = v * torch.rsqrt(var + eps) * (1.0 + scale.float())
        return out.to(x.dtype).float()

    def q(v):
        return v.to(x.dtype).float()

    r = (x.float() + a.float()).to(x.dtype).float()
    h = rms(r, ln2)
    u = q(h @ w_in.float())
    hm = q(activation(act)(q(h @ w_gate.float())) * u)
    o = hm @ w_out.float() + r * float(add_r)
    return o.to(x.dtype), r.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def fused_ffn_cuda(x, a, w_in, w_gate, w_out, ln2, *, add_r, eps=1e-6):
    """Launch ``csrc/fused_ffn.cu`` on the current stream: one launch of
    ``cluster_plan`` clusters for the whole batch."""
    B, D = x.shape
    F = w_in.shape[1]
    G, C = cluster_plan(D, F)
    if (B > _MAX_B or not C or a.shape != x.shape
            or w_in.shape != (D, F) or w_gate.shape != (D, F)
            or w_out.shape != (F, D)):
        raise NotImplementedError(
            f"fused_ffn CUDA kernel: B ≤ {_MAX_B}, d_ff a multiple of 16, "
            f"d_model split into multiples of 16 rows, ≤ {_MAX_ROWS} a rank; "
            f"got x {tuple(x.shape)}, w_in {tuple(w_in.shape)}")
    bf = torch.bfloat16
    tensors = dict(x=x, a=a, w_in=w_in, w_gate=w_gate, w_out=w_out, ln2=ln2)
    _build.require("fused_ffn", tensors, dict(
        x=bf, a=bf, w_in=bf, w_gate=bf, w_out=bf, ln2=torch.float32))
    fn = _build.function("fused_ffn", "fused_ffn_launch", _ARGTYPES)
    # each cluster's f32 partial of the down projection
    ws = torch.empty((G, B, D), dtype=torch.float32, device=x.device)
    o = torch.empty_like(x)
    r = torch.empty_like(x)
    arrivals = _build.arrival_counters("fused_ffn", x.device)
    err = fn(*(t.data_ptr() for t in tensors.values()), ws.data_ptr(),
             arrivals.data_ptr(), o.data_ptr(), r.data_ptr(), B, D, F, G, C,
             eps, float(add_r), _build.stream_ptr(x))
    _build.check(err, "fused_ffn")
    tracecount.launch("fused_ffn")
    return o, r
