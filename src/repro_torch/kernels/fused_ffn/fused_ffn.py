"""B2 — fused block tail: Gemma-2's post-attention norm (``post_ln1``,
where given), first residual add, pre-FFN RMSNorm, the FFN over d_ff
tiles (gated ``act(h·Wg)·(h·Wi)`` or ungated ``act(h·Wi)``), second
residual add.

Replaces ``repro/kernels/fused_ffn/fused_ffn.py:fused_ffn_block``
(``pallas_call`` at line 153), with or without ``post_ln1``, gated or
ungated, with the reference's activation table (``silu``, ``gelu`` —
the tanh approximation, as ``gelu_tanh`` —, ``relu``, ``relu2``).

CUDA kernel: ``csrc/fused_ffn.cu``.  What bounds it on an H100: bytes —
the FFN matrices (270.5 MB at Llama2-7B, 352 MB at Granite-8B, 1019 MB
at Gemma-2 27B, 113 MB ungated at Minitron-4B) are read once per step
for all slots, at 2·B FLOPs per weight element.  Design: one launch of
``G`` thread-block clusters of ``C`` CTAs (:func:`cluster_plan`: 15 of 8
at every served width, one wave).  Cluster ``g`` owns a slice of d_ff,
taken in chunks of at most 64 16-column units (one chunk up to
Granite-8B's width; three at Gemma-2 27B's d_ff 36864), and each of its
ranks ``D/C`` rows of ``w_in``/``w_gate`` (the matching columns of
``w_out``: 576 at Gemma-2's d_model 4608, 1024 at Qwen2-72B's 8192);
per chunk the ranks'
``u``/``g`` partials are summed on chip over
distributed shared memory in rank order, and the down projection goes
to an f32 ``[G, B, D]`` workspace.  The last cluster to finish a column
slice (an arrival counter, reset by the kernel itself) sums the ``G``
partials in cluster order and adds the residual — a fixed order, so
token streams do not change from run to run (no float atomics).  Tensor
cores (``mma.sync``) do the products; the slots are the MMA's n
dimension.  The activation is a template parameter of the kernel.

Rounding points follow the reference exactly: ``rms(a, post_ln1)``
(``fused_ffn.py:73``) and ``r`` (``:75``), the norm output (``:66``),
``u``, ``g`` and ``act(g)·u`` — ungated ``act(u)`` — (``:84-94``) round
to the model dtype; the activation runs in f32; accumulation is f32; the
output rounds once (``:101``).
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
_MAX_ROWS = 1024      # d_model rows a rank may hold (csrc MAX_DT · 128)
# past 640 rows a rank (csrc NARROW_DT · 128) only the gated silu FFN has
# instances: Qwen2-72B's, the one registered model that wide
_NARROW_ROWS = 640
# the reference's activation table (models/layers.py:activation) as the
# kernel's template parameter (csrc ``Act``); gelu is the tanh form
ACTS = {"silu": 0, "gelu": 1, "gelu_tanh": 1, "relu": 2, "relu2": 3}


@functools.lru_cache(maxsize=None)
def cluster_plan(d_model: int, d_ff: int) -> Tuple[int, int]:
    """``(G, C)``: ``G`` clusters of ``C`` CTAs for the shapes alone.
    ``C`` is the largest power of two ≤ 8 that leaves each rank a
    multiple of 16 rows of d_model, at most 1024 (Qwen2-72B's 8192: 8
    ranks of 1024; every narrower served width keeps its plan of 8
    ranks); ``G`` brings the grid to
    ``_build.WAVE_CTAS`` (one wave: 15 clusters of 8), and no more than
    there are 16-column units of d_ff (a cluster takes its slice in
    chunks of at most 64 units, csrc ``chunk_cols``).  ``(0, 0)`` where
    no plan fits (d_ff not a multiple of 16, or d_model not split
    so)."""
    if d_ff % 16 or d_ff <= 0:
        return 0, 0
    c = _build.MAX_CLUSTER
    while c >= 1 and (d_model % (16 * c) or d_model // c > _MAX_ROWS):
        c //= 2
    if c < 1:
        return 0, 0
    return min(_build.WAVE_CTAS // c, d_ff // 16), c


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
    post-first-residual stream ``r = x + a`` (``x + rms(a, post_ln1)``
    with ``post_ln1``), both in ``x.dtype``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    if act not in ACTS:
        raise NotImplementedError(
            f"the port's fused_ffn runs the reference's activations "
            f"{sorted(ACTS)}, gated or not (got act {act!r})")
    tracecount.call("fused_ffn")
    args = (x, a, w_in, w_gate, w_out, ln2, post_ln1)
    if x.is_cuda:
        return fused_ffn_cuda(*args, add_r=add_r, act=act, eps=eps)
    if x.device.type == "cpu":
        return fused_ffn_plain(*args, add_r=add_r, act=act, eps=eps)
    raise ValueError(f"fused_ffn_block: unsupported device {x.device}")


def fused_ffn_plain(x, a, w_in, w_gate, w_out, ln2, post_ln1=None, *, add_r,
                    act="silu", eps=1e-6):
    """Plain PyTorch version (the reference's ``ref.py``): f32 matmuls,
    model-dtype rounding at the reference's op boundaries."""
    def rms(v, scale):
        var = torch.mean(v * v, dim=-1, keepdim=True)
        out = v * torch.rsqrt(var + eps) * (1.0 + scale.float())
        return out.to(x.dtype).float()

    def q(v):
        return v.to(x.dtype).float()

    af = a.float() if post_ln1 is None else rms(a.float(), post_ln1)
    r = (x.float() + af).to(x.dtype).float()
    h = rms(r, ln2)
    u = q(h @ w_in.float())
    if w_gate is not None:
        hm = q(activation(act)(q(h @ w_gate.float())) * u)
    else:
        hm = q(activation(act)(u))
    o = hm @ w_out.float() + r * float(add_r)
    return o.to(x.dtype), r.to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def fused_ffn_cuda(x, a, w_in, w_gate, w_out, ln2, post_ln1=None, *, add_r,
                   act="silu", eps=1e-6):
    """Launch ``csrc/fused_ffn.cu`` on the current stream: one launch of
    ``cluster_plan`` clusters for the whole batch (``w_gate`` None: the
    ungated instance, which reads no gate columns; ``post_ln1`` None: no
    post-attention norm)."""
    B, D = x.shape
    F = w_in.shape[1]
    G, C = cluster_plan(D, F)
    if (B > _MAX_B or not C or a.shape != x.shape or act not in ACTS
            or w_in.shape != (D, F) or w_out.shape != (F, D)
            or (w_gate is not None and w_gate.shape != (D, F))
            or (D // C > _NARROW_ROWS
                and (w_gate is None or ACTS[act] != ACTS["silu"]))):
        raise NotImplementedError(
            f"fused_ffn CUDA kernel: B ≤ {_MAX_B}, d_ff a multiple of 16, "
            f"d_model split into multiples of 16 rows, ≤ {_NARROW_ROWS} a "
            f"rank, ≤ {_MAX_ROWS} for gated silu (other activations that "
            f"wide: ROADMAP Queue B: B2); got x {tuple(x.shape)}, w_in "
            f"{tuple(w_in.shape)}, act {act!r}, gated {w_gate is not None}")
    bf = torch.bfloat16
    tensors = {k: t for k, t in dict(x=x, a=a, w_in=w_in, w_gate=w_gate,
                                     w_out=w_out, ln2=ln2,
                                     post_ln1=post_ln1).items()
               if t is not None}
    _build.require("fused_ffn", tensors, dict(
        x=bf, a=bf, w_in=bf, w_gate=bf, w_out=bf, ln2=torch.float32,
        post_ln1=torch.float32))
    fn = _build.function("fused_ffn", "fused_ffn_launch", _ARGTYPES)
    # each cluster's f32 partial of the down projection
    ws = torch.empty((G, B, D), dtype=torch.float32, device=x.device)
    o = torch.empty_like(x)
    r = torch.empty_like(x)
    arrivals = _build.arrival_counters("fused_ffn", x.device)
    ptrs = [t.data_ptr() if t is not None else None
            for t in (x, a, w_in, w_gate, w_out, ln2, post_ln1)]
    err = fn(*ptrs, ws.data_ptr(), arrivals.data_ptr(), o.data_ptr(),
             r.data_ptr(), B, D, F, G, C, ACTS[act], int(w_gate is not None),
             eps, float(add_r), _build.stream_ptr(x))
    _build.check(err, "fused_ffn")
    tracecount.launch("fused_ffn")
    return o, r
