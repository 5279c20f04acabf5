"""B3 — fused LM-head / sampling tail: final RMSNorm, f32 logits one
vocab tile at a time, streaming top-k (value descending, ties to the
lowest index).

Replaces ``repro/kernels/fused_head/fused_head.py:fused_head_block``
(``pallas_call`` at line 128) with ``topk.select_topk``; no softcap (the
Gemma-2 slice; it raises ``NotImplementedError``).

CUDA kernel: ``csrc/fused_head.cu``.  What bounds it on an H100: bytes —
the ``[V, D]`` table (262.1 MB at Llama2-7B) is read once per step for
all slots.  Design: one block per 128 vocab rows (250 blocks; the ragged
last tile is masked, so V needs no divisor tile), a warp per row with
16-byte loads, a per-slot top-k of the tile in registers; a second
launch from the same source merges the ``[n_tiles, B, k]`` partials in
the same total order.  Both launches are one wrapper call and one count;
the ``[B, V]`` logits never reach device memory.

What must match the reference: indices exactly; values to a few f32
ulps (the summation order differs — ROADMAP fault C1).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.kernels.fused_head.topk import select_topk
from repro_torch.models.layers import rms_norm

_MAX_B = 8
_MAX_K = 8


def fused_head_block(
    x: torch.Tensor,                  # [B, D] raw residual stream
    table: torch.Tensor,              # [V, D] LM-head table
    ln: torch.Tensor,                 # [D] f32 final norm scale
    *,
    eps: float = 1e-6,
    logit_softcap: float = 0.0,
    k: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(values [B, k] f32, indices [B, k] int32)`` sorted value
    descending, ties to the lowest index.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    if logit_softcap:
        raise NotImplementedError(
            "the port's fused_head has no logit softcap yet (the Gemma-2 "
            "slice, ROADMAP.md)")
    tracecount.call("fused_head")
    if x.is_cuda:
        return fused_head_cuda(x, table, ln, eps=eps, k=k)
    if x.device.type == "cpu":
        return fused_head_plain(x, table, ln, eps=eps, k=k)
    raise ValueError(f"fused_head_block: unsupported device {x.device}")


def fused_head_plain(x, table, ln, *, eps=1e-6, k=8):
    """Plain PyTorch version (the reference's ``ref.py``): the rounded
    norm, logits over the whole vocabulary, one ``select_topk``.  The
    logits are the correctly rounded f32 values (summed in f64), so a
    kernel's own f32 summation error is held against the exact sum."""
    h = rms_norm(x, ln, eps).double()
    logits = (h @ table.double().T).float()                      # [B, V]
    ids = torch.arange(logits.shape[-1], dtype=torch.int32,
                       device=x.device).expand_as(logits)
    return select_topk(logits, ids, k)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
    + [ctypes.c_float] + [ctypes.c_void_p]


def fused_head_cuda(x, table, ln, *, eps=1e-6, k=8):
    """Launch ``csrc/fused_head.cu`` on the current stream."""
    B, D = x.shape
    V = table.shape[0]
    if B > _MAX_B or D % 8 or not 1 <= k <= _MAX_K or table.shape[1] != D:
        raise NotImplementedError(
            f"fused_head CUDA kernel: B ≤ {_MAX_B}, D % 8 == 0, "
            f"1 ≤ k ≤ {_MAX_K}; got x {tuple(x.shape)}, k={k}")
    tensors = dict(x=x, table=table, ln=ln)
    _build.require("fused_head", tensors, dict(
        x=torch.bfloat16, table=torch.bfloat16, ln=torch.float32))
    fn = _build.function("fused_head", "fused_head_launch", _ARGTYPES)
    # the workspace is sized by the kernel's own tile count
    tiles = _build.function("fused_head", "fused_head_tiles", [ctypes.c_int])
    n_tiles = tiles(V)
    part_v = torch.empty((n_tiles, B, k), dtype=torch.float32,
                         device=x.device)
    part_i = torch.empty((n_tiles, B, k), dtype=torch.int32, device=x.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    err = fn(*(t.data_ptr() for t in tensors.values()), part_v.data_ptr(),
             part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, D, V, k,
             eps, _build.stream_ptr(x))
    _build.check(err, "fused_head")
    tracecount.launch("fused_head")
    return vals, idx
