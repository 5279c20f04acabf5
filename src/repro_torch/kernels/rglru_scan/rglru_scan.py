"""B6 — the RG-LRU scan: per (slot, channel), over the time steps,

    h_t = exp(log_a_t) · h_{t−1} + b_t

from ``h0``, returning every ``h_t`` and the last one in f32.

Replaces ``repro/kernels/rglru_scan/rglru_scan.py:rglru_scan_kernel``
(``pallas_call`` at line 61; oracle ``ref.py``).  The reference's model
never calls it (``models/rglru.py:rglru_scan`` uses an associative scan,
``rglru_step`` one fused step); the port runs it in both places: prefill
at ``S`` = prompt length and every decode step at ``S`` = 1 (the
recurrence of ``rglru_step``, ``rglru.py:104–106``).  The gates, the
``exp``/``sqrt`` of the input scale and ``i ⊙ u`` stay in torch.

CUDA kernel: ``csrc/rglru_scan.cu``.  What bounds it on an H100: its
bytes (``log_a``, ``b`` and ``h_seq`` once each, ``h0`` and ``h_fin``
once) at 3.35 TB/s.  One thread per (slot, channel) keeps ``h`` in a
register for the whole scan and issues a chunk of steps' loads before
their dependent multiply-adds.

``h_out``: where ``h_fin`` goes; it may be ``h0`` itself (the engine
updates the state in place), in both the kernel and the plain version.
The CUDA path takes contiguous f32 tensors and any ``S ≥ 1``; anything
else raises ``NotImplementedError`` (ROADMAP.md) and never falls back to
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               h_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``log_a``/``b [B, S, C]``, ``h0 [B, C]`` → ``(h_seq [B, S, C] in
    log_a's dtype, h_fin [B, C] f32)``; ``h_fin`` is ``h_out`` when given.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    tracecount.call("rglru_scan")
    if log_a.is_cuda:
        return rglru_scan_cuda(log_a, b, h0, h_out=h_out)
    if log_a.device.type == "cpu":
        return rglru_scan_plain(log_a, b, h0, h_out=h_out)
    raise ValueError(f"rglru_scan: unsupported device {log_a.device}")


def rglru_scan_plain(log_a, b, h0, *, h_out=None):
    """Plain PyTorch version: the reference's ``ref.py`` (a sequential
    scan), a Python loop over ``t`` in f32; ``h_seq`` leaves in
    ``log_a``'s dtype, as the Pallas kernel's does."""
    a, bb = torch.exp(log_a.float()), b.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bb[:, t]
        out[:, t] = h
    if h_out is not None:
        h = h_out.copy_(h)
    return out.to(log_a.dtype), h


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rglru_scan_cuda(log_a, b, h0, *, h_out=None):
    """Launch ``csrc/rglru_scan.cu`` on the current stream."""
    if (log_a.dim() != 3 or b.shape != log_a.shape
            or h0.shape != (log_a.shape[0], log_a.shape[2])
            or (h_out is not None and h_out.shape != h0.shape)
            or not all(t.is_contiguous() for t in (log_a, b, h0))):
        raise NotImplementedError(
            "rglru_scan CUDA kernel: contiguous log_a and b [B, S, C], h0 "
            "[B, C]; got "
            f"log_a {tuple(log_a.shape)}, b {tuple(b.shape)}, h0 "
            f"{tuple(h0.shape)} (ROADMAP.md, Queue B: B6)")
    B, S, C = log_a.shape
    f32 = torch.float32
    h_seq = torch.empty((B, S, C), dtype=f32, device=log_a.device)
    h_fin = torch.empty_like(h0) if h_out is None else h_out
    tensors = dict(log_a=log_a, b=b, h0=h0, h_seq=h_seq, h_fin=h_fin)
    _build.require("rglru_scan", tensors, {n: f32 for n in tensors})
    fn = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in tensors.values()), B, S, C,
             _build.stream_ptr(log_a))
    _build.check(err, "rglru_scan")
    tracecount.launch("rglru_scan")
    return h_seq, h_fin
