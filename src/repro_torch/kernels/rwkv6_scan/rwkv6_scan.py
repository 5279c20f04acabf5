"""B7 — the RWKV-6 WKV scan: per (slot, head), over the time steps,

    o_t = r_t · (S + u ⊙ k_tᵀ v_t)        S ← diag(w_t) S + k_tᵀ v_t

with an f32 ``[hd, hd]`` state ``S`` from ``s0`` to ``s_fin``.

Replaces ``repro/kernels/rwkv6_scan/rwkv6_scan.py:rwkv6_scan_kernel``
(``pallas_call`` at line 71), whose oracle ``ref.py`` is the model's
``models/rwkv6._wkv_scan``.  The port runs it wherever the reference
runs that scan (the RWKV-6 time mix, at prefill with ``S`` = prompt
length) or its one-step form (``rwkv6_step``, decode, ``S`` = 1).

CUDA kernel: ``csrc/rwkv6_scan.cu``.  What bounds it on an H100: its
bytes (r, k, v, w, o once each, ``s0`` and ``s_fin`` once) at 3.35 TB/s,
with its f32 FLOPs on the CUDA cores just below; at prefill the FMAs
and shared-memory reads each of the ``S`` dependent steps issues set its
time.  Design: one CTA per (slot, head, 32 value columns), all resident
at once, keeps its share of the state in registers for the whole scan,
16 rows × 2 columns a lane, so every r, k, w value read from shared
memory serves two columns; each row group's share of ``o`` is one FMA
chain over its rows and ``o`` the four groups' sums in order (the same
f32 arithmetic, to the bit, as one column a thread); r, k, w and v
arrive as TMA boxes (2-D tensor maps) in a 4-chunk ring, two chunks in
flight, one barrier a chunk, and a third warp issues the boxes and
writes the outputs while two scan.  At ``S`` = 1 (decode) a one-step
kernel takes the same lanes and arithmetic without the ring.

``s_out``: where ``s_fin`` goes; it may be ``s0`` itself (the engine
updates the state in place), in both the kernel and the plain version.
The CUDA path takes f32 inputs and ``hd`` = 64; anything else raises
``NotImplementedError`` (ROADMAP.md) and never falls back to the plain
version, which is for CPU tensors and the tests only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build

_HEAD_DIMS = (64,)      # the kernel's template instances


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               s_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w ``[B, S, H, hd]``, u ``[H, hd]``, s0 ``[B, H, hd, hd]`` →
    ``(o [B, S, H, hd], s_fin [B, H, hd, hd] f32)``; ``s_fin`` is
    ``s_out`` when given.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    tracecount.call("rwkv6_scan")
    if r.is_cuda:
        return rwkv6_scan_cuda(r, k, v, w, u, s0, s_out=s_out)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0, s_out=s_out)
    raise ValueError(f"rwkv6_scan: unsupported device {r.device}")


def rwkv6_scan_plain(r, k, v, w, u, s0, *, s_out=None):
    """Plain PyTorch version: ``models/rwkv6._wkv_scan`` of the reference
    (its ``ref.py``), a Python loop over ``t`` in f32; ``o`` leaves in
    ``r``'s dtype, as the Pallas kernel's does."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[..., :, None]                           # [H, hd, 1]
    s = s0.float().clone()
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # [B, H, hd, hd]
        o[:, t] = torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    if s_out is not None:
        s = s_out.copy_(s)
    return o.to(r.dtype), s


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rwkv6_scan_cuda(r, k, v, w, u, s0, *, s_out=None):
    """Launch ``csrc/rwkv6_scan.cu`` on the current stream."""
    B, S, H, hd = r.shape
    if (hd not in _HEAD_DIMS or any(t.shape != r.shape for t in (k, v, w))
            or u.shape != (H, hd) or s0.shape != (B, H, hd, hd)
            or (s_out is not None and s_out.shape != s0.shape)):
        raise NotImplementedError(
            f"rwkv6_scan CUDA kernel: head dim in {_HEAD_DIMS}, r/k/v/w "
            "[B, S, H, hd], u [H, hd], s0 [B, H, hd, hd]; other shapes are "
            f"later work (ROADMAP.md, Queue B: B7); got r {tuple(r.shape)}, "
            f"u {tuple(u.shape)}, s0 {tuple(s0.shape)}")
    f32 = torch.float32
    o = torch.empty((B, S, H, hd), dtype=f32, device=r.device)
    s_fin = torch.empty_like(s0) if s_out is None else s_out
    tensors = dict(r=r, k=k, v=v, w=w, u=u, s0=s0, o=o, s_fin=s_fin)
    _build.require("rwkv6_scan", tensors, {n: f32 for n in tensors})
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise NotImplementedError(
            "rwkv6_scan CUDA kernel: every tensor must start on a 16-byte "
            "boundary (ROADMAP.md, Queue B: B7)")
    fn = _build.function("rwkv6_scan", "rwkv6_scan_launch", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in tensors.values()), B, S, H, hd,
             _build.stream_ptr(r))
    _build.check(err, "rwkv6_scan")
    tracecount.launch("rwkv6_scan")
    return o, s_fin
