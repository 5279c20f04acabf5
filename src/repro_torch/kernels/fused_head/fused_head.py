"""B3 — fused LM-head / sampling tail: final RMSNorm, f32 logits over the
vocabulary, streaming top-k (value descending, ties to the lowest index).

Replaces ``repro/kernels/fused_head/fused_head.py:fused_head_block``
(``pallas_call`` at line 128) with ``topk.select_topk`` and
``topk.topk_pair_merge``, with or without the logit softcap
``tanh(l/cap)·cap`` (Gemma-2's 30), at most 8 slots and ``k`` ≤ 8.  The
cap applies to every f32 logit before it enters the running top-k
(``fused_head.py:79–80``): f32 rounding can make two different logits
equal after it, and the tie then goes to the lower index, which capping
only the survivors would not reproduce.

CUDA kernel: ``csrc/fused_head.cu``, one device launch.  What bounds it
on an H100: bytes — the ``[V, D]`` bf16 table (262.1 MB at Llama2-7B) is
read once per step for all slots.  Design: ``G`` thread-block clusters of
``C`` CTAs (:func:`cluster_plan`: 15 of 8 at every served width, the most
an H100 runs at once at one CTA an SM).  Each CTA owns a contiguous run of
16-row vocabulary units (the ragged last unit masked), streams it through
a 4-stage ``cp.async`` ring whose first stages load while the rounded
final norm is computed, takes the logits on the tensor cores
(``mma.sync``: 16 table rows as A, the slots as n; each stage's 32-dim
product added to an f32 sum on the CUDA cores) and keeps a per-slot
running top-8 in registers.  The cluster's ranks merge their candidates
over distributed shared memory (``cluster::topk``, a ClusterReduce whose
operator is ``topk_pair_merge``) into ``[G, B, k]`` partials, and the
last cluster to arrive (an int32 arrival counter the kernel resets)
merges those.  The selection does no arithmetic, so a second launch
gives the same bits.  One wrapper call is one launch and one count; the
``[B, V]`` logits never reach device memory.

The plain version (:func:`fused_head_plain`) is for CPU tensors and the
tests only.  What must match the reference: indices exactly; values to a
few f32 ulps of the f64 sum (the summation order differs — ROADMAP
faults C1 and C3).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.kernels.fused_head.topk import select_topk
from repro_torch.models.layers import rms_norm

_MAX_B = 8
_MAX_K = 8
_MAX_D = 9216         # the widest h beside a 2-stage ring in 227 KB (csrc
                      # stages(): 4 stages up to 5120, 3 up to 7168)


@functools.lru_cache(maxsize=None)
def cluster_plan(vocab: int, d_model: int) -> Tuple[int, int]:
    """``(G, C)``: ``G`` clusters of ``C`` CTAs for the shapes alone.
    ``C`` is 8, or the largest power of two with a 16-row vocabulary
    unit for each CTA; ``G`` brings the grid to ``_build.WAVE_CTAS`` CTAs,
    at most one a unit.  ``(0, 0)`` where the kernel takes no such
    shape (``d_model`` not a multiple of 8 or over ``_MAX_D``)."""
    if d_model % 8 or not 0 < d_model <= _MAX_D or vocab < 1:
        return 0, 0
    units = -(-vocab // 16)
    c = _build.MAX_CLUSTER
    while c > units:
        c //= 2
    return max(1, min(_build.WAVE_CTAS // c, units // c)), c


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
    descending, ties to the lowest index; the values softcapped.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; any other device raises."""
    tracecount.call("fused_head")
    kw = dict(eps=eps, logit_softcap=logit_softcap, k=k)
    if x.is_cuda:
        return fused_head_cuda(x, table, ln, **kw)
    if x.device.type == "cpu":
        return fused_head_plain(x, table, ln, **kw)
    raise ValueError(f"fused_head_block: unsupported device {x.device}")


# vocabulary rows a tile of the plain version's f64 product: no f64
# temporary is the table's size
PLAIN_TILE_ROWS = 16384


def fused_head_plain(x, table, ln, *, eps=1e-6, logit_softcap=0.0, k=8):
    """Plain PyTorch version (the reference's ``ref.py``): the rounded
    norm, logits over the whole vocabulary, the softcap on every logit in
    f32, one ``select_topk``.  The logits are the correctly rounded f32
    values (summed in f64, ``PLAIN_TILE_ROWS`` table rows at a time), so a
    kernel's own f32 summation error is held against the exact sum."""
    h = rms_norm(x, ln, eps).double()
    logits = torch.cat([(h @ table[v0:v0 + PLAIN_TILE_ROWS].double().T)
                        .float() for v0 in range(0, table.shape[0],
                                                 PLAIN_TILE_ROWS)],
                       dim=-1)                                   # [B, V]
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    ids = torch.arange(logits.shape[-1], dtype=torch.int32,
                       device=x.device).expand_as(logits)
    return select_topk(logits, ids, k)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def fused_head_cuda(x, table, ln, *, eps=1e-6, logit_softcap=0.0, k=8):
    """Launch ``csrc/fused_head.cu`` on the current stream: one launch of
    ``cluster_plan`` clusters for the whole batch."""
    B, D = x.shape
    V = table.shape[0]
    G, C = cluster_plan(V, D)
    if B > _MAX_B or not C or not 1 <= k <= _MAX_K or table.shape[1] != D:
        raise NotImplementedError(
            f"fused_head CUDA kernel: B ≤ {_MAX_B}, D % 8 == 0 and "
            f"D ≤ {_MAX_D}, 1 ≤ k ≤ {_MAX_K} (ROADMAP.md, Queue B: B3); "
            f"got x {tuple(x.shape)}, table {tuple(table.shape)}, k={k}")
    tensors = dict(x=x, table=table, ln=ln)
    _build.require("fused_head", tensors, dict(
        x=torch.bfloat16, table=torch.bfloat16, ln=torch.float32))
    if any(t.data_ptr() % 16 for t in tensors.values()):
        raise NotImplementedError(
            "fused_head CUDA kernel: x, table and ln must start on a 16-byte "
            "boundary (ROADMAP.md, Queue B: B3)")
    fn = _build.function("fused_head", "fused_head_launch", _ARGTYPES)
    # each cluster's candidates, merged by the last cluster to arrive
    part_v = torch.empty((G, B, k), dtype=torch.float32, device=x.device)
    part_i = torch.empty((G, B, k), dtype=torch.int32, device=x.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    arrivals = _build.arrival_counters("fused_head", x.device)
    err = fn(*(t.data_ptr() for t in tensors.values()), part_v.data_ptr(),
             part_i.data_ptr(), arrivals.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), B, D, V, k, G, C, eps, float(logit_softcap),
             _build.stream_ptr(x))
    _build.check(err, "fused_head")
    tracecount.launch("fused_head")
    return vals, idx
