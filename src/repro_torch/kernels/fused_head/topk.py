"""Top-k selection under one total order — the port of
``repro/kernels/fused_head/topk.py``.

Value descending, ties to the LOWEST index.  The plain head version,
the unfused prefill tail and the CUDA kernel's tile fold and merge
(``csrc/fused_head.cu``) all select through this order, so their
candidate sets agree index for index.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = 2 ** 31 - 1


def select_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``(vals [..., M], ids [..., M])`` → sorted ``(vals [..., k]
    f32, ids [..., k] int32)``: k passes of (max, lowest index among the
    maxima, mask), as the reference."""
    v = vals.float()
    i = ids.to(torch.int32)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=v.device)
    out_v, out_i = [], []
    for _ in range(k):
        mv = v.amax(dim=-1, keepdim=True)
        mi = torch.where(v == mv, i, big).amin(dim=-1, keepdim=True)
        out_v.append(mv)
        out_i.append(mi)
        v = torch.where((v == mv) & (i == mi), -torch.inf, v)
    return torch.cat(out_v, dim=-1), torch.cat(out_i, dim=-1)


def topk_pair_merge(a: Tuple[torch.Tensor, torch.Tensor],
                    b: Tuple[torch.Tensor, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted candidate sets into their joint top-k under the
    same order — commutative and associative over disjoint index sets,
    so any merge tree gives the same k winners."""
    av, ai = a
    bv, bi = b
    return select_topk(torch.cat([av, bv], dim=-1),
                       torch.cat([ai, bi], dim=-1), av.shape[-1])
