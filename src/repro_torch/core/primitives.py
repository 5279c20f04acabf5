"""Cluster-level collectives between processes — the port of
``repro/core/primitives.py`` over ``torch.distributed``.

The paper's two collectives (Alg. 1 and 2) use a binary-tree schedule:
in round ``r`` (stride ``2**r``) rank ``b`` sends to ``(b + stride) mod
N`` and receives from ``(b − stride) mod N``.  ClusterReduce applies
``⊕`` each round at a constant message size (``d = fn(d, recv)``, the
reference's order, so an f32 sum gives the reference's bits);
ClusterGather doubles the message each round and restores the canonical
order at the end.  Inside a GPU the port runs them over distributed
shared memory (``csrc/cluster.cuh``); here they run between processes,
each round one ``dist.batch_isend_irecv`` of this rank's send and
receive, on the model axis of a mesh (``launch/mesh.py``) — the
reference's ``ppermute`` on an ICI axis.

An axis is a :class:`MeshAxis` (one physical mesh axis as this process
sees it: the global ranks of its line, in axis order, and its process
group) or a :class:`SubAxis` of one (the model axis factored as
``heads × cluster``, cluster minor).  A sub-axis's rounds pair only the
ranks of one logical group, the reference's ``_ring_perm``.  Every rank
of the axis must call the same collective with the same shapes, or the
backend waits for the missing peer.

An axis of size 1 returns its input and moves nothing; a tree over an
axis whose size is not a power of two raises, as the reference does.
``cluster_reduce_xla`` is the reference's ``lax.psum``: on gloo (the
CPU, where the port is held against the reference) an all-gather and
the sum in rank order, ``((x0 + x1) + x2) + …``, which is XLA's CPU
``psum`` to the bit; on NCCL ``dist.all_reduce``, in the backend's own
order, so it agrees with the tree and with XLA only to rounding.  A bf16
or f16 tensor is summed in f32 and rounded once, as XLA's CPU ``psum``
of bf16 rounds (gloo's all-reduce would round after every add).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple, Union

import torch
import torch.distributed as dist

PyTree = Any


@dataclass(frozen=True, eq=False)
class MeshAxis:
    """One physical mesh axis as this process sees it: ``ranks``, the
    global ranks along its line in axis order; ``index``, this process's
    position among them; ``group``, the process group over them (None
    at size 1)."""

    name: str
    ranks: Tuple[int, ...]
    index: int
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True, eq=False)
class SubAxis:
    """A logical sub-axis of a physical axis (``repro`` ``SubAxis``):
    ``size`` logical ranks, ``minor_size`` the product of the sizes of
    the sub-axes minor to it (the stride between consecutive logical
    ranks on the physical axis)."""

    axis: MeshAxis
    size: int
    minor_size: int = 1

    @property
    def name(self) -> str:
        return self.axis.name

    def index(self) -> int:
        return (self.axis.index // self.minor_size) % self.size


Axis = Union[MeshAxis, SubAxis]

_REDUCE_OPS = {
    "sum": lambda a, b: a + b,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _axis_size(axis: Axis) -> int:
    return axis.size


def _phys(axis: Axis) -> MeshAxis:
    return axis.axis if isinstance(axis, SubAxis) else axis


def axis_index(axis: Axis) -> int:
    return axis.index() if isinstance(axis, SubAxis) else axis.index


def _ring_perm(axis: Axis, stride: int) -> List[Tuple[int, int]]:
    """The paper's send pattern over the physical axis: ``(src, dst)``
    pairs of physical indices, rank ``b`` sending to ``(b + stride) mod
    N``; on a :class:`SubAxis` only ranks of one logical group pair."""
    if not isinstance(axis, SubAxis):
        n = axis.size
        return [(b, (b + stride) % n) for b in range(n)]
    n, ms = axis.size, axis.minor_size
    perm = []
    for r in range(axis.axis.size):
        b = (r // ms) % n
        perm.append((r, r + ((b + stride) % n - b) * ms))
    return perm


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _tree_map(fn: Callable, *trees):
    t = trees[0]
    if torch.is_tensor(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"not a tensor tree: {type(t)}")


def ppermute(x: torch.Tensor, axis: Axis, stride: int) -> torch.Tensor:
    """One round of the tree: send ``x`` to the peer ``stride`` ahead on
    ``axis`` and return what the peer ``stride`` behind sent."""
    phys = _phys(axis)
    perm = _ring_perm(axis, stride)
    me = phys.index
    dst = perm[me][1]
    src = next(s for s, d in perm if d == me)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, phys.ranks[dst]),
        dist.P2POp(dist.irecv, out, phys.ranks[src])])
    for r in reqs:
        r.wait()
    return out


# ---------------------------------------------------------------------------
# ClusterReduce — Alg. 1
# ---------------------------------------------------------------------------
def cluster_reduce(x: PyTree, axis: Axis, op: Union[str, Callable] = "sum"
                   ) -> PyTree:
    """All-reduce ``x`` over ``axis`` on the tree: ``log2 N`` rounds of
    constant size, ``d = fn(d, recv)`` each (``primitives.py:107``)."""
    n = _axis_size(axis)
    if n == 1:
        return x
    if not _is_pow2(n):
        raise ValueError(
            f"cluster axis size must be 2**k (paper Alg. 1); got {n}")
    fn = _REDUCE_OPS[op] if isinstance(op, str) else op

    def reduce_leaf(leaf):
        d, stride = leaf, 1
        while stride < n:
            d = fn(d, ppermute(d, axis, stride))
            stride *= 2
        return d

    return _tree_map(reduce_leaf, x)


def cluster_reduce_pairs(x: PyTree, axis: Axis,
                         merge: Callable[[PyTree, PyTree], PyTree]) -> PyTree:
    """ClusterReduce with a structured operator ``merge(mine, theirs)``
    over a whole tree each round (``primitives.py:136``): the flash
    combine's ``(m, l, o)`` and the head's ``(values, ids)``."""
    n = _axis_size(axis)
    if n == 1:
        return x
    if not _is_pow2(n):
        raise ValueError(f"cluster axis size must be 2**k; got {n}")
    d, stride = x, 1
    while stride < n:
        recv = _tree_map(lambda leaf: ppermute(leaf, axis, stride), d)
        d = merge(d, recv)
        stride *= 2
    return d


# ---------------------------------------------------------------------------
# ClusterGather — Alg. 2
# ---------------------------------------------------------------------------
def cluster_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """All-gather ``x`` over ``axis`` on the tree → ``[N, *x.shape]`` in
    canonical rank order (``primitives.py:165``): round ``r`` sends the
    first ``2**r`` segments, and the buffer, filled in reverse ring order
    ``[b, b − 1, …]``, is reordered at the end."""
    n = _axis_size(axis)
    if n == 1:
        return x[None]
    if not _is_pow2(n):
        raise ValueError(
            f"cluster axis size must be 2**k (paper Alg. 2); got {n}")
    buf, stride = x[None], 1
    while stride < n:
        buf = torch.cat([buf, ppermute(buf[:stride], axis, stride)], dim=0)
        stride *= 2
    b = axis_index(axis)
    idx = torch.tensor([(b - j) % n for j in range(n)], device=x.device)
    return buf[idx]


def cluster_gather_tiled(x: torch.Tensor, axis: Axis, dim: int = 0
                         ) -> torch.Tensor:
    """:func:`cluster_gather` with the segments concatenated along
    ``dim`` (``primitives.py:197``)."""
    n = _axis_size(axis)
    if n == 1:
        return x
    out = torch.movedim(cluster_gather(x, axis), 0, dim)
    shape = x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:]
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# The backend's own collectives (the reference's XLA path)
# ---------------------------------------------------------------------------
_DIST_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def cluster_reduce_xla(x: PyTree, axis: MeshAxis, op: str = "sum") -> PyTree:
    """``dist.all_reduce`` over a whole physical axis (the reference's
    ``lax.psum``/``pmax``/``pmin``), into new tensors."""
    if op not in _DIST_OPS:
        raise ValueError(op)
    if axis.size == 1:
        return x

    in_order = op == "sum" and dist.get_backend(axis.group) == "gloo"

    def leaf(t):
        # a 16-bit float sums in f32 and rounds once, as XLA's psum does
        low = t.dtype in (torch.bfloat16, torch.float16)
        out = t.float() if low else t.clone()
        if in_order:             # XLA's CPU psum: rank 0 + rank 1 + …
            parts = cluster_gather_xla(out, axis, tiled=False)
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
        else:
            dist.all_reduce(out, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                            group=axis.group)
        return out.to(t.dtype) if low else out

    return _tree_map(leaf, x)


def cluster_gather_xla(x: torch.Tensor, axis: MeshAxis, dim: int = 0,
                       tiled: bool = True) -> torch.Tensor:
    """``dist.all_gather`` over a whole physical axis (the reference's
    ``lax.all_gather``)."""
    if axis.size == 1:
        return x if tiled else x[None]
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return (torch.cat(parts, dim=dim) if tiled
            else torch.stack(parts, dim=dim))


def offchip_reduce(x: torch.Tensor, axis: MeshAxis, op: str = "sum"
                   ) -> torch.Tensor:
    """The global-memory pattern the paper ablates against
    (``primitives.py:229``): every rank gathers all ``N`` buffers, then
    reduces them locally in rank order — ``size · N`` bytes a rank
    against the tree's ``size · log2 N``."""
    allbuf = cluster_gather_xla(x, axis, dim=0, tiled=False)
    if op == "sum":
        return allbuf.sum(dim=0)
    if op == "max":
        return allbuf.amax(dim=0)
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Traffic model (paper §3.2)
# ---------------------------------------------------------------------------
def traffic_reduce(size: float, n: int) -> float:
    """``Traffic_Reduce(size, N) = size · log2(N) · N``."""
    if n <= 1:
        return 0.0
    return float(size) * math.log2(n) * n


def traffic_gather(size: float, n: int) -> float:
    """``Traffic_Gather(size, N) = size · (2^(log2(N/2)+1) − 1) · N``."""
    if n <= 1:
        return 0.0
    return float(size) * (2 ** (math.log2(n / 2) + 1) - 1) * n


# ---------------------------------------------------------------------------
# Online-softmax combine
# ---------------------------------------------------------------------------
def flash_merge(a: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                b: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """Merge two flash-attention partials ``(m, l, o)`` — ``m`` the
    running max, ``l = Σ exp(s − m)``, ``o = Σ exp(s − m)·v``
    (``primitives.py:266``)."""
    m_a, l_a, o_a = a
    m_b, l_b, o_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return m, l_a * ca + l_b * cb, o_a * ca[..., None] + o_b * cb[..., None]


def cluster_flash_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                          axis: Axis, *, fused: bool = True):
    """Combine per-rank FlashDecoding partials over ``axis``
    (``primitives.py:284``).  ``fused``: one tree with the flash-merge
    operator; otherwise the paper's Alg. 3 — ClusterReduce the maxima,
    rescale, ClusterReduce ``l``, then the outputs."""
    if fused:
        return cluster_reduce_pairs((m, l, o), axis, flash_merge)
    g_max = cluster_reduce(m, axis, "max")
    scale = torch.exp(m - g_max)
    g_sum = cluster_reduce(l * scale, axis, "sum")
    o_sum = cluster_reduce(o * scale[..., None], axis, "sum")
    return g_max, g_sum, o_sum
