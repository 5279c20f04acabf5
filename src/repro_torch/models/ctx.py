"""Parallel execution context — the port of ``repro/models/ctx.py``.

Model code that can run on a mesh takes a :class:`ParallelCtx`: either
the axes of a mesh (``launch/mesh.py``) — the model axis whole, its
``heads`` and ``cluster`` sub-axes, the data axis — or the single-device
context, whose collectives are the identity and move nothing (the
default everywhere, so a model axis of 1 runs what it ran before the
model axis existed).  The collectives are ``core/primitives.py``'s: the
paper's trees, or ``dist.all_reduce`` where the reference calls
``lax.psum``.  Indices are Python ints (this process's own position),
where the reference's are traced values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import primitives as prim
from repro_torch.core.primitives import Axis, MeshAxis, SubAxis


@dataclass(frozen=True, eq=False)
class ParallelCtx:
    """Axis bindings (``ctx.py:25``).  ``model``: the whole model axis
    (a :class:`MeshAxis`) or None; ``heads``: the sub-axis sharding the
    heads (the whole axis when the head count divides it); ``cluster``:
    the paper's cluster sub-axis (size 1 on the head-parallel layout);
    ``data``: the data-parallel axes; ``fused_combine``: the decode
    adapters' flash combine over the cluster as one tree with the
    flash-merge operator (the reference's option, off by default)."""

    model: Optional[Axis] = None
    heads: Optional[Axis] = None
    cluster: Optional[Axis] = None
    data: Tuple[MeshAxis, ...] = ()
    model_static: int = 1
    fused_combine: bool = False

    # -- sizes -------------------------------------------------------------
    @property
    def model_size(self) -> int:
        if self.model is None:
            return 1
        if isinstance(self.model, SubAxis):
            return self.model.size
        return self.model_static

    @property
    def heads_size(self) -> int:
        return self.heads.size if self.heads is not None else 1

    @property
    def cluster_size(self) -> int:
        return self.cluster.size if self.cluster is not None else 1

    # -- collectives (the identity when unbound) ----------------------------
    def psum_model(self, x):
        if self.model is None:
            return x
        if isinstance(self.model, SubAxis):
            return prim.cluster_reduce(x, self.model, "sum")
        return prim.cluster_reduce_xla(x, self.model, "sum")

    def psum_heads(self, x):
        """The heads reduce of the train and prefill paths: an ordinary
        all-reduce when ``heads`` spans the whole model axis at cluster 1
        (the reference's rule, ``ctx.py:80–93``: it moves ``2(N−1)/N ·
        size`` against the tree's ``log2 N · size`` on ``[B, S, D]``
        activations), the tree otherwise."""
        if self.heads is None:
            return x
        if (isinstance(self.heads, SubAxis)
                and self.heads.size == self.model_size
                and self.cluster_size == 1):
            return prim.cluster_reduce_xla(x, self.heads.axis, "sum")
        return prim.cluster_reduce(x, self.heads, "sum")

    def gather_cluster(self, x, dim: int):
        """ClusterGather (paper Alg. 2) along ``dim``."""
        if self.cluster is None:
            return x
        return prim.cluster_gather_tiled(x, self.cluster, dim=dim)

    def reduce_cluster(self, x, op="sum"):
        if self.cluster is None:
            return x
        return prim.cluster_reduce(x, self.cluster, op)

    def heads_index(self) -> int:
        return prim.axis_index(self.heads) if self.heads is not None else 0

    def cluster_index(self) -> int:
        return prim.axis_index(self.cluster) if self.cluster is not None else 0

    def model_index(self) -> int:
        return prim.axis_index(self.model) if self.model is not None else 0

    def data_index(self) -> int:
        """This process's position on the (flattened) data axes."""
        i = 0
        for ax in self.data:
            i = i * ax.size + ax.index
        return i


def make_train_ctx(model_axis: Optional[MeshAxis] = None, heads_sub: int = 0,
                   model_size: int = 1, data: Tuple[MeshAxis, ...] = (),
                   **extra) -> ParallelCtx:
    """A context factoring ``model_axis`` into ``heads_sub × cluster``
    (``ctx.py:119``); ``heads_sub == model_size`` is head-parallel with
    a cluster of 1."""
    if model_size == 1:
        return ParallelCtx(data=data, **extra)
    heads_sub = heads_sub or model_size
    seq_sub = model_size // heads_sub
    heads = SubAxis(model_axis, heads_sub, minor_size=seq_sub)
    cluster = SubAxis(model_axis, seq_sub, minor_size=1)
    return ParallelCtx(model=model_axis, heads=heads, cluster=cluster,
                       data=data, model_static=model_size, **extra)


def single_device_ctx() -> ParallelCtx:
    return ParallelCtx()


SINGLE = single_device_ctx()


def pick_heads_sub(n_heads: int, n_kv: int, model_size: int) -> int:
    """The largest power of two ≤ ``model_size`` dividing ``n_heads``
    (``ctx.py:141``); the rest of the axis becomes the cluster."""
    h = model_size
    while h > 1 and (n_heads % h) != 0:
        h //= 2
    return max(h, 1)
