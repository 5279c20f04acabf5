"""Meshes over an initialised ``torch.distributed`` world — the port of
``repro/launch/mesh.py``.

A :class:`Mesh` is ``data × model`` processes, one GPU each on the card
(NCCL) or one CPU process each (gloo), rank ``d·model + m`` at
``(d, m)``: the device order of ``jax.make_mesh((data, model), ("data",
"model"))``.  It holds this process's two axes (``core/primitives.py``
:class:`MeshAxis`, each with its process group) and its device.  Every
process of the world must build the same mesh, in the same order, since
building one makes every group of the world.

:func:`init_world` starts the world: NCCL for ``device="cuda"`` (it
raises when the host has fewer GPUs than ranks; NCCL refuses two ranks
on one device), gloo for ``device="cpu"``.  It never falls back from
one to the other.  Give it a ``store`` (the tests' ``FileStore``, no
port bound) or an ``init_method`` (``tcp://localhost:<port>``).
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.core.primitives import MeshAxis

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _check_gpus(world_size: int) -> None:
    n = torch.cuda.device_count()
    if n < world_size:
        raise RuntimeError(
            f"a CUDA mesh of {world_size} ranks needs {world_size} GPUs on "
            f"this host, and {n} are visible (NCCL takes one rank a GPU; "
            "pass device='cpu' for gloo processes)")


def init_world(rank: int, world_size: int, *, device="cuda", store=None,
               init_method: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """``dist.init_process_group`` with the backend of ``device``: NCCL on
    the card (rank ``r`` on ``cuda:r``), gloo on the CPU; ``timeout``
    bounds how long a collective waits for a missing peer."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _check_gpus(world_size)
        torch.cuda.set_device(rank)
    kw = {"store": store} if store is not None else {
        "init_method": init_method or "env://"}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(_BACKEND[dev.type], rank=rank,
                            world_size=world_size, **kw)


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape`` ``{"data": d, "model": m}``, this process's ``axes`` and
    ``device``; ``rank`` is its global rank."""

    shape: Dict[str, int]
    axes: Dict[str, MeshAxis]
    rank: int
    device: torch.device


def make_mesh(data: int, model: int, *, device="cuda") -> Mesh:
    """The ``data × model`` mesh of the initialised world, whose size must
    be ``data · model``: the model groups ``{d·model + m : m}`` and the
    data groups ``{d·model + m : d}``, all made on every process (a
    group of one is not made)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("init_world (torch.distributed) first")
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise RuntimeError(
            f"a {dev.type} mesh runs on {_BACKEND[dev.type]}, and the world "
            f"runs {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"a {data} × {model} mesh needs {data * model} "
                         f"ranks; the world has {world}")
    if dev.type == "cuda":
        _check_gpus(world)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    axes = {}
    lines = {"model": [[d * model + m for m in range(model)]
                       for d in range(data)],
             "data": [[d * model + m for d in range(data)]
                      for m in range(model)]}
    for name in ("model", "data"):
        mine = None
        for ranks in lines[name]:
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = MeshAxis(name, tuple(ranks), ranks.index(rank), group)
        axes[name] = mine
    return Mesh({"data": data, "model": model}, axes, rank, dev)


def make_test_mesh(data: int = 2, model: int = 4, *, device="cuda") -> Mesh:
    """The tests' 2 × 4 mesh (``mesh.py:make_test_mesh``) of the
    initialised world."""
    return make_mesh(data, model, device=device)


def dp_axes_of(mesh: Mesh) -> tuple:
    return ("data",)


def dp_size_of(mesh: Mesh) -> int:
    return mesh.shape["data"]
