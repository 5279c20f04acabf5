"""One decode step as one CUDA-graph replay — the port's counterpart of
the reference's jitted step (``repro/launch/serve.py:306``,
``jax.jit(shard_map(dec_body, ...))``).  The reference has no module
for it: there ``jax.jit`` is a call.

:class:`StepGraph` captures :func:`~repro_torch.serving.engine.decode_step`
once, on one engine's serve params and decode state, and replays it: a
step is then a few copies and one ``cudaGraphLaunch`` on the host,
where the eager step issues every launch from Python.  It owns fixed
device buffers for the step's small inputs — ``tokens [B]`` int32,
``cache_lens [B]``, the sampling leaves and, under ``check_finite``,
``nonfinite`` — and the captured step writes its results back into the
same buffers; the KV caches and recurrent states are updated in place
by the step already, and an encoder-decoder's ``enc_kv`` in place by
prefill, so the graph is bound to the engine's tensors.

The graph is built for those tensors and no others: params other than
the captured ones, or a state whose caches or recurrent tensors are not
the captured ones, raise ``ValueError``.  It never re-captures and never
falls back to the eager step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.serving.engine import (ServeConfig, decode_step,
                                        init_decode_state)
from repro_torch.serving.sampling import SAMPLING_LEAVES

WARMUP_STEPS = 2


def capture_graph(step: Callable[[], None], device: torch.device
                  ) -> Callable[[], None]:
    """Capture ``step`` (no arguments; it reads and writes fixed tensors)
    into a CUDA graph with the default ``capture_error_mode="global"`` —
    a host sync or a blocking copy inside the step raises — and return
    the graph's replay.  The graph and its private memory pool live as
    long as the replay does."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        step()
    return graph.replay


def _big_leaves(state: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors updated in place: every KV cache, ``pos`` and recurrent
    state of the layer groups and the tail, and an encoder-decoder's
    ``enc_kv``, which prefill writes in place and the step reads (a
    rebound tensor would leave the graph reading stale keys)."""
    enc = state.get("enc_kv", {})
    return [t for block in state["layers"] + state["tail"] for t in block] \
        + [enc[n] for n in sorted(enc)]


def _small_leaves(state: Dict[str, Any], check_finite: bool
                  ) -> List[torch.Tensor]:
    """The tensors a step returns anew: ``cache_lens``, the sampling
    leaves and, under ``check_finite``, ``nonfinite``."""
    return ([state["cache_lens"]]
            + [state["sampling"][n] for n in SAMPLING_LEAVES]
            + ([state["nonfinite"]] if check_finite else []))


def _step_fn(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
             static: Dict[str, Any], tokens: torch.Tensor,
             out: torch.Tensor) -> Callable[[], None]:
    """The captured step: ``decode_step`` on the static state and tokens,
    its results copied back into the static buffers.  It holds only
    tensors, not the :class:`StepGraph`, so dropping the engine frees the
    graph (no reference cycle)."""
    static = dict(static, sampling=dict(static["sampling"]))
    small = _small_leaves(static, scfg.check_finite)

    def step():
        nxt, new = decode_step(cfg, scfg, params, static, tokens)
        out.copy_(nxt)
        for dst, src in zip(small, _small_leaves(new, scfg.check_finite)):
            dst.copy_(src)
    return step


def _copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst``
    (broadcast where ``src``'s leaf has fewer rows)."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:                          # lists and named tuples
        for d, s in zip(dst, src):
            _copy_tree(d, s)


class StepGraph:
    """``decode_fn(params, state, tokens) → (next tokens [B], state)`` as
    one replay of a graph captured on ``params`` and ``state``.

    Capture, at construction: ``WARMUP_STEPS`` eager steps (on a side
    stream on the card, after building every kernel), so that the
    kernels are loaded, the cluster launches have checked their shapes
    (``csrc/cluster.cuh``) and cuBLAS has its handles and workspaces
    before the capture; then the capture; then ``state`` is put back,
    in place, to exactly what ``init_decode_state`` makes.  ``state``'s
    small leaves become the graph's input buffers.

    Per call: a small leaf of ``state`` that is not the buffer (a
    ``retire_fn`` or an admit returns new ones) is copied in, then the
    tokens, then the graph replays.  The returned state's small leaves
    are the buffers (the next replay overwrites them, as the step
    updates the caches in place); the returned tokens are a copy.

    ``launches``: the kernel launches the capture counted, which every
    replay credits to ``tracecount.launches()``; ``replays``: this
    graph's replays."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 params: Dict[str, Any], state: Dict[str, Any]):
        dev = state["cache_lens"].device
        B = scfg.batch_local
        self._params = params
        self._check_finite = scfg.check_finite
        self._big_ptrs = [t.data_ptr() for t in _big_leaves(state)]
        self._small = _small_leaves(state, scfg.check_finite)
        self._tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._next = torch.zeros((B,), dtype=torch.int32, device=dev)
        step = _step_fn(cfg, scfg, params, state, self._tokens, self._next)
        # on the card the warm-up runs on a side stream (None: no-op)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if side is not None:
            _build.build_all()
            side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        with tracecount.capturing() as counted:
            self._replay = capture_graph(step, dev)
        self.launches = dict(counted)
        self.replays = 0
        # the warm-up leaves no trace: a fresh state of one cache row,
        # broadcast along the rows (every cache row starts alike; a
        # full-size fresh state would double the caches, 13.1 GB at
        # Gemma-2 27B's width)
        _copy_tree(state, init_decode_state(
            cfg, dataclasses.replace(scfg, max_seq=1), device=dev))
        self._tokens.zero_()
        self._next.zero_()

    def __call__(self, params: Dict[str, Any], state: Dict[str, Any],
                 tokens) -> tuple:
        if params is not self._params:
            raise ValueError("StepGraph: params are not the ones the graph "
                             "was captured on")
        if [t.data_ptr() for t in _big_leaves(state)] != self._big_ptrs:
            raise ValueError("StepGraph: the state's caches or recurrent "
                             "states are not the ones the graph was "
                             "captured on")
        for dst, src in zip(self._small,
                            _small_leaves(state, self._check_finite)):
            if src is not dst:
                dst.copy_(src)
        tok = tokens if torch.is_tensor(tokens) else torch.from_numpy(
            np.asarray(tokens))
        if tok.shape != self._tokens.shape:
            raise ValueError(f"StepGraph: tokens of shape {tuple(tok.shape)}"
                             f", want {tuple(self._tokens.shape)}")
        self._tokens.copy_(tok)
        self._replay()
        tracecount.replayed(self.launches)
        self.replays += 1
        new = dict(state)
        new["cache_lens"] = self._small[0]
        new["sampling"] = dict(zip(SAMPLING_LEAVES,
                                   self._small[1:1 + len(SAMPLING_LEAVES)]))
        if self._check_finite:
            new["nonfinite"] = self._small[-1]
        return self._next.clone(), new
