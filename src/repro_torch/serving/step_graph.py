"""One decode step as one CUDA-graph replay — the port's counterpart of
the reference's jitted step (``repro/launch/serve.py:306``,
``jax.jit(shard_map(dec_body, ...))``).  The reference has no module
for it: there ``jax.jit`` is a call.

:class:`StepGraph` captures :func:`~repro_torch.serving.engine.decode_step`
once, on one engine's serve params and decode state, and replays it: a
step is then a few copies and one ``cudaGraphLaunch`` on the host,
where the eager step issues every launch from Python.  Two graphs are
captured, one memory pool between them: the greedy step (every slot
takes its first candidate) and the sampled one (``finalize_candidates``
over the slots' noise); a call replays the one its ``sampled`` asks
for, so a batch with no sampled request runs none of the sampler's
arithmetic.  It owns fixed
device buffers for the step's small inputs — ``tokens [B]`` int32,
``cache_lens [B]``, the sampling leaves and the flags' leaves
(``nonfinite``, ``work_blocks``, ``head_resid``, ``head_val``,
``head_tok``, where the engine has them) — and the captured step writes
its results back into the same buffers; the KV caches, their ``kv_fp``
checksums and the recurrent states are updated in place by the step
already, and an encoder-decoder's ``enc_kv`` in place by
prefill, so the graph is bound to the engine's tensors.

The graph is built for those tensors and no others: params other than
the captured ones, or a state whose caches or recurrent tensors are not
the captured ones, raise ``ValueError``.  It never re-captures and never
falls back to the eager step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tracecount
from repro_torch.kernels import _build
from repro_torch.serving.engine import (ServeConfig, decode_step,
                                        reset_decode_state)
from repro_torch.serving.sampling import SAMPLING_LEAVES

WARMUP_STEPS = 2


def capture_graph(step: Callable[[], None], device: torch.device,
                  pool=None) -> Callable[[], None]:
    """Capture ``step`` (no arguments; it reads and writes fixed tensors)
    into a CUDA graph with the default ``capture_error_mode="global"`` —
    a host sync or a blocking copy inside the step raises — and return
    the graph's replay.  The graph and its memory pool live as long as
    the replay does.  ``pool``: a ``torch.cuda.graph_pool_handle()`` the
    graphs of one engine share — safe here, as no tensor a step
    allocates outlives it (its results are copied into fixed buffers)
    and replays never overlap."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
        step()
    return graph.replay


# the flags' leaves a step returns anew (ServeConfig: check_finite,
# track_work, shadow_head), where the state has them
FLAG_LEAVES = ("nonfinite", "work_blocks", "head_resid", "head_val",
               "head_tok")


def _big_leaves(state: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors updated in place: every KV cache, ``pos`` and recurrent
    state of the layer groups and the tail, their ``kv_fp`` checksums,
    the admitted slots' noise ``gumbel``, and an encoder-decoder's
    ``enc_kv``, which prefill writes in place
    and the step reads (a rebound tensor would leave the graph reading
    stale keys)."""
    enc = state.get("enc_kv", {})
    return [t for block in state["layers"] + state["tail"] for t in block] \
        + state.get("kv_fp", []) + state.get("kv_fp_tail", []) \
        + [state["gumbel"]] + [enc[n] for n in sorted(enc)]


def _small_names(state: Dict[str, Any]) -> List[str]:
    """The leaves a step returns anew: ``cache_lens``, the sampling
    leaves (as ``sampling.<name>``) and the flags' leaves present."""
    return (["cache_lens"] + [f"sampling.{n}" for n in SAMPLING_LEAVES]
            + [n for n in FLAG_LEAVES if n in state])


def _small_leaves(state: Dict[str, Any], names: List[str]
                  ) -> List[torch.Tensor]:
    return [state["sampling"][n[len("sampling."):]]
            if n.startswith("sampling.") else state[n] for n in names]


def _step_fn(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
             static: Dict[str, Any], tokens: torch.Tensor,
             out: torch.Tensor, sampled: bool) -> Callable[[], None]:
    """The captured step: ``decode_step`` on the static state and tokens,
    its results copied back into the static buffers.  It holds only
    tensors, not the :class:`StepGraph`, so dropping the engine frees the
    graph (no reference cycle)."""
    static = dict(static, sampling=dict(static["sampling"]))
    names = _small_names(static)
    small = _small_leaves(static, names)

    def step():
        nxt, new = decode_step(cfg, scfg, params, static, tokens,
                               sampled=sampled)
        out.copy_(nxt)
        for dst, src in zip(small, _small_leaves(new, names)):
            dst.copy_(src)
    return step


class StepGraph:
    """``decode_fn(params, state, tokens, sampled=False) → (next tokens
    [B], state)`` as one replay of a graph captured on ``params`` and
    ``state`` — the greedy step's, or the sampled step's where
    ``sampled``.

    Capture, at construction: for each of the two steps
    ``WARMUP_STEPS`` eager steps (on a side
    stream on the card, after building every kernel), so that the
    kernels are loaded, the cluster launches have checked their shapes
    (``csrc/cluster.cuh``) and cuBLAS has its handles and workspaces
    before the capture; then the captures; then ``state`` is put back,
    in place, to exactly what ``init_decode_state`` makes.  ``state``'s
    small leaves become the graph's input buffers.

    Per call: a small leaf of ``state`` that is not the buffer (a
    ``retire_fn`` or an admit returns new ones) is copied in, then the
    tokens, then the graph replays.  The returned state's small leaves
    are the buffers (the next replay overwrites them, as the step
    updates the caches in place); the returned tokens are a copy.

    ``launches``: the kernel launches the capture counted (the same in
    both graphs: the sampler is plain tensor arithmetic), which every
    replay credits to ``tracecount.launches()``; ``replays``: the
    replays of both graphs."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 params: Dict[str, Any], state: Dict[str, Any]):
        dev = state["cache_lens"].device
        B = scfg.batch_local
        self._params = params
        self._names = _small_names(state)
        self._big_ptrs = [t.data_ptr() for t in _big_leaves(state)]
        self._small = _small_leaves(state, self._names)
        self._tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._next = torch.zeros((B,), dtype=torch.int32, device=dev)
        steps = [_step_fn(cfg, scfg, params, state, self._tokens, self._next,
                          sampled) for sampled in (False, True)]
        # on the card the warm-up runs on a side stream (None: no-op)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if side is not None:
            _build.build_all()
            side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for step in steps:
                for _ in range(WARMUP_STEPS):
                    step()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
        pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                else None)
        self._replays, counts = [], []
        for step in steps:
            with tracecount.capturing() as counted:
                self._replays.append(capture_graph(step, dev, pool=pool))
            counts.append(dict(counted))
        if counts[0] != counts[1]:
            raise AssertionError(f"StepGraph: the greedy and the sampled "
                                 f"steps launch {counts[0]} and {counts[1]}")
        self.launches = counts[0]
        self.replays = 0
        # the warm-up leaves no trace
        reset_decode_state(cfg, scfg, state)
        self._tokens.zero_()
        self._next.zero_()

    def __call__(self, params: Dict[str, Any], state: Dict[str, Any],
                 tokens, sampled: bool = False) -> tuple:
        if params is not self._params:
            raise ValueError("StepGraph: params are not the ones the graph "
                             "was captured on")
        if [t.data_ptr() for t in _big_leaves(state)] != self._big_ptrs:
            raise ValueError("StepGraph: the state's caches or recurrent "
                             "states are not the ones the graph was "
                             "captured on")
        for dst, src in zip(self._small, _small_leaves(state, self._names)):
            if src is not dst:
                dst.copy_(src)
        tok = tokens if torch.is_tensor(tokens) else torch.from_numpy(
            np.asarray(tokens))
        if tok.shape != self._tokens.shape:
            raise ValueError(f"StepGraph: tokens of shape {tuple(tok.shape)}"
                             f", want {tuple(self._tokens.shape)}")
        self._tokens.copy_(tok)
        self._replays[int(bool(sampled))]()
        tracecount.replayed(self.launches)
        self.replays += 1
        new = dict(state, sampling={})
        for name, t in zip(self._names, self._small):
            if name.startswith("sampling."):
                new["sampling"][name[len("sampling."):]] = t
            else:
                new[name] = t
        return self._next.clone(), new
