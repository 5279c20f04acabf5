"""Runtime call and launch counters — the port's counterpart of
``repro/core/tracecount.py``.

The JAX package counts call sites as they trace (one trace is one
compiled step).  PyTorch runs eagerly, so the port counts at run time,
two numbers per kernel:

* ``calls``: every entry into a kernel wrapper, whatever the device —
  the CPU tests read it to prove a decode step makes ``2·L + 1`` kernel
  calls (one attention kernel, ``fused_decode`` or ``fused_mla_decode``,
  and one ``fused_ffn`` per layer, one ``fused_head`` per step), ``L``
  on the unfused ``backend="xla"`` path (one ``flash_decode`` per
  layer), ``L + 1`` on RWKV-6 (one ``rwkv6_scan`` per layer, one
  ``fused_head``), ``L`` on RecurrentGemma's unfused path (one
  ``rglru_scan`` per recurrent layer, one ``flash_decode`` per
  local-attention layer) and ``L_rec + 2·L_local + 1`` on its fused
  path (``fused_decode`` and ``fused_ffn`` per local-attention layer,
  ``rglru_scan`` per recurrent one, one ``fused_head``),
  ``L + 1`` on MoE DeepSeek-V2-Lite's fused path (one
  ``fused_mla_decode`` per layer and one ``fused_head``: its FFN is the
  expert dispatch in torch) and none on its unfused path (its MLA
  attention, MoE and head are torch and cuBLAS);
* ``launches``: bumped by each CUDA wrapper at the one place where it
  launches its kernel, and nowhere else (a plain-version call on a CPU
  tensor does not count) — ``chip_smoke.py`` reads it to prove the main
  path on the card went through the kernels.

A CUDA graph (``serving/step_graph.py``) runs no Python when it
replays, so launches made while a graph is captured
(:func:`capturing`) go to that graph's own count, not to
:func:`launches`, and a replay (:func:`replayed`) credits its graph's
captured launches to :func:`launches` and adds one to :func:`replays`:
launches counted eagerly are ``launches()`` less what the replays
credited.

Three families more, as in the reference:

* :func:`live_attend_blocks` — the per-slot attend-step (KV-block)
  count of one attention layer, which the engine adds into
  ``state["work_blocks"]`` under ``ServeConfig.track_work``;
* the detection signals (:func:`record_signal`), host counters the
  fleet router (``serving/router.py``) bumps once per probe that fires:
  ``detect_nonfinite``, ``detect_lens_bounds``, ``detect_journal_stale``,
  ``detect_journal_mismatch``, ``detect_heartbeat``,
  ``detect_kv_fingerprint``, ``detect_weight_fingerprint``,
  ``detect_shadow_recompute``, ``replica_failed``, ``replica_healed``
  and ``request_failed`` (the reference's labels,
  ``repro/core/tracecount.py``);
* the probe costs (:func:`record_probe`): ``probe_ticks`` (one per
  monitor probe) and ``probe_bytes_kv`` / ``probe_bytes_weights`` /
  ``probe_bytes_shadow``, the bytes each probe family reads — on the
  card the KV and weight probes read the device tensors in place and
  only ``[B]`` vectors or scalars reach the host, the shadow probe reads
  one slot's residual on the host (``serving/integrity.py``).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Iterator, Optional

import torch

KERNELS = ("fused_decode", "fused_ffn", "fused_head", "fused_mla_decode",
           "rwkv6_scan", "flash_decode", "rglru_scan")

_calls: Dict[str, int] = {name: 0 for name in KERNELS}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_replays = 0
_capture: Optional[Dict[str, int]] = None   # the graph being captured


def call(name: str) -> None:
    _calls[name] += 1


def launch(name: str) -> None:
    if _capture is not None:
        _capture[name] += 1
    else:
        _launches[name] += 1


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """While a graph is captured: launches go to the dict yielded (that
    graph's launches per replay), not to :func:`launches`."""
    global _capture
    if _capture is not None:
        raise RuntimeError("tracecount: a graph is already being captured")
    _capture = {name: 0 for name in KERNELS}
    try:
        yield _capture
    finally:
        _capture = None


def replayed(graph_launches: Dict[str, int]) -> None:
    """One replay of a graph whose capture counted ``graph_launches``."""
    global _replays
    _replays += 1
    for name, n in graph_launches.items():
        _launches[name] += n


def reset() -> None:
    global _replays
    for d in (_calls, _launches):
        for name in d:
            d[name] = 0
    _replays = 0


def calls() -> Dict[str, int]:
    return dict(_calls)


def launches() -> Dict[str, int]:
    return dict(_launches)


def replays() -> int:
    return _replays


def live_attend_blocks(cache_lens: torch.Tensor, *, s_blk: int,
                       block_s: int, rank: int = 0, window: int = 0,
                       ring: bool = False) -> torch.Tensor:
    """Per-slot attend-step count of one attention layer, int32 ``[B]``:
    the reference's formula (``repro/core/tracecount.py:
    live_attend_blocks``) on this process's cluster rank ``rank`` (its
    shard's live span starts at position ``rank·s_blk`` on a linear
    cache; a ring counts from 0), blocks of ``min(block_s,
    s_blk)`` rows — the Pallas kernels' tiles at the reference's
    ``block_s``, so ``work_blocks`` counts what the reference's counts.
    B1's and B5's own tiles differ (they mask a ragged last tile and
    stream every row of a slot's live prefix); the count is a measure of
    a slot's live span, not of the port's launches.  A free slot
    (``cache_len`` −1) counts 0."""
    cl = cache_lens.to(torch.int32)
    if rank and not ring:
        cl = cl - rank * s_blk
    blk = min(block_s, s_blk)
    n_blocks = max(1, s_blk // max(blk, 1))
    hi = torch.clamp(torch.div(cl + blk - 1, blk, rounding_mode="floor") - 1,
                     0, n_blocks - 1)
    if window > 0 and not ring:
        lo = torch.minimum(torch.clamp(
            torch.div(cl - window, blk, rounding_mode="floor"), min=0), hi)
    else:
        lo = torch.zeros_like(hi)
    return torch.where(cl > 0, hi - lo + 1, 0).to(torch.int32)


_SIGNALS: Counter = Counter()
_PROBES: Counter = Counter()


def record_signal(name: str, n: int = 1) -> None:
    """A detection signal fired (host-side, always on)."""
    _SIGNALS[name] += n


def signal_totals() -> Counter:
    return Counter(_SIGNALS)


def reset_signals() -> None:
    _SIGNALS.clear()


def record_probe(name: str, n: int = 1) -> None:
    """Account a probe's cost (host-side, always on)."""
    _PROBES[name] += n


def probe_totals() -> Counter:
    return Counter(_PROBES)


def reset_probes() -> None:
    _PROBES.clear()
