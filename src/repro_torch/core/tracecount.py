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
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

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
