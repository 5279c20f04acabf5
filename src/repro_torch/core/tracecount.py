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
  ``fused_head``), or ``L`` on RecurrentGemma (one ``rglru_scan`` per
  recurrent layer, one ``flash_decode`` per local-attention layer);
* ``launches``: bumped by each CUDA wrapper at the one place where it
  launches its kernel, and nowhere else (a plain-version call on a CPU
  tensor does not count) — ``chip_smoke.py`` reads it to prove the main
  path on the card went through the kernels.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("fused_decode", "fused_ffn", "fused_head", "fused_mla_decode",
           "rwkv6_scan", "flash_decode", "rglru_scan")

_calls: Dict[str, int] = {name: 0 for name in KERNELS}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def call(name: str) -> None:
    _calls[name] += 1


def launch(name: str) -> None:
    _launches[name] += 1


def reset() -> None:
    for d in (_calls, _launches):
        for name in d:
            d[name] = 0


def calls() -> Dict[str, int]:
    return dict(_calls)


def launches() -> Dict[str, int]:
    return dict(_launches)
