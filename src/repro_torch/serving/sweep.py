"""Systematic SDC fault sweeps over the fleet router — the port of
``repro/serving/sweep.py``.

One :class:`~repro_torch.serving.faults.FaultSweep` grid; each spec runs
in a router run of its own over the same engines and trace, and the
outcomes reduce to a coverage matrix:

* ``fault_free`` — every probe on, no fault: the detection signals
  fired (must be 0), whether the streams equal the probes-off oracle,
  and the probes' bytes a tick;
* ``{kind}_bit{b}`` — per fault kind and bit: ``detected_pct``,
  ``detect_steps`` (the worst latency in router ticks) and
  ``oracle_exact_pct`` (every journaled stream equal to the oracle's).

Between runs a ``flip_weight_bit`` is undone by each engine's
``repack_fn`` (the heal's path).  The port's sweep returns its matrix
and writes no file.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import tracecount
from repro_torch.serving.faults import FaultInjector, FaultSweep
from repro_torch.serving.integrity import IntegrityConfig
from repro_torch.serving.router import Router
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import Request


def _streams(journal) -> Dict[int, Tuple[int, ...]]:
    return {rid: tuple(e.tokens) for rid, e in journal.items()}


def run_sdc_sweep(engines, *, prompts: Sequence[Sequence[int]],
                  max_new: int, prompt_cap: int,
                  sweep: Optional[FaultSweep] = None,
                  icfg: Optional[IntegrityConfig] = None,
                  max_requeues: Optional[int] = None,
                  max_ticks: int = 10_000,
                  sampling: Optional[Sequence[SamplingParams]] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Run the grid; returns the coverage matrix as ``{row: {column:
    value}}`` (see the module docstring for the rows and columns).

    ``prompts`` seeds one request per prompt, all arriving at tick 0 —
    the same trace for the oracle, the control and every fault run.
    ``sampling``: each request's params (default greedy; the port's
    addition, so a sweep can hold sampled streams to the oracle).
    """
    sweep = sweep if sweep is not None else FaultSweep()
    icfg = icfg if icfg is not None else IntegrityConfig()
    sampling = list(sampling) if sampling is not None \
        else [GREEDY] * len(prompts)

    def trace() -> List[Tuple[int, Request]]:
        return [(0, Request(i, list(p), max_new, sampling=sp))
                for i, (p, sp) in enumerate(zip(prompts, sampling))]

    def restore() -> None:
        for eng in engines:
            if eng.repack_fn is not None:       # in place
                eng.params["serve"] = eng.repack_fn(eng.params["train"])

    # 1. the oracle: no probes, no faults — ground-truth streams
    oracle = _streams(Router(engines, prompt_cap=prompt_cap,
                             max_new_cap=max_new).run(trace(),
                                                      max_ticks=max_ticks))

    # 2. the control: every probe on, no faults — the false-positive
    #    and probe-overhead row
    tracecount.reset_signals()
    tracecount.reset_probes()
    ctl = _streams(Router(engines, prompt_cap=prompt_cap,
                          max_new_cap=max_new, integrity=icfg)
                   .run(trace(), max_ticks=max_ticks))
    sig = sum(tracecount.signal_totals().values())
    pt = tracecount.probe_totals()
    per_tick = (pt["probe_bytes_kv"] + pt["probe_bytes_weights"]
                + pt["probe_bytes_shadow"]) / max(pt["probe_ticks"], 1)
    cells: Dict[str, Dict[str, float]] = {"fault_free": {
        "false_positive_signals": float(sig),
        "streams_match": float(ctl == oracle),
        "probe_bytes_per_tick": float(per_tick),
    }}

    # 3. the grid: one spec per run, engines restored in between
    agg: Dict[str, List[Tuple[bool, int, bool]]] = {}
    for spec in sweep.specs():
        inj = FaultInjector([spec])
        tracecount.reset_signals()
        router = Router(engines, prompt_cap=prompt_cap,
                        max_new_cap=max_new, integrity=icfg,
                        max_requeues=max_requeues,
                        injectors={spec.replica: inj})
        journal = router.run(trace(), max_ticks=max_ticks)
        lat = router.detection_latency(inj)
        detected = bool(lat) and lat[0] >= 0
        exact = _streams(journal) == oracle
        agg.setdefault(f"{spec.kind}_bit{spec.bit}", []).append(
            (detected, lat[0] if detected else -1, exact))
        if spec.kind == "flip_weight_bit":
            restore()

    for key, rows in agg.items():
        lats = [l for d, l, _ in rows if d]
        cells[key] = {
            "detected_pct": 100.0 * sum(d for d, _, _ in rows) / len(rows),
            "detect_steps": float(max(lats)) if lats else -1.0,
            "oracle_exact_pct":
                100.0 * sum(e for _, _, e in rows) / len(rows),
        }
    return cells


def format_coverage(cells: Dict[str, Dict[str, float]]) -> str:
    """The coverage matrix as a table (``python -m
    repro_torch.launch.serve --sweep``)."""
    lines = [f"{'cell':<28} {'detected%':>9} {'latency(ticks)':>14} "
             f"{'oracle-exact%':>13}"]
    for key in sorted(k for k in cells if k != "fault_free"):
        c = cells[key]
        lines.append(f"{key:<28} {c['detected_pct']:>9.1f} "
                     f"{c['detect_steps']:>14.0f} "
                     f"{c['oracle_exact_pct']:>13.1f}")
    ff = cells.get("fault_free")
    if ff is not None:
        lines.append(
            f"{'fault_free':<28} signals={ff['false_positive_signals']:.0f} "
            f"streams_match={ff['streams_match']:.0f} "
            f"probe_bytes/tick={ff['probe_bytes_per_tick']:.0f}")
    return "\n".join(lines)
