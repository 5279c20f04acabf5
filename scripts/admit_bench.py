#!/usr/bin/env python3
"""Time the targeted prefill-insert (the admit) of one checkout on the
card: fused Llama2-7B at full width and depth, 8 slots, ``max_seq``
1024, seeded random weights.

Two measurements, each on the checkout given (its ``src/`` and its
``chip_smoke.py``, so a parent unpacked beside this one is timed with its
own code):

* ``admit8``: eight requests admitted in one call, the prompts of
  ``chip_smoke.py``'s 12-request trace (16–512 tokens), into a fresh
  state; the median of ``--reps`` calls (the device synchronized around
  each, host clock);
* ``trace``: that trace through ``SlotScheduler``, each admit call timed
  the same way, and the wall time of the whole trace (its decode steps
  included), after one untimed run.

From the root of a checkout, after ``chip_smoke.py`` has built the
kernels or with ``nvcc`` on the path:

    python3 scripts/admit_bench.py [TREE] [--reps N]

Prints one ``[admit]`` line per measurement, and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synced_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("admit_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.serving.engine import EngineOptions
    from repro_torch.serving.sampling import host_sampling_rows
    from repro_torch.serving.scheduler import SlotScheduler, replay_trace

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    path = "llama2-7b"
    cfg = get_config(path)
    slots = chip_smoke.SLOTS
    eng = build_engine_full(cfg, max_seq=chip_smoke.MAX_SEQ,
                            batch_global=slots,
                            options=EngineOptions(backend="pallas"),
                            device="cuda", seed=chip_smoke.SEED)
    trace, prompt_cap = chip_smoke.request_trace(path, cfg)

    # admit8: the trace's first eight prompts in one admit
    toks = np.zeros((slots, prompt_cap), np.int32)
    lens = np.zeros((slots,), np.int32)
    for b, (_, req) in enumerate(trace[:slots]):
        toks[b, :len(req.prompt)] = req.prompt
        lens[b] = len(req.prompt)
    state = SlotScheduler(eng, prompt_cap=prompt_cap).state
    ms = []
    for _ in range(args.reps + 1):
        _, t = synced_ms(lambda: eng.admit_fn(
            eng.params["train"], state, toks, lens,
            host_sampling_rows(slots)))
        ms.append(t)
    print(f"[admit] tree={os.path.basename(tree) or tree} mode=admit8 "
          f"prompt_tokens={int(lens.sum())} first_ms={ms[0]:.2f} "
          f"median_ms={statistics.median(ms[1:]):.2f} "
          f"all_ms={[round(t, 2) for t in ms[1:]]}")

    # trace: every admit call of the 12-request trace timed
    admit = eng.admit_fn
    for run in range(2):
        admit_ms = []

        def timed(*a, **k):
            out, t = synced_ms(lambda: admit(*a, **k))
            admit_ms.append(t)
            return out

        sched = SlotScheduler(eng._replace(admit_fn=timed),
                              prompt_cap=prompt_cap)
        t0 = time.perf_counter()
        results = replay_trace(sched, trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.tokens) for r in results.values())
    print(f"[admit] tree={os.path.basename(tree) or tree} mode=trace "
          f"admit_calls={len(admit_ms)} admit_ms_total={sum(admit_ms):.1f} "
          f"admit_ms={[round(t, 1) for t in admit_ms]} "
          f"decode_steps={sched.decode_calls} wall_s={wall:.3f} "
          f"tokens={n_tok} tokens_per_s={n_tok / wall:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
