#!/usr/bin/env python3
"""Where a graphed decode step's device time goes besides its kernels:
the gaps between the graph's nodes, per engine build, on one card.
From the root of a checkout on a machine with a card:

    python3 scripts/graph_gaps.py [--builds N] [--paths PATH:BACKEND,...]

For each path (default: Granite-8B and Minitron-4B on both backends, as
``chip_smoke.py`` serves them), builds the engine ``N`` times (default
3) in this one process, and for each build, on its own state filled as
``chip_smoke.fill_state`` fills it:

* ``device_step_ms``: 8 graph replays queued behind a spin kernel
  (``chip_smoke.cuda_ms``: the host's issue stays out of the window);
* ``kernel_ms``: the sum of the device kernels' durations a step, from a
  ``torch.profiler`` trace of 4 replays that follows on the same state;
* ``gap_us_per_launch``: the step's time outside its kernels, over its
  device launches.

One JSON line per build; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

PATHS = "granite-8b:pallas,granite-8b:xla,minitron-4b:pallas,minitron-4b:xla"


def kernel_ms(eng, state, steps: int = 4):
    """Kernel time and device launches a step over ``steps`` replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros(8, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok, state = eng.decode_fn(eng.params["serve"], state, tok)
        torch.cuda.synchronize()
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in spans)
    return total / steps / 1e3, len(spans) / steps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--builds", type=int, default=3)
    ap.add_argument("--paths", default=PATHS)
    opt = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("graph_gaps: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=smi.splitlines()[0])), flush=True)
    _build.build_all()
    for spec in opt.paths.split(","):
        path, backend = spec.split(":")
        cfg = cs.path_config(path)
        for build in range(opt.builds):
            eng, _, _ = cs.build_engine(path, cfg, backend)
            state = cs.fill_state(path, cfg, eng, eng.state,
                                  np.random.default_rng(cs.SEED + 3))
            tok = torch.zeros(cs.SLOTS, dtype=torch.int32, device="cuda")
            box = [state]

            def replay():
                box[0] = eng.decode_fn(eng.params["serve"], box[0], tok)[1]
            step_ms, covered = cs.cuda_ms(replay, 8)
            k_ms, launches = kernel_ms(eng, box[0])
            print(json.dumps(dict(
                path=path, backend=backend, build=build,
                device_step_ms=round(step_ms, 3), kernel_ms=round(k_ms, 3),
                device_launches_per_step=launches,
                gap_us_per_launch=round(1e3 * (step_ms - k_ms) / launches,
                                        3),
                queued_under_spin=covered)), flush=True)
            del eng, state, box, replay
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
