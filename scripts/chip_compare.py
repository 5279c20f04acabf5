#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two trees in turns on one card: parent,
change, change, parent, as many rounds as asked.

Host-bound step times vary between calls by up to 2×, so a change is
compared with its parent only inside one call, in turns.  From the root
of a checkout, with the parent unpacked into a directory of its own
(``git archive <parent> | tar -x -C build/parent``):

    python3 scripts/chip_compare.py build/parent [CHANGE_DIR] [--rounds N]
        [--out DIR]

CHANGE_DIR defaults to this checkout (an unpacked ``git archive`` of the
change also proves that the committed files suffice).

Each run's full output goes to ``DIR/compare_<i>_<tree>.log`` (default
``build/compare``); the summary printed per run is each path's untraced
median step, host issue time and device time per step by kernel group
(phase 5), and the ``kernels`` line's device ms per call (phase 6).
Exits nonzero if any run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def summarize(log: str) -> dict:
    """The per-path step, host and device numbers and the kernel rows of
    one ``chip_smoke.py`` output."""
    paths, kernels = {}, []
    for line in log.splitlines():
        m = re.match(r"\[(serve|profile)\] path=(\S+) backend=(\S+) (.*)", line)
        if m:
            kind, path, backend, rest = m.groups()
            kv = dict(re.findall(r"(\w+)=(\S+)", rest))
            d = paths.setdefault(f"{path}/{backend}", {})
            if kind == "serve" and "median_step_ms" in kv:
                d.update(step_ms=kv["median_step_ms"],
                         host_ms=kv["median_host_ms"])
            if kind == "profile":
                d.update({k[:-len("_ms_per_step")]: v for k, v in kv.items()
                          if k.endswith("_ms_per_step") and v != "0.0"
                          and not k.startswith("stage")})
                d["idle_share"] = kv.get("idle_share")
        if line.startswith('{"kernels"'):
            kernels = [(r["name"], r["path"], r["stage"], r["ms"],
                        r["library_ms"]) for r in json.loads(line)["kernels"]]
    return dict(paths=paths, kernels=kernels)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "compare"))
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    parent, change = (os.path.abspath(d) for d in (args.parent, args.change))
    for tree in (parent, change):
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            print(f"no chip_smoke.py under {tree}", file=sys.stderr)
            return 2
    os.makedirs(out, exist_ok=True)
    ok = True
    order = (("parent", parent), ("change", change), ("change", change),
             ("parent", parent)) * args.rounds
    for i, (tag, tree) in enumerate(order):
        run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                             capture_output=True, text=True)
        log = run.stdout + run.stderr
        with open(os.path.join(out, f"compare_{i + 1}_{tag}.log"), "w") as f:
            f.write(log)
        ok &= run.returncode == 0
        print(json.dumps(dict(run=i + 1, tree=tag, rc=run.returncode,
                              **summarize(log))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
