#!/usr/bin/env python3
"""Check and time chosen kernels of the port alone, at every path's
shapes, for one or more trees in turns on one card.

``chip_smoke.py`` phases 3 and 6 for a few kernels, without serving any
path: each case of ``chip_smoke.kernel_cases`` whose kernel is named
(check-only cases included) is held against its plain version, then
timed beside its bound (device ms per call, CUDA events around 20 calls
queued behind a spin kernel; B2's and B3's ``products_ms`` as phase 6
takes them).  From the root of a checkout on a machine with a card:

    python3 scripts/kernel_bench.py fused_head,rwkv6_scan \\
        [--trees build/parent . . build/parent] [--out DIR] [--all]

Each tree (an unpacked ``git archive``, or this checkout) runs in a
process of its own, importing that tree's ``chip_smoke.py`` and
``repro_torch``, in the order given; each prints one JSON line a case
(``tree``, ``name``, ``path``, ``stage``, ``max_abs_err``, ``ms``,
``call_ms`` — one call with its host work —, ``plain_ms``, ``bound_ms``,
``products_ms``; ``--all`` times the check-only cases too, such as one
rank's shapes of a mesh or of a cluster across devices), one of its
build (registers and
spills per kernel instance, from ``nvcc -Xptxas -v``) and one of the
card (``nvidia-smi``'s name and power limit).  Full output of
run i goes to ``DIR/bench_<i>.log`` (default ``build/bench``).  Exits
nonzero if any check or run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tree(tree: str, names, time_all: bool = False) -> int:
    """Check and time the cases of ``names`` with ``tree``'s code."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps(dict(tree=tree, card=card)), flush=True)
    logs = _build.build_all(tuple(names))
    for name, log in logs.items():
        print(json.dumps(dict(
            tree=tree, build=name,
            registers=[int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)],
            spills=sorted({ln.strip() for ln in log.splitlines()
                           if "spill" in ln
                           and "0 bytes spill stores" not in ln}))),
              flush=True)
    seen = set()
    for path, backend in cs.PATHS:
        cfg = cs.path_config(path)
        for case in cs.kernel_cases(path, cfg, backend):
            if case["name"] not in names:
                continue
            case.setdefault("stage", "decode")
            key = (case["name"], case["stage"],
                   case.get("check_only", False), case["cost"])
            if key in seen:             # the same shape on another path
                continue
            seen.add(key)
            err = cs.check_kernel(case)
            row = dict(tree=tree, name=case["name"], path=path,
                       stage=case["stage"], max_abs_err=err)
            if time_all or not case.get("check_only"):
                args, kw = case["args"], case["kw"]
                ms, covered = cs.cuda_ms(lambda: case["fn"](**args, **kw), 20)
                b_ms, b_by = cs.bound(*case["cost"],
                                      case.get("rate", cs.BF16_FLOPS))
                plain_ms, _ = cs.cuda_ms(
                    lambda: case["plain"](*args.values(), **kw), 5)
                row.update(ms=round(ms, 4), call_ms=round(cs.call_ms(
                    lambda: case["fn"](**args, **kw), 20), 4),
                           plain_ms=round(plain_ms, 4),
                           bound_ms=round(b_ms, 4), bound_by=b_by,
                           queued_under_spin=covered)
                prod = {"fused_ffn": "ffn_products",
                        "fused_head": "head_products"}.get(case["name"])
                if prod and hasattr(cs, prod):
                    row["products_ms"] = round(cs.cuda_ms(
                        getattr(cs, prod)(case), 20)[0], 4)
            print(json.dumps(row), flush=True)
            del case
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernels", help="comma-separated kernel names")
    ap.add_argument("--trees", nargs="+", default=[ROOT])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench"))
    ap.add_argument("--all", action="store_true",
                    help="time the check-only cases too")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = tuple(args.kernels.split(","))
    if args.one:
        return run_tree(args.one, names, args.all)
    os.makedirs(args.out, exist_ok=True)
    ok = True
    for i, tree in enumerate(args.trees):
        tree = os.path.abspath(tree)
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.kernels, "--one", tree]
                             + ["--all"] * args.all, cwd=tree,
                             capture_output=True, text=True)
        log = run.stdout + run.stderr
        with open(os.path.join(args.out, f"bench_{i + 1}.log"), "w") as f:
            f.write(log)
        ok &= run.returncode == 0
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps(dict(run=i + 1, **json.loads(line))),
                      flush=True)
        if run.returncode:
            print(log[-3000:], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
