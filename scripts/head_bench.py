#!/usr/bin/env python3
"""Time the loose head's ways of computing f32 logits without an f32
copy of the table, on one card.  From the root of a checkout on a
machine with a card:

    python3 scripts/head_bench.py [--out DIR]

At RecurrentGemma-9B's (256000 × 4096), Minitron-4B's (256000 × 3072)
and Granite-8B's (49152 × 4096) tables, 8 slots: the f32 copy of the
whole table; one f32 product a vocabulary tile of 1024 … 8192 rows, the
tile upcast on its own; the port's ``models/layers.py:lm_head_logits``
(64-column chunks as bf16 products with f32 output, summed in f32) at
tiles of 4096 … 16384 rows and the whole vocabulary; and one bf16
product with f32 output over all of d_model (``torch.mm(...,
out_dtype=)``, where the installed PyTorch has it): device ms per call
issued eagerly and as the nodes of one CUDA graph (as a decode step
runs it), the peak memory a call adds, and the top-8 candidates against
the f64 sum (indices equal, values' largest error in f32 ulps).

One JSON line per measurement; the card's name and power limit first.
Full output goes to ``DIR/head_bench.log`` as well (default
``build/head_bench``).  Exits nonzero if a check failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def emit(log, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    log.write(line + "\n")


def bench_head(cs, log) -> None:
    import torch
    from repro_torch.models.layers import lm_head_logits
    from repro_torch.serving.sampling import head_candidates
    for arch, V, D in (("recurrentgemma-9b", 256000, 4096),
                       ("minitron-4b", 256000, 3072),
                       ("granite-8b", 49152, 4096)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 4)
        table = cs.randn(gen, (V, D), D ** -0.5)
        x = cs.randn(gen, (cs.SLOTS, D), 1.0)
        want = x.double() @ table.double().T
        wv, wi = head_candidates(want.float(), 8)
        variants = {"f32 table copy": lambda: x.float() @ table.float().T}
        for rows in (1024, 2048, 4096, 8192):
            # one f32 product a tile, the tile upcast on its own
            variants[f"f32 tiles of {rows}"] = (
                lambda rows=rows: torch.cat(
                    [x.float() @ table[v0:v0 + rows].float().T
                     for v0 in range(0, V, rows)], dim=-1))
        for rows in (4096, 8192, 16384, V):
            variants[f"lm_head_logits, tiles of {rows}"] = (
                lambda rows=rows: lm_head_logits(table, x, tile_rows=rows))
        try:
            torch.mm(x, table.T, out_dtype=torch.float32)
            variants["bf16 mm, f32 out"] = lambda: torch.mm(
                x, table.T, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            emit(log, head=arch, variant="bf16 mm, f32 out",
                 unavailable=str(e)[:200])
        for name, fn in variants.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            logits = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            gv, gi = head_candidates(logits, 8)
            ulp = (torch.nextafter(wv.abs(), torch.full_like(wv, float("inf")))
                   - wv.abs())
            ulps = float(((gv - wv).abs() / ulp).max())
            all_err = float(((logits.double() - want).abs()
                             / want.abs().clamp(min=1e-30)).max())
            del logits
            ms, covered = cs.cuda_ms(fn, 10)
            # as a decode step runs it: the nodes of one CUDA graph
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            graph_ms = cs.cuda_ms(graph.replay, 10)[0]
            del graph
            emit(log, head=arch, V=V, D=D, variant=name, ms=round(ms, 4),
                 graph_ms=round(graph_ms, 4),
                 peak_extra_mb=round(peak / 2**20, 1),
                 top8_indices_equal=bool(torch.equal(gi, wi)),
                 top8_max_ulps=round(ulps, 2),
                 max_rel_err_all=f"{all_err:.3e}",
                 bound_ms=round(cs.bound(V * D * 2 + cs.SLOTS * V * 4,
                                         2 * cs.SLOTS * V * D)[0], 4),
                 queued_under_spin=covered)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "head_bench"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("head_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    os.makedirs(opt.out, exist_ok=True)
    with open(os.path.join(opt.out, "head_bench.log"), "w") as log:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        emit(log, card=smi, torch=torch.__version__)
        bench_head(cs, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
