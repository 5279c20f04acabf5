#!/usr/bin/env python3
"""Time the unfused MLA layer (``core/dataflow.py:mla_attention``)
against the fused one (``mla_attention_packed``, B4) at
DeepSeek-V2-Lite's width on one card, and what its masked pass over all
``max_seq`` cache rows costs.  From the root of a checkout on a machine
with a card:

    python3 scripts/mla_bench.py [--out DIR]

8 slots, a latent cache of ``chip_smoke.MAX_SEQ`` rows, every slot at
each of the lengths the MoE path's lockstep batches decode at (128 and
160, then 512 and 576) with stale rows past them, seeded random weights
at the init's scales.  For each length: the whole unfused layer, its
attention core alone (``latent_attention``: the f32 copy of the cache,
scores, mask, softmax, ``p·v``) over all rows and over a cache cut to
the live rows (what attending only live rows would cost), and the fused
layer as the ``"pallas"`` path serves it (B4, the append, the heads'
sum).  Device ms per call, as a decode step's graph runs them: 20 calls
captured in one CUDA graph, its replay timed behind a spin kernel
(``chip_smoke.cuda_ms``), so the host's issue of the calls' many small
launches stays out of the time; and per step (× 27 layers).

One JSON line per length; the card's name and power limit first.  Full
output also goes to ``DIR/mla_bench.log`` (default ``build/mla_bench``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

LENGTHS = (128, 160, 512, 576)
CALLS = 20


def graph_ms(cs, fn):
    """Device ms per call of ``fn``: ``CALLS`` calls as the nodes of one
    CUDA graph (after a warm-up on a side stream), one replay timed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    ms, covered = cs.cuda_ms(graph.replay, 1)
    return ms / CALLS, covered


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mla_bench"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mla_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.core import dataflow as df
    from repro_torch.kernels import _build
    os.makedirs(opt.out, exist_ok=True)
    log = open(os.path.join(opt.out, "mla_bench.log"), "w")

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit(card=smi.splitlines()[0])
    _build.build_all(("fused_mla_decode",))
    cfg = cs.path_config(cs.MOE_PATH)
    m = cfg.mla
    B, D, S, nq = cs.SLOTS, cfg.d_model, cs.MAX_SEQ, cfg.n_heads
    nope, rope, lat, v = (m.nope_head_dim, m.rope_head_dim,
                          m.kv_lora_rank, m.v_head_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 4)
    w = df.MLAWeights(
        wq=cs.randn(gen, (D, nq, nope + rope), D ** -0.5),
        wdkv=cs.randn(gen, (D, lat + rope), D ** -0.5),
        wuk=cs.randn(gen, (nq, nope, lat), 0.05),
        wuv=cs.randn(gen, (nq, lat, v), 0.05),
        wo=cs.randn(gen, (nq * v, D), (nq * v) ** -0.5))
    wo4 = w.wo.view(nq, v, D).float()
    packed = df.PackedMLAWeights(
        wq=w.wq.view(D, -1), wdkv=w.wdkv, wuk=w.wuk,
        wproj=torch.einsum("qlv,qvd->qld", w.wuv.float(), wo4).to(
            torch.bfloat16),
        ln1=torch.zeros((D,), dtype=torch.float32, device="cuda"))
    x = cs.randn(gen, (B, D), 1.0)
    k_all = cs.randn(gen, (S, B, lat + rope), 1.0)
    scale = (nope + rope) ** -0.5
    for n in LENGTHS:
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        row_i = torch.arange(S, dtype=torch.int32, device="cuda")[:, None]
        pos = torch.where(row_i < n + 40, row_i, -1).expand(S, B)

        def cache(rows):
            return df.KVBlock(k_all[:rows].clone(),
                              k_all[:rows, :, :1].clone(),
                              pos[:rows].contiguous())
        full, live = cache(S), cache(n + 1)
        cos, sin = df.rope_at(lens, rope, cfg.rope_theta)
        q_cat = cs.randn(gen, (B, nq, lat + rope), 1.0)
        times = {
            "unfused_layer": lambda: df.mla_attention(
                x, w, full, lens, cos, sin, nope_dim=nope, rope_dim=rope),
            "core_all_rows": lambda: df.latent_attention(
                q_cat, full, lens, lat, scale),
            "core_live_rows": lambda: df.latent_attention(
                q_cat, live, lens, lat, scale),
            "fused_layer": lambda: df.mla_attention_packed(
                x, packed, full, lens, cos, sin, nope_dim=nope,
                rope_dim=rope)}
        row = dict(path=cs.MOE_PATH, slots=B, cache_rows=S, cache_len=n)
        for name, fn in times.items():
            ms, covered = graph_ms(cs, fn)
            row[f"{name}_ms"] = round(ms, 4)
            row[f"{name}_ms_per_step"] = round(ms * cfg.n_layers, 3)
            row["queued_under_spin"] = row.get("queued_under_spin",
                                               True) and covered
        emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
