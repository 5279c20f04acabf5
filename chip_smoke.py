#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives nine serving paths, each at full width and depth with seeded
random bf16 weights and 8 slots.  Three run the fused ``backend="pallas"``
kernels: Llama2-7B (32 layers; kernels B1 ``fused_decode``, B2
``fused_ffn``, B3 ``fused_head``) and the dense-MLA arm of
DeepSeek-V2-Lite (27 layers, ``moe=None``; kernels B4
``fused_mla_decode``, B2, B3), both ragged with ``max_seq`` 1024, and
RWKV-6 3B (32 layers, attention-free; kernels B7 ``rwkv6_scan`` at
prefill and at every decode step, B3), served lockstep.  The fourth is
Llama2-7B again, on the same weights, through the unfused
``backend="xla"`` dataflow (the paper's baseline: plain torch products,
RoPE, append and head around B5 ``flash_decode``), so the fused and the
unfused step are timed in one call.  The fifth is RecurrentGemma-9B (38
layers: 26 RG-LRU and 12 local-attention, tied embeddings) on its only
backend, ``"xla"`` with the default ``EngineOptions()``, served lockstep
with ``max_seq`` 4096: B6 ``rglru_scan`` runs every RG-LRU recurrence at
prefill and at every decode step, B5 every local layer's decode over a
2048-row ring cache.  The last four are the GQA dense models, each on
both backends like Llama2-7B: Granite-8B (36 layers, 32/8 heads, tied
embeddings: B3 reads ``embed`` itself) and Minitron-4B (32 layers,
24/8 heads, an ungated squared-ReLU FFN: B2's ungated ``relu2``
instance), through B1's GQA mode, B2 and B3 on ``"pallas"`` and B5 on
``"xla"``.  It builds the hand-written kernels from
``src/repro_torch/csrc`` with ``nvcc`` and then, one line per phase:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds B1–B7, one ``nvcc`` per source, all at once;
3. holds each kernel against its plain PyTorch version on the card at
   each path's shapes (8 slots, bf16, ragged cache lengths −1, 0, 1 …
   1023 with stale entries past each live prefix): bf16 outputs to 2e-2
   in f32; B4's f32 ``o``, ``m`` and ``l`` relative to each slot's
   largest element to ``MLA_REL_TOL``; B7's f32 ``o`` and ``s_fin``
   relative to each (slot, head)'s largest element to ``WKV_REL_TOL``,
   at the prefill shape ``[8, 512, 40, 64]`` from a zero and a random
   ``s0`` and at the decode shape ``[8, 1, 40, 64]``, the state updated
   in place as the engine does, and check-only at ``S`` = 130 and 17
   (the last chunk of its ring partial); head candidates to exact
   indices and values within 4 f32 ulps, and check-only at a ragged
   vocabulary of 32011 rows at Llama2-7B's width, where slot 1's eight
   best rows lie in one CTA's run; B5 per slot at the unfused path's shape
   (``q [8, 32, 128]``, cache ``[1024, 8, 32, 128]``, the lengths above
   clamped to 0) and at a GQA shape with a window and a softcap, bf16
   to 2e-2 with the length-0 slots exactly zero, and check-only on its
   block-wide CUDA-core path (GQA 32/4 with a window in bf16; f32, to
   ``FLASH_F32_REL_TOL`` of each slot's largest element); B6's f32
   ``h_seq`` and ``h_fin`` relative to each slot's largest element to
   ``RGLRU_REL_TOL``, at the prefill shape ``[8, 2080, 4096]`` from a
   zero and a random ``h0`` and at the decode shape ``[8, 1, 4096]``
   (``log_a ≤ 0`` at the model's scale, the state updated in place as
   the engine does); B5 at RecurrentGemma's shape, q ``[8, 16, 256]``
   against a full 2048-row ring ``[2048, 8, 1, 256]``, and check-only
   at ragged lengths on that ring (0, 1, the first batch's 128–160, the
   edges of 64-row tiles and of the 8 ranks' runs, 2047, 2048); B1
   check-only at lengths on its 4 ranks' split edges, B4 on its 8 ranks'
   run edges, B1 check-only at lengths on the GQA paths' 8 ranks'
   run edges (``GQA_EDGE_LENS``); B2 at every ``d_ff`` width (11008,
   10944, 14336 gated ``silu``, 9216 ungated ``relu2``: their clusters'
   slices differ), and check-only at each fused attention path's widths
   with 5 slots (gated) or 3 (ungated) and at 512 × 1024 gated
   ``gelu_tanh``, ``relu``, ``relu2`` and ungated ``silu``,
   ``gelu_tanh``, ``relu``;
   B3 at every vocabulary (32000 … 256000); B5 at the GQA paths' 32/8
   and 24/8; check-only, the unfused paths' loose head
   (``models/layers.py:lm_head_logits``, no kernel of its own) on a
   random table of each path's shape (32000, 49152 and 256000 rows),
   its top-8 against the f64 sum to exact indices and values within 4
   f32 ulps, its peak allocation under a quarter of an f32 copy of the
   table; the cluster kernels (B1, B2, B3, B4,
   B5) and B7 launched twice on the same inputs give the same bits (their
   ranks' and clusters' partials merge in a fixed order; B3's merges
   select without arithmetic);
4. per path, builds the engine, whose ``decode_fn`` replays the decode
   step captured once in a CUDA graph (``serving/step_graph.py``), and
   serves through it; per attention path a staggered 12-request trace
   through ``SlotScheduler``, checking that the capture counted exactly
   ``L`` launches of the attention kernel, ``L`` of B2 and one of B3
   (``2·L + 1``: 65, 55, 73, 65) — on the unfused paths ``L`` of B5 and
   nothing else —
   that every decode step was exactly one replay of that graph and
   credited those launches, and that no launch fell outside a step
   (these launch counts are the capture's, which each replay credits:
   phase 5's trace is the check made on the device), that every token
   lies in the vocabulary and that every residual row stayed finite; on
   RWKV-6 (no per-slot insert: the reference's ``admit`` raises) one
   engine runs two ``generate`` batches of 8 requests (prompts of 128
   then 512 tokens, 32 then 64 new tokens) and checks ``L`` B7 launches
   and no B3 launch per prefill, ``L`` B7 and one B3 per decode step,
   none outside them, tokens in the vocabulary, every row finite, and
   that the second batch's first tokens equal a prefill's from a fresh
   state; it prints the 512-token prefill's time (time to first token);
   RecurrentGemma-9B runs the same two-batch loop (prompts of 128 then
   2080 tokens, 32 new tokens each: the 2048-row rings wrap during the
   second prefill and stay wrapped) and checks 26 B6 launches and no B5
   per prefill, 26 B6 and 12 B5 per decode step and nothing else, and
   prints the 2080-token prefill's time; prefills stay eager (no
   replay).  Then it holds the graph against the eager step: the
   engine's own state admitted or prefilled afresh and cloned, 16
   graphed steps on it and 16 eager ones (``decode_step`` with
   ``KERNELS``) on the clone from the same forced tokens must give equal
   tokens on every step and every state leaf (caches, ``pos``, recurrent
   states, ``cache_lens``, sampling, ``nonfinite``) equal bit for bit;
   it prints both medians of step and host-issue time and requires the
   graphed step to issue in under 1 ms and to be no slower than the
   eager one, then times the graphed step's device work alone (replays
   queued behind a spin kernel: ``graph_device_step_ms``), and each
   unfused path's ratio line gives its step over its fused path's both
   as served and as device work alone;
5. after every path's phase 4 (a profiler trace leaves the host's
   graph launches slower for the rest of the process), per path on an
   engine built anew, runs teacher-forced decode steps once through the
   kernels and once through their plain versions (RecurrentGemma after
   a 2080-token prefill), and requires their greedy tokens to agree on at
   least 90 % of (step, slot) — each unfused path's tokens also against
   its fused path's; then traces a few replays of the engine's
   graph on its own state with ``torch.profiler`` for the device time
   per kernel and the device's idle share, and requires exactly the
   device kernels that the step's port kernels run at decode
   (``DECODE_KERNELS``: both of B4's, B7's ``wkv_step_kernel``, one each
   of the others) to show, each as many spans a step as phase 4's
   capture counted launches, then times the graphed host issue again
   (``graph_host_ms_after_trace``); dropping an engine, in either
   phase, must give back its memory, the graph's pool included;
6. times an empty launch (``torch.cuda._sleep(0)``) in the kernels'
   harness, one launch at a time and as a graph's nodes (the ``floor``
   line: a launch's cost, below which no kernel's time can go), with
   the host's time for one launch of a graph of ``FLOOR_NODES`` empty
   nodes, taken before phase 4 and again after phase 5's traces, then
   times each kernel and its plain version beside its bound at each
   path's shapes (device time per call: CUDA events around back-to-back
   calls queued behind a spin kernel, median after warm-up; ``call_ms``
   is one call with its host work), and prints them as one JSON
   ``kernels`` line with each kernel's launches per step as its path's
   phase 4 counted them (``stage`` "prefill": per prefill); B5's rows
   carry ``library_ms``, one ``F.scaled_dot_product_attention`` call
   with a per-slot mask on the same cache (no PyTorch call computes B6's
   recurrence: its ``library_ms`` is null); B2's rows carry
   ``products_ms``, its three products as ``torch.matmul`` calls of the
   same shapes (not one call of B2's function: ``library_ms`` null);
   B3's rows carry ``products_ms``, one ``torch.matmul(h, table.T)`` in
   bf16 on the same table — a yardstick of the rate at which the table
   can be read, not B3's function (no norm, no f32 logits, no top-k:
   ``library_ms`` null); ``bound_under_floor`` marks a row whose bound
   lies under the empty launch's time.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits nonzero; without a CUDA device it exits nonzero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    ATTN_LOCAL, RECURRENT, RWKV6, get_config)
from repro_torch.core import tracecount  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import (  # noqa: E402
    flash_decode_attention, flash_decode_plain)
from repro_torch.kernels.fused_decode.fused_decode import (  # noqa: E402
    fused_decode_attention, fused_decode_plain, rope_at)
from repro_torch.kernels.fused_ffn.fused_ffn import (  # noqa: E402
    fused_ffn_block, fused_ffn_plain)
from repro_torch.kernels.fused_head.fused_head import (  # noqa: E402
    fused_head_block, fused_head_plain)
from repro_torch.kernels.fused_mla_decode.fused_mla_decode import (  # noqa: E402
    fused_mla_decode_attention, fused_mla_decode_plain)
from repro_torch.kernels.rglru_scan.rglru_scan import (  # noqa: E402
    rglru_scan, rglru_scan_plain)
from repro_torch.kernels.rwkv6_scan.rwkv6_scan import (  # noqa: E402
    rwkv6_scan, rwkv6_scan_plain)
from repro_torch.launch.serve import build_engine_full, generate  # noqa: E402
from repro_torch.models.layers import lm_head_logits  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    KERNELS, PLAIN_KERNELS, EngineOptions, decode_step,
    init_decode_state)
from repro_torch.serving.sampling import head_candidates  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    Request, SlotScheduler, replay_trace)
from repro_torch.serving.step_graph import StepGraph  # noqa: E402

PATHS = (("llama2-7b", "pallas"),
         ("deepseek-v2-lite", "pallas"),   # its dense-MLA arm
         ("rwkv6-3b", "pallas"),
         ("llama2-7b", "xla"),             # the unfused baseline
         ("recurrentgemma-9b", "xla"),     # its one backend
         ("granite-8b", "pallas"),         # GQA 32/8, tied embeddings
         ("granite-8b", "xla"),
         ("minitron-4b", "pallas"),        # GQA 24/8, ungated relu2 FFN
         ("minitron-4b", "xla"))
SLOTS = 8
MAX_SEQ = 1024
SEED = 0
# lockstep paths: max_seq and the (prompt, new tokens) of each batch; the
# second RecurrentGemma prompt wraps the 2048-row rings during prefill
LOCKSTEP = {"rwkv6-3b": (MAX_SEQ, ((128, 32), (512, 64))),
            "recurrentgemma-9b": (4096, ((128, 32), (2080, 32)))}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
F32_FLOPS = 67e12              # H100 SXM f32 on the CUDA cores
BF16_TOL = 2e-2                # bf16 inputs: a value on a rounding
                               # boundary may round the other way under
                               # another summation order
HEAD_ULPS = 4                  # head values: f32 summation order only
MLA_REL_TOL = 1e-3             # B4's f32 outputs from the same bf16
                               # inputs: summation order only, relative to
                               # each slot's largest element (o is not
                               # normalized: it grows with the live length)
WKV_REL_TOL = 1e-4             # B7's f32 o and s_fin from the same f32
                               # inputs: summation order (and fused
                               # multiply-adds) only, relative to each
                               # (slot, head)'s largest element
RGLRU_REL_TOL = 1e-4           # B6's f32 h_seq and h_fin: the same order
                               # of steps, but a fused multiply-add and
                               # another exp, over up to 2080 dependent
                               # steps, relative to each slot's largest
                               # element
FLASH_F32_REL_TOL = 1e-4       # B5 on f32 inputs: summation order only,
                               # relative to each slot's largest element
FLOOR_NODES = 2600             # about RWKV-6's device launches a step
SPIN_CYCLES = 50_000_000       # ≈ 25 ms at the H100's clock: longer than
                               # the host needs to queue a timed batch


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def randn(gen, shape, scale, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def close_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > BF16_TOL + BF16_TOL * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements off by "
            f"more than {BF16_TOL} (max abs err {float(err.max()):.3e})")
    return float(err.max())


def close_rel(name: str, got: torch.Tensor, want: torch.Tensor,
              tol: float = MLA_REL_TOL, lead: int = 1) -> float:
    """f32 outputs, per group of the ``lead`` leading axes (a slot, or a
    (slot, head)) relative to the group's largest element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    size = want.abs().flatten(lead).amax(dim=-1).clamp(min=1e-30)
    rel = err.flatten(lead).amax(dim=-1) / size
    if not torch.isfinite(got).all() or (rel > tol).any():
        raise AssertionError(f"{name}: off by {rel.max():.3e} of the "
                             f"group's largest element (tolerance {tol})")
    return float(err.max())


def close_head(name: str, got, want) -> float:
    (gv, gi), (wv, wi) = got, want
    if not torch.equal(gi, wi):
        raise AssertionError(f"{name}: candidate indices differ:\n{gi}\n{wi}")
    ulp = torch.nextafter(wv.abs(), torch.full_like(wv, float("inf"))) \
        - wv.abs()
    err = (gv - wv).abs()
    if not torch.isfinite(gv).all() or (err > HEAD_ULPS * ulp).any():
        raise AssertionError(
            f"{name}: candidate values off by more than {HEAD_ULPS} ulps "
            f"(max {float((err / ulp).max()):.1f})")
    return float(err.max())


def cuda_ms(fn, n: int, reps: int = 5, warmup: int = 3):
    """Device ms per call: the median over ``reps`` of one CUDA-event
    pair around ``n`` back-to-back calls, divided by ``n``.  A spin
    kernel queued first keeps the device busy while the host queues the
    calls, so the wrappers' host work stays out of the window; the
    second result says whether the spin outlasted the queuing in every
    rep (if not, host gaps may be inside the window)."""
    for _ in range(warmup):
        fn()
    times, covered = [], True
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        for _ in range(n):
            fn()
        covered &= not e0.query()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times), covered


def call_ms(fn, n: int, warmup: int = 3) -> float:
    """Median of ``n`` single-call CUDA-event timings: device time plus
    the host work of one call that the device waits for."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def empty_graph(nodes: int):
    """A CUDA graph of ``nodes`` empty kernels (``torch.cuda._sleep(0)``),
    captured after one eager launch has loaded the kernel."""
    torch.cuda._sleep(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(nodes):
            torch.cuda._sleep(0)
    return graph


def launch_host_ms(graph, reps: int = 20) -> float:
    """Median host clock around one ``graph.replay()`` issued to an idle
    device: the host's cost of a graph launch."""
    times = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times[3:])


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (dicts, lists,
    named tuples of tensors): views and aliases count once."""
    storages = {}

    def walk(t):
        if torch.is_tensor(t):
            s = t.untyped_storage()
            storages[s.data_ptr()] = s.nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(tree)
    return sum(storages.values())


def bound(n_bytes: float, n_ops: float, rate: float = BF16_FLOPS):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3 inputs: one layer's operands at each path's shapes
# ---------------------------------------------------------------------------
def decode_lens(S: int, lens=None):
    """Ragged cache lengths (by default −1 = free slot … S − 1) and
    per-slot positions with stale entries past each live prefix, which
    the kernels must skip."""
    lens = torch.tensor(lens or [-1, 0, 1, 127, 300, 513, 777, S - 1],
                        dtype=torch.int32, device="cuda")
    s_idx = torch.arange(S, dtype=torch.int32, device="cuda")[:, None]
    pos = torch.where(s_idx < lens[None, :] + 40, s_idx, -1).to(torch.int32)
    return lens, pos, int(lens.clamp(min=0).sum())


# B1 at lengths on 64-row tile edges ± 1: its 4 ranks (Llama2-7B) cut the
# slots' live rows, laid end to end, into equal runs of tiles that stop
# at a slot's edge, so runs start and end inside slots and tiles
B1_EDGE_LENS = [63, 64, 65, 255, 256, 257, 513, MAX_SEQ - 1]
# B1 on the GQA paths' clusters of 8 ranks: 1024 live rows (slot edges at
# 64, 128, 256, 448, 511, 576, 831) cut into runs of 128 rows that end at
# a slot's edge (128, 256), one row inside a slot (512) or in a slot's
# middle (384, 640, 768, 896), in 64-row tiles that stop at slot edges
GQA_EDGE_LENS = [64, 64, 128, 192, 63, 65, 255, 193]


def gqa_case(cfg, gen, lens=None):
    """B1 at ``cfg``'s widths; with ``lens`` a check-only case (no path
    runs those lengths, so it has no phase 6 row)."""
    B, D, S = SLOTS, cfg.d_model, MAX_SEQ
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    P = (nq + 2 * nkv) * hd
    edge = lens is not None
    lens, pos, live = decode_lens(S, lens)
    cos, sin = rope_at(lens, hd, cfg.rope_theta)
    dec = dict(
        x=randn(gen, (B, D), 1.0),
        wqkv=randn(gen, (D, P), D ** -0.5),
        wo=randn(gen, (nq, hd, D), (nq * hd) ** -0.5),
        norm_scale=randn(gen, (D,), 0.1, torch.float32),
        k_cache=randn(gen, (S, B * nkv, hd), 1.0),
        v_cache=randn(gen, (S, B * nkv, hd), 1.0),
        pos=pos, cache_lens=lens, include_new=(lens >= 0).to(torch.int32),
        cos=cos, sin=sin)
    dec_bytes = (B * D * 2 + D * P * 2 + nq * hd * D * 2 + D * 4
                 + 2 * live * nkv * hd * 2 + live * 4 + B * 4 * (2 + hd)
                 + B * nq * D * 4 + 2 * B * nkv * hd * 2 + 2 * B * nq * 4)
    dec_ops = 2 * B * D * P + 4 * live * nq * hd + 4 * B * nq * hd \
        + 2 * B * nq * hd * D
    case = dict(name="fused_decode", fn=fused_decode_attention,
                plain=fused_decode_plain, args=dec,
                kw=dict(q_heads=nq, kv_heads=nkv, scale=hd ** -0.5,
                        norm_eps=cfg.norm_eps),
                cost=(dec_bytes, dec_ops),
                replaces="src/repro/kernels/fused_decode/fused_decode.py:276")
    if edge:
        case.update(check_only=True,
                    stage=f"rank-split edge lengths {lens.tolist()}")
    return case


# B4 at lengths whose live rows, laid end to end (768), cut into the 8
# ranks' runs of 96 rows at a slot's edge, one row inside a slot, or in
# the middle of a long slot, with 32-row tiles that stop at slot edges
B4_EDGE_LENS = [95, 97, 96, 96, 24, 168, 1, 191]


def mla_case(cfg, gen, lens=None):
    """B4 at ``cfg``'s widths; with ``lens`` a check-only case (no path
    runs those lengths, so it has no phase 6 row)."""
    B, D, S = SLOTS, cfg.d_model, MAX_SEQ
    m = cfg.mla
    nq, nope, rope, lat = (cfg.n_heads, m.nope_head_dim, m.rope_head_dim,
                           m.kv_lora_rank)
    lr, Pq = lat + rope, cfg.n_heads * (nope + rope)
    edge = lens is not None
    lens, pos, live = decode_lens(S, lens)
    cos, sin = rope_at(lens, rope, cfg.rope_theta)
    args = dict(
        x=randn(gen, (B, D), 1.0),
        wq=randn(gen, (D, Pq), D ** -0.5),
        wdkv=randn(gen, (D, lr), D ** -0.5),
        wuk=randn(gen, (nq, nope, lat), 0.05),
        # the init's W_UV (0.05) times W_O (1/√(q·v)), summed over v
        wproj=randn(gen, (nq, lat, D), 0.05 / nq ** 0.5),
        norm_scale=randn(gen, (D,), 0.1, torch.float32),
        c_cache=randn(gen, (S, B, lr), 1.0),
        pos=pos, cache_lens=lens,
        include_new=((lens >= 0) & (lens < S)).to(torch.int32),
        cos=cos, sin=sin)
    n_bytes = (B * D * 2 + D * Pq * 2 + D * lr * 2 + nq * nope * lat * 2
               + nq * lat * D * 2 + D * 4 + live * lr * 2 + live * 4
               + B * 4 * (2 + rope)
               + B * nq * D * 4 + B * lr * 2 + 2 * B * nq * 4)
    n_ops = (2 * B * D * (Pq + lr) + 2 * B * nq * nope * lat
             + 2 * live * nq * (lr + lat) + 2 * B * nq * (lr + lat)
             + 2 * B * nq * lat * D)
    case = dict(name="fused_mla_decode", fn=fused_mla_decode_attention,
                plain=fused_mla_decode_plain, args=args,
                kw=dict(q_heads=nq, nope=nope, rope_d=rope, l_rank=lat,
                        norm_eps=cfg.norm_eps),
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/fused_mla_decode/"
                         "fused_mla_decode.py:180")
    if edge:
        case.update(check_only=True,
                    stage=f"rank-run edge lengths {lens.tolist()}")
    return case


def wkv_case(cfg, gen, S: int, check_only: bool = False):
    """B7 at ``[SLOTS, S, H, hd]`` with the model path's scales: r, k, v
    the projections of a normed row (≈ N(0, 1)), w the decay
    exp(−exp(−0.5 + δ)), u ≈ 0.1, and a random ``s0`` (a state after a
    prompt) beside the zero one prefill starts from; ``check_only`` at a
    length no path runs (no phase 6 row)."""
    B, H, hd = SLOTS, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    f32 = torch.float32
    shape = (B, S, H, hd)
    args = dict(r=randn(gen, shape, 1.0, f32), k=randn(gen, shape, 1.0, f32),
                v=randn(gen, shape, 1.0, f32),
                w=torch.exp(-torch.exp(-0.5 + randn(gen, shape, 0.1, f32))),
                u=randn(gen, (H, hd), 0.1, f32),
                s0=randn(gen, (B, H, hd, hd), 1.0, f32))
    s0s = [args["s0"]]
    if S > 1:
        s0s.insert(0, torch.zeros_like(args["s0"]))
    n_bytes = 5 * B * S * H * hd * 4 + H * hd * 4 + 2 * B * H * hd * hd * 4
    n_ops = 6 * B * S * H * hd * hd
    case = dict(name="rwkv6_scan", fn=rwkv6_scan, plain=rwkv6_scan_plain,
                args=args, kw={}, s0s=s0s, rate=F32_FLOPS,
                stage="prefill" if S > 1 else "decode",
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/rwkv6_scan/rwkv6_scan.py:58")
    if check_only:
        case.update(check_only=True, stage=f"prefill S {S}")
    return case


# B7 at lengths whose last 8-step chunk of its ring is partial
WKV_EDGE_LENS = (130, 17)


def rglru_case(cfg, gen, S: int):
    """B6 at ``[SLOTS, S, C]`` with the model path's scales: ``log_a =
    −8·softplus(Λ)·r`` (Λ as the init lays it out over the channels, r
    a sigmoid gate), ``b = √(1 − a²)·i·u`` (i a sigmoid gate, u ≈ N(0,
    1)), and a random ``h0`` (a state after a prompt) beside the zero
    one prefill starts from."""
    B, C = SLOTS, cfg.rglru_d_state or cfg.d_model
    f32 = torch.float32
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, C, device="cuda")) * 2.0 / 8.0))
    log_a = -8.0 * F.softplus(lam) * torch.sigmoid(
        randn(gen, (B, S, C), 1.0, f32))
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * torch.sigmoid(randn(gen, (B, S, C), 1.0, f32)) \
        * randn(gen, (B, S, C), 1.0, f32)
    args = dict(log_a=log_a.contiguous(), b=b.contiguous(),
                h0=randn(gen, (B, C), 1.0, f32))
    h0s = [args["h0"]]
    if S > 1:
        h0s.insert(0, torch.zeros_like(args["h0"]))
    n_bytes = 3 * B * S * C * 4 + 2 * B * C * 4
    n_ops = 3 * B * S * C                  # exp, multiply, add
    return dict(name="rglru_scan", fn=rglru_scan, plain=rglru_scan_plain,
                args=args, kw={}, h0s=h0s, rate=F32_FLOPS,
                stage="prefill" if S > 1 else "decode",
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/rglru_scan/rglru_scan.py:50")


# B5 at RecurrentGemma's shape, ragged: the first batch's lengths
# (128-160), tile edges (64 rows) and the edges of the 8 ranks' runs of
# ⌈L/8⌉ rows (one 64-row tile a rank up to 512 rows, two up to 1024,
# three up to 1536)
RING_EDGE_LENS = ([0, 1, 63, 64, 65, 127, 128, 129],
                  [159, 160, 255, 256, 257, 511, 512, 513],
                  [1023, 1024, 1025, 1535, 1537, 1791, 2047, 2048])


def ring_flash_case(cfg, gen, lens=None):
    """B5 as RecurrentGemma's local layers call it once the rings have
    wrapped: ``q [8, 16, 256]`` bf16 against a full ``[2048, 8, 1, 256]``
    bf16 ring, every slot's length 2048, no window of its own; with
    ``lens`` a check-only case at those lengths."""
    B, hd = SLOTS, cfg.resolved_head_dim
    S = cfg.sliding_window
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    edge = lens is not None
    lens = (torch.tensor(lens, dtype=torch.int32, device="cuda") if edge
            else torch.full((B,), S, dtype=torch.int32, device="cuda"))
    args = dict(q=randn(gen, (B, nq, hd), 1.0),
                k_cache=randn(gen, (S, B, nkv, hd), 1.0),
                v_cache=randn(gen, (S, B, nkv, hd), 1.0), cache_len=lens)
    n_bytes = 2 * B * S * nkv * hd * 2 + 2 * B * nq * hd * 2 + B * 4
    n_ops = 4 * B * S * nq * hd
    case = dict(name="flash_decode", fn=flash_decode_attention,
                plain=flash_decode_plain, args=args,
                kw=dict(window=0, attn_softcap=0.0),
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/flash_decode/flash_decode.py:73")
    if edge:
        case.update(check_only=True, stage=f"ring lengths {lens.tolist()}")
    return case


def flash_case(cfg, gen, *, q_heads=None, kv_heads=None, q_scale=1.0,
               window=0, cap=0.0, dtype=torch.bfloat16):
    """B5 in the engine's per-slot form: ``q [8, q, hd]`` against a cache
    ``[1024, 8, kv, hd]`` at the phase 3 lengths clamped to 0 (each
    slot's rows past its length are stale and must be masked).  Default:
    the unfused Llama path's shape in bf16; with other heads, a window,
    a softcap or f32 a check-only shape (no path runs it, so it has no
    phase 6 row): B5's block-wide CUDA-core path (5-15 query rows a kv
    head, or f32) runs only there."""
    B, S, hd = SLOTS, MAX_SEQ, cfg.resolved_head_dim
    nq, nkv = q_heads or cfg.n_heads, kv_heads or cfg.n_kv_heads
    lens, _, _ = decode_lens(S)
    lens = lens.clamp(min=0)
    args = dict(q=randn(gen, (B, nq, hd), q_scale, dtype),
                k_cache=randn(gen, (S, B, nkv, hd), 1.0, dtype),
                v_cache=randn(gen, (S, B, nkv, hd), 1.0, dtype),
                cache_len=lens)
    lo = (lens - window + 1).clamp(min=0) if window else 0 * lens
    live = int((lens - lo).sum())
    n_bytes = 2 * live * nkv * hd * 2 + 2 * B * nq * hd * 2 + B * 4
    n_ops = 4 * live * nq * hd
    case = dict(name="flash_decode", fn=flash_decode_attention,
                plain=flash_decode_plain, args=args,
                kw=dict(window=window, attn_softcap=cap),
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/flash_decode/flash_decode.py:73")
    if window or cap or q_heads or dtype != torch.bfloat16:
        case.update(check_only=True, stage=f"gqa {nq}/{nkv} window "
                    f"{window} softcap {cap:g} {str(dtype)[6:]}")
    return case


def kernel_cases(cfg, backend):
    """The kernels of ``cfg``'s path at its widths: on ``"pallas"`` the
    attention kernel (B1, or B4 for MLA), B2 and B3 — or, on RWKV-6, B7
    at the prefill and the decode shape, and B3; on ``"xla"`` B5 at the
    path's shape and at a GQA shape with a window and a softcap — or, on
    RecurrentGemma, B6 at the prefill and the decode shape and B5 on a
    full ring."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    B, D, F, V = SLOTS, cfg.d_model, cfg.d_ff, cfg.vocab_size
    if RECURRENT in cfg.block_pattern:
        n_prompt = LOCKSTEP[cfg.name][1][-1][0]
        cases = [rglru_case(cfg, gen, n_prompt), rglru_case(cfg, gen, 1),
                 ring_flash_case(cfg, gen)] + [
            ring_flash_case(cfg, gen, lens) for lens in RING_EDGE_LENS]
    elif backend == "xla" and cfg.q_per_kv > 1:
        cases = [flash_case(cfg, gen)]          # the path's GQA shape
    elif backend == "xla":
        cases = [flash_case(cfg, gen),
                 flash_case(cfg, gen, q_heads=32, kv_heads=8, q_scale=8.0,
                            window=256, cap=50.0),
                 flash_case(cfg, gen, q_heads=32, kv_heads=4, window=300),
                 flash_case(cfg, gen, q_heads=32, kv_heads=32,
                            dtype=torch.float32)]
    elif cfg.block_pattern == (RWKV6,):
        cases = [wkv_case(cfg, gen, LOCKSTEP[cfg.name][1][-1][0]),
                 wkv_case(cfg, gen, 1),
                 head_case(cfg, gen)] + [
            wkv_case(cfg, gen, S, check_only=True) for S in WKV_EDGE_LENS]
    else:
        attn = (mla_case(cfg, gen) if cfg.mla is not None
                else gqa_case(cfg, gen))
        if cfg.mla is not None:
            edges = [mla_case(cfg, gen, B4_EDGE_LENS)]
        elif cfg.q_per_kv == 1:
            edges = [gqa_case(cfg, gen, B1_EDGE_LENS),
                     head_case(cfg, gen, RAGGED_VOCAB)]
        else:
            edges = [gqa_case(cfg, gen, GQA_EDGE_LENS)]
        cases = [attn, ffn_case(cfg, gen), head_case(cfg, gen)] + edges
        # B2 with fewer slots than 8 (its instances that take the batch
        # at run time), at the path's widths
        cases.append(ffn_case(cfg, gen, slots=5 if cfg.ffn_gated else 3))
        if not cfg.ffn_gated:
            # the other activations, gated and ungated, at a small width
            cases += [
                ffn_case(cfg, gen, act=act, gated=gated, width=(512, 1024))
                for gated, acts in ((True, ("gelu_tanh", "relu", "relu2")),
                                    (False, ("silu", "gelu_tanh", "relu")))
                for act in acts]
    if backend == "xla":
        cases.append(loose_head_case(cfg, gen))
    for case in cases:
        case["path"], case["backend"] = cfg.name, backend
    return cases


def ffn_case(cfg, gen, act=None, gated=None, width=None, slots=SLOTS):
    """B2 at ``cfg``'s widths, its activation and gating; with ``act``,
    ``gated`` and ``width`` (d_model, d_ff), or fewer ``slots``, a
    check-only case (no path runs it, so it has no phase 6 row)."""
    B = slots
    D, F = width or (cfg.d_model, cfg.d_ff)
    act = act or cfg.ffn_act
    gated = cfg.ffn_gated if gated is None else gated
    args = dict(x=randn(gen, (B, D), 1.0), a=randn(gen, (B, D), 1.0),
                w_in=randn(gen, (D, F), D ** -0.5),
                w_gate=randn(gen, (D, F), D ** -0.5) if gated else None,
                w_out=randn(gen, (F, D), F ** -0.5),
                ln2=randn(gen, (D,), 0.1, torch.float32))
    n_mat = 3 if gated else 2
    case = dict(name="fused_ffn", fn=fused_ffn_block, plain=fused_ffn_plain,
                args=args, kw=dict(add_r=1.0, act=act, eps=cfg.norm_eps),
                cost=(4 * B * D * 2 + n_mat * D * F * 2 + D * 4,
                      2 * B * D * F * n_mat),
                replaces="src/repro/kernels/fused_ffn/fused_ffn.py:105")
    if width or B != SLOTS:
        case.update(check_only=True,
                    stage=f"{'gated' if gated else 'ungated'} {act} {D}x{F} "
                    f"{B} slots")
    return case


def loose_head_case(cfg, gen):
    """The unfused paths' loose head (``models/layers.py:lm_head_logits``,
    no kernel of its own) on a random table of the path's shape,
    check-only: its top-8 against the f64 sum (C3) and its peak memory
    (``check_loose_head``)."""
    D, V = cfg.d_model, cfg.vocab_size
    return dict(name="lm_head_logits", fn=lm_head_logits,
                args=dict(table=randn(gen, (V, D), D ** -0.5),
                          x=randn(gen, (SLOTS, D), 1.0)),
                check_only=True, stage=f"table {V}x{D}")


# B3 at a vocabulary that is no multiple of 16 rows (a ragged last unit)
RAGGED_VOCAB = 32011


def head_case(cfg, gen, vocab=None):
    """B3 at ``cfg``'s width and vocabulary; with ``vocab`` a check-only
    case at that vocabulary, where slot 1's eight best rows (5000–5007)
    all lie in one CTA's run (``fused_head.cluster_plan``: a run is
    ≈ 267 rows), so seven of that CTA's neighbours and the other clusters
    bring no candidate of slot 1 to the merges."""
    B, D, V = SLOTS, cfg.d_model, vocab or cfg.vocab_size
    table = randn(gen, (V, D), D ** -0.5)
    x_head = randn(gen, (B, D), 1.0)
    # a tie across the first and the last vocab tile, at the top of
    # slot 0's candidates: the lower index must come first
    table[100] = torch.sign(x_head[0]).to(torch.bfloat16) * 0.05
    table[V - 1] = table[100]
    if vocab:
        for i in range(8):
            table[5000 + i] = (torch.sign(x_head[1]) * (0.04 - 0.002 * i)
                               ).to(torch.bfloat16)
    head = dict(x=x_head, table=table,
                ln=torch.zeros((D,), dtype=torch.float32, device="cuda"))
    head_bytes = B * D * 2 + V * D * 2 + D * 4 + B * 8 * 8
    head_ops = 2 * B * D * V
    case = dict(name="fused_head", fn=fused_head_block, plain=fused_head_plain,
                args=head, kw=dict(eps=cfg.norm_eps, k=8),
                cost=(head_bytes, head_ops),
                replaces="src/repro/kernels/fused_head/fused_head.py:97")
    if vocab:
        case.update(check_only=True, stage=f"vocab {V}")
    return case


def check_wkv(case) -> float:
    """B7 from each ``s0`` with the state updated in place (``s_out`` =
    the state passed in, as the engine calls it) against the plain
    version from a fresh copy: ``o`` and ``s_fin`` per (slot, head)."""
    errs = []
    for s0 in case["s0s"]:
        args = dict(case["args"], s0=s0)
        state = s0.clone()
        o, s_fin = case["fn"](**dict(args, s0=state), s_out=state)
        again = s0.clone()
        o2, _ = case["fn"](**dict(args, s0=again), s_out=again)
        want_o, want_s = case["plain"](*args.values())
        torch.cuda.synchronize()
        if s_fin.data_ptr() != state.data_ptr():
            raise AssertionError("rwkv6_scan: s_fin not written in place")
        if not (torch.equal(o, o2) and torch.equal(state, again)):
            raise AssertionError("rwkv6_scan: a second launch on the same "
                                 "inputs gave other bits")
        errs.append(close_rel("rwkv6_scan[o]", o.transpose(1, 2),
                              want_o.transpose(1, 2), WKV_REL_TOL, lead=2))
        close_rel("rwkv6_scan[s_fin]", s_fin, want_s, WKV_REL_TOL, lead=2)
    return max(errs)


def check_rglru(case) -> float:
    """B6 from each ``h0`` with the state updated in place (``h_out`` =
    the state passed in, as the engine's decode step calls it) against
    the plain version from a fresh copy: ``h_seq`` and ``h_fin`` per
    slot."""
    errs = []
    for h0 in case["h0s"]:
        args = dict(case["args"], h0=h0)
        state = h0.clone()
        h_seq, h_fin = case["fn"](**dict(args, h0=state), h_out=state)
        want_seq, want_fin = case["plain"](*args.values())
        torch.cuda.synchronize()
        if h_fin.data_ptr() != state.data_ptr():
            raise AssertionError("rglru_scan: h_fin not written in place")
        errs.append(close_rel("rglru_scan[h_seq]", h_seq, want_seq,
                              RGLRU_REL_TOL))
        close_rel("rglru_scan[h_fin]", h_fin, want_fin, RGLRU_REL_TOL)
    return max(errs)


# the cluster kernels merge their ranks' (and B2 its clusters') partials
# in a fixed order, B3 selects without arithmetic and B7 sums in a fixed
# order: a second launch on the same inputs gives the same bits (B7's
# check runs in check_wkv, from a fresh copy of the state)
REPEATABLE = ("fused_decode", "flash_decode", "fused_ffn", "fused_mla_decode",
              "fused_head", "rwkv6_scan")


def check_loose_head(case) -> float:
    """The loose head on the card (bf16 products with f32 output over
    64-column chunks): the top-8 of its f32 logits against the f64 sum
    ``x · tableᵀ``, indices exact and values within ``HEAD_ULPS``; and no
    f32 copy of the table (the call's peak allocation stays under a
    quarter of one)."""
    table, x = case["args"]["table"], case["args"]["x"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = head_candidates(case["fn"](table, x), 8)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if peak >= table.numel():               # a quarter of 4 bytes an entry
        raise AssertionError(f"lm_head_logits: {peak / 2**20:.0f} MiB at "
                             f"its peak on a {tuple(table.shape)} table")
    want = head_candidates((x.double() @ table.double().T).float(), 8)
    return close_head("lm_head_logits", got, want)


def check_kernel(case) -> float:
    if case["name"] == "lm_head_logits":
        return check_loose_head(case)
    if case["name"] == "rwkv6_scan":
        return check_wkv(case)
    if case["name"] == "rglru_scan":
        return check_rglru(case)
    got = case["fn"](**case["args"], **case["kw"])
    want = case["plain"](*case["args"].values(), **case["kw"])
    name = case["name"]
    if name in REPEATABLE:
        again = case["fn"](**case["args"], **case["kw"])
        torch.cuda.synchronize()
        pairs = (zip(got, again) if isinstance(got, tuple)
                 else [(got, again)])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name}: a second launch on the same "
                                 "inputs gave other bits")
    torch.cuda.synchronize()
    if name == "fused_head":
        return close_head(name, got, want)
    if name == "flash_decode":
        empty = case["args"]["cache_len"] <= 0
        if got[empty].any():
            raise AssertionError("flash_decode: a length-0 slot is not zero")
        if got.dtype == torch.float32:
            return close_rel(name, got, want, FLASH_F32_REL_TOL)
        return close_bf16(name, got, want)
    if name == "fused_mla_decode":
        (o, c_new, m, l), (wo, wc, wm, wl) = got, want
        err = close_rel(f"{name}[o]", o, wo)
        close_bf16(f"{name}[c_new]", c_new, wc)
        close_rel(f"{name}[m]", m, wm)
        close_rel(f"{name}[l]", l, wl)
        return err
    errs = [close_bf16(f"{name}[{i}]", g, w)
            for i, (g, w) in enumerate(zip(got, want))]
    return errs[0]


# ---------------------------------------------------------------------------
# Phase 4: the staggered request trace at full width
# ---------------------------------------------------------------------------
def check_graph(graph, want, step_replays):
    """The decode steps just served: every one was exactly one replay of
    the engine's one graph, whose capture counted ``want`` launches.
    Each replay credits the capture's count, so the launches per step
    that phase 4 reads repeat it; phase 5's trace checks on the device
    that every replay ran them."""
    if not isinstance(graph, StepGraph):
        raise AssertionError(f"decode_fn is {type(graph).__name__}, not "
                             "the engine's StepGraph")
    if graph.launches != want:
        raise AssertionError(f"the graph captured {graph.launches}, want "
                             f"{want}")
    if not step_replays or any(r != (1, 1) for r in step_replays):
        raise AssertionError(f"decode steps that were not one replay of the "
                             f"graph: {step_replays[:8]}")


def decode_launches(cfg, backend):
    """Launches one decode step must make on an attention path: ``L`` of
    the attention kernel, ``L`` of B2 and one of B3 on ``"pallas"``;
    ``L`` of B5 on ``"xla"``."""
    if backend == "xla":
        return {"flash_decode": cfg.n_layers}
    attn = "fused_mla_decode" if cfg.mla is not None else "fused_decode"
    return {attn: cfg.n_layers, "fused_ffn": cfg.n_layers, "fused_head": 1}


def serve_trace(cfg, eng):
    rng = np.random.default_rng(SEED)
    n_req = 12
    arrivals = np.sort(rng.integers(0, 16, n_req))
    trace = [(int(arrivals[i]), Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 513))).tolist(),
        max_new=int(rng.integers(8, 65)))) for i in range(n_req)]
    step_launches, step_replays, step_ms, host_ms = [], [], [], []
    dec = eng.decode_fn

    def counted_decode(p, st, tok):
        before = tracecount.launches()
        replays = (tracecount.replays(), dec.replays)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        nxt, st = dec(p, st, tok)
        # the host's time to enqueue the step; near step_ms, the step
        # waits on the host
        host_ms.append(1e3 * (time.perf_counter() - t0))
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        after = tracecount.launches()
        step_launches.append({k: after[k] - before[k] for k in after})
        step_replays.append((tracecount.replays() - replays[0],
                             dec.replays - replays[1]))
        if int(st["nonfinite"].max()) != 0:
            raise AssertionError(f"non-finite residual or head value: "
                                 f"{st['nonfinite'].tolist()}")
        return nxt, st

    sched = SlotScheduler(eng._replace(decode_fn=counted_decode),
                          prompt_cap=512)
    tracecount.reset()
    t0 = time.perf_counter()
    results = replay_trace(sched, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tracecount.launches()
    want = {k: 0 for k in launches}
    want.update(decode_launches(cfg, eng.scfg.backend))
    check_graph(dec, want, step_replays)
    bad = [(i, n) for i, n in enumerate(step_launches) if n != want]
    if bad or not step_launches:
        raise AssertionError(f"launches per decode step {bad[:4]}, want "
                             f"{want} on each of {len(step_launches)} steps")
    if any(launches[k] == 0 for k, n in want.items() if n):
        raise AssertionError(f"a kernel never launched: {launches}")
    per_kernel = step_launches[0]      # the same on every step, as checked
    if len(step_launches) != sched.decode_calls or any(
            launches[k] != per_kernel[k] * sched.decode_calls
            for k in launches):
        raise AssertionError(f"launches outside the decode steps: "
                             f"{launches} over {sched.decode_calls} steps")
    toks = np.concatenate([r.tokens for r in results.values()])
    if len(toks) != sum(r.max_new for _, r in trace) \
            or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("tokens missing or outside the vocabulary")
    refills = sum(1 for _, kind, _, _ in sched.events if kind == "admit") \
        - SLOTS
    return dict(requests=n_req, ticks=sched.tick,
                decode_steps=sched.decode_calls, tokens=len(toks),
                readmits=refills, replays=tracecount.replays(),
                launches_per_step=sum(per_kernel.values()),
                median_step_ms=round(statistics.median(step_ms), 3),
                median_host_ms=round(statistics.median(host_ms), 3),
                wall_s=round(wall, 2)), launches, per_kernel, results


def lockstep_launches(cfg):
    """Launches one prefill and one decode step must make on a lockstep
    path: RWKV-6 ``L`` B7 per prefill, ``L`` B7 and one B3 per step;
    RecurrentGemma one B6 per RG-LRU layer per prefill, and per step one
    B6 per RG-LRU layer and one B5 per local-attention layer."""
    if cfg.block_pattern == (RWKV6,):
        return ({"rwkv6_scan": cfg.n_layers},
                {"rwkv6_scan": cfg.n_layers, "fused_head": 1})
    n_rec = cfg.layer_kinds.count(RECURRENT)
    return ({"rglru_scan": n_rec},
            {"rglru_scan": n_rec,
             "flash_decode": cfg.layer_kinds.count(ATTN_LOCAL)})


def serve_lockstep(cfg, eng):
    """A lockstep model's serving loop: two ``generate`` batches of
    ``SLOTS`` requests on one engine (``LOCKSTEP``), every prefill and
    decode step counted, timed (CUDA events; host clock for the enqueue)
    and checked for non-finite rows."""
    rng = np.random.default_rng(SEED)
    calls = {"prefill": [], "decode": []}

    def counted(fn, stage):
        def run(p, st, tok):
            before = tracecount.launches()
            replays = (tracecount.replays(), eng.decode_fn.replays)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            nxt, st = fn(p, st, tok)
            host = 1e3 * (time.perf_counter() - t0)
            e1.record()
            e1.synchronize()
            after = tracecount.launches()
            calls[stage].append(dict(
                ms=e0.elapsed_time(e1), host_ms=host,
                launches={k: after[k] - before[k] for k in after},
                replays=(tracecount.replays() - replays[0],
                         eng.decode_fn.replays - replays[1])))
            if int(st["nonfinite"].max()) != 0:
                raise AssertionError(f"non-finite residual or head value: "
                                     f"{st['nonfinite'].tolist()}")
            return nxt, st
        return run

    plan = LOCKSTEP[cfg.name][1]
    state, batches = eng.state, []
    tracecount.reset()
    t0 = time.perf_counter()
    for n_prompt, n_new in plan:
        prompts = rng.integers(0, cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        toks, state = generate(eng.params,
                               counted(eng.prefill_fn, "prefill"),
                               counted(eng.decode_fn, "decode"), state,
                               prompts, n_new)
        toks = toks.cpu().numpy()
        if toks.shape != (SLOTS, n_new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError("tokens missing or outside the vocabulary")
        batches.append((prompts, toks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tracecount.launches()
    want = {stage: {k: 0 for k in launches} for stage in calls}
    for stage, need in zip(("prefill", "decode"), lockstep_launches(cfg)):
        want[stage].update(need)
    check_graph(eng.decode_fn, want["decode"],
                [c["replays"] for c in calls["decode"]])
    if any(c["replays"] != (0, 0) for c in calls["prefill"]):
        raise AssertionError("a prefill replayed the decode graph")
    for stage, log in calls.items():
        bad = [(i, c["launches"]) for i, c in enumerate(log)
               if c["launches"] != want[stage]]
        if bad or not log:
            raise AssertionError(f"{stage} launches {bad[:4]}, want "
                                 f"{want[stage]} on each of {len(log)}")
    n_pre, n_dec = len(calls["prefill"]), len(calls["decode"])
    if any(launches[k] != n_pre * want["prefill"][k]
           + n_dec * want["decode"][k] for k in launches):
        raise AssertionError(f"launches outside prefill and decode: "
                             f"{launches} over {n_pre} prefills and {n_dec} "
                             "steps")
    # the second batch's prefill started afresh: its first tokens are a
    # fresh state's (launches of this check are not counted)
    prompts, toks = batches[-1]
    fresh = init_decode_state(cfg, eng.scfg, device="cuda")
    first, _ = eng.prefill_fn(eng.params["train"], fresh, prompts)
    if not np.array_equal(first.cpu().numpy(), toks[:, 0]):
        raise AssertionError("the second prefill did not start afresh")
    dec = calls["decode"]
    serve = dict(
        batches=len(plan), prefills=n_pre, decode_steps=n_dec,
        replays=tracecount.replays(), tokens=sum(t.size for _, t in batches),
        launches_per_step=sum(want["decode"].values()),
        launches_per_prefill=sum(want["prefill"].values()),
        median_step_ms=round(statistics.median(c["ms"] for c in dec), 3),
        median_host_ms=round(statistics.median(c["host_ms"] for c in dec),
                             3),
        prefill_ms={n: round(c["ms"], 3) for (n, _), c in
                    zip(plan, calls["prefill"])},
        prefill_host_ms={n: round(c["host_ms"], 3) for (n, _), c in
                         zip(plan, calls["prefill"])},
        wall_s=round(wall, 2))
    counts = {stage: ({k: n * len(calls[stage]) for k, n in w.items()}, w)
              for stage, w in want.items()}
    return serve, counts, batches


# ---------------------------------------------------------------------------
# Phase 5: kernels against their plain versions, end to end
# ---------------------------------------------------------------------------
# lockstep paths' forced-decode prompt: RWKV-6 its first batch's, and
# RecurrentGemma its second's (past the ring)
FORCED_PROMPT = {"rwkv6-3b": 128, "recurrentgemma-9b": 2080}


def fill_state(cfg, eng, state, rng):
    """Every slot of ``state`` filled: on an attention path admitted with
    a prompt of 32–512 tokens, on a lockstep path prefilled with one of
    ``FORCED_PROMPT`` tokens (the caches and recurrent states in place)."""
    lens = rng.integers(32, 513, SLOTS).astype(np.int32)
    n_prompt = FORCED_PROMPT.get(cfg.name)
    toks = rng.integers(0, cfg.vocab_size,
                        (SLOTS, max(512, n_prompt or 0))).astype(np.int32)
    if n_prompt:                            # lockstep: one prompt length
        _, state = eng.prefill_fn(eng.params["train"], state,
                                  toks[:, :n_prompt])
    else:
        _, state = eng.admit_fn(eng.params["train"], state, toks, lens)
    return state


def clone_state(state):
    """A copy of every leaf: decode updates the caches and recurrent
    states in place, so a second run needs a state of its own."""
    return {k: (v.clone() if torch.is_tensor(v) else
                {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else [type(c)(*(t.clone() for t in c)) for c in v])
            for k, v in state.items()}


def state_leaves(state):
    """``(name, tensor)`` for every leaf of a decode state."""
    out = []
    for k in sorted(state):
        v = state[k]
        if torch.is_tensor(v):
            out.append((k, v))
        elif isinstance(v, dict):
            out += [(f"{k}.{n}", t) for n, t in sorted(v.items())]
        else:
            out += [(f"{k}[{i}].{f}", t) for i, c in enumerate(v)
                    for f, t in zip(c._fields, c)]
    return out


def time_steps(step, state, forced):
    """``step(state, tokens)`` once per row of ``forced``: the tokens of
    every step, the state after them, and the median step ms (CUDA
    events around each step) and host-issue ms (host clock around the
    call)."""
    toks, ms, host = [], [], []
    for t in range(len(forced)):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        nxt, state = step(state, forced[t])
        host.append(1e3 * (time.perf_counter() - t0))
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        toks.append(nxt)
    return (torch.stack(toks), state, statistics.median(ms),
            statistics.median(host))


def graph_vs_eager(cfg, eng, steps: int = 16):
    """The engine's graphed step against the eager step (``decode_step``
    with ``KERNELS``): the engine's own state refilled and a clone of it,
    ``steps`` steps each from the same forced tokens; tokens equal on
    every step and every state leaf equal bit for bit at the end.  Times
    both (CUDA events around each step; the host clock for its issue)
    and returns the numbers of the line.  Then times the graphed step's
    device work alone: replays queued behind a spin kernel, so the
    host's issue stays out of the window (``graph_device_step_ms``; the
    served step's excess over it is device time spent waiting on the
    host)."""
    rng = np.random.default_rng(SEED + 3)
    state = fill_state(cfg, eng, eng.state, rng)
    twin = clone_state(state)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, SLOTS))
                             .astype(np.int32), device="cuda")
    graph = eng.decode_fn
    replays = graph.replays
    g_toks, state, g_ms, g_host = time_steps(
        lambda st, tok: graph(eng.params["serve"], st, tok), state, forced)
    e_toks, twin, e_ms, e_host = time_steps(
        lambda st, tok: decode_step(cfg, eng.scfg, eng.params["serve"], st,
                                    tok, kernels=KERNELS), twin, forced)
    if graph.replays - replays != steps:
        raise AssertionError(f"{graph.replays - replays} replays for "
                             f"{steps} graphed steps")
    differ = (g_toks != e_toks).any(dim=1).nonzero().flatten().tolist()
    if differ:
        raise AssertionError(f"graphed and eager tokens differ at steps "
                             f"{differ}")
    g_leaves, e_leaves = state_leaves(state), state_leaves(twin)
    if [n for n, _ in g_leaves] != [n for n, _ in e_leaves]:
        raise AssertionError("graphed and eager states have other leaves")
    bad = [n for (n, g), (_, e) in zip(g_leaves, e_leaves)
           if g.dtype != e.dtype or not torch.equal(
               g.contiguous().view(-1).view(torch.uint8),
               e.contiguous().view(-1).view(torch.uint8))]
    if bad:
        raise AssertionError(f"graphed and eager states differ in {bad}")
    if g_host >= 1.0 or g_ms > e_ms:
        raise AssertionError(f"graphed step {g_ms:.3f} ms (host "
                             f"{g_host:.3f} ms) against eager {e_ms:.3f} ms")
    box = [state]

    def replay():
        box[0] = graph(eng.params["serve"], box[0], forced[0])[1]
    dev_ms, covered = cuda_ms(replay, 8)
    return dict(steps=steps, tokens_equal=True, state_equal=True,
                graph_median_step_ms=round(g_ms, 3),
                graph_median_host_ms=round(g_host, 3),
                eager_median_step_ms=round(e_ms, 3),
                eager_median_host_ms=round(e_host, 3),
                eager_over_graph=round(e_ms / g_ms, 3),
                graph_device_step_ms=round(dev_ms, 3),
                device_queued_under_spin=covered)


def forced_decode(cfg, eng, steps: int = 8):
    rng = np.random.default_rng(SEED + 2)
    state = fill_state(cfg, eng,
                       init_decode_state(cfg, eng.scfg, device="cuda"), rng)
    # decode updates the caches and recurrent states in place: the plain
    # run gets a copy of its own
    twin = clone_state(state)
    forced = rng.integers(0, cfg.vocab_size, (steps, SLOTS)).astype(np.int32)

    def run(kernels, st):
        cands, toks = [], []

        def keep(out):
            cands.append(out)
            return out

        # the head's candidates: B3's, or the loose head's top-k
        ks = kernels._replace(head=lambda *a, **k: keep(kernels.head(*a,
                                                                     **k)))
        engine_mod.head_candidates = lambda *a: keep(head_candidates(*a))
        try:
            for t in range(steps):
                nxt, st = decode_step(
                    cfg, eng.scfg, eng.params["serve"], st,
                    torch.as_tensor(forced[t], device="cuda"), kernels=ks)
                toks.append(nxt.cpu().numpy())
        finally:
            engine_mod.head_candidates = head_candidates
        return np.stack(toks), cands, st

    (got, g_cands, _), (want, w_cands, _) = (run(KERNELS, state),
                                             run(PLAIN_KERNELS, twin))
    agree = float(np.mean(got == want))
    # the largest difference of the best candidate's value, f32 logits
    gap = "{:.3e}".format(max(float((g[0][:, 0] - w[0][:, 0]).abs().max())
                              for g, w in zip(g_cands, w_cands)))
    if agree < 0.9:
        raise AssertionError(f"kernel vs plain token agreement {agree}")
    return dict(steps=steps, slots=SLOTS, agreement=round(agree, 4),
                max_logit_gap=gap), got


# ---------------------------------------------------------------------------
# Where a decode step's device time goes (a separate, traced run)
# ---------------------------------------------------------------------------
GROUPS = (("fused_decode", ("fused_decode_kernel",)),
          ("fused_ffn", ("fused_ffn_kernel",)),
          ("fused_head", ("fused_head_kernel",)),
          ("fused_mla_decode", ("fused_mla_decode_kernel",
                                "mla_ckv_kernel")),
          ("rwkv6_scan", ("wkv_scan_kernel", "wkv_step_kernel")),
          ("flash_decode", ("flash_cluster_kernel",)),
          ("rglru_scan", ("rglru_scan_kernel",)))
# the device kernels each port kernel runs at decode, every one once a
# launch (B7's chunked scan runs at prefill only)
DECODE_KERNELS = dict(GROUPS, rwkv6_scan=("wkv_step_kernel",))
MATMUL_NAMES = ("gemm", "gemv", "nvjet", "splitk", "cutlass", "xmma", "cublas")


def profile_steps(cfg, eng, state, per_step, steps: int = 4):
    """Device time per decode step by kernel — the port's kernels by
    name, cuBLAS/CUTLASS products as ``matmul``, everything else (the
    small PyTorch ops) as ``other`` — the device launches per step, and
    the share of the traced window in which no kernel or copy ran, over
    ``steps`` replays of the engine's graph on the engine's own ``state``.
    The profiler's own host cost inflates that idle share; the untraced
    step time is phase 4's.  The port kernels a decode step launches
    (``per_step``: phase 4's count, the capture's) must show exactly
    their device kernels (``DECODE_KERNELS``), each with ``per_step``
    spans a step, and no other port kernel: the replays ran every
    captured launch on the device, and a renamed kernel cannot slip into
    ``other``."""
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok, state = eng.decode_fn(eng.params["serve"], state, tok)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler traced no device event")
    busy, end = 0.0, spans[0][0]
    per = {name: 0.0 for name, _ in GROUPS}
    per["matmul"] = per["other"] = 0.0
    stages = {}                  # each launch of a multi-launch kernel
    n_spans = {}                 # spans of each port device kernel
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        group, key = next(((g, k) for g, keys in GROUPS for k in keys
                           if k in name), ("other", None))
        if group == "other" and any(m in name.lower() for m in MATMUL_NAMES):
            group = "matmul"
        per[group] += t1 - t0
        if key is not None:
            n_spans[key] = n_spans.get(key, 0) + 1
            if len(dict(GROUPS)[group]) > 1:
                stages[key] = stages.get(key, 0.0) + t1 - t0
    window = end - spans[0][0]
    spans_per_step = {k: n / steps for k, n in n_spans.items()}
    want = {k: n for g, n in per_step.items() if n
            for k in DECODE_KERNELS[g]}
    if spans_per_step != want:
        raise AssertionError(f"device spans per step {spans_per_step}, "
                             f"want {want} from phase 4's launches "
                             f"{per_step}")
    out = {f"{g}_ms_per_step": round(v / steps / 1e3, 3)
           for g, v in per.items()}
    out["stage_ms_per_step"] = {k: round(v / steps / 1e3, 3)
                                for k, v in stages.items()}
    out.update(spans_per_step=spans_per_step,
               device_launches_per_step=len(spans) / steps,
               window_ms_per_step=round(window / steps / 1e3, 3),
               idle_share=round(1.0 - busy / window, 4))
    return out


def path_config(arch: str):
    """The path's config: DeepSeek-V2-Lite as its dense-MLA arm (MoE is
    a later slice)."""
    cfg = get_config(arch)
    return dataclasses.replace(cfg, moe=None) if cfg.moe else cfg


def step_weights(cfg, eng):
    """The weights a decode step reads: every layer's attention and FFN
    weights (or the RWKV-6 block's leaves, or every leaf of every
    RecurrentGemma block, its tail included) and the head table — on the
    unfused path the train tree's ``wq``/``wk``/``wv``/``wo`` and the
    ``lm_head`` (tied: ``embed``) the loose head reads."""
    serve = eng.params["serve"]
    blk = serve["blocks"][0]
    table = (serve["head"].table if "head" in serve else
             serve["embed" if cfg.tie_embeddings else "lm_head"])
    if RECURRENT in cfg.block_pattern:
        return tree_bytes(serve["blocks"] + serve["tail"]) \
            + table.numel() * table.element_size()
    if cfg.block_pattern == (RWKV6,):
        block_w = tuple(blk["rwkv"].values())
    elif isinstance(blk["attn"], dict):
        block_w = tuple(blk["attn"].values()) + tuple(
            t for t in blk["ffn"].values() if t is not None)
    else:
        attn = blk["attn"]
        block_w = ((attn.wq, attn.wdkv, attn.wuk, attn.wproj)
                   if cfg.mla is not None else (attn.wqkv, attn.wo)) + tuple(
            t for t in (blk["ffn"].w_in, blk["ffn"].w_gate, blk["ffn"].w_out)
            if t is not None)
    return sum(t.numel() * t.element_size() for t in block_w + (table,))


def build_engine(cfg, backend):
    """The path's engine (its decode step captured in a graph) and its
    ``max_seq``, after emptying the allocator's cache, with the memory
    reserved before it was built."""
    lockstep = cfg.name in LOCKSTEP
    max_seq = LOCKSTEP[cfg.name][0] if lockstep else MAX_SEQ
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    eng = build_engine_full(cfg, max_seq=max_seq, batch_global=SLOTS,
                            options=EngineOptions(backend=backend,
                                                  check_finite=True),
                            device="cuda", seed=SEED)
    torch.cuda.synchronize()
    return eng, max_seq, reserved


def check_released(reserved: int) -> None:
    """After the last engine reference went: its memory, the graph's
    private pool included, is given back (no reference cycle keeps
    it)."""
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - reserved
    if kept > 256 << 20:
        raise AssertionError(f"{kept / 2**30:.2f} GiB still reserved after "
                             "the engine was dropped")


def serve_path(cfg, backend, peers):
    """Phase 4 for one path: build the engine, serve the trace (the
    lockstep paths: their two batches) through its graph, then the graph
    against the eager step.  ``peers`` holds the earlier paths' results
    by (arch, backend); the unfused path's step is compared with the
    fused path's of its arch there.  Returns the path's launch counts
    per stage ("decode", and "prefill" where prefill runs a kernel):
    total and per call, and its median step time."""
    lockstep = cfg.name in LOCKSTEP
    t0 = time.perf_counter()
    eng, max_seq, reserved = build_engine(cfg, backend)
    tag = dict(path=cfg.name, backend=backend)
    say("engine", **tag, layers=cfg.n_layers, max_seq=max_seq,
        build_s=round(time.perf_counter() - t0, 1),
        graph_launches=sum(eng.decode_fn.launches.values()),
        weights_gb=round(tree_bytes(eng.params) / 1e9, 3),
        **{"state_gb" if lockstep else "kv_gb":
           round(tree_bytes(eng.state["layers"] + eng.state["tail"])
                 / 1e9, 3)},
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    if lockstep:
        serve, counts, batches = serve_lockstep(cfg, eng)
        toks = batches[-1][1]
        first = {b: toks[b, :4].tolist() for b in range(3)}
    else:
        serve, launches, per_step, results = serve_trace(cfg, eng)
        counts = {"decode": (launches, per_step)}
        first = {r: res.tokens[:4] for r, res in sorted(results.items())[:3]}
    # the floor of a step: every weight byte read once at the HBM rate
    weight_bytes = step_weights(cfg, eng)
    serve["step_weights_gb"] = round(weight_bytes / 1e9, 3)
    serve["weights_bound_ms"] = round(1e3 * weight_bytes / HBM_BYTES_PER_S, 3)
    say("serve", **tag, **serve)
    say("serve", **tag, first_tokens=first)
    vs_eager = graph_vs_eager(cfg, eng)
    say("graph", **tag, **vs_eager)
    dev_ms = vs_eager["graph_device_step_ms"]
    fused = peers.get((cfg.name, "pallas")) if backend == "xla" else None
    if fused is not None:
        # served steps (host issue inside the window) and device work
        # alone (graph replays queued behind a spin)
        say("serve", path=cfg.name, fused_median_step_ms=fused["step_ms"],
            unfused_median_step_ms=serve["median_step_ms"],
            unfused_over_fused=round(serve["median_step_ms"]
                                     / fused["step_ms"], 4),
            fused_device_step_ms=fused["device_ms"],
            unfused_device_step_ms=dev_ms,
            device_unfused_over_fused=round(dev_ms / fused["device_ms"], 4))
    del eng
    check_released(reserved)
    return counts, dict(step_ms=serve["median_step_ms"], device_ms=dev_ms)


def check_path(cfg, backend, counts, peers):
    """Phase 5 for one path, on an engine built anew: the kernels
    against their plain versions end to end (the unfused path's tokens
    also against the fused path's, from ``peers``), then a trace of
    replays of its graph on its own state, refilled, and the graphed
    host issue timed again after the trace.  Returns the forced
    tokens."""
    eng, _, reserved = build_engine(cfg, backend)
    tag = dict(path=cfg.name, backend=backend)
    forced, forced_toks = forced_decode(cfg, eng)
    fused = peers.get((cfg.name, "pallas")) if backend == "xla" else None
    if fused is not None:
        # the card's counterpart of tests/test_backend_parity.py:241: the
        # same weights and forced tokens through both backends
        agree = float(np.mean(forced_toks == fused["forced"]))
        if agree < 0.9:
            raise AssertionError(f"unfused vs fused token agreement {agree}")
        forced["agreement_with_fused"] = round(agree, 4)
    say("forced", **tag, **forced)
    state = fill_state(cfg, eng, eng.state, np.random.default_rng(SEED + 3))
    prof = profile_steps(cfg, eng, state, counts["decode"][1])
    # the trace leaves the profiler attached to the process, and graph
    # launches cost the host more after it (phase 4 ran before any trace)
    host_ms = time_steps(
        lambda st, t: eng.decode_fn(eng.params["serve"], st, t), state,
        torch.zeros((16, SLOTS), dtype=torch.int32, device="cuda"))[3]
    say("profile", **tag, **prof,
        graph_host_ms_after_trace=round(host_ms, 3))
    del eng, state
    check_released(reserved)
    return forced_toks


def ffn_products(case):
    """B2's three products as plain ``torch.matmul`` calls on the same
    weights — ``h·w_in``, ``h·w_gate``, ``hm·w_out`` in bf16 (cuBLAS), the
    unfused path's way of reading them — for ``products_ms`` beside B2's
    time.  Not one call computing B2's function, so ``library_ms`` stays
    null."""
    a = case["args"]
    h = a["x"]
    hm = torch.empty((h.shape[0], a["w_in"].shape[1]), dtype=h.dtype,
                     device=h.device).normal_()

    def run():
        torch.matmul(h, a["w_in"])
        if a["w_gate"] is not None:
            torch.matmul(h, a["w_gate"])
        torch.matmul(hm, a["w_out"])
    return run


def head_products(case):
    """B3's logits as one plain ``torch.matmul(h, table.T)`` in bf16
    (cuBLAS) on the same table — a yardstick of the rate at which the
    table can be read, for ``products_ms`` beside B3's time.  Not B3's
    function (no norm, no f32 logits, no top-k), so ``library_ms`` stays
    null."""
    h, table = case["args"]["x"], case["args"]["table"]
    return lambda: torch.matmul(h, table.T)


def library_call(case):
    """One PyTorch call computing B5's per-slot function on the same
    inputs, for ``library_ms``: ``F.scaled_dot_product_attention`` with
    q ``[B, H, 1, hd]``, the cache columns as ``[B, kv, S, hd]`` views
    (permuted, not copied) and a boolean mask ``[B, 1, 1, S]`` of each
    slot's valid rows, made outside the call."""
    a = case["args"]
    q, k, v, lens = a["q"], a["k_cache"], a["v_cache"], a["cache_len"]
    S = k.shape[0]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4, k4, v4 = q.unsqueeze(2), k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)
    gqa = {"enable_gqa": True} if q.shape[1] != k.shape[2] else {}
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  **gqa)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = [(path_config(arch), backend) for arch, backend in PATHS]

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)))

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()          # full logs: build/kernels/*.log
    say("build", seconds=round(time.perf_counter() - t0, 1),
        built=",".join(logs) or "none")
    for name, log in logs.items():
        # per source: the most registers an instance uses, and any spill
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and "0 bytes spill stores" not in ln})
        print(f"  {name}: {len(regs)} kernel instances, at most "
              f"{max(regs, default=0)} registers; spills: "
              f"{'; '.join(spills) or 'none'}")

    # 3. each kernel against its plain version at each path's shapes
    cases = [case for cfg, backend in paths
             for case in kernel_cases(cfg, backend)]
    for case in cases:
        case.setdefault("stage", "decode")
        case["max_abs_err"] = check_kernel(case)
        say("kernel", name=case["name"], path=case["path"],
            backend=case["backend"], stage=case["stage"], ok=True,
            max_abs_err=f"{case['max_abs_err']:.3e}")
        if case.get("check_only"):
            del case["args"]                # no phase 6 row

    # the host's cost of a graph launch before any profiler trace (a
    # trace leaves the host's graph launches slower for the rest of the
    # process); timed again in phase 6
    floor_graph = empty_graph(FLOOR_NODES)
    host_untraced = launch_host_ms(floor_graph)
    # 4. each path served at full width through its graph, one engine at
    # a time, before any profiler trace
    counts, peers = {}, {}
    for cfg, backend in paths:
        key = (cfg.name, backend)
        counts[key], peers[key] = serve_path(cfg, backend, peers)
    # 5. each path again: kernels against plain versions end to end, and
    # the traced replays
    for cfg, backend in paths:
        key = (cfg.name, backend)
        peers[key]["forced"] = check_path(cfg, backend, counts[key], peers)

    # 6. the launch floor: an empty kernel in the kernels' harness, issued
    # one launch at a time and as the nodes of one graph
    floor_ms, floor_covered = cuda_ms(lambda: torch.cuda._sleep(0), 100)
    node_ms = cuda_ms(floor_graph.replay, 1)[0] / FLOOR_NODES
    say("floor", kernel="torch.cuda._sleep(0)",
        empty_launch_ms=round(floor_ms, 5), graph_node_ms=round(node_ms, 5),
        queued_under_spin=floor_covered, graph_nodes=FLOOR_NODES,
        graph_launch_host_ms=round(host_untraced, 4),
        graph_launch_host_ms_after_trace=round(
            launch_host_ms(floor_graph), 4))
    del floor_graph
    # times beside the bounds (the check-only shapes run on no path)
    rows = []
    for case in cases:
        if case.get("check_only"):
            continue
        args, kw = case["args"], case["kw"]
        launches, per_step = counts[case["path"], case["backend"]][
            case["stage"]]
        library_ms, extra = None, {}
        if case["name"] == "flash_decode":
            lib = library_call(case)
            # the library call computes the same function: live slots
            # agree with the kernel (its length-0 rows are NaN)
            live = args["cache_len"] > 0
            close_bf16("sdpa", lib()[:, :, 0][live],
                       case["fn"](**args, **kw)[live])
            library_ms = round(cuda_ms(lib, 20)[0], 4)
            extra = dict(library="F.scaled_dot_product_attention on the "
                         "cache as permuted views, no copy outside the "
                         "call")
        if case["name"] in ("fused_ffn", "fused_head"):
            products = (ffn_products if case["name"] == "fused_ffn"
                        else head_products)(case)
            extra = dict(products_ms=round(cuda_ms(products, 20)[0], 4))
        ms, covered = cuda_ms(lambda: case["fn"](**args, **kw), 20)
        # the plain versions may sync with the host: their time is
        # whatever the device waits, host gaps included
        plain_ms, _ = cuda_ms(lambda: case["plain"](*args.values(), **kw), 5)
        one_call = call_ms(lambda: case["fn"](**args, **kw), 20)
        bound_ms, bound_by = bound(*case["cost"],
                                   case.get("rate", BF16_FLOPS))
        rows.append(dict(
            name=case["name"], path=case["path"], backend=case["backend"],
            stage=case["stage"], route="cuda",
            source=f"src/repro_torch/csrc/{case['name']}.cu",
            replaces=case["replaces"], launches=launches[case["name"]],
            launches_per_step=per_step[case["name"]],
            max_abs_err=case["max_abs_err"], ms=round(ms, 4),
            plain_ms=round(plain_ms, 4), bound_ms=round(bound_ms, 4),
            bound_by=bound_by, library_ms=library_ms,
            bound_under_floor=bound_ms < floor_ms,
            call_ms=round(one_call, 4),
            queued_under_spin=covered, **extra))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
