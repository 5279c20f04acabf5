#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It drives eighteen serving paths, each at full width and depth with
seeded random bf16 weights and 8 slots.  Three run the fused ``backend="pallas"``
kernels: Llama2-7B (32 layers; kernels B1 ``fused_decode``, B2
``fused_ffn``, B3 ``fused_head``) and the dense-MLA arm of
DeepSeek-V2-Lite (27 layers, ``moe=None``; kernels B4
``fused_mla_decode``, B2, B3), both ragged with ``max_seq`` 1024, and
RWKV-6 3B (32 layers, attention-free; kernels B7 ``rwkv6_scan`` at
prefill and at every decode step, B3), served lockstep.  The fourth is
Llama2-7B again, on the same weights, through the unfused
``backend="xla"`` dataflow (the paper's baseline: plain torch products,
RoPE, append and head around B5 ``flash_decode``), so the fused and the
unfused step are timed in one call.  The fifth and sixth are
RecurrentGemma-9B (38 layers: 26 RG-LRU and 12 local-attention with MQA
16/1 of head dim 256, tied embeddings), served lockstep with ``max_seq``
4096 on both backends: B6 ``rglru_scan`` runs every RG-LRU recurrence at
prefill and at every decode step; on ``"pallas"`` (what ``"auto"``
resolves to) every local layer's decode is B1's MQA 16/1 mode over its
2048-row ring cache and B2, and the head B3 on ``embed`` (51 launches a
step); on ``"xla"`` (the default ``EngineOptions()``) every local
layer's decode is B5 over the ring and the head the loose one.  The
next four are the GQA dense models, each on
both backends like Llama2-7B: Granite-8B (36 layers, 32/8 heads, tied
embeddings: B3 reads ``embed`` itself) and Minitron-4B (32 layers,
24/8 heads, an ungated squared-ReLU FFN: B2's ungated ``relu2``
instance), through B1's GQA mode, B2 and B3 on ``"pallas"`` and B5 on
``"xla"``.  The last two are DeepSeek-V2-Lite as the reference registers
it (path ``deepseek-v2-lite-moe``: 27 layers, each MLA attention and a
64-expert top-6 MoE FFN of expert width 1408 at capacity factor 1.25),
served lockstep (the scheduler refuses MoE, as the reference's does) on
``"pallas"`` (B4, the experts in torch and cuBLAS, B3) and on ``"xla"``
(the unfused MLA attention, the same experts, the loose head: no kernel
of the port's).  The last two are Gemma-2 27B (46 layers, local and
global attention in turn, 32/16 heads, window 4096, attention softcap
50, logit softcap 30, post-norms, tied embeddings; ``max_seq`` 4608, so
the local layers hold 4096-row rings and the global ones 4608-row
caches) on ``"pallas"`` (B1's window, ring and softcap modes at 2 query
heads a KV head, B2 with ``post_ln1``, B3 with the logit softcap) and
``"xla"`` (B5 with the softcap on the rings).  The last four are the
modality models, lockstep with seeded random frontend embeddings
``[8, num_positions, feature_dim]`` (``frontend_embeds``):
SeamlessM4T-medium (12 decoder layers of MHA 16/16 at head dim 64 over
a 12-layer encoder of 1024 frames, vocabulary 256206) on ``"pallas"``
(B1's MHA mode at head dim 64; the cross-attention and the FFN in torch
and cuBLAS, as the reference keeps them outside its kernels; B3: 13
launches a step) and ``"xla"`` (B5: 12), and InternVL2-2B (24 layers,
GQA 16/8, 256 patch embeddings spliced into prompts of 320 and 768
tokens, vocabulary 92553) on ``"pallas"`` (B1, B2 at 2048 × 8192, B3:
49) and ``"xla"`` (B5: 24).  It builds the
hand-written kernels from
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
   the engine does); B1's MQA 16/1 mode at ``head_dim`` 256 on wrapped
   2048-row rings (a free slot, a short slot, slots below, at and past
   the wrap and past the second: ``RGEMMA_LENS``), B2 at 4096 × 12288
   ``gelu_tanh`` (and check-only with 5 slots), B3 on the tied
   256000-row table; B5 at RecurrentGemma's shape, q ``[8, 16, 256]``
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
   and 24/8 (the MoE path's B4 and B3 run at the dense arm's shapes);
   at Gemma-2's widths B1 on wrapped 4096-row rings (stale rows, a free
   slot, the row the append will overwrite still holding an
   out-of-window position) with the window and the softcap, and
   check-only on a global layer's 4608-row cache, B2 at 4608 × 36864
   with ``post_ln1`` (and check-only with 5 slots), B3 at 256000 rows
   with the logit softcap (two of slot 2's logits the cap makes equal:
   the lower index must win), B5 at 32/16 on the ring with the softcap
   (check-only on the global cache); at SeamlessM4T's widths B1's MHA
   mode at head dim 64 (and check-only at lengths on its 4 ranks' run
   and 128-row tile edges, ``HD64_EDGE_LENS``), B3 at 256206 rows and B5
   at 16/16 of 64; at InternVL2's B1 at 16/8, B2 at 2048 × 8192 gated
   ``silu`` (and check-only with 5 slots), B3 at 92553 rows and B5 at
   16/8 — both vocabularies no multiple of 16 rows, each head case with
   a best row planted in the last, partial unit;
   check-only, the unfused paths' loose head
   (``models/layers.py:lm_head_logits``, no kernel of its own) on a
   random table of each path's shape (32000, 49152, 102400 and 256000
   rows),
   its top-8 against the f64 sum to exact indices and values within 4
   f32 ulps, its peak allocation under a quarter of an f32 copy of the
   table; the cluster kernels (B1, B2, B3, B4,
   B5) and B7 launched twice on the same inputs give the same bits (their
   ranks' and clusters' partials merge in a fixed order; B3's merges
   select without arithmetic); check-only, a cluster across devices (the
   KV sequence over the ranks of a cluster, ROADMAP A.5b): B1 on each
   rank's 512-row shard of a 1024-row cache (``pos_base`` 0 and 512,
   the new token on its owner rank only, ``CLUSTER_LENS``: slots whose
   rank holds none of their rows) at one rank's heads on 16 GPUs at a
   cluster of 2 (``CLUSTER_RANKS``: Qwen2-72B's 8/1 with ``bqkv`` at
   ``D`` 8192, Granite-8B's 4/1, Minitron-4B's 3/1), Gemma-2's local
   layer at an explicit cluster of 2 (each rank's 2048-slot ring shard,
   ``pos_base`` −1, window and cap), B4 at DeepSeek-V2-Lite's widths
   with 8 heads a rank (4 GPUs, cluster 2) on shards at ``pos_base`` 0
   and 512, and B5's rank-local mode (stored-pos mask, the f32 partial
   ``(o, m, l)``: each (slot, head) to ``FLASH_F32_REL_TOL``, empty
   partials exactly ``(−1e30, 0, 0)``) at Llama2-7B's and Gemma-2's
   unfused shapes;
3b. the shard merge (``[shard_merge]`` lines): B1 at Llama2-7B's full
   width and B4 at DeepSeek-V2-Lite's, each launched on the ``n``
   shards of one cache for ``n`` = 2 and 4 and the ranks' ``(m, l, o)``
   merged with ``core/primitives.py:flash_merge`` in this one process,
   against one launch over the whole cache: ``o / l`` and ``m`` of every
   live slot within ``MERGE_REL_TOL`` of each (slot, head)'s largest
   element — the identity that makes a cluster across devices right;
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
   RecurrentGemma-9B runs the same two-batch loop on each backend
   (prompts of 128 then 2080 tokens, 32 new tokens each: the 2048-row
   rings wrap during the second prefill and stay wrapped) and checks 26
   B6 launches and nothing else per prefill, and per decode step 26 B6
   and 12 B5 on ``"xla"``, 26 B6, 12 B1, 12 B2 and one B3 on
   ``"pallas"``, and nothing else, and prints the 2080-token prefill's
   time; MoE DeepSeek-V2-Lite runs the
   RWKV-6 loop (prompts of 128 then 512 tokens, 32 then 64 new tokens)
   and checks no launch per prefill, 27 B4 and one B3 (and no B2) per
   decode step on ``"pallas"`` and no launch at all on ``"xla"``; the
   modality models run it too (SeamlessM4T 128 + 32 and 512 + 64
   tokens, InternVL2 320 + 32 and 768 + 64) with their frontend
   embeddings passed to every prefill, no launch per prefill, and per
   decode step 12 B1 and one B3 or 12 B5 (SeamlessM4T), 24 B1, 24 B2
   and one B3 or 24 B5 (InternVL2), and nothing else; SeamlessM4T's
   prefill writes the encoder's k/v into the state the graph reads;
   Gemma-2 serves the 12-request trace with two long requests
   (``LONG_REQUESTS``: a 4200-token prompt, whose prefill wraps the
   rings, and a 4080-token one that wraps them in decode), each checked
   to have been admitted while another request was live;
   prefills stay eager (no replay).  Then it holds the graph against the eager step: the
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
   as served and as device work alone; a ``memory`` line gives the
   engine's weights and caches beside the most the card held over the
   path (where a second state does not fit on the card, as Gemma-2's
   13.1 GB of caches beside its 54.5 GB of weights, the clone lives in
   host memory and is copied back into the engine's own tensors for the
   second run; phase 5 likewise);
5. after every path's phase 4 (a profiler trace leaves the host's
   graph launches slower for the rest of the process), per path on an
   engine built anew, runs teacher-forced decode steps once through the
   kernels and once through their plain versions (RecurrentGemma after
   a 2080-token prefill), and requires their greedy tokens to agree on at
   least 90 % of (step, slot) — each unfused path's tokens also against
   its fused path's; then traces a few replays of the engine's
   graph on its own state with ``torch.profiler`` (after one replay as
   the profiler's warm-up, finished before the window opens) for the
   device time
   per kernel and the device's idle share, and requires exactly the
   device kernels that the step's port kernels run at decode
   (``DECODE_KERNELS``: both of B4's, B7's ``wkv_step_kernel``, one each
   of the others) to show, each as many spans a step as phase 4's
   capture counted launches, then times the graphed host issue again
   (``graph_host_ms_after_trace``); dropping an engine, in either
   phase, must give back its memory, the graph's pool included;
   between phases 4 and 5, before any profiler trace (a trace leaves
   every later graph launch slower on the host, and the fleet holds its
   graphed step to phase 5's 1 ms of host issue), the fleet
   (``fleet_phase``, ``[fleet]`` lines): two
   ``build_replicas`` replicas of Llama2-7B at full width and depth on
   ``"pallas"`` (65 launches a step) with every probe's leaves, behind
   the router (``serving/router.py``), serving the 12-request trace
   with half its requests sampled at temperature 0.8: the threefry words
   and Gumbel values on the card equal to the CPU's on a grid of seeds
   and offsets; the step with the fleet's leaves off and on; a
   probes-off run (one replay a decode step, the kernels' launches) and
   a run with every probe (``IntegrityConfig()``) that must fire no
   signal and give the same streams, with each probe's ms and bytes a
   tick and ``commit_lag``; each of the nine fault kinds injected into
   replica 0 at tick ``FLEET_FAULT_TICK`` (``flip_weight_bit`` at bits
   0 and 14) must fire its probe (the KV kinds within one tick, a weight
   flip within the commit window), leave every journaled stream equal to
   the probes-off run's, move a sampled request to replica 1 on a kill,
   and heal, re-verify and serve again on a weight flip (heal ms); the
   single-bit sub-sweep must detect every fault with exact streams; the
   graphed step must equal the eager one bit for bit at temperature 0.8
   with every leaf; and teacher-forced sampled tokens, kernels against
   plain and unfused against fused on replica 0's weights, must differ
   only by near-ties: both runs' candidate lists sorted, their values
   within ``CAND_TOL``, and equal tokens wherever the lists are equal
   (the overall agreement is printed and gates nothing: the noise goes
   by candidate rank, ROADMAP C14);
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
   with a per-slot mask on the same cache (with the softcap, Gemma-2's,
   that call is not the same function: ``library_ms`` null and its time
   as ``library_nocap_ms``; no PyTorch call computes B6's recurrence:
   its ``library_ms`` is null); B2's rows carry
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
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.primitives import flash_merge  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    build_engine_full, build_replicas, generate)
from repro_torch.models.layers import lm_head_logits  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    KERNELS, PLAIN_KERNELS, EngineOptions, decode_step,
    init_decode_state)
from repro_torch.serving.faults import (  # noqa: E402
    FAULT_KINDS, FaultInjector, FaultSpec, FaultSweep)
from repro_torch.serving.integrity import IntegrityConfig  # noqa: E402
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.sampling import (  # noqa: E402
    CAND_K, GREEDY, SamplingParams, fill_sampling_row, head_candidates,
    host_sampling_rows)
from repro_torch.serving.scheduler import (  # noqa: E402
    Request, SlotScheduler, replay_trace)
from repro_torch.serving.sweep import (  # noqa: E402
    format_coverage, run_sdc_sweep)
from repro_torch.serving.step_graph import StepGraph  # noqa: E402

# (path, backend): a path is an arch, or DeepSeek-V2-Lite with its MoE
# layers (``MOE_PATH``); plain "deepseek-v2-lite" is its dense-MLA arm
MOE_PATH = "deepseek-v2-lite-moe"
PATHS = (("llama2-7b", "pallas"),
         ("deepseek-v2-lite", "pallas"),   # its dense-MLA arm
         ("rwkv6-3b", "pallas"),
         ("llama2-7b", "xla"),             # the unfused baseline
         ("recurrentgemma-9b", "pallas"),  # MQA 16/1 of 256 on rings
         ("recurrentgemma-9b", "xla"),
         ("granite-8b", "pallas"),         # GQA 32/8, tied embeddings
         ("granite-8b", "xla"),
         ("minitron-4b", "pallas"),        # GQA 24/8, ungated relu2 FFN
         ("minitron-4b", "xla"),
         (MOE_PATH, "pallas"),             # as registered: 64 experts
         (MOE_PATH, "xla"),                # and its unfused MLA
         ("gemma2-27b", "pallas"),         # 32/16, rings, softcaps,
         ("gemma2-27b", "xla"),            # post-norms, tied
         ("seamless-m4t-medium", "pallas"),  # encoder-decoder, MHA of 64
         ("seamless-m4t-medium", "xla"),
         ("internvl2-2b", "pallas"),       # patch embeddings spliced in,
         ("internvl2-2b", "xla"),          # GQA 16/8, vocabulary 92553
         ("qwen2-72b", "pallas"),          # GQA 64/8 with q/k/v biases at
         ("qwen2-72b", "xla"))             # d_model 8192, 32 of 80 layers
GEMMA = "gemma2-27b"
RGEMMA = "recurrentgemma-9b"
SEAMLESS = "seamless-m4t-medium"
INTERNVL = "internvl2-2b"
QWEN = "qwen2-72b"
# paths whose depth is cut: Qwen2-72B's 80 layers hold about 145 GB of
# bf16 weights; 32 of them (56.2 GB, with 5.0 GB of tables and 1.1 GB of
# caches) fit the card's 80 GB at full width
PATH_LAYERS = {QWEN: 32}
# the per-rank shapes of Qwen2-72B on a model axis of 4 and 8 GPUs (the
# head-parallel layout, launch/specs.py): query and kv heads, d_ff and
# vocabulary rows a rank, held on this card check-only
QWEN_RANKS = ((4, 16, 2, 7392, 38016), (8, 8, 1, 3696, 19008))
SLOTS = 8
MAX_SEQ = 1024
SEED = 0
# trace paths whose max_seq is not MAX_SEQ: Gemma-2's local layers then
# hold 4096-row rings (its window) that its trace wraps, and its global
# layers 4608-row linear caches
TRACE_MAX_SEQ = {GEMMA: 4608}
# lockstep paths: max_seq and the (prompt, new tokens) of each batch; the
# second RecurrentGemma prompt wraps the 2048-row rings during prefill;
# MoE serves lockstep (the scheduler refuses it, as the reference's does)
LOCKSTEP = {"rwkv6-3b": (MAX_SEQ, ((128, 32), (512, 64))),
            RGEMMA: (4096, ((128, 32), (2080, 32))),
            MOE_PATH: (MAX_SEQ, ((128, 32), (512, 64))),
            # the modality models serve lockstep (the scheduler refuses
            # them, as the reference's does); InternVL2's prompts hold its
            # 256 patch positions
            SEAMLESS: (MAX_SEQ, ((128, 32), (512, 64))),
            INTERNVL: (MAX_SEQ, ((320, 32), (768, 64)))}
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
CAND_TOL = 0.125               # one head candidate's f32 logit in two
                               # forced runs (kernels and plain, or the
                               # two backends) from the same bf16 state:
                               # 32 layers of bf16 rounding in another
                               # order; on Llama2-7B (H100) any
                               # candidate moved by 0.054 at most
FLOOR_NODES = 2600             # about RWKV-6's device launches a step
SPIN_CYCLES = 50_000_000       # ≈ 25 ms at the H100's clock: longer than
                               # the host needs to queue a timed batch


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def randn(gen, shape, scale, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def frontend_embeds(cfg, seed: int = SEED):
    """A modality model's stub frontend output for the ``SLOTS`` slots,
    ``[SLOTS, num_positions, feature_dim]`` bf16 N(0, 1) from ``seed``
    (the reference's ``launch/serve.py:389`` draws them likewise); None
    for a text model."""
    if cfg.frontend is None:
        return None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f = cfg.frontend
    return randn(gen, (SLOTS, f.num_positions, f.feature_dim), 1.0)


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
# B1 at head dim 64 (SeamlessM4T-medium's 4 ranks, 128-row tiles): 3200
# live rows cut into runs of 800 that start and end inside slots, and
# lengths on 128-row tile edges ± 1
HD64_EDGE_LENS = [127, 128, 129, 383, 384, 385, 641, MAX_SEQ - 1]


def shard_of(pos, lens, n: int, r: int, ring: bool):
    """Rank ``r`` of a cluster of ``n`` ranks across devices: its rows of
    the whole cache's ``pos`` (``S / n`` rows from ``r·S / n``),
    ``include_new`` on the owner of each slot's append only (the
    reference's ``_append_slot``: row ``cache_len``, or ring slot
    ``cache_len mod S``) and its ``pos_base`` (``r·S / n``; −1 on a
    ring)."""
    S = pos.shape[0]
    s_sh = S // n
    slot = torch.remainder(lens, S) if ring else lens
    owner = ((torch.div(slot, s_sh, rounding_mode="floor") == r)
             & (lens >= 0)).to(torch.int32)
    return (pos[r * s_sh:(r + 1) * s_sh].contiguous(), owner,
            -1 if ring else r * s_sh)


def shard_live(pos, lens, pos_base, window=0, newest=False):
    """The rows a rank's shard holds for its slots' attention: stored
    positions in ``[0, cache_len)`` (``newest``: up to ``cache_len``) and
    the window, within the rank-local span."""
    cl = lens[None, :]
    valid = (pos >= 0) & ((pos <= cl) if newest else (pos < cl))
    if window:
        valid &= pos > cl - window
    span = torch.clamp(lens + int(newest) - max(pos_base, 0), 0,
                       pos.shape[0])
    return valid & (torch.arange(pos.shape[0], device=pos.device)[:, None]
                    < span[None, :])


def gqa_case(cfg, gen, lens=None, *, S=MAX_SEQ, ring=False,
             check_only=None, heads=None, shard=None, ring_rows=None):
    """B1 at ``cfg``'s widths with its attention softcap and, on a model
    with q/k/v biases, a seeded ``bqkv``, on a linear cache of ``S`` rows
    — or, with ``ring``, as Gemma-2's local layers call it: on their ring
    of ``window`` rows (``ring_positions``) with the window.  With
    ``lens``, a check-only case (no path runs those lengths, so it has no
    phase 6 row) unless ``check_only`` is False; with ``heads``
    ``(mesh size, query heads, kv heads)`` a check-only case at one
    rank's heads of that mesh; with ``shard`` ``(n, r)``, rank ``r``'s
    shard of the cache on a cluster of ``n`` across devices
    (:func:`shard_of`: ``pos_base``, the owner's ``include_new``);
    ``ring_rows``: a ring of that many rows (``min(window, max_seq)``
    below the window), the window still masking."""
    B, D = SLOTS, cfg.d_model
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if heads is not None:
        nq, nkv = heads[1:]
    P = (nq + 2 * nkv) * hd
    window = cfg.sliding_window if ring else 0
    check_only = lens is not None if check_only is None else check_only
    if ring:
        S = ring_rows or window
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        pos = ring_positions(S, lens)
    else:
        lens, pos, _ = decode_lens(S, lens)
    include_new, pos_base = (lens >= 0).to(torch.int32), 0
    if shard is not None:
        pos, include_new, pos_base = shard_of(pos, lens, *shard, ring)
        S = pos.shape[0]
    live = int(shard_live(pos, lens, pos_base, window).sum())
    cos, sin = rope_at(lens, hd, cfg.rope_theta)
    dec = dict(
        x=randn(gen, (B, D), 1.0),
        wqkv=randn(gen, (D, P), D ** -0.5),
        wo=randn(gen, (nq, hd, D), (nq * hd) ** -0.5),
        norm_scale=randn(gen, (D,), 0.1, torch.float32),
        k_cache=randn(gen, (S, B * nkv, hd), 1.0),
        v_cache=randn(gen, (S, B * nkv, hd), 1.0),
        pos=pos, cache_lens=lens, include_new=include_new,
        cos=cos, sin=sin)
    dec_bytes = (B * D * 2 + D * P * 2 + nq * hd * D * 2 + D * 4
                 + 2 * live * nkv * hd * 2 + live * 4 + B * 4 * (2 + hd)
                 + B * nq * D * 4 + 2 * B * nkv * hd * 2 + 2 * B * nq * 4)
    dec_ops = 2 * B * D * P + 4 * live * nq * hd + 4 * B * nq * hd \
        + 2 * B * nq * hd * D
    kw = dict(q_heads=nq, kv_heads=nkv, scale=hd ** -0.5,
              norm_eps=cfg.norm_eps, window=window,
              attn_softcap=cfg.attn_softcap)
    if shard is not None:
        kw["pos_base"] = pos_base
    if cfg.qkv_bias:
        kw["bqkv"] = randn(gen, (P,), 0.5)
        dec_bytes += P * 2
    case = dict(name="fused_decode", fn=fused_decode_attention,
                plain=fused_decode_plain, args=dec, kw=kw,
                cost=(dec_bytes, dec_ops),
                replaces="src/repro/kernels/fused_decode/fused_decode.py:276")
    if shard is not None:
        case.update(check_only=True, stage=(
            f"cluster {shard[0]} rank {shard[1]}"
            + (f" of {heads[0]} GPUs" if heads else "")
            + f": {nq}/{nkv} heads, {S} rows, pos_base {pos_base}, "
              f"lengths {lens.tolist()}"))
    elif heads is not None:
        case.update(check_only=True, stage=f"a rank of {heads[0]} GPUs: "
                    f"{nq}/{nkv} heads")
    elif check_only:
        case.update(check_only=True,
                    stage=f"rank-split edge lengths {lens.tolist()}"
                    if S == MAX_SEQ else f"global layer, {S} rows, "
                    f"lengths {lens.tolist()}")
    return case


# Gemma-2's B1 and B5 cache lengths: a free slot, 0, short slots, and
# slots below, at and past the 4096-row ring's wrap (row cache_len mod S
# then still holds cache_len − S, outside the window) and past its second
GEMMA_LENS = [-1, 0, 37, 513, 4095, 4096, 4097, 8200]
# on the 4608-row global layers: the last row, and no wrap
GLOBAL_LENS = [-1, 0, 37, 513, 4095, 4096, 4097, 4607]
# RecurrentGemma's B1 cache lengths on its 2048-row rings: a free slot, a
# short slot, and slots below, at and past the wrap (row cache_len mod S
# then still holds cache_len − S, outside the window), past the second
# wrap, and two at the served batch's lengths (2080 + 32 tokens)
RGEMMA_LENS = [-1, 37, 2047, 2048, 2049, 2080, 2111, 4100]


def ring_positions(S: int, lens: torch.Tensor) -> torch.Tensor:
    """``pos [S, B]`` of ring caches of ``S`` rows holding ``lens``
    positions (row r: the largest p < len with p ≡ r mod S, else −1, as
    prefill's ring fill and in-order appends leave it); a slot that has
    not wrapped also holds 40 stale rows past its length (positions from
    a longer earlier occupant), and a free slot (−1) those of a 5000-token
    one."""
    r = torch.arange(S, dtype=torch.int32, device="cuda")[:, None]
    n = torch.where(lens < 0, 5000, lens)[None, :]
    p = r + (n - 1 - r).clamp(min=0) // S * S
    pos = torch.where(r < n, p, -1)
    stale = (r >= n) & (r < n + 40)
    return torch.where(stale, r, pos).to(torch.int32)


# B4 at lengths whose live rows, laid end to end (768), cut into the 8
# ranks' runs of 96 rows at a slot's edge, one row inside a slot, or in
# the middle of a long slot, with 32-row tiles that stop at slot edges
B4_EDGE_LENS = [95, 97, 96, 96, 24, 168, 1, 191]


def mla_case(cfg, gen, lens=None, heads=None, shard=None):
    """B4 at ``cfg``'s widths; with ``lens`` a check-only case (no path
    runs those lengths, so it has no phase 6 row); with ``heads``
    ``(mesh size, heads)`` a check-only case at one rank's heads of that
    mesh; with ``shard`` ``(n, r)`` rank ``r``'s shard of the latent
    cache on a cluster of ``n`` across devices (:func:`shard_of`)."""
    B, D, S = SLOTS, cfg.d_model, MAX_SEQ
    m = cfg.mla
    nq, nope, rope, lat = (heads[1] if heads else cfg.n_heads,
                           m.nope_head_dim, m.rope_head_dim, m.kv_lora_rank)
    lr, Pq = lat + rope, nq * (nope + rope)
    edge = lens is not None
    lens, pos, live = decode_lens(S, lens)
    include_new = ((lens >= 0) & (lens < S)).to(torch.int32)
    if shard is not None:
        pos, include_new, pos_base = shard_of(pos, lens, *shard, False)
        S = pos.shape[0]
        live = int(shard_live(pos, lens, pos_base).sum())
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
        pos=pos, cache_lens=lens, include_new=include_new,
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
    if heads:
        case.update(check_only=True,
                    stage=f"a rank of {heads[0]} GPUs: {nq} heads")
    if shard is not None:
        case["kw"]["pos_base"] = pos_base
        case.update(check_only=True, stage=(
            f"cluster {shard[0]} rank {shard[1]}"
            + (f" of {heads[0]} GPUs" if heads else "")
            + f": {nq} heads, {S} rows, pos_base {pos_base}, "
              f"lengths {lens.tolist()}"))
    return case


def wkv_case(cfg, gen, S: int, check_only: bool = False, heads=None):
    """B7 at ``[SLOTS, S, H, hd]`` with the model path's scales: r, k, v
    the projections of a normed row (≈ N(0, 1)), w the decay
    exp(−exp(−0.5 + δ)), u ≈ 0.1, and a random ``s0`` (a state after a
    prompt) beside the zero one prefill starts from; ``check_only`` at a
    length no path runs (no phase 6 row); ``heads``: a mesh rank's."""
    B, hd = SLOTS, cfg.rwkv_head_dim
    H = heads or cfg.d_model // hd
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


def rglru_case(cfg, gen, S: int, channels=None):
    """B6 at ``[SLOTS, S, C]`` with the model path's scales: ``log_a =
    −8·softplus(Λ)·r`` (Λ as the init lays it out over the channels, r
    a sigmoid gate), ``b = √(1 − a²)·i·u`` (i a sigmoid gate, u ≈ N(0,
    1)), and a random ``h0`` (a state after a prompt) beside the zero
    one prefill starts from; ``channels``: rank 0's of a mesh (a
    check-only case)."""
    B, C = SLOTS, cfg.rglru_d_state or cfg.d_model
    f32 = torch.float32
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, C, device="cuda")) * 2.0 / 8.0))
    C = channels or C
    lam = lam[:C]
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
    case = dict(name="rglru_scan", fn=rglru_scan, plain=rglru_scan_plain,
                args=args, kw={}, h0s=h0s, rate=F32_FLOPS,
                stage="prefill" if S > 1 else "decode",
                cost=(n_bytes, n_ops),
                replaces="src/repro/kernels/rglru_scan/rglru_scan.py:50")
    if channels:
        case.update(check_only=True, stage=f"{case['stage']} S {S}, "
                    f"{C} channels a rank")
    return case


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
               window=0, cap=0.0, dtype=torch.bfloat16, S=MAX_SEQ,
               lens=None, check_only=None):
    """B5 in the engine's per-slot form: ``q [8, q, hd]`` against a cache
    ``[S, 8, kv, hd]`` at ``lens`` (default: the phase 3 lengths clamped
    to 0; each slot's rows past its length are stale and must be
    masked).  Default: the unfused Llama path's shape in bf16; with other
    heads, a window, a softcap or f32 a check-only shape unless
    ``check_only`` is False (no path runs it, so it has no phase 6 row):
    B5's block-wide CUDA-core path (5-15 query rows a kv head, or f32)
    runs only there."""
    B, hd = SLOTS, cfg.resolved_head_dim
    nq, nkv = q_heads or cfg.n_heads, kv_heads or cfg.n_kv_heads
    lens = (decode_lens(S)[0].clamp(min=0) if lens is None else
            torch.tensor(lens, dtype=torch.int32, device="cuda"))
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
    if check_only is None:
        check_only = bool(window or cap or q_heads or dtype != torch.bfloat16)
    if check_only:
        case.update(check_only=True, stage=f"gqa {nq}/{nkv} window "
                    f"{window} softcap {cap:g} {str(dtype)[6:]}"
                    + (f", {S} rows" if S != MAX_SEQ else ""))
    return case


# A cluster across devices (ROADMAP A.5b): each rank holds S / n rows of
# every cache.  Cache lengths on 1024 positions split at 512: a free slot,
# slots whose positions all lie on rank 0 (rank 1 holds none of their rows
# and does not own their token: 37, 300, 511), 512 (rank 1 owns the new
# token and holds no row), and slots on both ranks
CLUSTER_LENS = [-1, 0, 37, 300, 511, 512, 513, 1000]
# one rank's query/kv heads on a model axis of 16 at the reference's
# pick of a cluster of 2 (launch/specs.py:serving_layout)
CLUSTER_RANKS = {QWEN: (16, 8, 1), "granite-8b": (16, 4, 1),
                 "minitron-4b": (16, 3, 1)}
MERGE_REL_TOL = 1e-3           # n shards' f32 partials merged against one
                               # launch over the whole cache: summation
                               # order only, relative to each (slot,
                               # head)'s largest element


def rank_flash_case(cfg, gen, shard, lens, *, ring=False, q_scale=1.0,
                    heads=None, ring_rows=None):
    """B5's rank-local mode (a cluster across devices: the stored-pos
    mask, the f32 partial ``(o, m, l)``) on rank ``r`` of ``n``'s shard
    (``shard = (n, r)``) of the unfused path's per-slot cache after the
    append (positions up to each slot's ``cache_len``): Llama2-7B's
    1024-row linear cache, or Gemma-2's 4096-slot local ring with the
    window and the cap, ``q`` scaled so the cap bites; check-only.
    ``heads``: a rank's ``(query, kv)`` heads; ``ring_rows``: a ring of
    that many rows below the window."""
    B, hd = SLOTS, cfg.resolved_head_dim
    nq, nkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if ring:
        W, window, cap = (ring_rows or cfg.sliding_window,
                          cfg.sliding_window, cfg.attn_softcap)
        pos = ring_positions(W, lens + 1)
    else:
        W, window, cap = MAX_SEQ, 0, 0.0
        pos = decode_lens(W, (lens + 1).tolist())[1]
    pos, _, pos_base = shard_of(pos, lens, *shard, ring)
    S = pos.shape[0]
    live_rows = shard_live(pos, lens, pos_base, window, newest=True)
    live = int(live_rows.sum())
    span = int(torch.clamp(lens + 1 - max(pos_base, 0), 0, S).sum())
    args = dict(q=randn(gen, (B, nq, hd), q_scale),
                k_cache=randn(gen, (S, B, nkv, hd), 1.0),
                v_cache=randn(gen, (S, B, nkv, hd), 1.0), cache_len=lens)
    n_bytes = (2 * live * nkv * hd * 2 + span * 4 + B * nq * hd * 2
               + 2 * B * 4 + B * nq * hd * 4 + 2 * B * nq * 4)
    n_ops = 4 * live * nq * hd
    return dict(name="flash_decode", fn=flash_decode_attention,
                plain=flash_decode_plain, args=args,
                kw=dict(window=window, attn_softcap=cap, pos=pos,
                        pos_base=pos_base),
                cost=(n_bytes, n_ops), check_only=True,
                stage=f"cluster {shard[0]} rank {shard[1]}, rank-local "
                      f"partial: {nq}/{nkv} heads, {S} rows, pos_base "
                      f"{pos_base}, newest positions {lens.tolist()}",
                replaces="src/repro/kernels/flash_decode/flash_decode.py:73")


def kernel_cases(path, cfg, backend):
    """The kernels of ``path`` at its widths: on ``"pallas"`` the
    attention kernel (B1, or B4 for MLA), B2 and B3 — or, on RWKV-6, B7
    at the prefill and the decode shape, and B3; with MoE none (its B4
    and B3 run at the dense-MLA arm's shapes, whose cases hold them; the
    experts are torch and cuBLAS); on RecurrentGemma B6 at the prefill
    and the decode shape, then B1 (MQA 16/1 of 256) on wrapped 2048-row
    rings with ragged lengths and a free slot, B2 (4096 × 12288
    ``gelu_tanh``) and B3 on ``embed``; on Gemma-2 B1 on a wrapped ring with
    the window and the softcap (check-only on a global layer's linear
    cache), B2 with ``post_ln1``, B3 with the logit softcap; on ``"xla"``
    B5 at the path's shape and at a GQA shape with a window and a
    softcap — on Gemma-2 its 4096-row ring and (check-only) its global
    cache with the softcap, or, on RecurrentGemma, B6 at the prefill and
    the decode shape and B5 on a full ring; the unfused MLA path runs no
    kernel (only its loose head is checked); on SeamlessM4T B1's MHA mode
    at head dim 64 and B3 at 256206 rows (no B2: its FFN is unfused) or
    B5 at 16/16 of 64; InternVL2 as the GQA paths (B1 at 2 query heads a
    kv head, B2 at 2048 × 8192, B3 at 92553 rows; B5 at 16/8)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    B, D, F, V = SLOTS, cfg.d_model, cfg.d_ff, cfg.vocab_size
    if RECURRENT in cfg.block_pattern:
        n_prompt = LOCKSTEP[path][1][-1][0]
        cases = [rglru_case(cfg, gen, n_prompt), rglru_case(cfg, gen, 1)]
        if backend == "pallas":
            # B1's MQA 16/1 mode at head_dim 256 on the wrapped rings, B2
            # at 4096 × 12288 gelu_tanh, B3 on the tied 256000-row table
            cases += [gqa_case(cfg, gen, RGEMMA_LENS, ring=True,
                               check_only=False),
                      ffn_case(cfg, gen), head_case(cfg, gen),
                      ffn_case(cfg, gen, slots=5)]
        else:
            cases += [ring_flash_case(cfg, gen)] + [
                ring_flash_case(cfg, gen, lens) for lens in RING_EDGE_LENS]
    elif backend == "xla" and cfg.mla is not None:
        cases = []
    elif cfg.encoder is not None:
        # SeamlessM4T: B1's MHA mode at head dim 64 (its edges check-only)
        # and B3 on the 256206-row table on "pallas" — its FFN stays
        # unfused, so no B2 —; B5 at 16/16 of 64 on "xla"
        cases = ([gqa_case(cfg, gen), head_case(cfg, gen),
                  gqa_case(cfg, gen, HD64_EDGE_LENS)]
                 if backend == "pallas" else [flash_case(cfg, gen)])
    elif cfg.moe is not None:
        # B4 and B3 at the dense-MLA arm's shapes: its cases hold them
        cases = []
    elif backend == "xla" and path == GEMMA:
        # B5 gets each slot's min(cache_len + 1, S) on the local rings and
        # the global caches, q scaled so the softcap bites
        cases = [flash_case(cfg, gen, q_scale=8.0, cap=cfg.attn_softcap,
                            S=S, check_only=S != cfg.sliding_window,
                            lens=[min(max(n + 1, 0), S) for n in lens])
                 for S, lens in ((cfg.sliding_window, GEMMA_LENS),
                                 (TRACE_MAX_SEQ[GEMMA], GLOBAL_LENS))]
        # the rank-local partial on a ring shard of a cluster of 2
        cases += [rank_flash_case(cfg, gen, (2, r), GEMMA_LENS, ring=True,
                                  q_scale=8.0) for r in range(2)]
    elif path == GEMMA:
        cases = [gqa_case(cfg, gen, GEMMA_LENS, ring=True, check_only=False),
                 ffn_case(cfg, gen), head_case(cfg, gen),
                 gqa_case(cfg, gen, GLOBAL_LENS, S=TRACE_MAX_SEQ[GEMMA]),
                 ffn_case(cfg, gen, slots=5)]
        # an explicit cluster of 2 across devices: each rank's 2048-slot
        # shard of a local layer's ring (pos_base −1), window and cap
        cases += [gqa_case(cfg, gen, GEMMA_LENS, ring=True, shard=(2, r))
                  for r in range(2)]
    elif backend == "xla" and cfg.q_per_kv > 1:
        cases = [flash_case(cfg, gen)]          # the path's GQA shape
    elif backend == "xla":
        cases = [flash_case(cfg, gen),
                 # the rank-local partial of a cluster of 2 across devices
                 *(rank_flash_case(cfg, gen, (2, r), CLUSTER_LENS)
                   for r in range(2)),
                 flash_case(cfg, gen, q_heads=32, kv_heads=8, q_scale=8.0,
                            window=256, cap=50.0),
                 flash_case(cfg, gen, q_heads=32, kv_heads=4, window=300),
                 flash_case(cfg, gen, q_heads=32, kv_heads=32,
                            dtype=torch.float32)]
    elif cfg.block_pattern == (RWKV6,):
        cases = [wkv_case(cfg, gen, LOCKSTEP[path][1][-1][0]),
                 wkv_case(cfg, gen, 1),
                 head_case(cfg, gen)] + [
            wkv_case(cfg, gen, S, check_only=True) for S in WKV_EDGE_LENS]
    else:
        attn = (mla_case(cfg, gen) if cfg.mla is not None
                else gqa_case(cfg, gen))
        if cfg.mla is not None:
            # and one rank's heads of a 2- and a 4-GPU model axis, and a
            # rank's shard of a cluster of 2 on 4 GPUs (8 heads a rank)
            edges = [mla_case(cfg, gen, B4_EDGE_LENS)] + [
                mla_case(cfg, gen, heads=(ms, cfg.n_heads // ms))
                for ms in (2, 4)] + [
                mla_case(cfg, gen, CLUSTER_LENS, heads=(4, cfg.n_heads // 2),
                         shard=(2, r)) for r in range(2)]
        elif cfg.q_per_kv == 1:
            edges = [gqa_case(cfg, gen, B1_EDGE_LENS),
                     head_case(cfg, gen, RAGGED_VOCAB)]
        else:
            edges = [gqa_case(cfg, gen, GQA_EDGE_LENS)]
        if path == QWEN:
            # one rank's B1, B2 and B3 shapes on 4 and 8 GPUs
            for ms, nq, nkv, f_loc, v_loc in QWEN_RANKS:
                edges += [gqa_case(cfg, gen, heads=(ms, nq, nkv)),
                          ffn_case(cfg, gen, width=(cfg.d_model, f_loc)),
                          head_case(cfg, gen, v_loc)]
        if path in CLUSTER_RANKS:
            # each rank's shard of a cluster of 2 on 16 GPUs
            edges += [gqa_case(cfg, gen, CLUSTER_LENS,
                               heads=CLUSTER_RANKS[path], shard=(2, r))
                      for r in range(2)]
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
    cases += mesh_rank_cases(path, cfg, backend, gen)
    if backend == "xla":
        cases.append(loose_head_case(cfg, gen))
    for case in cases:
        case["path"], case["backend"] = path, backend
    return cases


# The recurrent and modality models on a mesh (ROADMAP A.5b, second half):
# one rank's shapes at the reference's picks of 8 slots
# (launch/specs.py:serving_layout), held check-only on this one card.
# RecurrentGemma-9B takes a cluster across devices at every model axis:
# at max_seq 4096 every head on every rank, (1, n) for n = 2, 4, 8, each
# rank 2048 / n slots of the local layers' ring; at max_seq 1024 (2, 2)
# on 4 GPUs and (4, 4) on 16, 8/1 and 4/1 heads on 512 and 256 slots of
# a 1024-slot ring.  RWKV-6, SeamlessM4T-medium and InternVL2-2B are
# head-parallel up to 8 GPUs.
MESH_AXES = (2, 4, 8)
RGEMMA_RING_RANKS = ((4, 2, 2), (16, 4, 4))    # (GPUs, heads_sub, cluster)


def mesh_rank_cases(path, cfg, backend, gen):
    """One rank's kernel shapes on a model axis of 2, 4 and 8 GPUs (and
    RecurrentGemma's 16), check-only: RecurrentGemma's B1 16/1 on the
    shards of a 2048-slot ring, 8/1 and 4/1 on those of a 1024-slot one
    (``pos_base`` −1), B2 at ``d_ff / ms`` and B6 at ``d_state / ms``
    channels on ``"pallas"``, B5's rank-local mode at head dim 256 on
    the same shards on ``"xla"``; RWKV-6's B7 at ``heads / ms`` heads;
    SeamlessM4T's B1 MHA at ``16 / ms`` heads of 64 and B3 on the last
    rank's padded vocabulary shard; InternVL2's B1 at ``16 / ms`` over
    ``8 / ms`` heads, B2 at ``d_ff / ms`` and B3 likewise."""
    D, F, nq = cfg.d_model, cfg.d_ff, cfg.n_heads
    out = []
    if path == RGEMMA and backend == "pallas":
        for n in MESH_AXES:
            out += [gqa_case(cfg, gen, RGEMMA_LENS, ring=True, shard=(n, r),
                             heads=(n, nq, 1)) for r in (0, n - 1)]
        for ms, hs, n in RGEMMA_RING_RANKS:
            out += [gqa_case(cfg, gen, CLUSTER_LENS, ring=True,
                             ring_rows=MAX_SEQ, shard=(n, r),
                             heads=(ms, nq // hs, 1)) for r in (0, n - 1)]
        C, n_prompt = cfg.rglru_d_state, LOCKSTEP[path][1][-1][0]
        for ms in MESH_AXES:
            out += [ffn_case(cfg, gen, width=(D, F // ms)),
                    rglru_case(cfg, gen, n_prompt, channels=C // ms),
                    rglru_case(cfg, gen, 1, channels=C // ms)]
    elif path == RGEMMA:
        out += [rank_flash_case(cfg, gen, (2, r), RGEMMA_LENS, ring=True)
                for r in range(2)]
        for ms, hs, n in RGEMMA_RING_RANKS:
            out += [rank_flash_case(cfg, gen, (n, r), CLUSTER_LENS,
                                    ring=True, ring_rows=MAX_SEQ,
                                    heads=(nq // hs, 1))
                    for r in (0, n - 1)]
    elif cfg.block_pattern == (RWKV6,):
        H = D // cfg.rwkv_head_dim
        for ms in MESH_AXES:
            for S in (LOCKSTEP[path][1][-1][0], 1):
                case = wkv_case(cfg, gen, S, check_only=True,
                                heads=H // ms)
                case["stage"] = (f"a rank of {ms} GPUs: {H // ms} heads, "
                                 f"S {S}")
                out.append(case)
    elif path in (SEAMLESS, INTERNVL) and backend == "pallas":
        V = cfg.vocab_size
        for ms in MESH_AXES:
            v_loc = -(-V // ms)
            out += [gqa_case(cfg, gen, heads=(ms, nq // ms,
                                              cfg.n_kv_heads // ms)),
                    head_case(cfg, gen, v_loc, pad=v_loc * ms - V)]
            if cfg.encoder is None:
                out.append(ffn_case(cfg, gen, width=(D, F // ms)))
    return out


def ffn_case(cfg, gen, act=None, gated=None, width=None, slots=SLOTS):
    """B2 at ``cfg``'s widths, its activation and gating (on a post-norm
    model with ``post_ln1`` and ``add_r`` 0, as the engine calls it);
    with ``act``, ``gated`` and ``width`` (d_model, d_ff), or fewer
    ``slots``, a check-only case (no path runs it, so it has no phase 6
    row)."""
    B = slots
    D, F = width or (cfg.d_model, cfg.d_ff)
    act = act or cfg.ffn_act
    gated = cfg.ffn_gated if gated is None else gated
    args = dict(x=randn(gen, (B, D), 1.0), a=randn(gen, (B, D), 1.0),
                w_in=randn(gen, (D, F), D ** -0.5),
                w_gate=randn(gen, (D, F), D ** -0.5) if gated else None,
                w_out=randn(gen, (F, D), F ** -0.5),
                ln2=randn(gen, (D,), 0.1, torch.float32))
    post = cfg.use_post_norm and not width
    if post:
        # Gemma-2: post_ln1 inside, the second add after the kernel
        args["post_ln1"] = randn(gen, (D,), 0.1, torch.float32)
    n_mat = 3 if gated else 2
    case = dict(name="fused_ffn", fn=fused_ffn_block, plain=fused_ffn_plain,
                args=args, kw=dict(add_r=0.0 if post else 1.0, act=act,
                                   eps=cfg.norm_eps),
                cost=(4 * B * D * 2 + n_mat * D * F * 2 + (2 if post else 1)
                      * D * 4, 2 * B * D * F * n_mat),
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


def head_case(cfg, gen, vocab=None, pad=0):
    """B3 at ``cfg``'s width and vocabulary, with its logit softcap; with
    ``vocab`` a check-only case at that vocabulary, where slot 1's eight
    best rows (5000–5007) all lie in one CTA's run
    (``fused_head.cluster_plan``: a run is ≈ 267 rows), so seven of that
    CTA's neighbours and the other clusters bring no candidate of slot 1
    to the merges.  With a softcap (Gemma-2's 30), slot 2's two best rows
    have different logits that the cap makes equal in f32: the kernel
    must cap every logit before its top-k for the lower index to win.
    ``pad``: the last rank's shard of a vocabulary padded over a mesh —
    its last ``pad`` rows zeros (not masked, as the reference's)."""
    B, D, V = SLOTS, cfg.d_model, vocab or cfg.vocab_size
    table = randn(gen, (V, D), D ** -0.5)
    x_head = randn(gen, (B, D), 1.0)
    # a tie across the first and the last vocab tile, at the top of
    # slot 0's candidates: the lower index must come first
    table[100] = torch.sign(x_head[0]).to(torch.bfloat16) * 0.05
    table[V - 1 - pad] = table[100]
    if pad:
        table[V - pad:] = 0
    if vocab:
        for i in range(8):
            table[5000 + i] = (torch.sign(x_head[1]) * (0.04 - 0.002 * i)
                               ).to(torch.bfloat16)
    cap = cfg.logit_softcap
    if cap:
        # slot 2's best rows: 201's logit a bf16 step above 200's, near
        # 250, equal once capped in f32: the tie goes to 200
        table[200] = (torch.sign(x_head[2]) * (250.0 / (0.8 * D))).to(
            torch.bfloat16)
        table[201] = table[200]
        j = int(x_head[2].float().abs().argmax())
        table[201, j] = (table[200, j].float() * (1 + 2 ** -7)).to(
            torch.bfloat16)
    head = dict(x=x_head, table=table,
                ln=torch.zeros((D,), dtype=torch.float32, device="cuda"))
    head_bytes = B * D * 2 + V * D * 2 + D * 4 + B * 8 * 8
    head_ops = 2 * B * D * V
    case = dict(name="fused_head", fn=fused_head_block, plain=fused_head_plain,
                args=head, kw=dict(eps=cfg.norm_eps, logit_softcap=cap, k=8),
                cost=(head_bytes, head_ops),
                replaces="src/repro/kernels/fused_head/fused_head.py:97")
    if cap:
        case["tie"] = (2, [200, 201])
    if vocab:
        case.update(check_only=True, stage=f"vocab {V}"
                    + (f", the last {pad} rows padding" if pad else ""))
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
        if "tie" in case:                 # the capped tie, as planted
            slot, ids = case["tie"]
            if want[1][slot, :2].tolist() != ids or want[0][slot, 0] != \
                    want[0][slot, 1]:
                raise AssertionError(f"fused_head: no capped tie at slot "
                                     f"{slot}: {want[0][slot, :2].tolist()} "
                                     f"{want[1][slot, :2].tolist()}")
        return close_head(name, got, want)
    if name == "flash_decode" and isinstance(got, tuple):
        # the rank-local partial: f32 o per (slot, head), m and l; a row
        # with no valid cache row holds (−1e30, 0, 0) on both sides
        (o, m, l), (wo, wm, wl) = got, want
        empty = wm <= -1e29
        if not torch.equal(m <= -1e29, empty) or (l[empty] != 0).any() \
                or o[empty].any():
            raise AssertionError("flash_decode: an empty partial is not "
                                 "(-1e30, 0, 0)")
        close_rel(f"{name}[m]", torch.where(empty, 0.0, m),
                  torch.where(empty, 0.0, wm), FLASH_F32_REL_TOL)
        close_rel(f"{name}[l]", l, wl, FLASH_F32_REL_TOL)
        return close_rel(f"{name}[o]", o, wo, FLASH_F32_REL_TOL, lead=2)
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
# Phase 3b: a cluster across devices on one card — n launches over n shards
# of one cache, merged, equal one launch over the whole cache
# ---------------------------------------------------------------------------
def merge_shards(case, n: int):
    """Launch ``case``'s kernel (B1 or B4) on each of ``n`` shards of its
    whole cache (``pos_base = r·S / n``, the new token on its owner only)
    and merge the ranks' ``(m, l, o)`` in rank order with
    ``core/primitives.py:flash_merge``, in this one process (no
    collective): the combine a cluster across devices runs over its
    ranks.  Returns the merged ``(m, l, o)``."""
    args, kw = case["args"], case["kw"]
    cache = "k_cache" if case["name"] == "fused_decode" else "c_cache"
    parts = []
    for r in range(n):
        pos, owner, pos_base = shard_of(args["pos"], args["cache_lens"], n,
                                        r, False)
        s_sh = pos.shape[0]
        sh = dict(args, pos=pos, include_new=owner)
        for key in (("k_cache", "v_cache") if cache == "k_cache"
                    else ("c_cache",)):
            sh[key] = args[key][r * s_sh:(r + 1) * s_sh]
        out = case["fn"](**sh, **dict(kw, pos_base=pos_base))
        o, m, l = (out[0], out[3], out[4]) if cache == "k_cache" \
            else (out[0], out[2], out[3])
        parts.append((m, l, o))
    merged = parts[0]
    for p in parts[1:]:
        merged = flash_merge(merged, p)
    return merged


def shard_merge_phase() -> None:
    """The identity that makes a cluster across devices right, at full
    width on the card: B1 at Llama2-7B's (32/32, ``D`` 4096, ``S`` 1024,
    8 slots) and B4 at DeepSeek-V2-Lite's (16 heads, ``D`` 2048) — each
    launched on the ``n`` shards of one cache for ``n`` = 2 and 4 and
    merged (:func:`merge_shards`) — against one launch over the whole
    cache, ``(o / l)`` of every live slot and head within
    ``MERGE_REL_TOL`` of its largest element, and ``m`` likewise.  The
    lengths leave ranks holding none of a live slot's rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases = (gqa_case(path_config("llama2-7b"), gen, CLUSTER_LENS),
             mla_case(path_config("deepseek-v2-lite"), gen, CLUSTER_LENS))
    for case in cases:
        out = case["fn"](**case["args"], **case["kw"])
        whole = ((out[3], out[4], out[0]) if case["name"] == "fused_decode"
                 else (out[2], out[3], out[0]))
        live = case["args"]["cache_lens"] >= 0
        for n in (2, 4):
            m, l, o = merge_shards(case, n)
            torch.cuda.synchronize()
            norm = lambda t: (t[2] / t[1][..., None])[live]
            err_o = close_rel(f"merge {case['name']} n={n} [o/l]",
                              norm((m, l, o)), norm(whole), MERGE_REL_TOL,
                              lead=2)
            want_o = norm(whole)
            rel = float(((norm((m, l, o)) - want_o).abs().amax(dim=-1)
                         / want_o.abs().amax(dim=-1).clamp(min=1e-30)).max())
            close_rel(f"merge {case['name']} n={n} [m]", m[live],
                      whole[0][live], MERGE_REL_TOL)
            say("shard_merge", kernel=case["name"],
                width=f"{case['args']['x'].shape[1]}", n=n,
                lengths=",".join(map(str, CLUSTER_LENS)),
                max_rel_err=f"{rel:.3e}", max_abs_err=f"{err_o:.3e}",
                tolerance=MERGE_REL_TOL, ok=True)
        del case


# ---------------------------------------------------------------------------
# Phase 3c: the model axis's rank-sum identity at full width — a layer's
# rank slices, run one rank after another on this card, and their
# collectives, equal the layer run whole
# ---------------------------------------------------------------------------
class ThreadWorld:
    """The ``torch.distributed`` calls ``core/primitives.py`` makes, for
    ``n`` ranks that are threads of this process on the one card: a send
    is a copy into the receiver's mailbox, an all-gather and an
    all-reduce meet at a barrier (the sum in rank order).  Installed as
    ``primitives.dist`` for the block of a ``with``, so the port's own
    collectives — the paper's trees and the reference's ``psum`` — run
    unchanged between the ranks."""

    class ReduceOp:
        SUM, MAX, MIN = "sum", "max", "min"

    isend, irecv = "isend", "irecv"

    class P2POp:
        def __init__(self, op, tensor, peer):
            self.op, self.tensor, self.peer = op, tensor, peer

    def __init__(self, n: int):
        import queue
        import threading
        self.n, self.local = n, threading.local()
        self.boxes = {(a, b): queue.Queue() for a in range(n)
                      for b in range(n)}
        self.barrier = threading.Barrier(n, timeout=300)
        self.slots = [None] * n

    def __enter__(self):
        from repro_torch.core import primitives as prim
        self.prim, self.saved = prim, prim.dist
        prim.dist = self
        return self

    def __exit__(self, *exc):
        self.prim.dist = self.saved

    def get_backend(self, group=None):
        return "threads"

    def batch_isend_irecv(self, ops):
        me = self.local.rank
        for op in ops:
            if op.op == self.isend:
                self.boxes[me, op.peer].put(op.tensor.clone())
        for op in ops:
            if op.op == self.irecv:
                op.tensor.copy_(self.boxes[op.peer, me].get(timeout=300))
        return []

    def _exchange(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def all_gather(self, parts, t, group=None):
        for dst, src in zip(parts, self._exchange(t)):
            dst.copy_(src)

    def all_reduce(self, t, op="sum", group=None):
        parts = self._exchange(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p if op == "sum" else (
                torch.maximum(acc, p) if op == "max" else torch.minimum(acc, p))
        t.copy_(acc)

    def run(self, body):
        """``body(rank)`` on every rank, each in a thread; the results in
        rank order (an exception in any rank is raised here)."""
        import threading
        out, errs = [None] * self.n, []

        def main(r):
            self.local.rank = r
            try:
                out[r] = body(r)
            except BaseException as e:         # re-raised below
                errs.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=main, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


# one layer of each model (its index in a one-group config) and the
# backends whose kernels differ on it
MESH_MERGE_SEQ = 4096                 # the reference's picks at max_seq 4096
MESH_MERGE_TOL = 2e-2          # a layer's bf16 output from rank partials
                               # summed in another order: a few bf16 steps
                               # (2^-8) of each slot's largest element,
                               # the scale its residual sums round at
MESH_MERGE_LAYERS = (
    (RGEMMA, 0, ("pallas",)),         # RG-LRU + FFN: B6 (both backends)
    (RGEMMA, 2, ("pallas", "xla")),   # local attention: B1 or B5, ring
    ("rwkv6-3b", 0, ("pallas",)),     # time and channel mix: B7
    (SEAMLESS, 0, ("pallas", "xla")),  # self-, cross-attention, FFN
    (INTERNVL, 0, ("pallas", "xla")))
MESH_MERGE_LENS = [-1, 0, 37, 300, 511, 512, 513, 1000]
RGEMMA_MERGE_LENS = [-1, 37, 2047, 2048, 2049, 2080, 2111, 4000]


def one_group(cfg):
    """``cfg`` cut to its first layer group (RecurrentGemma R, R, L; one
    layer otherwise, an encoder to one layer)."""
    kw = dict(n_layers=len(cfg.block_pattern))
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=1)
    return dataclasses.replace(cfg, **kw)


def merge_state(cfg, gen):
    """A decode state of ``cfg`` at ``MESH_MERGE_SEQ`` for the 8 slots,
    every leaf random: caches with the positions prefill and the appends
    leave (rings wrapped), RG-LRU and RWKV-6 states, ``enc_kv``."""
    from repro_torch.core.dataflow import KVBlock
    from repro_torch.serving.engine import ServeConfig
    state = init_decode_state(cfg, ServeConfig(
        max_seq=MESH_MERGE_SEQ, batch_local=SLOTS), device="cuda")
    ring = ATTN_LOCAL in cfg.block_pattern
    lens = torch.tensor(RGEMMA_MERGE_LENS if ring else MESH_MERGE_LENS,
                        dtype=torch.int32, device="cuda")
    state["cache_lens"] = lens
    for kind, leaf in zip(cfg.block_pattern, state["layers"]):
        for t in leaf:
            if t.dtype != torch.int32:
                t.copy_(randn(gen, t.shape, 1.0, t.dtype))
        if isinstance(leaf, KVBlock):
            S = leaf.pos.shape[1]
            leaf.pos[0] = (ring_positions(S, lens) if kind == ATTN_LOCAL
                           else decode_lens(S, lens.tolist())[1])
    for t in (state.get("enc_kv") or {}).values():
        t.copy_(randn(gen, t.shape, 1.0))
    return state


def rank_state(cfg, lay, r, state):
    """Model rank ``r``'s share of a whole decode ``state`` (copies): its
    kv heads of every cache and of ``enc_kv`` (replicated where the heads
    ranks outnumber them) and its cluster rank's rows, its RG-LRU
    channels, its RWKV-6 heads."""
    from repro_torch.core.dataflow import KVBlock
    hs, n, ms = lay.heads_sub, lay.cluster, lay.model_size
    h, c = divmod(r, n)
    B = SLOTS

    def kv_heads(t, kv):                 # [..., B·kv, hd] → the rank's
        kv_loc = max(1, kv // hs)
        k0 = h * kv // hs if hs <= kv else h // (hs // kv)
        v = t.unflatten(-2, (B, kv))[..., k0:k0 + kv_loc, :]
        return v.flatten(-3, -2).contiguous()

    out = dict(state, layers=[])
    for kind, leaf in zip(cfg.block_pattern, state["layers"]):
        if isinstance(leaf, KVBlock):
            S = leaf.pos.shape[1] // n
            rows = slice(c * S, (c + 1) * S)
            out["layers"].append(KVBlock(
                kv_heads(leaf.k[:, rows], cfg.n_kv_heads),
                kv_heads(leaf.v[:, rows], cfg.n_kv_heads),
                leaf.pos[:, rows].contiguous()))
        elif kind == RECURRENT:
            C = leaf.h.shape[-1] // ms
            out["layers"].append(type(leaf)(
                *(t[..., r * C:(r + 1) * C].contiguous() for t in leaf)))
        else:
            H = leaf.s.shape[2] // hs
            out["layers"].append(leaf._replace(
                s=leaf.s[:, :, h * H:(h + 1) * H].contiguous(),
                x_prev_t=leaf.x_prev_t.clone(),
                x_prev_c=leaf.x_prev_c.clone()))
    if "enc_kv" in state:
        out["enc_kv"] = {k: kv_heads(t, cfg.n_kv_heads)
                         for k, t in state["enc_kv"].items()}
    return out


def run_layer(cfg, params, state, x, i, backend, ctx):
    """Layer ``i`` (of the one group) of a decode step on ``params`` and
    ``state`` (updated in place) through the port's kernels:
    ``serving/engine.py:decode_block`` on the serve tree of ``backend``."""
    from repro_torch.serving.prepack import prepack_for_serving
    kind = cfg.block_pattern[i]
    serve = (prepack_for_serving(cfg, params, backend="pallas", ctx=ctx)
             if backend == "pallas" else params)
    serve = engine_mod.hoist_serve_weights(serve, ctx)
    cache = engine_mod._layer(state["layers"][i], 0)
    lens = state["cache_lens"]
    cos = sin = None
    if not cfg.is_attention_free:
        cos, sin = rope_at(lens, cfg.resolved_head_dim, cfg.rope_theta)
    cross = enc_kv = None
    if cfg.encoder is not None:
        cross = engine_mod._layer(serve["cross_attn"], 0)
        enc_kv = (state["enc_kv"]["k"][0], state["enc_kv"]["v"][0])
    appends = engine_mod._step_appends(cfg, [(kind, cache)], lens,
                                       engine_mod._spec(ctx))
    return engine_mod.decode_block(
        cfg, kind, engine_mod._layer(serve["blocks"][i], 0), x, cache, lens,
        cos, sin, KERNELS, cross, enc_kv, ctx, appends)


def mesh_merge_phase() -> None:
    """The identity that makes the model axis right, at full width on the
    card: for one layer of each of RecurrentGemma-9B (an RG-LRU layer,
    and a local-attention layer whose ring splits over the cluster),
    RWKV-6 3B, SeamlessM4T-medium (a decoder layer with its
    cross-attention) and InternVL2-2B, each rank of a model axis of 2 and
    4 — at the reference's pick for max_seq 4096 — runs its
    ``shard_params`` slice and its share of the state through the port's
    kernels (threads of this process, one card), the ranks' partials
    summed in rank order where the reference puts a ``psum`` and merged
    ``(m, l, o)`` where it puts a cluster combine (the port's own
    collectives, ``ThreadWorld``); every rank's output equals the layer
    run unsharded within ``MESH_MERGE_TOL`` of each slot's largest
    element.  The ranks' outputs need not be equal to the bit: the
    paper's tree sums four bf16 partials in another grouping on each
    rank."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import ctx_for, serving_layout
    from repro_torch.core.primitives import MeshAxis
    from repro_torch.models.ctx import SINGLE
    from repro_torch.models.transformer import init_params, shard_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    built = {}
    for path, i, backends in MESH_MERGE_LAYERS:
        if path not in built:
            built.clear()
            cfg = one_group(get_config(path))
            built[path] = (cfg, init_params(cfg, seed=SEED, device="cuda"),
                           merge_state(cfg, gen))
        cfg, whole, state = built[path]
        x = randn(gen, (SLOTS, cfg.d_model), 1.0)
        for backend in backends:
            want = run_layer(cfg, whole, clone_state(state), x, i, backend,
                             SINGLE)
            for ms in (2, 4):
                lay = serving_layout(cfg, ms, seq_len=MESH_MERGE_SEQ,
                                     batch=SLOTS)
                world = ThreadWorld(ms)

                def body(r):
                    model = MeshAxis("model", tuple(range(ms)), r,
                                     tuple(range(ms)))
                    mesh = Mesh({"data": 1, "model": ms}, {
                        "model": model,
                        "data": MeshAxis("data", (r,), 0, None)}, r,
                        torch.device("cuda"))
                    ctx = ctx_for(mesh, lay)
                    part = shard_params(cfg, lay, whole, r)
                    return run_layer(cfg, part, rank_state(cfg, lay, r,
                                                           state),
                                     x, i, backend, ctx)
                with world:
                    outs = world.run(body)
                torch.cuda.synchronize()
                err = max(close_rel(f"mesh_merge {path} layer {i} "
                                    f"{backend} ms={ms} rank {r}", got,
                                    want, MESH_MERGE_TOL)
                          for r, got in enumerate(outs))
                rel = max(float(((got.float() - want.float()).abs().amax(-1)
                                 / want.float().abs().amax(-1)).max())
                          for got in outs)
                say("mesh_merge", model=path, layer=i,
                    kind=cfg.block_pattern[i], backend=backend,
                    model_axis=ms, heads_sub=lay.heads_sub,
                    cluster=lay.cluster, max_abs_err=f"{err:.3e}",
                    max_rel_err=f"{rel:.3e}", tolerance=MESH_MERGE_TOL,
                    ok=True)
                del outs, world
            del want
        del x
    built.clear()
    torch.cuda.empty_cache()


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
    the attention kernel, ``L`` of B2 (none with MoE or an encoder, whose
    FFN stays unfused) and one of B3 on ``"pallas"``; ``L`` of B5 on
    ``"xla"`` (none for MLA)."""
    if backend == "xla":
        return {} if cfg.mla is not None else {"flash_decode": cfg.n_layers}
    attn = "fused_mla_decode" if cfg.mla is not None else "fused_decode"
    ffn = ({} if cfg.moe is not None or cfg.encoder is not None
           else {"fused_ffn": cfg.n_layers})
    return {attn: cfg.n_layers, **ffn, "fused_head": 1}


# Gemma-2's long requests (rid: prompt, new tokens): one whose prefill
# wraps the 4096-row rings and one that starts just under 4096 and wraps
# them in decode, both arriving while short requests are live
LONG_REQUESTS = {GEMMA: {3: (4200, 24), 6: (4080, 40)}}


def request_trace(path, cfg):
    """The staggered trace a path serves and its prompt cap: 12 requests
    arriving over 16 ticks, prompts of 16–512 tokens, 8–64 new tokens
    (seed 0); on Gemma-2 two of them replaced by ``LONG_REQUESTS``."""
    rng = np.random.default_rng(SEED)
    n_req = 12
    arrivals = np.sort(rng.integers(0, 16, n_req))
    trace = [(int(arrivals[i]), Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 513))).tolist(),
        max_new=int(rng.integers(8, 65)))) for i in range(n_req)]
    long = LONG_REQUESTS.get(path, {})
    for rid, (n_prompt, n_new) in long.items():
        trace[rid] = (trace[rid][0], Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab_size,
                                         n_prompt).tolist(),
            max_new=n_new))
    return trace, max([512] + [n for n, _ in long.values()])


def check_long_admits(path, sched) -> None:
    """Each of the path's long requests was admitted while another
    request was live (admitted at or before its tick, finishing after)."""
    admit, finish = {}, {}
    for tick, kind, rid, _ in sched.events:
        (admit if kind == "admit" else finish)[rid] = tick
    for rid in LONG_REQUESTS.get(path, {}):
        t = admit[rid]
        if not any(r != rid and admit[r] <= t < finish[r] for r in admit):
            raise AssertionError(f"request {rid} was admitted alone")


def serve_trace(path, cfg, eng):
    trace, prompt_cap = request_trace(path, cfg)
    step_launches, step_replays, step_ms, host_ms = [], [], [], []
    dec = eng.decode_fn

    def counted_decode(p, st, tok, sampled=False):
        before = tracecount.launches()
        replays = (tracecount.replays(), dec.replays)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        nxt, st = dec(p, st, tok, sampled=sampled)
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
                          prompt_cap=prompt_cap)
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
    check_long_admits(path, sched)
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
    return dict(requests=len(trace), ticks=sched.tick,
                decode_steps=sched.decode_calls, tokens=len(toks),
                readmits=refills, replays=tracecount.replays(),
                launches_per_step=sum(per_kernel.values()),
                median_step_ms=round(statistics.median(step_ms), 3),
                median_host_ms=round(statistics.median(host_ms), 3),
                wall_s=round(wall, 2)), launches, per_kernel, results


def lockstep_launches(cfg, backend):
    """Launches one prefill and one decode step must make on a lockstep
    path: RWKV-6 ``L`` B7 per prefill, ``L`` B7 and one B3 per step;
    RecurrentGemma one B6 per RG-LRU layer per prefill, and per step one
    B6 per RG-LRU layer and, per local-attention layer, one B5 on
    ``"xla"`` or one B1 and one B2 on ``"pallas"`` (there also one B3:
    26 + 12 + 12 + 1 = 51); MoE DeepSeek-V2-Lite and the modality models
    none per prefill (it is torch and cuBLAS) and ``decode_launches`` per
    step (SeamlessM4T 12 + 1 or 12, InternVL2 24 + 24 + 1 or 24)."""
    if cfg.moe is not None or cfg.frontend is not None:
        return {}, decode_launches(cfg, backend)
    if cfg.block_pattern == (RWKV6,):
        return ({"rwkv6_scan": cfg.n_layers},
                {"rwkv6_scan": cfg.n_layers, "fused_head": 1})
    n_rec = cfg.layer_kinds.count(RECURRENT)
    n_loc = cfg.layer_kinds.count(ATTN_LOCAL)
    attn = ({"flash_decode": n_loc} if backend == "xla" else
            {"fused_decode": n_loc, "fused_ffn": n_loc, "fused_head": 1})
    return {"rglru_scan": n_rec}, {"rglru_scan": n_rec, **attn}


def serve_lockstep(path, cfg, eng):
    """A lockstep path's serving loop: two ``generate`` batches of
    ``SLOTS`` requests on one engine (``LOCKSTEP``), every prefill and
    decode step counted, timed (CUDA events; host clock for the enqueue)
    and checked for non-finite rows."""
    rng = np.random.default_rng(SEED)
    calls = {"prefill": [], "decode": []}

    def counted(fn, stage):
        def run(p, st, tok, *fe):
            before = tracecount.launches()
            replays = (tracecount.replays(), eng.decode_fn.replays)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            nxt, st = fn(p, st, tok, *fe)
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

    plan = LOCKSTEP[path][1]
    state, batches = eng.state, []
    fe = frontend_embeds(cfg)
    tracecount.reset()
    t0 = time.perf_counter()
    for n_prompt, n_new in plan:
        prompts = rng.integers(0, cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        toks, state = generate(eng.params,
                               counted(eng.prefill_fn, "prefill"),
                               counted(eng.decode_fn, "decode"), state,
                               prompts, n_new, fe)
        toks = toks.cpu().numpy()
        if toks.shape != (SLOTS, n_new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError("tokens missing or outside the vocabulary")
        batches.append((prompts, toks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tracecount.launches()
    want = {stage: {k: 0 for k in launches} for stage in calls}
    for stage, need in zip(("prefill", "decode"),
                           lockstep_launches(cfg, eng.scfg.backend)):
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
    first, _ = eng.prefill_fn(eng.params["train"], fresh, prompts, fe)
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
# RecurrentGemma (past the ring) and MoE DeepSeek-V2-Lite their second's
FORCED_PROMPT = {"rwkv6-3b": 128, RGEMMA: 2080, MOE_PATH: 512,
                 SEAMLESS: 512, INTERNVL: 768}


# the fill lengths of a path whose slots do not all take 32–512 tokens:
# on Gemma-2 three slots past or near the 4096-row rings' wrap
FILL_LENS = {GEMMA: [4090, 4200, 32, 100, 300, 512, 4095, 64]}
ALONE = 1024     # a longer prompt is admitted on its own: prefill's
                 # activations for several would not fit beside Gemma-2's
                 # weights and caches


def fill_state(path, cfg, eng, state, rng, samp=None):
    """Every slot of ``state`` filled: on an attention path admitted with
    a prompt of 32–512 tokens (``FILL_LENS`` where given; a prompt over
    ``ALONE`` tokens admitted on its own) and the sampling rows ``samp``
    (default greedy), on a lockstep path prefilled with one of
    ``FORCED_PROMPT`` tokens (the caches and recurrent states in
    place)."""
    lens = rng.integers(32, 513, SLOTS).astype(np.int32)
    lens = np.asarray(FILL_LENS.get(path, lens), np.int32)
    n_prompt = FORCED_PROMPT.get(path)
    toks = rng.integers(0, cfg.vocab_size,
                        (SLOTS, max(512, n_prompt or 0, int(lens.max())))
                        ).astype(np.int32)
    if n_prompt:                            # lockstep: one prompt length
        _, state = eng.prefill_fn(eng.params["train"], state,
                                  toks[:, :n_prompt], frontend_embeds(cfg))
        return state
    long = lens > ALONE
    groups = [np.arange(SLOTS) == b for b in np.nonzero(long)[0]]
    for group in groups + [~long]:
        _, state = eng.admit_fn(eng.params["train"], state, toks,
                                np.where(group, lens, 0), samp)
    return state


def clone_state(state, device="cuda"):
    """A copy of every leaf on ``device``: decode updates the caches and
    recurrent states in place, so a second run needs a state of its
    own."""
    def copy(t):
        return t.to(device, copy=True)
    return {k: (copy(v) if torch.is_tensor(v) else
                {n: copy(t) for n, t in v.items()} if isinstance(v, dict)
                else [copy(c) if torch.is_tensor(c)
                      else type(c)(*(copy(t) for t in c)) for c in v])
            for k, v in state.items()}


def twin_state(state):
    """``clone_state`` on the card where a second state fits there with
    8 GiB to spare, else in host memory (Gemma-2 27B: 13.1 GB of caches
    beside 54.5 GB of weights): a host twin is copied back into
    ``state``'s own tensors (``restore_state``) for the second run."""
    need = sum(t.numel() * t.element_size() for _, t in state_leaves(state))
    free = torch.cuda.mem_get_info()[0]
    return clone_state(state, "cuda" if free > need + (8 << 30) else "cpu")


def restore_state(state, saved):
    """``saved``'s values into ``state``'s own tensors, leaf by leaf."""
    for (_, dst), (_, src) in zip(state_leaves(state), state_leaves(saved)):
        dst.copy_(src)
    return state


def state_leaves(state):
    """``(name, tensor)`` for every leaf of a decode state."""
    out = []
    for k in sorted(state):
        v = state[k]
        if torch.is_tensor(v):
            out.append((k, v))
        elif isinstance(v, dict):
            out += [(f"{k}.{n}", t) for n, t in sorted(v.items())]
        else:                    # caches, or kv_fp's [G, B] checksums
            out += [(f"{k}[{i}]", c) if torch.is_tensor(c) else
                    (f"{k}[{i}].{f}", t)
                    for i, c in enumerate(v)
                    for f, t in ([(None, c)] if torch.is_tensor(c)
                                 else zip(c._fields, c))]
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


def graph_vs_eager(path, cfg, eng, steps: int = 16, samp=None):
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
    state = fill_state(path, cfg, eng, eng.state, rng, samp)
    twin = twin_state(state)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, SLOTS))
                             .astype(np.int32), device="cuda")
    graph = eng.decode_fn
    replays = graph.replays
    sampled = samp is not None
    g_toks, state, g_ms, g_host = time_steps(
        lambda st, tok: graph(eng.params["serve"], st, tok, sampled=sampled),
        state, forced)
    on_host = not twin["cache_lens"].is_cuda
    if on_host:
        # the graphed run's end state kept in host memory, the start state
        # copied back into the engine's tensors for the eager run
        ended = clone_state(state, "cpu")
        twin = restore_state(state, twin)
    e_toks, twin, e_ms, e_host = time_steps(
        lambda st, tok: decode_step(cfg, eng.scfg, eng.params["serve"], st,
                                    tok, kernels=KERNELS, sampled=sampled),
        twin, forced)
    if on_host:
        state, e_dev = ended, twin
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
               g.to(e.device).contiguous().view(-1).view(torch.uint8),
               e.contiguous().view(-1).view(torch.uint8))]
    if bad:
        raise AssertionError(f"graphed and eager states differ in {bad}")
    if g_host >= 1.0 or g_ms > e_ms:
        raise AssertionError(f"graphed step {g_ms:.3f} ms (host "
                             f"{g_host:.3f} ms) against eager {e_ms:.3f} ms")
    # the replays below need the engine's own tensors: the eager run's
    # end state on the host path
    box = [e_dev if on_host else state]

    def replay():
        box[0] = graph(eng.params["serve"], box[0], forced[0],
                       sampled=sampled)[1]
    dev_ms, covered = cuda_ms(replay, 8)
    return dict(steps=steps, tokens_equal=True, state_equal=True,
                graph_median_step_ms=round(g_ms, 3),
                graph_median_host_ms=round(g_host, 3),
                eager_median_step_ms=round(e_ms, 3),
                eager_median_host_ms=round(e_host, 3),
                eager_over_graph=round(e_ms / g_ms, 3),
                graph_device_step_ms=round(dev_ms, 3),
                device_queued_under_spin=covered)


def forced_decode(path, cfg, eng, steps: int = 8, samp=None):
    rng = np.random.default_rng(SEED + 2)
    # the engine's state as a fresh one: the fill rewrites every slot
    state = fill_state(path, cfg, eng, eng.state, rng, samp)
    # decode updates the caches and recurrent states in place: the plain
    # run gets a copy of its own (on the host where the card has no room,
    # copied back into the engine's tensors when the kernels' run is done)
    twin = twin_state(state)
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
                    torch.as_tensor(forced[t], device="cuda"), kernels=ks,
                    sampled=samp is not None)
                toks.append(nxt.cpu().numpy())
        finally:
            engine_mod.head_candidates = head_candidates
        return np.stack(toks), cands, st

    got, g_cands, _ = run(KERNELS, state)
    if not twin["cache_lens"].is_cuda:
        twin = restore_state(state, twin)
    want, w_cands, _ = run(PLAIN_KERNELS, twin)
    agree = float(np.mean(got == want))
    # the largest difference of the best candidate's value, f32 logits
    gap = "{:.3e}".format(max(float((g[0][:, 0] - w[0][:, 0]).abs().max())
                              for g, w in zip(g_cands, w_cands)))
    out = dict(steps=steps, slots=SLOTS, agreement=round(agree, 4),
               max_logit_gap=gap)
    cands = tuple(np.stack([c[i].float().cpu().numpy() if i == 0
                            else c[i].cpu().numpy() for c in g_cands])
                  for i in (0, 1))
    if samp is None:
        if agree < 0.9:
            raise AssertionError(f"kernel vs plain token agreement {agree}")
    else:
        out.update(sampled_agreement(
            "kernel vs plain", got, want, cands,
            tuple(np.stack([c[i].float().cpu().numpy() if i == 0
                            else c[i].cpu().numpy() for c in w_cands])
                  for i in (0, 1))))
    return out, got, cands


def sampled_agreement(what, got, want, cands, other) -> dict:
    """Sampled tokens of two runs from the same states and noise, with
    the candidate lists (values, ids ``[T, B, K]``) each run handed the
    sampler.  Its noise goes by rank, so where the two lists differ the
    draw may pick otherwise, and the token agreement gates nothing; what
    is gated, each difference being a near-tie of the logits:

    * each list is sorted by value;
    * an id in both lists has values within ``CAND_TOL``;
    * an id in one list only is at most ``CAND_TOL`` above the other
      list's last value (it crossed the rank-K edge);
    * where the lists are equal, the tokens are.

    A fault that reorders, loses or misvalues candidates fails one of
    them.  Returns the share of equal lists, the largest value gap and
    edge crossing, and the share of picks off candidate 0."""
    (va, ia), (vb, ib) = cands, other
    problems = [f"{name} candidates not sorted" for name, v in
                (("first", va), ("second", vb)) if (np.diff(v) > 0).any()]
    gap = cross = 0.0
    for t, b in np.ndindex(*ia.shape[:2]):
        da = dict(zip(ia[t, b].tolist(), va[t, b].tolist()))
        db = dict(zip(ib[t, b].tolist(), vb[t, b].tolist()))
        gap = max([gap] + [abs(da[i] - db[i]) for i in da.keys() & db.keys()])
        cross = max([cross] + [da[i] - vb[t, b, -1] for i in da.keys() - db]
                    + [db[i] - va[t, b, -1] for i in db.keys() - da])
    if gap > CAND_TOL or cross > CAND_TOL:
        problems.append(f"candidate values {gap:.3e} apart, {cross:.3e} "
                        f"over the other list's last (tolerance {CAND_TOL})")
    same = (ia == ib).all(axis=-1)
    if (got != want)[same].any():
        problems.append("sampled tokens differ where the candidate lists "
                        "are equal")
    if problems:
        raise AssertionError(f"{what}: {problems}")
    return dict(same_candidate_lists=round(float(same.mean()), 4),
                max_candidate_gap="{:.3e}".format(gap),
                max_edge_cross="{:.3e}".format(cross),
                near_ties_only=True,
                off_candidate0=round(float((got != ia[..., 0]).mean()), 4))


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


def _profile_once(cfg, eng, state, per_step, steps: int = 4):
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
    ``other``.  Only device activity is traced (no host record is
    read), and one replay runs first as the profiler's warm-up (its
    schedule's ``warmup`` step: device tracing on, records discarded)
    and ends on the device before the traced window opens: a window
    opened with its first replay lost records at its edge (ROADMAP
    C12)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    tok = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        tok, state = eng.decode_fn(eng.params["serve"], state, tok)
        torch.cuda.synchronize()
        prof.step()                 # the traced window opens
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
    out = {f"{g}_ms_per_step": round(v / steps / 1e3, 3)
           for g, v in per.items()}
    out["stage_ms_per_step"] = {k: round(v / steps / 1e3, 3)
                                for k, v in stages.items()}
    out.update(spans_per_step=spans_per_step,
               device_launches_per_step=len(spans) / steps,
               window_ms_per_step=round(window / steps / 1e3, 3),
               idle_share=round(1.0 - busy / window, 4))
    return out, want


def profile_steps(cfg, eng, state, per_step, steps: int = 4):
    """:func:`_profile_once`, whose spans of the port's kernels must equal
    ``per_step``'s launches.  A trace that shows the same kernels with
    fewer spans and none more lost records (ROADMAP C12: CUPTI drops a
    run of records now and then) and is taken once more; the second
    trace must match exactly.  Extra spans, a kernel missing or another
    port kernel fail at once."""
    for attempt in range(2):
        out, want = _profile_once(cfg, eng, state, per_step, steps)
        got = out["spans_per_step"]
        if got == want:
            out["retraced_for_lost_records"] = attempt
            return out
        lost = set(got) == set(want) and all(got[k] <= want[k] for k in got)
        if not lost or attempt:
            raise AssertionError(f"device spans per step {got}, want {want} "
                                 f"from phase 4's launches {per_step}")
        print(f"[profile] lost records: device spans per step {got}, want "
              f"{want}; tracing once more", flush=True)


def path_config(path: str):
    """The path's config: DeepSeek-V2-Lite as registered (MoE on every
    layer) on ``MOE_PATH``, and as its dense-MLA arm (every FFN the dense
    one of width ``d_ff``) on ``"deepseek-v2-lite"``."""
    if path == MOE_PATH:
        return get_config("deepseek-v2-lite")
    cfg = get_config(path)
    if path in PATH_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=PATH_LAYERS[path])
    return dataclasses.replace(cfg, moe=None) if cfg.moe else cfg


def step_weights(cfg, eng):
    """The weights a decode step reads: every layer's attention and FFN
    weights — a MoE FFN's router and all its experts, which the
    reference's capacity dispatch reads whatever the routing — (or the
    RWKV-6 block's leaves, or every leaf of every RecurrentGemma block,
    its tail included) and the head table; on the unfused path the train
    tree's attention weights (MLA: ``wq``, ``wdkv``, ``wuk``, ``wuv``,
    ``wo``; on ``"pallas"`` B4 reads ``wproj`` in place of the last two)
    and the ``lm_head`` (tied: ``embed``) the loose head reads; with an
    encoder also every layer's cross-attention ``wq`` and ``wo`` (its k
    and v were projected at prefill: the step reads ``enc_kv``)."""
    serve = eng.params["serve"]
    table = (serve["head"].table if "head" in serve else
             serve["embed" if cfg.tie_embeddings else "lm_head"])
    if RECURRENT in cfg.block_pattern:
        return tree_bytes(serve["blocks"] + serve["tail"]) \
            + table.numel() * table.element_size()
    block_w = ()
    for blk in serve["blocks"]:          # each block-pattern position
        if cfg.block_pattern == (RWKV6,):
            block_w += tuple(blk["rwkv"].values())
            continue
        attn, ffn = blk["attn"], blk["ffn"]
        if isinstance(attn, dict):
            block_w += tuple(attn.values())
        elif cfg.mla is not None:
            block_w += (attn.wq, attn.wdkv, attn.wuk, attn.wproj)
        else:
            block_w += (attn.wqkv, attn.wo)
        block_w += tuple(t for t in (ffn.values() if isinstance(ffn, dict)
                                     else (ffn.w_in, ffn.w_gate, ffn.w_out))
                         if t is not None)
    if cfg.encoder is not None:
        cross = serve["cross_attn"]["attn"]
        block_w += (cross["wq"], cross["wo"])
    return sum(t.numel() * t.element_size() for t in block_w + (table,))


def build_engine(path, cfg, backend):
    """The path's engine (its decode step captured in a graph) and its
    ``max_seq``, after emptying the allocator's cache, with the memory
    reserved before it was built."""
    lockstep = path in LOCKSTEP
    max_seq = LOCKSTEP[path][0] if lockstep else TRACE_MAX_SEQ.get(path,
                                                                   MAX_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()
    eng = build_engine_full(cfg, max_seq=max_seq, batch_global=SLOTS,
                            options=EngineOptions(backend=backend,
                                                  check_finite=True),
                            device="cuda", seed=SEED)
    if cfg.qkv_bias:
        seed_biases(eng)
    torch.cuda.synchronize()
    return eng, max_seq, reserved


def seed_biases(eng) -> None:
    """Seeded random q/k/v biases in place of the init's zeros (the
    reference's init makes them zero, which would leave the bias path
    adding nothing): the train tree's ``bq``/``bk``/``bv``, which the
    serve tree's ``bqkv`` aliases on ``"pallas"`` — the same values on
    both backends."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    with torch.no_grad():
        for blk in eng.params["train"]["blocks"] + eng.params["train"]["tail"]:
            for name in ("bq", "bk", "bv"):
                t = blk["attn"][name]
                t.copy_(randn(gen, tuple(t.shape), 0.5))


def check_released(reserved: int) -> None:
    """After the last engine reference went: its memory, the graph's
    private pool included, is given back (no reference cycle keeps
    it)."""
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - reserved
    if kept > 256 << 20:
        raise AssertionError(f"{kept / 2**30:.2f} GiB still reserved after "
                             "the engine was dropped")


def serve_path(path, cfg, backend, peers):
    """Phase 4 for one path: build the engine, serve the trace (the
    lockstep paths: their two batches) through its graph, then the graph
    against the eager step.  ``peers`` holds the earlier paths' results
    by (path, backend); the unfused path's step is compared with the
    fused one of the same path there.  Returns the path's launch counts
    per stage ("decode", and "prefill" on a lockstep path): total and
    per call, and its median step time."""
    lockstep = path in LOCKSTEP
    t0 = time.perf_counter()
    eng, max_seq, reserved = build_engine(path, cfg, backend)
    tag = dict(path=path, backend=backend)
    held = (tree_bytes(eng.params)
            + tree_bytes(eng.state["layers"] + eng.state["tail"]))
    say("engine", **tag, layers=cfg.n_layers, max_seq=max_seq,
        build_s=round(time.perf_counter() - t0, 1),
        graph_launches=sum(eng.decode_fn.launches.values()),
        weights_gb=round(tree_bytes(eng.params) / 1e9, 3),
        **{"state_gb" if lockstep else "kv_gb":
           round(tree_bytes(eng.state["layers"] + eng.state["tail"])
                 / 1e9, 3)},
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    if lockstep:
        serve, counts, batches = serve_lockstep(path, cfg, eng)
        toks = batches[-1][1]
        first = {b: toks[b, :4].tolist() for b in range(3)}
    else:
        serve, launches, per_step, results = serve_trace(path, cfg, eng)
        counts = {"decode": (launches, per_step)}
        first = {r: res.tokens[:4] for r, res in sorted(results.items())[:3]}
    # the floor of a step: every weight byte read once at the HBM rate
    weight_bytes = step_weights(cfg, eng)
    serve["step_weights_gb"] = round(weight_bytes / 1e9, 3)
    serve["weights_bound_ms"] = round(1e3 * weight_bytes / HBM_BYTES_PER_S, 3)
    if "enc_kv" in eng.state:
        # the encoder's k/v every step reads beside the weights
        enc_bytes = tree_bytes(eng.state["enc_kv"])
        serve["enc_kv_gb"] = round(enc_bytes / 1e9, 3)
        serve["weights_and_enc_kv_bound_ms"] = round(
            1e3 * (weight_bytes + enc_bytes) / HBM_BYTES_PER_S, 3)
    say("serve", **tag, **serve)
    say("serve", **tag, first_tokens=first)
    vs_eager = graph_vs_eager(path, cfg, eng)
    say("graph", **tag, **vs_eager)
    # the most the card held over the build, the serving and the graph
    # check, beside the weights and caches the engine holds
    say("memory", **tag, weights_and_state_gb=round(held / 1e9, 3),
        peak_allocated_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
        card_gb=round(torch.cuda.get_device_properties(0).total_memory
                      / 1e9, 3))
    dev_ms = vs_eager["graph_device_step_ms"]
    fused = peers.get((path, "pallas")) if backend == "xla" else None
    if fused is not None:
        # served steps (host issue inside the window) and device work
        # alone (graph replays queued behind a spin)
        say("serve", path=path, fused_median_step_ms=fused["step_ms"],
            unfused_median_step_ms=serve["median_step_ms"],
            unfused_over_fused=round(serve["median_step_ms"]
                                     / fused["step_ms"], 4),
            fused_device_step_ms=fused["device_ms"],
            unfused_device_step_ms=dev_ms,
            device_unfused_over_fused=round(dev_ms / fused["device_ms"], 4))
    del eng
    check_released(reserved)
    return counts, dict(step_ms=serve["median_step_ms"], device_ms=dev_ms)


def check_path(path, cfg, backend, counts, peers):
    """Phase 5 for one path, on an engine built anew: the kernels
    against their plain versions end to end (the unfused path's tokens
    also against the fused path's, from ``peers``), then a trace of
    replays of its graph on its own state, refilled, and the graphed
    host issue timed again after the trace.  Returns the forced
    tokens."""
    eng, _, reserved = build_engine(path, cfg, backend)
    tag = dict(path=path, backend=backend)
    forced, forced_toks, _ = forced_decode(path, cfg, eng)
    fused = peers.get((path, "pallas")) if backend == "xla" else None
    if fused is not None:
        # the card's counterpart of tests/test_backend_parity.py:241: the
        # same weights and forced tokens through both backends
        agree = float(np.mean(forced_toks == fused["forced"]))
        if agree < 0.9:
            raise AssertionError(f"unfused vs fused token agreement {agree}")
        forced["agreement_with_fused"] = round(agree, 4)
    say("forced", **tag, **forced)
    state = fill_state(path, cfg, eng, eng.state,
                       np.random.default_rng(SEED + 3))
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


# ---------------------------------------------------------------------------
# The fleet: two Llama2-7B replicas behind the router, every probe on
# ---------------------------------------------------------------------------
FLEET = "llama2-7b"
FLEET_REPLICAS = 2
FLEET_FAULT_TICK = 8          # mid-trace: arrivals span ticks 0–15
FLEET_WEIGHT_TARGET = 1       # weight_leaves order: blocks[0].attn.wo
FLEET_FLIP_BITS = (0, 14)     # flip_weight_bit: a mantissa, an exponent bit
FLEET_KV_BIT = 7
FLEET_SWEEP_BITS = (0, 7, 14)
FLEET_SWEEP_NEW = 16
FLEET_OPTIONS = dict(backend="pallas", check_finite=True, track_work=True,
                     kv_fingerprint=True, shadow_head=True)
# (seed, emit offset) grid of the card-against-CPU PRNG check
PRNG_SEEDS = (0, 1, 2 ** 31, 2 ** 32 - 1, 12345)
PRNG_STEPS = (0, 1, 7, 1000, 2 ** 31 - 1)
# the probe each kind must trip (tests/test_router.py:42–50, and the
# fingerprints for the single-bit kinds)
FLEET_SIGNAL = {"kill": "detect_heartbeat",
                "blackhole": "detect_journal_stale",
                "corrupt_kv": "detect_nonfinite",
                "corrupt_lens": "detect_lens_bounds",
                "poison_weight": "detect_nonfinite",
                "drop_admit": "detect_journal_stale",
                "dup_admit": "detect_journal_stale",
                "flip_kv_bit": "detect_kv_fingerprint"}
WEIGHT_SIGNALS = {"detect_weight_fingerprint", "detect_shadow_recompute"}


def fleet_sampling(rid: int):
    """Half the requests sampled at temperature 0.8 (top-k 8 or 5, top-p
    0.9, their own seed), the other half greedy: rids 0, 1 of every four
    (dispatch alternates between the replicas, so each holds both
    kinds)."""
    if rid % 4 >= 2:
        return GREEDY
    return SamplingParams(temperature=0.8, top_k=8 if rid % 4 == 0 else 5,
                          top_p=0.9, seed=rid + 1)


def sampled_rows(n: int = SLOTS):
    """Admit rows with every slot at temperature 0.8 (top-k 5 or 8, top-p
    0.9 or 1, a seed each): the teacher-forced and graph checks."""
    rows = host_sampling_rows(n)
    for b in range(n):
        fill_sampling_row(rows, b, SamplingParams(
            temperature=0.8, top_k=8 if b % 2 else 5,
            top_p=0.9 if b % 3 else 1.0, seed=b + 1))
    return rows


def check_prng() -> dict:
    """Threefry words and Gumbel values on the card against the CPU
    port's, on the ``PRNG_SEEDS`` × ``PRNG_STEPS`` grid: equal bit for
    bit."""
    seeds = torch.tensor([s for s in PRNG_SEEDS for _ in PRNG_STEPS])
    steps = torch.tensor([n for _ in PRNG_SEEDS for n in PRNG_STEPS])
    out = {}
    for dev in ("cpu", "cuda"):
        key = threefry.fold_in(threefry.prng_key(seeds.to(dev)),
                               steps.to(dev))
        out[dev] = (key[0].cpu(), key[1].cpu(),
                    threefry.random_bits(key, CAND_K).cpu(),
                    threefry.positional_gumbel(seeds.to(dev), steps.to(dev),
                                               CAND_K).cpu())
    for name, c, g in zip(("key_hi", "key_lo", "bits", "gumbel"),
                          out["cpu"], out["cuda"]):
        if not torch.equal(c.view(-1).view(torch.uint8) if c.is_floating_point()
                           else c, g.view(-1).view(torch.uint8)
                           if g.is_floating_point() else g):
            raise AssertionError(f"PRNG {name} differs on the card")
    return dict(grid=len(seeds), words_equal=True, gumbel_equal=True)


def fleet_trace(cfg):
    """The 12-request trace of phase 4, half of it sampled
    (``fleet_sampling``)."""
    trace, prompt_cap = request_trace(FLEET, cfg)
    trace = [(t, Request(r.rid, r.prompt, r.max_new,
                         sampling=fleet_sampling(r.rid))) for t, r in trace]
    return trace, prompt_cap, max(r.max_new for _, r in trace)


def fleet_run(engines, trace, prompt_cap, max_new_cap, **kw):
    """One router run over the trace: the router, its streams, and its
    tick times (host clock; each tick reads its tokens back, so a tick's
    device work is inside it)."""
    router = Router(engines, prompt_cap=prompt_cap, max_new_cap=max_new_cap,
                    **kw)
    tick_ms, arrivals = [], sorted(trace, key=lambda ar: ar[0])
    i = 0
    while (i < len(arrivals) or not router.idle()) and router.tick < 10_000:
        now = []
        while i < len(arrivals) and arrivals[i][0] <= router.tick:
            now.append(arrivals[i][1])
            i += 1
        t0 = time.perf_counter()
        router.step(now)
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    if not router.idle():
        raise AssertionError("the fleet did not drain")
    return router, {rid: list(e.tokens)
                    for rid, e in router.journal.items()}, tick_ms


def fleet_step_ms(cfg, eng, samp) -> float:
    """The median graphed step of ``eng`` over 16 forced steps of a
    filled state (every slot sampled)."""
    rng = np.random.default_rng(SEED + 4)
    state = fill_state(FLEET, cfg, eng, eng.state, rng, samp)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (16, SLOTS))
                             .astype(np.int32), device="cuda")
    return time_steps(lambda st, t: eng.decode_fn(eng.params["serve"], st,
                                                  t, sampled=True),
                      state, forced)[2]


def fleet_phase() -> None:
    """The fleet on one card: two ``build_replicas`` replicas of full
    Llama2-7B on the fused path (B1, B2, B3) with every probe, the
    12-request trace half sampled; the fault-free run, each fault kind
    injected into replica 0 mid-trace, the single-bit sub-sweep, the
    graphed step against the eager one and the teacher-forced check at
    temperature 0.8, the PRNG on the card against the CPU.  Any failed
    check raises."""
    t_phase = time.perf_counter()
    cfg = get_config(FLEET)
    say("fleet", check="prng", **check_prng())
    samp = sampled_rows()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved = torch.cuda.memory_reserved()

    # the step with the fleet's leaves off (phase 4's engine) and on
    plain = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              options=EngineOptions(backend="pallas",
                                                    check_finite=True),
                              device="cuda", seed=SEED)
    off_ms = fleet_step_ms(cfg, plain, samp)
    del plain
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engines = build_replicas(cfg, n_replicas=FLEET_REPLICAS,
                             max_seq=MAX_SEQ, batch_global=SLOTS,
                             options=EngineOptions(**FLEET_OPTIONS),
                             device="cuda", seed=SEED)
    build_s = time.perf_counter() - t0
    want = decode_launches(cfg, "pallas")
    counted = [{k: n for k, n in e.decode_fn.launches.items() if n}
               for e in engines]
    if any(c != want for c in counted):
        raise AssertionError(f"replica graph launches {counted}, want "
                             f"{want}")
    on_ms = fleet_step_ms(cfg, engines[0], samp)
    say("fleet", replicas=FLEET_REPLICAS, build_s=round(build_s, 2),
        launches_per_step=sum(want.values()),
        step_ms_leaves_off=round(off_ms, 3),
        step_ms_leaves_on=round(on_ms, 3),
        on_over_off=round(on_ms / off_ms, 4),
        weights_gb=round(sum(tree_bytes(e.params) for e in engines) / 1e9, 3),
        kv_gb=round(sum(tree_bytes(e.state["layers"]) for e in engines)
                    / 1e9, 3))

    trace, prompt_cap, max_new_cap = fleet_trace(cfg)
    run = lambda **kw: fleet_run(engines, trace, prompt_cap,  # noqa: E731
                                 max_new_cap, **kw)
    # 1. the oracle (no probe), then the control (every probe)
    tracecount.reset()
    router, oracle, ticks_off = run()
    oracle_router = router
    replays = tracecount.replays()
    decodes = sum(r.sched.decode_calls for r in router.replicas)
    launches = tracecount.launches()
    if replays != decodes or any(
            launches[k] != n * replays for k, n in want.items()):
        raise AssertionError(f"{replays} replays and launches {launches} "
                             f"for {decodes} decode steps")
    toks = np.concatenate([oracle[r] for r in sorted(oracle)])
    if len(toks) != sum(r.max_new for _, r in trace) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError("oracle tokens missing or outside the "
                             "vocabulary")
    tracecount.reset_signals()
    tracecount.reset_probes()
    router, control, ticks_on = run(integrity=IntegrityConfig())
    signals = {k: n for k, n in tracecount.signal_totals().items() if n}
    if signals or router.detections or control != oracle:
        raise AssertionError(f"fault-free run: signals {signals}, streams "
                             f"equal {control == oracle}")
    probes = tracecount.probe_totals()
    n_probe = probes["probe_ticks"]
    probe_ms = {k: sum(r.monitor.probe_ms[k] for r in router.replicas)
                for k in ("kv", "weights", "shadow")}
    say("fleet", run="fault_free", ticks=router.tick, requests=len(trace),
        sampled=sum(1 for _, r in trace if r.sampling.temperature > 0),
        tokens=len(toks), decode_steps=decodes, replays=replays,
        commit_lag=router.commit_lag, signals=0, streams_equal=True,
        tick_ms_probes_off=round(statistics.median(ticks_off), 3),
        tick_ms_probes_on=round(statistics.median(ticks_on), 3),
        **{f"probe_{k}_ms_per_tick": round(v / n_probe, 3)
           for k, v in probe_ms.items()},
        **{f"probe_{k}_bytes_per_tick": int(probes[f"probe_bytes_{k}"]
                                            // n_probe)
           for k in ("kv", "weights", "shadow")})

    # 2. each fault kind into replica 0 mid-trace; the admit faults aim at
    # the slot of replica 0's first admit from the fault tick on (the
    # oracle run's), which carries them
    carrier = [slot for t, kind, _, slot in oracle_router.replicas[0]
               .sched.events if kind == "admit" and t >= FLEET_FAULT_TICK]
    if not carrier:
        raise AssertionError("replica 0 admits nothing after the fault tick")
    specs = [FaultSpec(k, FLEET_FAULT_TICK,
                       target=carrier[0] if k.endswith("_admit") else 0)
             for k in FAULT_KINDS]
    specs.append(FaultSpec("flip_kv_bit", FLEET_FAULT_TICK,
                           bit=FLEET_KV_BIT))
    specs += [FaultSpec("flip_weight_bit", FLEET_FAULT_TICK,
                        target=FLEET_WEIGHT_TARGET, bit=b)
              for b in FLEET_FLIP_BITS]
    for spec in specs:
        tracecount.reset_signals()
        inj = FaultInjector([spec])
        router, streams, _ = run(injectors={0: inj},
                                 integrity=IntegrityConfig())
        lat = router.detection_latency(inj)
        fired = router.detections[0]["signals"] if router.detections else []
        requeued = [e for e in router.journal.values() if e.requeues]
        row = dict(run=spec.kind, bit=spec.bit, fired_tick=inj.fired[0][1]
                   if inj.fired else None, latency=lat, signals=fired,
                   streams_equal=streams == oracle,
                   requeued=[e.rid for e in requeued],
                   recovery_ticks=router.recovery_steps(),
                   availability=round(router.availability(), 4))
        problems = []
        if len(inj.fired) != 1 or len(router.detections) != 1 \
                or router.detections[0]["replica"] != 0:
            problems.append("fired or detected other than once on replica 0")
        if streams != oracle:
            problems.append("a stream differs from the oracle")
        if tracecount.signal_totals()["detect_journal_mismatch"]:
            problems.append("a replay mismatched the journal")
        if spec.kind == "flip_weight_bit":
            heals = [e for e in router.events if e[1].startswith("heal")]
            after = [e for e in router.events if e[1] == "dispatch"
                     and e[3] == 0 and heals and e[0] >= heals[0][0]]
            row.update(heal_ms=[round(h, 1) for h in router.heal_ms],
                       dispatched_after_heal=len(after))
            if not WEIGHT_SIGNALS & set(fired) or not 0 <= lat[0] \
                    <= router.commit_lag:
                problems.append("weight flip not detected in the window")
            if [e[1] for e in heals] != ["heal"] \
                    or router.replicas[0].monitor.verify_weights_full() \
                    or not router.replicas[0].alive or not after:
                problems.append("no heal, rejoin and service after it")
        else:
            if FLEET_SIGNAL[spec.kind] not in fired or lat[0] not in (0, 1):
                problems.append(f"want {FLEET_SIGNAL[spec.kind]} within "
                                "one tick")
        if spec.kind == "kill" and not any(
                e.sampling.temperature > 0 and e.replicas[-1] == 1
                for e in requeued):
            problems.append("no sampled request moved to replica 1")
        say("fleet", **row)
        if problems:
            raise AssertionError(f"{spec}: {problems}")

    # 3. the single-bit sub-sweep
    t0 = time.perf_counter()
    cells = run_sdc_sweep(engines, prompts=[r.prompt for _, r in trace],
                          max_new=FLEET_SWEEP_NEW, prompt_cap=prompt_cap,
                          sweep=FaultSweep(bits=FLEET_SWEEP_BITS),
                          icfg=IntegrityConfig(),
                          sampling=[r.sampling for _, r in trace])
    for line in format_coverage(cells).splitlines():
        print("  " + line)
    ff = cells.pop("fault_free")
    bad = [k for k, c in cells.items() if c["detected_pct"] != 100.0
           or c["oracle_exact_pct"] != 100.0
           or (k.startswith("flip_kv_bit") and c["detect_steps"] > 1)]
    if ff["false_positive_signals"] or ff["streams_match"] != 1.0 or bad \
            or len(cells) != 2 * len(FLEET_SWEEP_BITS):
        raise AssertionError(f"sub-sweep: {ff} {bad}")
    say("fleet", run="sub_sweep", cells=len(cells), detected_pct=100.0,
        oracle_exact_pct=100.0, probe_bytes_per_tick=int(
            ff["probe_bytes_per_tick"]),
        seconds=round(time.perf_counter() - t0, 1))

    # 4. graphed against eager at temperature 0.8, every leaf on
    graph = engines[0].decode_fn
    vs_eager = graph_vs_eager(FLEET, cfg, engines[0], samp=samp)
    if sum(graph.launches.values()) != sum(want.values()):
        raise AssertionError(f"graph launches {graph.launches}")
    say("fleet", check="graph_vs_eager", temperature=0.8,
        leaves=",".join(n for n in ("work_blocks", "kv_fp", "head_resid",
                                    "head_val", "head_tok", "nonfinite")
                        if n in engines[0].state),
        launches_per_replay=sum(graph.launches.values()),
        **{k: vs_eager[k] for k in ("steps", "tokens_equal", "state_equal",
                                    "graph_median_step_ms",
                                    "eager_median_step_ms")})

    # 5. teacher-forced at temperature 0.8: kernels against plain, and
    # the unfused path (on replica 0's weights) against the fused one
    forced, fused_toks, fused_cands = forced_decode(FLEET, cfg, engines[0],
                                                    samp=samp)
    unfused = build_engine_full(
        cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
        options=EngineOptions(backend="xla", check_finite=True),
        device="cuda", train_params=engines[0].params["train"])
    u_forced, u_toks, u_cands = forced_decode(FLEET, cfg, unfused,
                                              samp=samp)
    vs_fused = sampled_agreement("unfused vs fused", u_toks, fused_toks,
                                 u_cands, fused_cands)
    say("fleet", check="forced", temperature=0.8,
        **{f"kernels_vs_plain_{k}": v for k, v in forced.items()
           if k not in ("steps", "slots")},
        **{f"unfused_kernels_vs_plain_{k}": v for k, v in u_forced.items()
           if k not in ("steps", "slots")},
        unfused_vs_fused_agreement=round(
            float(np.mean(u_toks == fused_toks)), 4),
        **{f"unfused_vs_fused_{k}": v for k, v in vs_fused.items()})
    del unfused, engines, graph, router, oracle_router, run
    say("fleet", peak_allocated_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 3),
        seconds=round(time.perf_counter() - t_phase, 1))
    check_released(reserved)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = [(path, path_config(path), backend) for path, backend in PATHS]

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)))
    # the model axis (launch/mesh.py) runs on one rank a GPU under NCCL,
    # which refuses two ranks on one device; gloo has no send or receive
    # of CUDA tensors: above 1 it is checked on the CPU's gloo processes
    # (tests/test_torch_model_axis.py), and here at 1, with one rank's
    # shapes of 4 and 8 GPUs held check-only in phase 3
    say("mesh", model_axis=1, data_axis=1,
        cards=torch.cuda.device_count(),
        why="one card: NCCL takes one rank a GPU; the model axis above 1 "
            "runs on gloo on the CPU, and its per-rank kernel shapes are "
            "checked in phase 3")

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
    cases = [case for path, cfg, backend in paths
             for case in kernel_cases(path, cfg, backend)]
    for case in cases:
        case.setdefault("stage", "decode")
        case["max_abs_err"] = check_kernel(case)
        say("kernel", name=case["name"], path=case["path"],
            backend=case["backend"], stage=case["stage"], ok=True,
            max_abs_err=f"{case['max_abs_err']:.3e}")
        # no phase 6 row for a check-only case; the others wait for phase 6
        # in host memory (Gemma-2's engine leaves no room for them)
        case.pop("s0s", None)
        case.pop("h0s", None)
        args = case.pop("args")
        if not case.get("check_only"):
            case["host_args"] = {k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in args.items()}
        del args

    # a cluster across devices: n shards' launches merged, against one
    shard_merge_phase()
    # the model axis: a layer's rank slices, run in turn, against the layer
    mesh_merge_phase()

    # the host's cost of a graph launch before any profiler trace (a
    # trace leaves the host's graph launches slower for the rest of the
    # process); timed again in phase 6
    floor_graph = empty_graph(FLOOR_NODES)
    host_untraced = launch_host_ms(floor_graph)
    # 4. each path served at full width through its graph, one engine at
    # a time, before any profiler trace
    counts, peers = {}, {}
    for path, cfg, backend in paths:
        key = (path, backend)
        counts[key], peers[key] = serve_path(path, cfg, backend, peers)

    # the fleet: two replicas behind the router, every fault kind; before
    # phase 5's traces, which slow every later graph launch on the host
    fleet_phase()

    # 5. each path again: kernels against plain versions end to end, and
    # the traced replays
    for path, cfg, backend in paths:
        key = (path, backend)
        peers[key]["forced"] = check_path(path, cfg, backend, counts[key],
                                          peers)

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
        case["args"] = {k: v.to("cuda") if torch.is_tensor(v) else v
                        for k, v in case.pop("host_args").items()}
        args, kw = case["args"], case["kw"]
        launches, per_step = counts[case["path"], case["backend"]][
            case["stage"]]
        library_ms, extra = None, {}
        if case["name"] == "flash_decode":
            lib = library_call(case)
            # the library call computes the same function without a
            # softcap: live slots agree with the kernel's uncapped one
            # (its length-0 rows are NaN)
            live = args["cache_len"] > 0
            capped = kw["attn_softcap"] > 0
            close_bf16("sdpa", lib()[:, :, 0][live],
                       case["fn"](**args, **dict(kw, attn_softcap=0.0))[live])
            lib_ms = round(cuda_ms(lib, 20)[0], 4)
            extra = dict(library="F.scaled_dot_product_attention on the "
                         "cache as permuted views, no copy outside the "
                         "call")
            if capped:
                # it has no softcap: a yardstick, not the same function
                extra.update(library_nocap_ms=lib_ms)
            else:
                library_ms = lib_ms
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
        del case["args"], args
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
