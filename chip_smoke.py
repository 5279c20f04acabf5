#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` with
``nvcc`` and then, one line per phase:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds B1–B3 (``fused_decode``, ``fused_ffn``, ``fused_head``);
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (Llama2-7B widths, 8 slots, bf16, ragged
   cache lengths including −1, 0 and 1): bf16 outputs to 2e-2 in f32,
   head candidates to exact indices and values within 4 f32 ulps;
4. serves a staggered 12-request trace through ``SlotScheduler`` on
   the full-width Llama2-7B (32 layers, seeded random bf16 weights,
   8 slots, ``max_seq`` 1024) and checks that every decode step made
   exactly ``L`` launches of B1, ``L`` of B2 and one of B3 (``2·L + 1``)
   and no launch fell outside a step, that every token lies in the
   vocabulary and that every residual row stayed finite;
5. runs teacher-forced decode steps of the same model once through the
   kernels and once through their plain versions, and requires their
   greedy tokens to agree on at least 90 % of (step, slot); then traces
   a few decode steps with ``torch.profiler`` for the device time per
   kernel and the device's idle share;
6. times each kernel and its plain version beside its bound (device
   time per call: CUDA events around back-to-back calls queued behind a
   spin kernel, median after warm-up; ``call_ms`` is one call with its
   host work), and prints them as one JSON ``kernels`` line with each
   kernel's launches per step as phase 4 counted them.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits nonzero; without a CUDA device it exits nonzero
before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tracecount  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_decode.fused_decode import (  # noqa: E402
    fused_decode_attention, fused_decode_plain, rope_at)
from repro_torch.kernels.fused_ffn.fused_ffn import (  # noqa: E402
    fused_ffn_block, fused_ffn_plain)
from repro_torch.kernels.fused_head.fused_head import (  # noqa: E402
    fused_head_block, fused_head_plain)
from repro_torch.launch.serve import build_engine_full  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    KERNELS, PLAIN_KERNELS, EngineOptions, Kernels, decode_step,
    init_decode_state)
from repro_torch.serving.scheduler import (  # noqa: E402
    Request, SlotScheduler, replay_trace)

ARCH = "llama2-7b"
SLOTS = 8
MAX_SEQ = 1024
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor rate
BF16_TOL = 2e-2                # bf16 inputs: a value on a rounding
                               # boundary may round the other way under
                               # another summation order
HEAD_ULPS = 4                  # head values: f32 summation order only
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


def bound(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3 inputs: one layer's operands at the main path's shapes
# ---------------------------------------------------------------------------
def kernel_cases(cfg):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    B, D, S = SLOTS, cfg.d_model, MAX_SEQ
    nq, nkv, hd, F, V = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                         cfg.d_ff, cfg.vocab_size)
    P = (nq + 2 * nkv) * hd
    lens = torch.tensor([-1, 0, 1, 127, 300, 513, 777, S - 1],
                        dtype=torch.int32, device="cuda")
    s_idx = torch.arange(S, dtype=torch.int32, device="cuda")[:, None]
    # stale entries past each live prefix: the kernel must skip them
    pos = torch.where(s_idx < lens[None, :] + 40, s_idx, -1).to(torch.int32)
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
    dec_kw = dict(q_heads=nq, kv_heads=nkv, scale=hd ** -0.5,
                  norm_eps=cfg.norm_eps)
    ffn = dict(x=randn(gen, (B, D), 1.0), a=randn(gen, (B, D), 1.0),
               w_in=randn(gen, (D, F), D ** -0.5),
               w_gate=randn(gen, (D, F), D ** -0.5),
               w_out=randn(gen, (F, D), F ** -0.5),
               ln2=randn(gen, (D,), 0.1, torch.float32))
    table = randn(gen, (V, D), D ** -0.5)
    x_head = randn(gen, (B, D), 1.0)
    # a tie across the first and the last vocab tile, at the top of
    # slot 0's candidates: the lower index must come first
    table[100] = torch.sign(x_head[0]).to(torch.bfloat16) * 0.05
    table[V - 1] = table[100]
    head = dict(x=x_head, table=table,
                ln=torch.zeros((D,), dtype=torch.float32, device="cuda"))

    live = int(lens.clamp(min=0).sum())
    dec_bytes = (B * D * 2 + D * P * 2 + nq * hd * D * 2 + D * 4
                 + 2 * live * nkv * hd * 2 + live * 4 + B * 4 * (2 + hd)
                 + B * nq * D * 4 + 2 * B * nkv * hd * 2 + 2 * B * nq * 4)
    dec_ops = 2 * B * D * P + 4 * live * nq * hd + 4 * B * nq * hd \
        + 2 * B * nq * hd * D
    ffn_bytes = 4 * B * D * 2 + 3 * D * F * 2 + D * 4
    ffn_ops = 2 * B * D * F * 3
    head_bytes = B * D * 2 + V * D * 2 + D * 4 + B * 8 * 8
    head_ops = 2 * B * D * V
    return [
        dict(name="fused_decode", fn=fused_decode_attention,
             plain=fused_decode_plain, args=dec, kw=dec_kw,
             cost=(dec_bytes, dec_ops),
             replaces="src/repro/kernels/fused_decode/fused_decode.py:276"),
        dict(name="fused_ffn", fn=fused_ffn_block, plain=fused_ffn_plain,
             args=ffn, kw=dict(add_r=1.0, eps=cfg.norm_eps),
             cost=(ffn_bytes, ffn_ops),
             replaces="src/repro/kernels/fused_ffn/fused_ffn.py:105"),
        dict(name="fused_head", fn=fused_head_block, plain=fused_head_plain,
             args=head, kw=dict(eps=cfg.norm_eps, k=8),
             cost=(head_bytes, head_ops),
             replaces="src/repro/kernels/fused_head/fused_head.py:97"),
    ]


def check_kernel(case) -> float:
    got = case["fn"](**case["args"], **case["kw"])
    want = case["plain"](*case["args"].values(), **case["kw"])
    torch.cuda.synchronize()
    name = case["name"]
    if name == "fused_head":
        return close_head(name, got, want)
    errs = [close_bf16(f"{name}[{i}]", g, w)
            for i, (g, w) in enumerate(zip(got, want))]
    return errs[0]


# ---------------------------------------------------------------------------
# Phase 4: the staggered request trace at full width
# ---------------------------------------------------------------------------
def serve_trace(cfg, eng):
    rng = np.random.default_rng(SEED)
    n_req = 12
    arrivals = np.sort(rng.integers(0, 16, n_req))
    trace = [(int(arrivals[i]), Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 513))).tolist(),
        max_new=int(rng.integers(8, 65)))) for i in range(n_req)]
    step_launches, step_ms = [], []
    dec = eng.decode_fn

    def counted_decode(p, st, tok):
        before = tracecount.launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        nxt, st = dec(p, st, tok)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        after = tracecount.launches()
        step_launches.append({k: after[k] - before[k] for k in after})
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
    want = dict(fused_decode=cfg.n_layers, fused_ffn=cfg.n_layers,
                fused_head=1)
    bad = [(i, n) for i, n in enumerate(step_launches) if n != want]
    if bad or not step_launches:
        raise AssertionError(f"launches per decode step {bad[:4]}, want "
                             f"{want} on each of {len(step_launches)} steps")
    if any(v == 0 for v in launches.values()):
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
                readmits=refills,
                launches_per_step=sum(per_kernel.values()),
                median_step_ms=round(statistics.median(step_ms), 3),
                wall_s=round(wall, 2)), launches, per_kernel, results


# ---------------------------------------------------------------------------
# Phase 5: kernels against their plain versions, end to end
# ---------------------------------------------------------------------------
def forced_decode(cfg, eng, steps: int = 8):
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(32, 513, SLOTS).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (SLOTS, 512)).astype(np.int32)
    state = init_decode_state(cfg, eng.scfg, device="cuda")
    _, state = eng.admit_fn(eng.params["train"], state, toks, lens)
    twin = {k: (v.clone() if torch.is_tensor(v) else
                {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else [type(c)(*(t.clone() for t in c)) for c in v])
            for k, v in state.items()}
    forced = rng.integers(0, cfg.vocab_size, (steps, SLOTS)).astype(np.int32)

    def run(kernels, st):
        cands = []

        def head(*a, **k):
            out = kernels.head(*a, **k)
            cands.append(out)
            return out

        ks = Kernels(kernels.decode, kernels.ffn, head)
        for t in range(steps):
            _, st = decode_step(cfg, eng.scfg, eng.params["serve"], st,
                                torch.as_tensor(forced[t], device="cuda"),
                                kernels=ks)
        return cands, st

    (got, state), (want, _) = run(KERNELS, state), run(PLAIN_KERNELS, twin)
    agree = np.mean([torch.equal(g[1][b, 0], w[1][b, 0])
                     for g, w in zip(got, want) for b in range(SLOTS)])
    gap = max(float((g[0][:, 0] - w[0][:, 0]).abs().max())
              for g, w in zip(got, want))
    if agree < 0.9:
        raise AssertionError(f"kernel vs plain token agreement {agree}")
    return dict(steps=steps, slots=SLOTS, agreement=round(float(agree), 4),
                max_logit_gap=f"{gap:.3e}"), state


# ---------------------------------------------------------------------------
# Where a decode step's device time goes (a separate, traced run)
# ---------------------------------------------------------------------------
GROUPS = (("fused_decode", ("fused_decode_kernel",)),
          ("fused_ffn", ("ffn_tile_kernel", "ffn_reduce_kernel")),
          ("fused_head", ("head_tile_kernel", "head_merge_kernel")))


def profile_steps(cfg, eng, state, steps: int = 4):
    """Device time per decode step by kernel, and the share of the
    traced window in which no kernel or copy ran.  The profiler's own
    host cost inflates that idle share; the untraced step time is
    phase 4's."""
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
        return dict(device_time="not measured (no device events traced)")
    busy, end = 0.0, spans[0][0]
    per = {name: 0.0 for name, _ in GROUPS}
    per["other"] = 0.0
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        group = next((g for g, keys in GROUPS
                      if any(k in name for k in keys)), "other")
        per[group] += t1 - t0
    window = end - spans[0][0]
    out = {f"{g}_ms_per_step": round(v / steps / 1e3, 3)
           for g, v in per.items()}
    out.update(window_ms_per_step=round(window / steps / 1e3, 3),
               idle_share=round(1.0 - busy / window, 4))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. each kernel against its plain version at the main path's shapes
    cases = kernel_cases(cfg)
    for case in cases:
        case["max_abs_err"] = check_kernel(case)
        say("kernel", name=case["name"], ok=True,
            max_abs_err=f"{case['max_abs_err']:.3e}")

    # 4. serving at full width
    t0 = time.perf_counter()
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            options=EngineOptions(check_finite=True),
                            device="cuda", seed=SEED)
    torch.cuda.synchronize()
    say("engine", build_s=round(time.perf_counter() - t0, 1),
        weights_gb=round(tree_bytes(eng.params) / 1e9, 3),
        kv_gb=round(tree_bytes(eng.state["layers"]) / 1e9, 3),
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    serve, launches, per_step, results = serve_trace(cfg, eng)
    # the floor of a step: every weight byte read once at the HBM rate
    blk, head = eng.params["serve"]["blocks"][0], eng.params["serve"]["head"]
    weight_bytes = sum(t.numel() * t.element_size() for t in (
        blk["attn"].wqkv, blk["attn"].wo, blk["ffn"].w_in,
        blk["ffn"].w_gate, blk["ffn"].w_out, head.table))
    serve["step_weights_gb"] = round(weight_bytes / 1e9, 3)
    serve["weights_bound_ms"] = round(1e3 * weight_bytes / HBM_BYTES_PER_S, 3)
    say("serve", **serve)
    say("serve", first_tokens={r: res.tokens[:4]
                               for r, res in sorted(results.items())[:3]})

    # 5. kernels against plain versions, end to end; then a traced run
    forced, state = forced_decode(cfg, eng)
    say("forced", **forced)
    say("profile", **profile_steps(cfg, eng, state))
    del eng
    torch.cuda.empty_cache()

    # 6. times beside the bounds
    rows = []
    for case in cases:
        args, kw = case["args"], case["kw"]
        ms, covered = cuda_ms(lambda: case["fn"](**args, **kw), 20)
        # the plain versions may sync with the host: their time is
        # whatever the device waits, host gaps included
        plain_ms, _ = cuda_ms(lambda: case["plain"](*args.values(), **kw), 5)
        one_call = call_ms(lambda: case["fn"](**args, **kw), 20)
        bound_ms, bound_by = bound(*case["cost"])
        rows.append(dict(
            name=case["name"], route="cuda",
            source=f"src/repro_torch/csrc/{case['name']}.cu",
            replaces=case["replaces"], launches=launches[case["name"]],
            launches_per_step=per_step[case["name"]],
            max_abs_err=case["max_abs_err"], ms=round(ms, 4),
            plain_ms=round(plain_ms, 4), bound_ms=round(bound_ms, 4),
            bound_by=bound_by, library_ms=None,
            call_ms=round(one_call, 4),
            queued_under_spin=covered))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
