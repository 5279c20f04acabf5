"""Serving entry points — the port of ``repro/launch/serve.py`` on one GPU.

:func:`build_engine_full` makes the weights (seeded random, on the
device, or carried over from the reference with
``models/transformer.py:from_reference_params``), resolves the backend
and the prepack as the reference does (``core/autotune.py``: the
unfused ``"xla"`` path by default, ``"auto"`` → the fused ``"pallas"``
kernels for attention models), builds the serve tree once (the
prepacked layout on ``"pallas"``, the train tree itself on ``"xla"``),
allocates the decode state and returns the steps a serving loop
drives: ``prefill_fn``/``decode_fn`` for lockstep batches
(:func:`generate`) and ``admit_fn``/``retire_fn`` for continuous
batching (``serving/scheduler.py``).  On the card ``decode_fn`` is one
CUDA-graph replay of the step, captured here on the engine's state
(``serving/step_graph.py``, the counterpart of the reference's jitted
step); the CPU runs the eager step, and so does :func:`decode_step`
called directly on the card.  Models with recurrent layers
(RWKV-6, RecurrentGemma's RG-LRU) are served lockstep only: their
``admit_fn`` raises, as the reference's does (a recurrent state cannot
take a per-slot insert).  MoE models (DeepSeek-V2-Lite as registered)
are served lockstep too: their ``admit_fn`` runs, as the reference's
does, but ``serving/scheduler.py:SlotScheduler`` refuses them (the
experts' capacity couples the slots).  The modality models
(SeamlessM4T-medium, InternVL2-2B) are served lockstep: ``prefill_fn``
and :func:`generate` take the stub frontend's embeddings with the
prompts, the encoder-decoder's ``admit_fn`` raises (its encoder's k/v
are the whole batch's, as the reference's prefill asserts), a VLM's
raises for want of the embeddings (the reference's admit passes none),
and ``SlotScheduler`` refuses both, as the reference asserts.

On a mesh (``mesh=``, ``launch/mesh.py``: ``data × model`` processes,
each calling :func:`build_engine_full` with the same arguments) the
engine is the reference's ``build_engine_full(cfg, mesh, …)``
(``launch/serve.py:121``): the layout is the reference's pick
(``launch/specs.py:serving_layout``: heads over the model axis, or a
cluster across devices that splits the KV sequence) or
``EngineOptions(cluster=n)``'s ``Layout(ms, ms // n)``, each process
holds its model rank's slice of the weights
(made from ``seed`` as the whole model would be, or ``train_params``
given as that slice) and the decode state of its data rank's
``batch_global / data`` slots, and every step takes and returns the
GLOBAL tokens on every process (its rows in, the data axis gathered
out), so a serving loop makes the same host decisions on every rank.
Every registered model serves so — the recurrent ones (RWKV-6,
RecurrentGemma) and the modality ones (``prefill_fn`` and
:func:`generate` take the global frontend embeddings, each process its
rows) too.  Above a model axis of 1 the decode step runs eagerly: no
CUDA graph is captured around the collectives.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import primitives as prim
from repro_torch.core.autotune import resolve_serving
from repro_torch.core.device import resolve_device
from repro_torch.launch.specs import ctx_for, serving_layout
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.transformer import Layout, init_params
from repro_torch.serving.engine import (EngineOptions, ServeConfig,
                                        decode_step, init_decode_state)
from repro_torch.serving.integrity import weight_leaves
from repro_torch.serving.prefill import prefill
from repro_torch.serving.prepack import (prepack_for_serving,
                                         share_packed_qkv)
from repro_torch.serving.sampling import (host_sampling_rows,
                                          reset_sampling_state)
from repro_torch.serving.step_graph import StepGraph


class EngineHandle(NamedTuple):
    """Everything a serving loop needs.  ``params`` is the ``{"train",
    "serve"}`` pair (on ``"pallas"`` the serve tree aliases every train
    tensor but MLA's folded ``wproj``, the train tree's ``wq``, ``wk``
    and ``wv`` being views of the packed ``wqkv``; on ``"xla"`` it is the
    train tree).

    * ``prefill_fn(params["train"], state, tokens [B, S], fe=None)`` —
      ``fe [B, P, F]``, the frontend's embeddings of a modality model;
    * ``decode_fn(params["serve"], state, tokens [B], sampled=False)`` —
      on the card a :class:`~repro_torch.serving.step_graph.StepGraph`,
      bound to ``params["serve"]`` and to ``state``'s caches;
      ``sampled``: some live slot has temperature > 0 (otherwise every
      slot takes its first candidate);
    * ``admit_fn(params["train"], state, tokens [B, S_cap], lengths [B],
      samp=None)`` — targeted prefill-insert of the slots with
      ``lengths[b] > 0`` (attention models; raises on recurrent layers);
    * ``retire_fn(state, mask [B])`` — frees the masked slots;
    * ``repack_fn(params["train"])`` — the heal (``serving/router.py``):
      writes clean bits back into every serve tensor, in place (the
      graph is bound to them), and returns ``params["serve"]`` itself;
      ``None`` on an engine built from ``train_params``, which has no
      seed to re-make them from.

    Every step returns ``(tokens, new state)``; the KV caches and
    recurrent states inside are shared with (and updated in place from)
    the state passed in.  On a mesh the tokens, lengths, masks and
    sampling rows are the global ``batch_global`` rows, ``state`` the
    process's own slots; ``to_global`` takes a ``[B_loc]`` state leaf to
    the global ``[batch_global]`` on every process (the identity off a
    mesh); ``ctx`` holds the process's mesh axes."""
    params: Any
    prefill_fn: Callable
    decode_fn: Callable
    admit_fn: Callable
    retire_fn: Callable
    state: Any
    scfg: ServeConfig
    cfg: ModelConfig
    batch_global: int
    repack_fn: Optional[Callable] = None
    to_global: Callable = lambda t: t
    ctx: ParallelCtx = SINGLE


def build_engine_full(cfg: ModelConfig, *, max_seq: int, batch_global: int,
                      options: Optional[EngineOptions] = None,
                      device="cuda", seed: int = 0,
                      train_params: Optional[dict] = None,
                      mesh=None) -> EngineHandle:
    """Build the serving steps for ``cfg`` on ``device`` (default CUDA;
    raises when no card is present and the CPU was not asked for).

    ``options.backend``/``options.prepack`` resolve as in the reference
    (``core/autotune.py``); ``"pallas"`` with prepack off raises
    ``NotImplementedError`` naming its ROADMAP item.
    Prefill does not depend on the backend.  ``train_params``:
    train-layout weights to serve (e.g. from ``from_reference_params``);
    default: :func:`init_params` from ``seed``.  On a CUDA device
    ``decode_fn`` is the step captured in a graph; on the CPU it is the
    eager step.  ``mesh``: serve on a ``data × model`` mesh (every process
    of its world calls this together; ``device`` is the mesh's, and
    ``train_params`` this process's model rank's slice)."""
    opt = options or EngineOptions()
    backend, prepack = resolve_serving(cfg, opt.backend, opt.prepack)
    lay, ctx, b_loc, d0 = Layout(), SINGLE, batch_global, 0
    if mesh is None:
        dev = resolve_device(device)
        if opt.cluster not in (None, 1):
            raise ValueError(f"a serve cluster of {opt.cluster} spans "
                             "devices: it needs a mesh (mesh=...)")
    else:
        dev = mesh.device
        ms = mesh.shape["model"]
        lay = serving_layout(cfg, ms, seq_len=max_seq, batch=batch_global,
                             cluster=opt.cluster)
        ctx = ctx_for(mesh, lay, fused_combine=opt.fused_combine)
        dp = mesh.shape["data"]
        if batch_global % dp == 0 and batch_global >= dp:
            b_loc = batch_global // dp
            d0 = ctx.data_index() * b_loc
    sharded = b_loc != batch_global

    def local(rows):
        """This process's rows of a global ``[batch_global, …]`` input."""
        return rows[d0:d0 + b_loc] if sharded else rows

    def to_global(t):
        return (prim.cluster_gather_xla(t, mesh.axes["data"], dim=0)
                if sharded else t)

    def fresh_params():
        return init_params(cfg, seed=seed, device=dev, lay=lay,
                           rank=ctx.model_index())

    train = train_params if train_params is not None else fresh_params()
    serve = train
    if prepack:
        serve = prepack_for_serving(cfg, train, backend=backend, ctx=ctx)
        train = share_packed_qkv(train, serve)
    params = {"train": train, "serve": serve}
    scfg = ServeConfig(max_seq=max_seq, batch_local=b_loc,
                       heads_size=ctx.heads_size,
                       cluster_size=ctx.cluster_size, backend=backend,
                       prepack=prepack,
                       check_finite=opt.check_finite,
                       track_work=opt.track_work,
                       kv_fingerprint=opt.kv_fingerprint,
                       shadow_head=opt.shadow_head)
    state = init_decode_state(cfg, scfg, device=dev)

    def prefill_fn(p, st, tokens, fe=None):
        nxt, st = prefill(cfg, scfg, p, st, local(tokens),
                          None if fe is None else local(fe), ctx=ctx)
        return to_global(nxt), st

    if dev.type == "cuda" and ctx.model is None:
        step = StepGraph(cfg, scfg, serve, state)
    else:                   # above model axis 1 no graph: collectives
        def step(p, st, tokens, sampled=False):
            return decode_step(cfg, scfg, p, st, tokens, sampled=sampled,
                               ctx=ctx)

    def decode_fn(p, st, tokens, sampled=False):
        nxt, st = step(p, st, local(tokens), sampled)
        return to_global(nxt), st

    def admit_fn(p, st, tokens, lengths, samp=None):
        if samp is None:
            samp = host_sampling_rows(batch_global)
        nxt, st = prefill(cfg, scfg, p, st, local(tokens),
                          lengths=local(lengths),
                          sampling={k: local(v) for k, v in samp.items()},
                          ctx=ctx)
        return to_global(nxt), st

    def retire_fn(st, mask):
        m = torch.as_tensor(local(np.asarray(mask)), device=dev) > 0
        new = dict(st)
        new["cache_lens"] = torch.where(
            m, torch.tensor(-1, dtype=torch.int32, device=dev),
            st["cache_lens"])
        new["sampling"] = reset_sampling_state(st["sampling"], m)
        if "nonfinite" in st:        # a retired slot's sentinel clears
            new["nonfinite"] = torch.where(m, 0, st["nonfinite"])
        return new

    def repack_fn(train_tree):
        # the replica's own construction, re-run on its device: the same
        # seed makes the same bits (which is what makes replicas alike);
        # the train tree aliases the serve tensors, so it heals with them
        fresh = fresh_params()
        if prepack:
            fresh = prepack_for_serving(cfg, fresh, backend=backend, ctx=ctx)
        with torch.no_grad():
            for (_, live), (_, clean) in zip(weight_leaves(serve),
                                             weight_leaves(fresh)):
                live.copy_(clean)
        return serve

    return EngineHandle(params, prefill_fn,
                        step if mesh is None else decode_fn, admit_fn,
                        retire_fn, state, scfg, cfg, batch_global,
                        repack_fn if train_params is None else None,
                        to_global, ctx)


def build_replicas(cfg: ModelConfig, *, n_replicas: int, max_seq: int,
                   batch_global: int, options: Optional[EngineOptions] = None,
                   device="cuda", seed: int = 0):
    """``n_replicas`` engines for the fleet router (``launch/serve.py:316``
    of the reference), each made from the same ``seed``, so any replica
    emits the same stream for a given prefix, sampling params and emit
    offset — what reconstructive recovery rests on.  ``check_finite``,
    ``kv_fingerprint`` and ``shadow_head`` default on here, as the
    reference's do."""
    if options is None:
        options = EngineOptions(check_finite=True, kv_fingerprint=True,
                                shadow_head=True)
    return [build_engine_full(cfg, max_seq=max_seq,
                              batch_global=batch_global, options=options,
                              device=device, seed=seed)
            for _ in range(n_replicas)]


def generate(params, pf, dec, state, prompts, n_new: int, fe=None):
    """prompts ``[B, S]`` (and a modality model's frontend embeddings
    ``fe [B, P, F]``) → greedy tokens ``[B, n_new]`` and the state: a
    lockstep batch, one prefill of every slot and ``n_new − 1`` decode
    steps (the reference's ``generate``; the one serving loop of the
    recurrent, the MoE and the modality models)."""
    nxt, state = pf(params["train"], state, prompts, fe)
    out = [nxt]
    for _ in range(n_new - 1):
        nxt, state = dec(params["serve"], state, nxt)
        out.append(nxt)
    return torch.stack(out, dim=-1), state


def main(argv=None) -> int:
    """Continuous batching from the command line — the port's counterpart
    of ``examples/serve_requests.py``, with its flags and
    ``--temperature``/``--top-k``/``--top-p`` (every other request
    sampled, seed = its id) and ``--device``.  One replica: the slot
    scheduler over a staggered trace.  ``--replicas N`` (implied by
    ``--fault`` and ``--sweep``): the router over N replicas, a
    fault-free oracle run, then ``--fault KIND`` injected into replica 0
    at ``--fault-step`` (the ``flip_*`` kinds at ``--bit``, with every
    integrity probe on) and each stream checked against the oracle;
    ``--sweep`` prints the single-bit coverage matrix.  The model is the
    full-size config on the card; ``--reduced`` takes the tests' size
    (use it with ``--device cpu``)."""
    import argparse
    import time

    from repro_torch.configs import get_config, reduced
    from repro_torch.serving.sampling import GREEDY, SamplingParams
    from repro_torch.serving.scheduler import (Request, SlotScheduler,
                                               replay_trace)

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-cap", type=int, default=12)
    ap.add_argument("--backend", default="xla",
                    choices=("xla", "pallas", "auto"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-step", type=int, default=2)
    ap.add_argument("--bit", type=int, default=7)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-bits", default="0,7,14")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.moe is not None:                 # the dense-MLA arm
        import dataclasses
        cfg = dataclasses.replace(cfg, moe=None)
    if args.fault is not None or args.sweep:
        args.replicas = max(args.replicas, 2)
    max_new_cap = 12
    rng = np.random.default_rng(args.seed)
    trace = []
    for rid in range(args.requests):
        plen = int(rng.integers(2, args.prompt_cap + 1))
        sp = (SamplingParams(temperature=args.temperature, top_k=args.top_k,
                             top_p=args.top_p, seed=rid)
              if args.temperature > 0 and rid % 2 else GREEDY)
        trace.append((int(rng.integers(0, 4)), Request(
            rid, [int(t) for t in rng.integers(1, cfg.vocab_size, plen)],
            int(rng.integers(2, max_new_cap + 1)), sampling=sp)))
    opts = EngineOptions(backend=args.backend, check_finite=True,
                         track_work=True, kv_fingerprint=True,
                         shadow_head=True)
    max_seq = args.prompt_cap + max_new_cap + 8
    if args.replicas == 1:
        eng = build_engine_full(cfg, max_seq=max_seq,
                                batch_global=args.slots, options=opts,
                                device=args.device, seed=args.seed)
        sched = SlotScheduler(eng, prompt_cap=args.prompt_cap)
        t0 = time.perf_counter()
        results = replay_trace(sched, trace)
        print(f"drained {args.requests} requests over {sched.tick} ticks "
              f"({sched.decode_calls} decode steps) in "
              f"{time.perf_counter() - t0:.2f}s; per-slot attend blocks "
              f"{sched.work_blocks().tolist()}")
        for rid, r in sorted(results.items()):
            print(f"req {rid}: slot {r.slot} ticks [{r.admit_tick}, "
                  f"{r.finish_tick}] temperature {r.sampling.temperature} "
                  f"tokens {r.tokens}")
        return 0

    from repro_torch.serving.faults import (ALL_FAULT_KINDS,
                                            BIT_FAULT_KINDS, FaultInjector,
                                            FaultSpec, FaultSweep)
    from repro_torch.serving.integrity import IntegrityConfig
    from repro_torch.serving.router import Router
    from repro_torch.serving.sweep import format_coverage, run_sdc_sweep
    engines = build_replicas(cfg, n_replicas=args.replicas, max_seq=max_seq,
                             batch_global=args.slots, options=opts,
                             device=args.device, seed=args.seed)
    icfg = IntegrityConfig(weight_leaves_per_tick=4)
    print(f"fleet: {args.replicas} replicas of {cfg.name}, "
          f"{args.requests} requests")
    if args.sweep:
        bits = (tuple(range(16)) if args.sweep_bits == "all"
                else tuple(int(b) for b in args.sweep_bits.split(",")))
        t0 = time.perf_counter()
        cells = run_sdc_sweep(
            engines, prompts=[q.prompt for _, q in trace], max_new=6,
            prompt_cap=args.prompt_cap,
            sweep=FaultSweep(bits=bits, steps=(args.fault_step,),
                             seed=args.seed),
            icfg=icfg, sampling=[q.sampling for _, q in trace])
        print(format_coverage(cells))
        print(f"sweep drained in {time.perf_counter() - t0:.2f}s")
        return 0

    def run(injectors=None, integrity=None):
        router = Router(engines, prompt_cap=args.prompt_cap,
                        max_new_cap=max_new_cap, injectors=injectors,
                        integrity=integrity)
        return router, router.run(trace)

    _, oracle = run()
    if args.fault is None:
        for rid, e in sorted(oracle.items()):
            print(f"req {rid}: replicas {e.replicas} ticks "
                  f"[{e.submit_tick}, {e.finish_tick}] tokens {e.tokens}")
        return 0
    if args.fault not in ALL_FAULT_KINDS:
        raise SystemExit(f"--fault must be one of {ALL_FAULT_KINDS}")
    bit = args.bit if args.fault in BIT_FAULT_KINDS else -1
    inj = FaultInjector([FaultSpec(args.fault, step=args.fault_step,
                                   target=0, seed=args.seed, replica=0,
                                   bit=bit)])
    router, journal = run({0: inj}, integrity=icfg)
    for d in router.detections:
        print(f"tick {d['tick']}: replica {d['replica']} failed — signals "
              f"{d['signals']} {d['details']}")
    for ev in router.events:
        if ev[1] in ("heal", "heal_failed"):
            print(f"tick {ev[0]}: replica {ev[2]} {ev[1]}")
    print(f"detection latency {router.detection_latency(inj)} ticks, "
          f"availability {router.availability():.3f}, worst recovery "
          f"{router.recovery_steps()} ticks, heal ms "
          f"{[round(h, 1) for h in router.heal_ms]}")
    exact = all(journal[r].tokens == oracle[r].tokens for r in oracle)
    for rid, e in sorted(journal.items()):
        print(f"req {rid}: replicas {e.replicas} requeues {e.requeues} "
              f"tokens {e.tokens} "
              f"{'=' if e.tokens == oracle[rid].tokens else '≠'} oracle")
    print("every stream equals the oracle" if exact
          else "a stream differs from the oracle")
    return 0 if exact else 1


if __name__ == "__main__":
    raise SystemExit(main())
