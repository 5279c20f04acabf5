"""Runs one function on every rank of a CPU world of gloo processes, for
the port's model-axis tests.

:func:`run_ranks` spawns ``world`` processes, each with one torch thread
(the default threads make the CPU tests many times slower under the
parallel run), joins them through a ``FileStore`` under the test's
``tmp_path`` (no rendezvous port), calls ``module:function(rank, world,
*args)`` in each and returns the ranks' results (``torch.save``d to
``tmp_path``).  Every collective waits at most ``RANK_TIMEOUT`` for a
missing peer, and the whole run at most ``timeout``: a rank that does
not post its round fails the test instead of hanging it.

The rank bodies below import torch and the port only.
"""
from __future__ import annotations

import datetime
import importlib
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT = datetime.timedelta(seconds=120)


def _entry(rank, world, store_path, out_dir, target, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    init_world(rank, world, device="cpu",
               store=dist.FileStore(store_path, world), timeout=RANK_TIMEOUT)
    try:
        mod, name = target.split(":")
        result = getattr(importlib.import_module(mod), name)(rank, world,
                                                             *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(target: str, world: int, tmp_path, *args, timeout: float = 300):
    """``[result of rank 0, …]`` of ``target`` (``"module:function"``, a
    module importable from ``tests/``) run on ``world`` gloo ranks."""
    out = Path(tmp_path) / f"ranks_{target.replace(':', '_')}"
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        _entry, args=(world, str(out / "store"), str(out), target, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"{target}: the {world} ranks did not finish "
                                 f"within {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def to_np(t):
    """A tensor (bf16 through f32) or a tree of them → numpy."""
    if isinstance(t, dict):
        return {k: to_np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(to_np(v) for v in t)
    if torch.is_tensor(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return t


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------
def primitives_body(rank, world, data):
    """Every primitive of ``core/primitives.py`` on this rank's rows of
    ``data``: on the model axis of a 2 × 4 mesh (``model/…``, the backend's
    all-reduce and all-gather too) and on the heads 2 × cluster 4 sub-axes
    of the 1 × 8 mesh (``heads/…``, ``clus/…``); then the model code's
    ``ParallelCtx`` on that line at heads 2 and 8 (``ctx2/…``,
    ``ctx8/…``)."""
    from repro_torch.core import primitives as prim
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.models.ctx import make_train_ctx
    x, m, l, o = (torch.from_numpy(data[k][rank]) for k in "xmlo")
    out = {}
    model = make_test_mesh(device="cpu").axes["model"]
    line = make_mesh(1, 8, device="cpu").axes["model"]
    axes = {"model": model, "heads": prim.SubAxis(line, 2, minor_size=4),
            "clus": prim.SubAxis(line, 4, minor_size=1)}
    for name, ax in axes.items():
        for op in ("sum", "max", "min"):
            out[f"{name}/reduce_{op}"] = prim.cluster_reduce(x, ax, op)
        out[f"{name}/gather"] = prim.cluster_gather(x, ax)
        out[f"{name}/gather_tiled1"] = prim.cluster_gather_tiled(x, ax, 1)
        out[f"{name}/pairs"] = prim.cluster_reduce_pairs(
            (m, l, o), ax, prim.flash_merge)
        for fused in (True, False):
            out[f"{name}/flash_{fused}"] = prim.cluster_flash_combine(
                m, l, o, ax, fused=fused)
    out["model/xla_sum"] = prim.cluster_reduce_xla(x, model, "sum")
    out["model/xla_max"] = prim.cluster_reduce_xla(x, model, "max")
    out["model/xla_gather"] = prim.cluster_gather_xla(x, model, dim=1)
    out["model/offchip_sum"] = prim.offchip_reduce(x, model, "sum")
    out["model/offchip_max"] = prim.offchip_reduce(x, model, "max")
    for hs in (2, 8):
        c = make_train_ctx(line, heads_sub=hs, model_size=8)
        out[f"ctx{hs}/psum_model"] = c.psum_model(x)
        out[f"ctx{hs}/psum_heads"] = c.psum_heads(x)
        out[f"ctx{hs}/gather_cluster"] = c.gather_cluster(x, 1)
        out[f"ctx{hs}/reduce_cluster_max"] = c.reduce_cluster(x, "max")
        out[f"ctx{hs}/index"] = np.array(
            [c.heads_index(), c.cluster_index(), c.model_index()], np.int32)
    return to_np(out)


def _near_tie_gaps(cfg, eng, state, got, want, model_axis):
    """For each slot where ``got`` ≠ ``want`` (global tokens): the gap
    between the two tokens' f32 logits in this engine, from the stashed
    pre-head residual (``shadow_head``) over the whole vocabulary (the
    ranks' shards gathered)."""
    from repro_torch.core import primitives as prim
    from repro_torch.models.layers import lm_head_logits, rms_norm
    from repro_torch.models.transformer import head_table
    p = eng.params["train"]
    x = rms_norm(state["head_resid"], p["final_norm"], cfg.norm_eps)
    logits = prim.cluster_gather_xla(
        lm_head_logits(head_table(cfg, p), x.to(torch.bfloat16)),
        model_axis, dim=-1)
    logits = eng.to_global(logits)
    return [float(abs(logits[b, int(got[b])] - logits[b, int(want[b])]))
            for b in range(len(got)) if got[b] != want[b]]


def engines_body(rank, world, cases):
    """Each case's engine on the 2 × 4 mesh, with the reference's weights
    (this rank's model slice): its prefill and forced decode tokens and,
    where a token differs from the reference's, the near-tie gap."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.launch.specs import serving_layout
    from repro_torch.models.transformer import from_reference_params
    from repro_torch.serving.engine import EngineOptions
    mesh = make_test_mesh(device="cpu")
    out = {}
    for key, case in cases.items():
        cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                                  **case["replace"])
        cluster = case.get("cluster")
        lay = serving_layout(cfg, mesh.shape["model"],
                             seq_len=case["max_seq"],
                             batch=case["prompts"].shape[0], cluster=cluster)
        train = from_reference_params(
            cfg, case["params"], lay=lay,
            rank=mesh.axes["model"].index, device="cpu")
        eng = build_engine_full(
            cfg, mesh=mesh, max_seq=case["max_seq"],
            batch_global=case["prompts"].shape[0], train_params=train,
            options=EngineOptions(backend=case["backend"], shadow_head=True,
                                  cluster=cluster))
        tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 case["prompts"])
        toks, gaps = [tok.numpy()], []
        gaps += _near_tie_gaps(cfg, eng, st, toks[-1], case["want"][0],
                               mesh.axes["model"])
        for t, forced in enumerate(case["forced"]):
            tok, st = eng.decode_fn(eng.params["serve"], st, forced)
            toks.append(tok.numpy())
            gaps += _near_tie_gaps(cfg, eng, st, toks[-1],
                                   case["want"][t + 1], mesh.axes["model"])
        out[key] = dict(tokens=np.stack(toks), gaps=gaps,
                        cache_lens=eng.to_global(st["cache_lens"]).numpy(),
                        kv_shape=tuple(st["layers"][0].k.shape))
    return out


def forward_body(rank, world, cases):
    """The f32 train-path forward on the 2 × 4 mesh: this rank's data rows
    of the final hidden states and the greedy tokens of its last
    position (the head's vocabulary shards merged by the tree)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import ctx_for
    from repro_torch.models.layers import lm_head_logits
    from repro_torch.models.transformer import (forward, from_reference_params,
                                                head_table)
    from repro_torch.serving.engine import _merge_vocab_shards
    from repro_torch.serving.sampling import head_candidates
    from repro_torch.models.transformer import Layout
    mesh = make_test_mesh(device="cpu")
    out = {}
    for key, case in cases.items():
        cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                                  **case["replace"])
        ms = mesh.shape["model"]
        lay = Layout(ms, heads_sub=ms // case.get("cluster", 1))
        ctx = ctx_for(mesh, lay)
        p = from_reference_params(cfg, case["params"], lay=lay,
                                  rank=ctx.model_index(), device="cpu")
        b_loc = case["tokens"].shape[0] // mesh.shape["data"]
        rows = case["tokens"][ctx.data_index() * b_loc:][:b_loc]
        h = forward(cfg, p, torch.from_numpy(rows), ctx=ctx)
        table = head_table(cfg, p)
        _, ids = _merge_vocab_shards(ctx, table.shape[0], *head_candidates(
            lm_head_logits(table, h[:, -1]), 8))
        out[key] = dict(hidden=h.numpy(), tokens=ids[:, 0].numpy())
    return out


def model_axis_body(rank, world, cases, fwd_cases):
    """:func:`engines_body` then :func:`forward_body`, in one world."""
    return dict(engines=engines_body(rank, world, cases),
                forward=forward_body(rank, world, fwd_cases))


def scheduler_body(rank, world, trace_spec):
    """The same trace through ``SlotScheduler`` on ``"xla"`` and on
    ``"pallas"`` on a 4 × 2 mesh (a 2-device model axis, one slot a data
    rank): each backend's (request, tokens) and events."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.serving.engine import EngineOptions
    from repro_torch.serving.scheduler import (Request, SlotScheduler,
                                               replay_trace)
    cfg = reduced(get_config("llama2-7b"))
    mesh = make_mesh(4, 2, device="cpu")
    out = {}
    for backend in ("xla", "pallas"):
        eng = build_engine_full(cfg, mesh=mesh, max_seq=32, batch_global=4,
                                options=EngineOptions(backend=backend,
                                                      track_work=True))
        sched = SlotScheduler(eng, prompt_cap=8)
        res = replay_trace(sched, [(a, Request(rid, prompt, new))
                                   for rid, (a, prompt, new)
                                   in enumerate(trace_spec)])
        out[backend] = dict(
            tokens=[(r, res[r].tokens) for r in sorted(res)],
            events=list(sched.events), work=sched.work_blocks(),
            lens=sched.cache_lens(), prepack=eng.scfg.prepack)
    return out


# ---------------------------------------------------------------------------
# A cluster across devices (tests/test_torch_cluster.py)
# ---------------------------------------------------------------------------
def _serve_leaves(tree):
    """The attention serve leaves of the first block pattern entry and of
    the tail as ``{path: numpy}`` (NamedTuple fields by name)."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if torch.is_tensor(node):
            out[path] = to_np(node)
        elif hasattr(node, "_asdict"):
            for k, v in node._asdict().items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
    for part in ("blocks", "tail"):
        for i, blk in enumerate(tree[part]):
            walk(blk.get("attn"), f"{part}/{i}/attn")
    return out


def prepack_body(mesh, cases):
    """The port's serve leaves of each case's rank slice: ``"pallas"``'s
    prepack (the cluster gather over this rank's cluster) and ``"xla"``'s
    per-step adapters (``hoist_serve_weights``: the column tiles)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.specs import ctx_for
    from repro_torch.models.transformer import (Layout,
                                                from_reference_params)
    from repro_torch.serving.engine import hoist_serve_weights
    from repro_torch.serving.prepack import prepack_for_serving
    out = {}
    for key, case in cases.items():
        cfg = reduced(get_config(case["arch"]))
        if case.get("dense"):
            cfg = dataclasses.replace(cfg, moe=None)
        lay = Layout(mesh.shape["model"], heads_sub=case["heads_sub"])
        ctx = ctx_for(mesh, lay)
        train = from_reference_params(cfg, case["params"], lay=lay,
                                      rank=ctx.model_index(), device="cpu")
        out[key] = dict(
            pallas=_serve_leaves(prepack_for_serving(cfg, train,
                                                     backend="pallas",
                                                     ctx=ctx)),
            xla=_serve_leaves(hoist_serve_weights(train, ctx)))
    return out


def _full_logits(cfg, eng, state, model_axis):
    """The global ``[B, V]`` f32 logits of the stashed pre-head residual
    (``shadow_head``), the ranks' vocabulary shards gathered."""
    from repro_torch.core import primitives as prim
    from repro_torch.models.layers import lm_head_logits, rms_norm
    from repro_torch.models.transformer import head_table
    p = eng.params["train"]
    x = rms_norm(state["head_resid"], p["final_norm"], cfg.norm_eps)
    logits = prim.cluster_gather_xla(
        lm_head_logits(head_table(cfg, p), x.to(torch.bfloat16)),
        model_axis, dim=-1)
    return eng.to_global(logits)[:, :cfg.vocab_size]


class _router_margins:
    """Within the block, every MoE layer's routing also records its
    router's top-k margin per token — the k-th choice's probability minus
    the (k+1)-th's (``models/moe.py:route``'s f32 softmax) — into ``recs``
    as ``(step[0], margins [T])``."""

    def __init__(self, step, recs):
        self.step, self.recs = step, recs

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.layers import softcap
        self.mod, self.orig = moe_mod, moe_mod.route

        def route(moe, router, x):
            probs = torch.softmax(softcap(x.float() @ router.float(),
                                          moe.router_softcap), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True).values
            self.recs.append((self.step[0],
                              top[:, moe.top_k - 1] - top[:, moe.top_k]))
            return self.orig(moe, router, x)
        moe_mod.route = route

    def __exit__(self, *exc):
        self.mod.route = self.orig


def cluster_engines_body(mesh, cases):
    """Each case's engine at ``EngineOptions(cluster=n)`` with the
    reference's weights: prefill and teacher-forced tokens, each step's
    global logits (rank 0 only, for the near-tie check), the layout and
    a rank's cache shape."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.models.transformer import (Layout,
                                                from_reference_params)
    from repro_torch.serving.engine import EngineOptions
    out = {}
    for key, case in cases.items():
        cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                                  **case["replace"])
        ms, n = mesh.shape["model"], case["cluster"]
        train = from_reference_params(
            cfg, case["params"], lay=Layout(ms, heads_sub=ms // n),
            rank=mesh.axes["model"].index, device="cpu")
        eng = build_engine_full(
            cfg, mesh=mesh, max_seq=case["max_seq"],
            batch_global=case["prompts"].shape[0], train_params=train,
            options=EngineOptions(backend=case["backend"], cluster=n,
                                  shadow_head=True,
                                  fused_combine=case.get("fused_combine",
                                                         False)))
        step, recs = [0], []
        with _router_margins(step, recs):
            tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                                     case["prompts"])
            toks, logits = [tok.numpy()], [_full_logits(cfg, eng, st,
                                                        mesh.axes["model"])]
            for t, forced in enumerate(case["forced"]):
                step[0] = t + 1
                tok, st = eng.decode_fn(eng.params["serve"], st, forced)
                toks.append(tok.numpy())
                logits.append(_full_logits(cfg, eng, st, mesh.axes["model"]))
        margins = np.full((len(toks), eng.scfg.batch_local), np.inf)
        for t, m in recs:
            margins[t] = np.minimum(margins[t], m.reshape(
                eng.scfg.batch_local, -1).amin(dim=-1).numpy())
        out[key] = dict(tokens=np.stack(toks), margins=margins,
                        logits=to_np(torch.stack(logits)) if mesh.rank == 0
                        else None,
                        cluster=eng.ctx.cluster_size,
                        heads=eng.ctx.heads_size,
                        cache_lens=eng.to_global(st["cache_lens"]).numpy(),
                        k_shape=tuple(st["layers"][0].k.shape))
    return out


def cluster_sampling_body(mesh, spec):
    """Sampled streams at each cluster of ``spec["clusters"]``: the
    pallas engine's fused-head candidates and the full-logits oracle (the
    same serve tree without its ``head`` bundle: the loose head), from
    the same admit, with a retired slot and per-slot temperature, top-k,
    top-p and seeds; and the greedy stream for the did-it-sample check."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.serving.engine import EngineOptions, reset_decode_state
    from repro_torch.serving.sampling import host_sampling_rows
    out = {}
    for arch in spec["archs"]:
        cfg = reduced(get_config(arch))
        for n in spec["clusters"]:
            eng = build_engine_full(
                cfg, mesh=mesh, max_seq=spec["max_seq"], batch_global=4,
                options=EngineOptions(backend="pallas", cluster=n), seed=0)
            serve = eng.params["serve"]
            head = serve["head"]
            oracle = {k: v for k, v in serve.items() if k != "head"}
            oracle.update({"final_norm": head.ln, "embed" if
                           cfg.tie_embeddings else "lm_head": head.table})
            rows = host_sampling_rows(4)
            for name, vals in spec["rows"].items():
                rows[name][:] = vals
            res = {}
            for label, p, sampled in (("fused", serve, True),
                                      ("oracle", oracle, True),
                                      ("greedy", serve, False)):
                st = reset_decode_state(cfg, eng.scfg, eng.state)
                r = rows if sampled else host_sampling_rows(4)
                tok, st = eng.admit_fn(eng.params["train"], st,
                                       spec["prompts"], np.full(4, 12), r)
                st = eng.retire_fn(st, np.array([0, 0, 1, 0]))
                toks = [tok.numpy()]
                for forced in spec["forced"]:
                    tok, st = eng.decode_fn(p, st, forced, sampled=sampled)
                    toks.append(tok.numpy())
                res[label] = np.stack(toks)
            out[f"{arch}-c{n}"] = res
    return out


def split_head_body(mesh, data):
    """Alg. 5 (``core/dataflow.py:split_head_attention``) on the heads 2 ×
    cluster 2 sub-axes of the model axis of 4, this rank's inputs."""
    from repro_torch.core import dataflow as df
    from repro_torch.core import primitives as prim
    model = mesh.axes["model"]
    spec = df.ClusterSpec(heads=prim.SubAxis(model, 2, minor_size=2),
                          cluster=prim.SubAxis(model, 2, minor_size=1))
    d, m = divmod(mesh.rank, mesh.shape["model"])
    t = {k: torch.from_numpy(np.ascontiguousarray(v[d, m]))
         for k, v in data.items() if k != "cache_len"}
    w = df.SplitHeadWeights(t["wq"], t["wk"], t["wv"], t["wo"])
    cache = df.KVBlock(t["k"].clone(), t["v"].clone(), t["pos"].clone())
    o, cache = df.split_head_attention(spec, t["x"], w, cache,
                                       int(data["cache_len"]))
    return dict(o=to_np(o), k=to_np(cache.k), v=to_np(cache.v),
                pos=to_np(cache.pos))


def cluster_sched_body(mesh, trace_spec):
    """The same trace through ``SlotScheduler`` on ``"xla"`` and on
    ``"pallas"`` at ``EngineOptions(cluster=2)`` on the 2 × 4 mesh (odd
    prompt lengths: prefill pads a run to the cluster's query blocks)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.serving.engine import EngineOptions
    from repro_torch.serving.scheduler import (Request, SlotScheduler,
                                               replay_trace)
    cfg = reduced(get_config("llama2-7b"))
    out = {}
    for backend in ("xla", "pallas"):
        eng = build_engine_full(cfg, mesh=mesh, max_seq=32, batch_global=4,
                                options=EngineOptions(backend=backend,
                                                      cluster=2,
                                                      track_work=True))
        sched = SlotScheduler(eng, prompt_cap=8)
        res = replay_trace(sched, [(a, Request(rid, prompt, new))
                                   for rid, (a, prompt, new)
                                   in enumerate(trace_spec)])
        out[backend] = dict(
            tokens=[(r, res[r].tokens) for r in sorted(res)],
            events=list(sched.events), lens=sched.cache_lens(),
            cluster=eng.ctx.cluster_size)
    return out


def cluster_body(rank, world, prepack_cases, fwd_cases, engine_cases,
                 sampling_spec, split_head_data, sched_trace):
    """Everything of ``tests/test_torch_cluster.py`` that runs on the 2 × 4
    mesh, in one world."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(device="cpu")
    return dict(prepack=prepack_body(mesh, prepack_cases),
                forward=forward_body(rank, world, fwd_cases),
                engines=cluster_engines_body(mesh, engine_cases),
                sampling=cluster_sampling_body(mesh, sampling_spec),
                split_head=split_head_body(mesh, split_head_data),
                sched=cluster_sched_body(mesh, sched_trace))



# ---------------------------------------------------------------------------
# The recurrent and modality models on a mesh (tests/_mesh_models.py)
# ---------------------------------------------------------------------------
def _case_cfg(case):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(
        reduced(get_config(case["arch"]), **case["reduced"]),
        **case["replace"])


def _state_shapes(cfg, st):
    """One leaf of each kind of this rank's decode state: the first RG-LRU
    ``h``, RWKV-6 ``s``, local and global cache ``k`` (a layer's) and
    ``enc_kv["k"]``."""
    from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, RWKV6
    names = {RECURRENT: ("rglru_h", "h"), RWKV6: ("rwkv_s", "s"),
             ATTN_LOCAL: ("local_k", "k")}
    out = {}
    for kind, leaf in zip(cfg.block_pattern, st["layers"]):
        name, field = names.get(kind, ("global_k", "k"))
        out.setdefault(name, tuple(getattr(leaf, field).shape[1:]))
    if "enc_kv" in st:
        out["enc_k"] = tuple(st["enc_kv"]["k"].shape)
    return out


def model_engines_body(mesh, cases):
    """Each case's engine (``cluster`` None: the reference's pick) with the
    reference's weights and the case's frontend embeddings: prefill and
    teacher-forced tokens, each step's global logits (rank 0 only), the
    layout, this rank's state shapes, and three tokens of ``generate``
    from a fresh state."""
    from repro_torch.launch.serve import build_engine_full, generate
    from repro_torch.launch.specs import serving_layout
    from repro_torch.models.transformer import from_reference_params
    from repro_torch.serving.engine import EngineOptions, reset_decode_state
    out = {}
    for key, case in cases.items():
        cfg = _case_cfg(case)
        B = case["prompts"].shape[0]
        lay = serving_layout(cfg, mesh.shape["model"],
                             seq_len=case["max_seq"], batch=B,
                             cluster=case["cluster"])
        train = from_reference_params(cfg, case["params"], lay=lay,
                                      rank=mesh.axes["model"].index,
                                      device="cpu")
        eng = build_engine_full(
            cfg, mesh=mesh, max_seq=case["max_seq"], batch_global=B,
            train_params=train,
            options=EngineOptions(backend=case["backend"], shadow_head=True,
                                  cluster=case["cluster"]))
        fe = None if case["fe"] is None else torch.from_numpy(case["fe"])
        tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 case["prompts"], fe)
        toks, logits = [tok.numpy()], [_full_logits(cfg, eng, st,
                                                    mesh.axes["model"])]
        for forced in case["forced"]:
            tok, st = eng.decode_fn(eng.params["serve"], st, forced)
            toks.append(tok.numpy())
            logits.append(_full_logits(cfg, eng, st, mesh.axes["model"]))
        out[key] = dict(tokens=np.stack(toks),
                        logits=to_np(torch.stack(logits)) if mesh.rank == 0
                        else None,
                        cluster=eng.ctx.cluster_size,
                        heads=eng.ctx.heads_size,
                        cache_lens=eng.to_global(st["cache_lens"]).numpy(),
                        shapes=_state_shapes(cfg, st))
        # the lockstep serving loop on the mesh, from a fresh state
        gen, _ = generate(eng.params, eng.prefill_fn, eng.decode_fn,
                          reset_decode_state(cfg, eng.scfg, st),
                          case["prompts"], 3, fe)
        out[key]["generate"] = gen.numpy()
        if case["odd"]:      # a prompt one token short: odd at cluster 2
            st = reset_decode_state(cfg, eng.scfg, st)
            tok, st = eng.prefill_fn(eng.params["train"], st,
                                     case["prompts"][:, :-1], fe)
            odd, odd_logits = [tok.numpy()], [
                _full_logits(cfg, eng, st, mesh.axes["model"])]
            for forced in case["forced"][:2]:
                tok, st = eng.decode_fn(eng.params["serve"], st, forced)
                odd.append(tok.numpy())
                odd_logits.append(_full_logits(cfg, eng, st,
                                               mesh.axes["model"]))
            out[key].update(odd=np.stack(odd), odd_logits=to_np(
                torch.stack(odd_logits)))
    return out


def model_forward_body(mesh, cases):
    """The f32 train-path forward at each case's cluster: this rank's data
    rows of the final hidden states and the greedy tokens of the last
    position (the head's vocabulary shards merged by the tree)."""
    from repro_torch.launch.specs import ctx_for
    from repro_torch.models.layers import lm_head_logits
    from repro_torch.models.transformer import (Layout, forward,
                                                from_reference_params,
                                                head_table)
    from repro_torch.serving.engine import _merge_vocab_shards
    from repro_torch.serving.sampling import head_candidates
    out = {}
    ms = mesh.shape["model"]
    for key, case in cases.items():
        cfg = _case_cfg(case)
        ctx = ctx_for(mesh, Layout(ms, heads_sub=ms // case["cluster"]))
        p = from_reference_params(cfg, case["params"],
                                  lay=Layout(ms, ms // case["cluster"]),
                                  rank=ctx.model_index(), device="cpu")
        b_loc = case["tokens"].shape[0] // mesh.shape["data"]
        lo = ctx.data_index() * b_loc
        fe = (None if case["fe"] is None
              else torch.from_numpy(case["fe"][lo:lo + b_loc]))
        h = forward(cfg, p, torch.from_numpy(case["tokens"][lo:lo + b_loc]),
                    fe, ctx=ctx)
        table = head_table(cfg, p)
        _, ids = _merge_vocab_shards(ctx, table.shape[0], *head_candidates(
            lm_head_logits(table, h[:, -1]), 8))
        out[key] = dict(hidden=h.numpy(), tokens=ids[:, 0].numpy(),
                        cands=ids.numpy())
    return out


def mesh_models_body(rank, world, engine_cases, fwd_cases):
    """Everything of ``tests/_mesh_models.py`` that runs on the 2 × 4 mesh,
    in one world."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(device="cpu")
    return dict(engines=model_engines_body(mesh, engine_cases),
                forward=model_forward_body(mesh, fwd_cases))
