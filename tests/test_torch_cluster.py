"""A cluster across devices — the KV sequence split over the ranks of a
cluster sub-axis above 1 — held against the JAX package on the same
meshes: the reference on 8 emulated devices (a subprocess), the port on
8 gloo processes (``tests/_mesh_ranks.py``), both on ``make_test_mesh()``
(2 × 4), with the reference's weights carried to each rank by
``from_reference_params(…, lay, rank)``.  The reference subprocess and
the port's ranks run at the same time.

* Per-rank weight slices (``to_device_major``) at ``Layout(4,
  heads_sub=2)`` and ``Layout(4, heads_sub=1)`` equal the reference's bit
  for bit for the six sharded models (and the dense-MLA arm), and so do
  the serve leaves: ``"pallas"``'s prepack (the cluster gather of the
  head-dim segments) and ``"xla"``'s per-step adapters (the column tiles
  of ``wo``, ``wuk``, ``wuv``) against the reference's
  ``prepack_for_serving``; MLA's fold ``wproj`` is an f32 product
  rounded once, held to 2e-2 as ``tests/test_prepack.py`` holds the
  reference's own.
* The f32 train-path forward at cluster 2: hidden states to 2e-5, the
  last position's greedy tokens equal.
* Engines on both backends (the reference's ``"pallas"`` in interpret
  mode) at ``EngineOptions(cluster=2)`` and ``(cluster=4)`` for reduced
  Llama2-7B, Gemma-2 27B (window 8 on both sides, so its rings wrap and
  split over the ranks) and DeepSeek-V2-Lite's dense-MLA arm; prefill
  and teacher-forced decode in bf16: tokens agree on ≥ 0.9 of (step,
  slot), and every difference is a near-tie (the two tokens' logits
  within ``NEAR_TIE`` in the port, ROADMAP C2).  DeepSeek-V2-Lite with
  its MoE layers at cluster 2 (``"pallas"``) and 4 (``"xla"``): tokens
  agree on ≥ 0.9; a difference there need not be a near-tie at the head,
  since a bf16 rounding can flip a top-k routing choice layers earlier
  (the reference's own engines at clusters 1 and 2 disagree so on some
  inputs; ROADMAP C18): both sides record every MoE layer's router
  margin (the k-th choice's probability minus the (k+1)-th's) per token,
  and every differing (step, slot) must have a margin within
  ``ROUTER_TIE`` at that step or an earlier one.  Unfused Llama2-7B at
  cluster 4 takes ``EngineOptions(fused_combine=True)`` on both sides
  (the flash combine as one tree).
* Sampled streams: the fused candidates (B3's plain version) and the
  full-logits oracle (the loose head) give identical streams at cluster
  1, 2 and 4 (the counterpart of ``tests/test_sampling.py:381``).
* ``SlotScheduler`` at ``EngineOptions(cluster=2)``: the same events
  and ≥ 0.9 token agreement fused against unfused (the counterpart of
  ``tests/test_torch_model_axis.py``'s scheduler check).
* ``split_head_attention`` (Alg. 5) against the reference's.
* ``serving_layout`` against the reference's pick.
"""
import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_ranks import run_ranks
from helpers import run_multidevice
from test_torch_layers import jax_tree_to_numpy

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig
from repro.launch.specs import serving_layout as ref_serving_layout
from repro.models.transformer import Layout as RefLayout
from repro.models.transformer import init_device_major, init_logical
from repro.models.transformer import to_device_major as ref_device_major
from repro.serving.prepack import prepack_for_serving as ref_prepack

from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs
from repro_torch.models.transformer import (Layout, from_reference_params,
                                            shard_params, to_device_major)

pytestmark = pytest.mark.multidevice

NEAR_TIE = 0.05          # bf16 logits: a few bf16 steps at |logit| ≈ 2
# a router near-tie: the k-th and (k+1)-th choices' probabilities within
# a quarter of bf16's relative step (2^-8 ≈ 3.9e-3) at the ≈ 0.25 the
# reduced model's second and third of 8 experts take — a bf16 rounding of
# the layer's input upstream can swap them (ROADMAP C18)
ROUTER_TIE = 1e-3
SLOTS, PROMPT, STEPS, MAX_SEQ = 4, 8, 4, 24
REPLACE = {"gemma2-27b": dict(sliding_window=8)}
ARCHS = ("llama2-7b", "gemma2-27b", "deepseek-v2-lite-dense")
REPLACE["deepseek-v2-lite-dense"] = dict(moe=None)
ENGINES = {f"{arch}-{backend}-c{n}": dict(arch=arch, backend=backend,
                                          cluster=n,
                                          replace=REPLACE.get(arch, {}))
           for arch in ARCHS for backend in ("xla", "pallas")
           for n in (2, 4)}
MOE = {"deepseek-v2-lite-pallas-c2", "deepseek-v2-lite-xla-c4"}
ENGINES.update({k: dict(arch="deepseek-v2-lite", backend=k.split("-")[-2],
                        cluster=int(k[-1]), replace={}) for k in MOE})
for c in ENGINES.values():         # the reference's registry name
    c["arch"] = c["arch"].replace("-dense", "")
# the adapter paths' combine as one flash-merge tree (the option's one
# non-default value) on one engine; the others run the paper's three
# reduces
ENGINES["llama2-7b-xla-c4"]["fused_combine"] = True


def _wkey(c):
    """The weights a case serves: its model and layout."""
    return (c["arch"], c["cluster"], tuple(sorted(c["replace"].items())))
FORWARD = {f"{arch}-c2": dict(arch=arch, cluster=2,
                              replace=REPLACE.get(arch, {}))
           for arch in ("llama2-7b", "gemma2-27b", "deepseek-v2-lite")}
SHARDED = ("qwen2-72b", "llama2-7b", "granite-8b", "minitron-4b",
           "gemma2-27b", "deepseek-v2-lite", "deepseek-v2-lite-dense")
PACK_LAYOUTS = (2, 1)    # heads_sub on a model axis of 4: cluster 2 and 4
SPLIT_HEAD = dict(B=2, D=16, q=2, kv=1, hd_n=8, S=8, cache_len=5)

REF_BODY = """
import dataclasses, pickle
from repro.configs import get_config, reduced
from repro.core import dataflow as df
from repro.core.primitives import SubAxis
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full
from repro.launch.specs import ctx_for
from repro.models import forward, param_specs, unwrap_local
from repro.models.transformer import Layout, init_device_major
from repro.serving.engine import EngineOptions
spec = pickle.load(open({inp!r}, "rb"))

def to_np(tree):
    if hasattr(tree, "_asdict"):
        return {{k: to_np(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, dict):
        return {{k: to_np(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)

# the router's top-k margin (the k-th choice's probability minus the
# (k+1)-th's) of every token each MoE layer routes, per step: a debug
# callback on each device beside the reference's own route
import repro.models.moe as moe_mod
from jax import lax
_route, STEP, MARGINS = moe_mod.route, [0], []

def _record(m, d):
    MARGINS.append((STEP[0], int(d), np.asarray(m)))

def route(moe, router, x):
    idx, w = _route(moe, router, x)
    logits = moe_mod.softcap(x.astype(jnp.float32)
                             @ router.astype(jnp.float32), moe.router_softcap)
    top = lax.top_k(jax.nn.softmax(logits, axis=-1), moe.top_k + 1)[0]
    jax.debug.callback(_record, top[:, moe.top_k - 1] - top[:, moe.top_k],
                       lax.axis_index("data"))
    return idx, w

moe_mod.route = route

def step_margins(n_steps, b_loc):
    jax.effects_barrier()
    out = np.full((n_steps, 2 * b_loc), np.inf)
    for t, d, m in MARGINS:
        row = m.reshape(b_loc, -1).min(axis=-1)
        sl = slice(d * b_loc, (d + 1) * b_loc)
        out[t, sl] = np.minimum(out[t, sl], row)
    MARGINS.clear()
    return out

mesh = make_test_mesh()
out = {{"engines": {{}}, "forward": {{}}}}
for key, case in spec["engines"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              **case["replace"])
    eng = build_engine_full(cfg, mesh, max_seq=spec["max_seq"],
                            batch_global=spec["prompts"].shape[0],
                            options=EngineOptions(
                                backend=case["backend"],
                                interpret=case["backend"] == "pallas",
                                cluster=case["cluster"],
                                fused_combine=case.get("fused_combine",
                                                       False)))
    MARGINS.clear()
    STEP[0] = 0
    tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                             spec["prompts"], None)
    toks = [np.asarray(tok)]
    for t, forced in enumerate(spec["forced"]):
        STEP[0] = t + 1
        tok, st = eng.decode_fn(eng.params["serve"], st, forced)
        toks.append(np.asarray(tok))
    margins = (step_margins(len(toks), spec["prompts"].shape[0] // 2)
               if cfg.moe is not None else None)
    out["engines"][key] = dict(tokens=np.stack(toks), margins=margins,
                               heads_sub=eng.lay.heads_sub,
                               embed=np.asarray(eng.params["train"]["embed"]))
for key, case in spec["forward"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              **case["replace"])
    lay = Layout(4, heads_sub=4 // case["cluster"])
    dm = jax.jit(lambda: init_device_major(cfg, lay, jax.random.PRNGKey(1),
                                           jnp.float32))()
    ctx = ctx_for(mesh, lay)
    f = shard_map(lambda p, t: forward(ctx, cfg, unwrap_local(p), t,
                                       remat=False), mesh=mesh,
                  in_specs=(param_specs(cfg, dm), P("data")),
                  out_specs=P("data"), check_vma=False)
    out["forward"][key] = dict(hidden=np.asarray(jax.jit(f)(dm,
                                                           spec["tokens"])),
                               embed=np.asarray(dm["embed"]))
sh = spec["split_head"]
dspec = df.ClusterSpec(heads=SubAxis("model", 2, 2),
                       cluster=SubAxis("model", 2, 1))

def sh_body(x, wq, wk, wv, wo, k, v, pos):
    sq = lambda a: a[0, 0]
    o, c = df.split_head_attention(
        dspec, sq(x), df.SplitHeadWeights(sq(wq), sq(wk), sq(wv), sq(wo)),
        df.KVBlock(sq(k), sq(v), sq(pos)), jnp.int32(sh["cache_len"]))
    return tuple(a[None, None] for a in (o, c.k, c.v, c.pos))

names = ("x", "wq", "wk", "wv", "wo", "k", "v", "pos")
dd = P("data", "model")
f = shard_map(sh_body, mesh=mesh, in_specs=(dd,) * 8, out_specs=(dd,) * 4,
              check_vma=False)
out["split_head"] = [np.asarray(a) for a in jax.jit(f)(
    *(jnp.asarray(sh[n]) for n in names))]
pickle.dump(out, open({out!r}, "wb"))
print("REF OK")
"""


def _cfgs(name, replace=None):
    arch = "deepseek-v2-lite" if name.startswith("deepseek") else name
    ref_cfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    if name.endswith("-dense"):
        ref_cfg = dataclasses.replace(ref_cfg, moe=None)
        cfg = dataclasses.replace(cfg, moe=None)
    replace = replace or {}
    return (dataclasses.replace(ref_cfg, **replace),
            dataclasses.replace(cfg, **replace))


def _split_head_data():
    """Every rank's own Alg. 5 inputs, ``[data, model, …]`` (x the same
    along the model axis, as a layer's input is)."""
    p = SPLIT_HEAD
    rng = np.random.default_rng(13)
    f = lambda *s, sc=1.0: (rng.standard_normal((2, 4) + s) * sc).astype(
        np.float32)
    B, D, q, kv, h, S = (p[k] for k in ("B", "D", "q", "kv", "hd_n", "S"))
    x = np.repeat(f(B, D)[:, :1], 4, axis=1)
    pos = np.where(np.arange(S) < p["cache_len"], np.arange(S), -1)
    return dict(x=x, wq=f(D, q, h, sc=D ** -0.5), wk=f(D, kv, h, sc=D ** -0.5),
                wv=f(D, kv, h, sc=D ** -0.5), wo=f(q * h, D, sc=0.3),
                k=f(S, B * kv, h), v=f(S, B * kv, h),
                pos=np.broadcast_to(pos.astype(np.int32), (2, 4, S)).copy(),
                cache_len=p["cache_len"])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, (SLOTS, PROMPT)).astype(np.int32)
    forced = rng.integers(0, 512, (STEPS, SLOTS)).astype(np.int32)
    tokens = rng.integers(0, 512, (SLOTS, 12)).astype(np.int32)
    sh = _split_head_data()
    spec = dict(max_seq=MAX_SEQ, prompts=prompts, forced=forced,
                tokens=tokens, engines=ENGINES, forward=FORWARD,
                split_head=sh)
    inp, out = tmp / "in.pkl", tmp / "ref.pkl"
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    ref_err = []

    def reference():
        try:
            run_multidevice(REF_BODY.format(inp=str(inp), out=str(out)),
                            timeout=600)
        except BaseException as e:                 # re-raised below
            ref_err.append(e)

    # the reference's run (the longest part) starts first; the weights
    # the port's ranks need are made here meanwhile
    th = threading.Thread(target=reference)
    th.start()
    try:
        # the reference engines' weights (its build's own init, jitted
        # the same way), carried to the port's ranks without waiting for
        # the reference's run; the run's embedding is checked against them
        weights = {}
        for c in ENGINES.values():
            if _wkey(c) not in weights:
                ref_cfg = _cfgs(c["arch"], c["replace"])[0]
                lay = RefLayout(4, heads_sub=4 // c["cluster"])
                weights[_wkey(c)] = jax_tree_to_numpy(jax.jit(
                    lambda: init_device_major(ref_cfg, lay,
                                              jax.random.PRNGKey(0)))())
        fwd = {}
        for key, c in FORWARD.items():
            ref_cfg = _cfgs(c["arch"], c["replace"])[0]
            lay = RefLayout(4, heads_sub=4 // c["cluster"])
            fwd[key] = jax_tree_to_numpy(jax.jit(lambda: init_device_major(
                ref_cfg, lay, jax.random.PRNGKey(1), jnp.float32))())
        packs, pack_cases = {}, {}
        for name in SHARDED:
            ref_cfg = _cfgs(name)[0]
            logical = init_logical(ref_cfg, jax.random.PRNGKey(2))
            for hs in PACK_LAYOUTS:
                lay = RefLayout(4, heads_sub=hs)
                dm, pk = jax.jit(lambda lg: (lambda d: (d, {
                    b: ref_prepack(ref_cfg, lay, d, backend=b)
                    for b in ("pallas", "xla")}))(
                    ref_device_major(ref_cfg, lay, lg)))(logical)
                key = f"{name}-h{hs}"
                packs[key] = {b: jax_tree_to_numpy(t) for b, t in pk.items()}
                pack_cases[key] = dict(
                    arch=("deepseek-v2-lite" if name.startswith("deepseek")
                          else name), dense=name.endswith("-dense"),
                    heads_sub=hs, params=jax_tree_to_numpy(dm))
        cases = {k: dict(c, params=weights[_wkey(c)], max_seq=MAX_SEQ,
                         prompts=prompts, forced=forced)
                 for k, c in ENGINES.items()}
        fwd_cases = {k: dict(c, params=fwd[k], tokens=tokens)
                     for k, c in FORWARD.items()}
        samp_rng = np.random.default_rng(3)
        sampling = dict(
            archs=("llama2-7b", "gemma2-27b"), clusters=(1, 2, 4),
            max_seq=32,
            prompts=samp_rng.integers(0, 512, (4, 12)).astype(np.int32),
            forced=samp_rng.integers(0, 512, (5, 4)).astype(np.int32),
            rows=dict(temp=[0.0, 0.9, 0.8, 0.7], topk=[8, 4, 8, 8],
                      topp=[1.0, 1.0, 1.0, 0.6], seed=[0, 11, 5, 3]))
        trace = [(rid // 2, [int(t) for t in samp_rng.integers(
            0, 512, int(samp_rng.integers(2, 8)))],
            int(samp_rng.integers(2, 5))) for rid in range(4)]
        port = run_ranks("_mesh_ranks:cluster_body", 8, tmp, pack_cases,
                         fwd_cases, cases, sampling, sh, trace, timeout=500)
    finally:
        th.join()
    if ref_err:
        raise ref_err[0]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return dict(ref=ref, port=port, packs=packs, weights=weights,
                fwd=fwd, sh=sh)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


@pytest.mark.parametrize("hs", PACK_LAYOUTS)
@pytest.mark.parametrize("name", SHARDED)
def test_device_major_slices_match_reference_at_cluster(name, hs):
    """The port's ``to_device_major`` of the reference's logical weights
    at ``Layout(4, hs)`` (cluster ``4 / hs``) against the reference's own,
    rank by rank; ``from_reference_params(…, lay, rank)`` gives the same
    slice."""
    ref_cfg, cfg = _cfgs(name)
    lay, ref_lay = Layout(4, heads_sub=hs), RefLayout(4, heads_sub=hs)
    logical, want = jax.jit(lambda k: (lambda lg: (lg, ref_device_major(
        ref_cfg, ref_lay, lg)))(init_logical(ref_cfg, k)))(
        jax.random.PRNGKey(2))
    want = jax_tree_to_numpy(want)
    lifted = jax.tree.map(lambda a: np.asarray(a)[None], jax_tree_to_numpy(
        logical), is_leaf=lambda a: isinstance(a, np.ndarray))
    port_logical = from_reference_params(cfg, lifted, device="cpu")
    dm = dict(_leaves(to_device_major(cfg, lay, port_logical)))
    for rank in range(4):
        got = dict(_leaves(from_reference_params(cfg, want, lay=lay,
                                                 rank=rank, device="cpu")))
        mine = dict(_leaves(shard_params(cfg, lay, port_logical, rank)))
        assert set(got) == set(mine) == set(dm)
        for p, g in got.items():
            assert torch.equal(g, mine[p]), (name, hs, rank, p)
            assert torch.equal(g, dm[p][rank]), (name, hs, rank, p)


def _serve_want(tree, rank):
    """The reference's packed attention leaves of rank ``rank``, keyed as
    ``_mesh_ranks._serve_leaves`` keys the port's."""
    out = {}
    for part in ("blocks", "tail"):
        for i, blk in enumerate(tree[part]):
            for k, v in (blk.get("attn") or {}).items():
                if v is not None:
                    out[f"{part}/{i}/attn/{k}"] = np.asarray(v)[rank]
    return out


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("hs", PACK_LAYOUTS)
@pytest.mark.parametrize("name", SHARDED)
def test_serve_leaves_match_reference_prepack(results, name, hs, backend):
    key = f"{name}-h{hs}"
    for rank in range(8):
        got = results["port"][rank]["prepack"][key][backend]
        want = _serve_want(results["packs"][key][backend], rank % 4)
        assert set(got) == set(want), (key, sorted(got), sorted(want))
        for p, w in want.items():
            g = got[p]
            w = np.asarray(w, np.float32)
            assert g.shape == w.shape, (key, p, g.shape, w.shape)
            if p.endswith("wproj"):        # an f32 product rounded once
                np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{key} {p}")


@pytest.mark.parametrize("key", sorted(FORWARD))
def test_forward_f32_at_cluster_2_matches_reference(results, key):
    h_ref = results["ref"]["forward"][key]["hidden"]       # [B, S, D]
    cfg = _cfgs(FORWARD[key]["arch"], FORWARD[key]["replace"])[1]
    params = results["fwd"][key]
    np.testing.assert_array_equal(results["ref"]["forward"][key]["embed"],
                                  params["embed"])
    table = params["embed" if cfg.tie_embeddings else "lm_head"]
    table = np.asarray(table, np.float32).reshape(-1, table.shape[-1])[
        :cfg.vocab_size]
    for rank in range(8):
        d = rank // 4
        got = results["port"][rank]["forward"][key]
        np.testing.assert_allclose(got["hidden"], h_ref[2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5)
        logits = h_ref[2 * d:2 * d + 2, -1].astype(np.float64) \
            @ table.astype(np.float64).T
        np.testing.assert_array_equal(got["tokens"], logits.argmax(-1))


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_engine_at_cluster_matches_reference(results, key):
    ref = results["ref"]["engines"][key]
    case = ENGINES[key]
    n = case["cluster"]
    assert ref["heads_sub"] == 4 // n
    np.testing.assert_array_equal(
        ref["embed"], results["weights"][_wkey(case)]["embed"])
    port = [results["port"][r]["engines"][key] for r in range(8)]
    cfg = _cfgs(case["arch"], case["replace"])[1]
    for rank in range(8):
        got = port[rank]
        np.testing.assert_array_equal(got["tokens"], port[0]["tokens"])
        assert (got["cluster"], got["heads"]) == (n, 4 // n)
        assert got["cache_lens"].tolist() == [PROMPT + STEPS] * SLOTS
        rows = (MAX_SEQ if cfg.mla is not None or "gemma" not in key
                else min(cfg.sliding_window, MAX_SEQ))
        assert got["k_shape"][1] == rows // n, (key, got["k_shape"])
    want, got = ref["tokens"], port[0]["tokens"]
    agree = float((got == want).mean())
    assert agree >= 0.9, (key, agree, got, want)
    if key in MOE:                 # a routing flip: see the docstring
        _check_router_near_ties(key, got, want, ref["margins"], np.concatenate(
            [port[0]["margins"], port[4]["margins"]], axis=1))
        return
    logits = port[0]["logits"]
    gaps = [abs(logits[t, b, got[t, b]] - logits[t, b, want[t, b]])
            for t, b in zip(*np.nonzero(got != want))]
    assert all(g <= NEAR_TIE for g in gaps), (key, gaps)


def _check_router_near_ties(key, got, want, ref_m, port_m):
    """Every (step, slot) where the port's token differs from the
    reference's traces to a router near-tie: the slot's smallest top-k
    margin over every MoE layer of this step and the earlier ones (its
    prompt's tokens at step 0) — in the port or in the reference — is
    within ``ROUTER_TIE`` (ROADMAP C18)."""
    cone = np.minimum.accumulate(np.minimum(ref_m, port_m), axis=0)
    diff = list(zip(*np.nonzero(got != want)))
    margins = [float(cone[t, b]) for t, b in diff]
    print(f"{key}: differing (step, slot) {diff}, router margins {margins}; "
          f"smallest margin a cell {cone.min(axis=0).tolist()}")
    assert all(m <= ROUTER_TIE for m in margins), (key, diff, margins)


@pytest.mark.parametrize("arch", ["llama2-7b", "gemma2-27b"])
def test_sampled_streams_fused_equal_oracle_at_every_cluster(results, arch):
    for n in (1, 2, 4):
        for rank in range(8):
            res = results["port"][rank]["sampling"][f"{arch}-c{n}"]
            np.testing.assert_array_equal(res["fused"], res["oracle"],
                                          err_msg=f"{arch} c{n} r{rank}")
            np.testing.assert_array_equal(
                res["fused"], results["port"][0]["sampling"][
                    f"{arch}-c{n}"]["fused"])
        res = results["port"][0]["sampling"][f"{arch}-c{n}"]
        # the stochastic slots left the greedy stream; the greedy one not
        assert (res["fused"][1:, [1, 3]] != res["greedy"][1:, [1, 3]]).any()
        np.testing.assert_array_equal(res["fused"][:, 0],
                                      res["greedy"][:, 0])


def test_split_head_attention_matches_reference(results):
    o, k, v, pos = results["ref"]["split_head"]
    for rank in range(8):
        d, m = divmod(rank, 4)
        got = results["port"][rank]["split_head"]
        np.testing.assert_allclose(got["o"], o[d, m], rtol=1e-5, atol=1e-5)
        # f32 products summed in another order; k also rotated at angles
        # whose frequencies torch and jax round alike to an ulp
        for name, want in (("k", k), ("v", v)):
            np.testing.assert_allclose(got[name], want[d, m], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_array_equal(got["pos"], pos[d, m])


@pytest.mark.parametrize("name", SHARDED[:-1])
def test_serving_layout_matches_reference_pick(name):
    """The reference's pick (``tune_cluster`` and ``_cluster_ok``) for the
    full-size and reduced configs at model axes 1–16 and three (max_seq,
    batch) pairs; Qwen2-72B, Granite-8B and Minitron-4B take a cluster of
    2 at 16."""
    for red in (False, True):
        ref_cfg, cfg = ref_get_config(name), get_config(name)
        if red:
            ref_cfg, cfg = ref_reduced(ref_cfg), reduced(cfg)
        for ms in (1, 2, 4, 8, 16):
            for seq, b in ((1024, 8), (4608, 8), (32, 4)):
                want = ref_serving_layout(
                    ref_cfg, ShapeConfig("serve", seq, b, "decode"), ms)
                got = specs.serving_layout(cfg, ms, seq_len=seq, batch=b)
                assert (got.model_size, got.heads_sub) == (
                    want.model_size, want.heads_sub), (name, red, ms, seq)
    got = specs.serving_layout(get_config(name), 16, seq_len=1024, batch=8)
    assert got.cluster == (2 if name in ("qwen2-72b", "granite-8b",
                                         "minitron-4b") else 1)


def test_scheduler_at_cluster_2_fused_vs_unfused(results):
    outs = [results["port"][r]["sched"] for r in range(8)]
    for rank in range(8):
        for backend in ("xla", "pallas"):
            assert outs[rank][backend]["tokens"] == outs[0][backend]["tokens"]
    xla, pallas = outs[0]["xla"], outs[0]["pallas"]
    assert xla["cluster"] == pallas["cluster"] == 2
    assert xla["events"] == pallas["events"]
    tok_x = np.concatenate([t for _, t in xla["tokens"]])
    tok_p = np.concatenate([t for _, t in pallas["tokens"]])
    assert (tok_x == tok_p).mean() >= 0.9, (xla, pallas)
    assert (xla["lens"] == -1).all() and (pallas["lens"] == -1).all()
