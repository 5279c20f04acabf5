"""The recurrent and modality models on the 2 × 4 mesh against the JAX
package: the shared part of ``tests/test_torch_mesh_recurrent.py``
(RWKV-6 3B, RecurrentGemma-9B) and ``tests/test_torch_mesh_modality.py``
(SeamlessM4T-medium, InternVL2-2B).

:func:`run_models` runs the reference's engines and f32 forwards on 8
emulated devices (a subprocess, its ``"pallas"`` in interpret mode) and,
at the same time, the port's on 8 gloo processes
(``_mesh_ranks:mesh_models_body``), with the reference's weights —
made here by the reference's own jitted init, as its engines make them —
carried to each rank by ``from_reference_params(…, lay, rank)``.  The
``check_*`` functions hold the results, the per-rank weight slices, a
rank's seeded init and ``serving_layout`` to the reference's.
"""
import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _mesh_ranks import run_ranks
from helpers import run_multidevice
from test_torch_layers import jax_tree_to_numpy
from test_torch_model_axis import NEAR_TIE

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig
from repro.launch.specs import serving_layout as ref_serving_layout
from repro.models.transformer import Layout as RefLayout
from repro.models.transformer import init_device_major, init_logical
from repro.models.transformer import to_device_major as ref_device_major

from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs
from repro_torch.models.transformer import (Layout, from_reference_params,
                                            init_params, shard_params,
                                            to_device_major)

SLOTS, PROMPT, STEPS, MAX_SEQ = 4, 16, 5, 32
MS = 4                   # the model axis of make_test_mesh()

REF_BODY = """
import dataclasses, pickle
from repro.configs import get_config, reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full
from repro.launch.specs import ctx_for
from repro.models import forward, init_device_major, param_specs, unwrap_local
from repro.models.transformer import Layout
from repro.serving.engine import EngineOptions
spec = pickle.load(open({inp!r}, "rb"))

def cfg_of(case):
    return dataclasses.replace(
        reduced(get_config(case["arch"]), **case["reduced"]),
        **case["replace"])

def to_np(tree):
    if hasattr(tree, "_asdict"):
        return {{k: to_np(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, dict):
        return {{k: to_np(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)

def leaf_sums(tree):
    return [float(np.asarray(l, np.float64).sum())
            for l in jax.tree.leaves(to_np(tree))]

mesh = make_test_mesh()
fe = spec["fe"]
out = {{"engines": {{}}, "forward": {{}}}}
for key, case in spec["engines"].items():
    cfg = cfg_of(case)
    eng = build_engine_full(cfg, mesh, max_seq=spec["max_seq"],
                            batch_global=spec["prompts"].shape[0],
                            options=EngineOptions(
                                backend=case["backend"],
                                interpret=case["backend"] == "pallas",
                                cluster=case["cluster"]))
    f = fe[case["arch"]]
    tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                             spec["prompts"], f)
    toks = [np.asarray(tok)]
    for forced in spec["forced"]:
        tok, st = eng.decode_fn(eng.params["serve"], st, forced)
        toks.append(np.asarray(tok))
    out["engines"][key] = dict(tokens=np.stack(toks),
                               heads_sub=eng.lay.heads_sub,
                               sums=leaf_sums(eng.params["train"]))
for key, case in spec["forward"].items():
    cfg = cfg_of(case)
    lay = Layout(4, heads_sub=4 // case["cluster"])
    # the caller's weights (its own jitted init, bit for bit the port's)
    shape = jax.eval_shape(lambda: init_device_major(
        cfg, lay, jax.random.PRNGKey(1), jnp.float32))
    dm = jax.tree.unflatten(jax.tree.structure(shape), [
        jnp.asarray(l) for l in spec["fwd_leaves"][key]])
    ctx = ctx_for(mesh, lay)
    f = fe[case["arch"]]
    if f is None:
        g = shard_map(lambda p, t: forward(ctx, cfg, unwrap_local(p), t,
                                           remat=False), mesh=mesh,
                      in_specs=(param_specs(cfg, dm), P("data")),
                      out_specs=P("data"), check_vma=False)
        h = jax.jit(g)(dm, spec["tokens"])
    else:
        g = shard_map(lambda p, t, e: forward(ctx, cfg, unwrap_local(p), t,
                                              e, remat=False), mesh=mesh,
                      in_specs=(param_specs(cfg, dm), P("data"), P("data")),
                      out_specs=P("data"), check_vma=False)
        h = jax.jit(g)(dm, spec["tokens"], f)
    out["forward"][key] = dict(hidden=np.asarray(h))
pickle.dump(out, open({out!r}, "wb"))
print("REF OK")
"""


def cfgs(arch, reduced_kw=None, replace=None):
    """The reference's and the port's reduced config of ``arch``."""
    reduced_kw, replace = reduced_kw or {}, replace or {}
    return (dataclasses.replace(
        ref_reduced(ref_get_config(arch), **reduced_kw), **replace),
        dataclasses.replace(reduced(get_config(arch), **reduced_kw),
                            **replace))


def engine_cases(models, clusters, odd=()):
    """One case per (model, backend, cluster): ``models`` maps an arch to
    its ``(reduced kwargs, replace)``; ``clusters`` an arch to the
    clusters it also runs at beside the pick (None); the archs in ``odd``
    also prefill a prompt one token short of ``PROMPT``
    (:func:`check_odd_prompt`)."""
    out = {}
    for arch, (red, rep) in models.items():
        for n in (None,) + tuple(clusters.get(arch, ())):
            for backend in ("xla", "pallas"):
                out[f"{arch}-{backend}-{'pick' if n is None else f'c{n}'}"] \
                    = dict(arch=arch, backend=backend, cluster=n,
                           reduced=red, replace=rep, odd=arch in odd)
    return out


def forward_cases(models, clusters):
    out = {}
    for arch, (red, rep) in models.items():
        for n in (1,) + tuple(clusters.get(arch, ())):
            out[f"{arch}-c{n}"] = dict(arch=arch, cluster=n, reduced=red,
                                       replace=rep)
    return out


def _pick(ref_cfg):
    return ref_serving_layout(ref_cfg, ShapeConfig("serve", MAX_SEQ, SLOTS,
                                                   "decode"), MS)


def frontend_embeds(cfg, rng):
    """Seeded stub-frontend embeddings ``[B, P, F]`` f32, or None."""
    if cfg.frontend is None:
        return None
    f = cfg.frontend
    return rng.standard_normal((SLOTS, f.num_positions, f.feature_dim)
                               ).astype(np.float32)


def _leaf_sums(tree):
    return [float(np.asarray(l, np.float64).sum())
            for l in jax.tree.leaves(tree)]


def run_models(tmp, engines, forward):
    """Every case on both sides: ``{"ref", "port", "weights", "fwd"}``."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, (SLOTS, PROMPT)).astype(np.int32)
    forced = rng.integers(0, 512, (STEPS, SLOTS)).astype(np.int32)
    tokens = rng.integers(0, 512, (SLOTS, PROMPT)).astype(np.int32)
    archs = sorted({c["arch"] for c in list(engines.values())
                    + list(forward.values())})
    fe = {a: frontend_embeds(cfgs(a)[0], np.random.default_rng(7))
          for a in archs}
    # the f32 forward's weights, made once here for both sides: the
    # reference's init jitted over 8 devices and here on one may round
    # an f32 leaf an ulp apart, which RWKV-6's group norm amplifies past
    # the forward's 2e-5
    fwd, fwd_leaves = {}, {}
    for key, c in forward.items():
        ref_cfg = cfgs(c["arch"], c["reduced"], c["replace"])[0]
        lay = RefLayout(MS, heads_sub=MS // c["cluster"])
        tree = jax.jit(lambda: init_device_major(
            ref_cfg, lay, jax.random.PRNGKey(1), jnp.float32))()
        fwd_leaves[key] = [np.asarray(l) for l in jax.tree.leaves(tree)]
        fwd[key] = jax_tree_to_numpy(tree)
    spec = dict(max_seq=MAX_SEQ, prompts=prompts, forced=forced,
                tokens=tokens, fe=fe, engines=engines, forward=forward,
                fwd_leaves=fwd_leaves)
    inp, out = tmp / "in.pkl", tmp / "ref.pkl"
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    ref_err = []

    def reference():
        try:
            run_multidevice(REF_BODY.format(inp=str(inp), out=str(out)),
                            timeout=900)
        except BaseException as e:                 # re-raised below
            ref_err.append(e)

    th = threading.Thread(target=reference)
    th.start()
    try:
        weights, layouts = {}, {}
        for key, c in engines.items():
            ref_cfg = cfgs(c["arch"], c["reduced"], c["replace"])[0]
            lay = (_pick(ref_cfg) if c["cluster"] is None
                   else RefLayout(MS, heads_sub=MS // c["cluster"]))
            layouts[key] = (lay.model_size, lay.heads_sub)
            wkey = (c["arch"], lay.heads_sub)
            if wkey not in weights:
                weights[wkey] = jax_tree_to_numpy(jax.jit(
                    lambda: init_device_major(ref_cfg, lay,
                                              jax.random.PRNGKey(0)))())
        cases = {k: dict(c, params=weights[(c["arch"], layouts[k][1])],
                         max_seq=MAX_SEQ, prompts=prompts, forced=forced,
                         fe=fe[c["arch"]])
                 for k, c in engines.items()}
        fwd_cases = {k: dict(c, params=fwd[k], tokens=tokens,
                             fe=fe[c["arch"]])
                     for k, c in forward.items()}
        port = run_ranks("_mesh_ranks:mesh_models_body", 8, tmp, cases,
                         fwd_cases, timeout=600)
    finally:
        th.join()
    if ref_err:
        raise ref_err[0]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return dict(ref=ref, port=port, weights=weights, layouts=layouts,
                fwd=fwd, engines=engines, forward=forward)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def check_engine(results, key):
    """Every rank the same global tokens, the reference's layout and
    weights, ≥ 0.9 of (step, slot) equal to the reference's and every
    difference a near-tie; each rank's state sized as the reference's;
    ``generate`` on the mesh starting from the prefill's tokens."""
    case = results["engines"][key]
    ref = results["ref"]["engines"][key]
    ms, hs = results["layouts"][key]
    assert ref["heads_sub"] == hs, (key, ref["heads_sub"], hs)
    # the weights carried to the port are the reference engine's: its
    # init jitted over 8 devices and here on one agree to an f32 ulp
    # (RG-LRU's Λ comes from f32 log/expm1, which the two compilations
    # may round apart), so the leaf sums agree to 1e-6
    weights = results["weights"][(case["arch"], hs)]
    np.testing.assert_allclose(ref["sums"], _leaf_sums(weights), rtol=1e-6,
                               atol=0, err_msg=key)
    cfg = cfgs(case["arch"], case["reduced"], case["replace"])[1]
    port = [results["port"][r]["engines"][key] for r in range(8)]
    for rank in range(8):
        got = port[rank]
        np.testing.assert_array_equal(got["tokens"], port[0]["tokens"])
        assert (got["heads"], got["cluster"]) == (hs, ms // hs), key
        assert got["cache_lens"].tolist() == [PROMPT + STEPS] * SLOTS
        for name, shape in got["shapes"].items():
            assert shape == _want_shape(cfg, name, hs, ms // hs), (
                key, name, shape)
        # generate's greedy stream starts at the prefill's token
        np.testing.assert_array_equal(got["generate"],
                                      port[0]["generate"])
        np.testing.assert_array_equal(got["generate"][:, 0],
                                      got["tokens"][0])
    want, got = ref["tokens"], port[0]["tokens"]
    agree = float((got == want).mean())
    assert agree >= 0.9, (key, agree, got, want)
    logits = port[0]["logits"]
    gaps = [abs(logits[t, b, got[t, b]] - logits[t, b, want[t, b]])
            for t, b in zip(*np.nonzero(got != want))]
    assert all(g <= NEAR_TIE for g in gaps), (key, gaps)


def check_odd_prompt(results, pick, clustered):
    """A prompt of ``PROMPT − 1`` tokens (odd: prefill pads it to the
    cluster's query blocks, and the recurrent layers must keep the padding
    out of their states) then two forced steps, at the ``clustered``
    engine against the ``pick`` one (cluster 1): tokens on ≥ 0.9 of
    (step, slot), every difference a near-tie in the pick's logits."""
    got = results["port"][0]["engines"][clustered]["odd"]
    want = results["port"][0]["engines"][pick]["odd"]
    logits = results["port"][0]["engines"][pick]["odd_logits"]
    assert (got == want).mean() >= 0.9, (got, want)
    gaps = [abs(logits[t, b, got[t, b]] - logits[t, b, want[t, b]])
            for t, b in zip(*np.nonzero(got != want))]
    assert all(g <= NEAR_TIE for g in gaps), gaps


def _want_shape(cfg, name, hs, n):
    """The reference's per-rank state leaf shapes (``engine.py:144–243``)
    for the leaves ``mesh_models_body`` reports, slots a data rank 2."""
    b = SLOTS // 2
    kv_loc = max(1, cfg.n_kv_heads // hs)
    if name == "rglru_h":
        return (b, (cfg.rglru_d_state or cfg.d_model) // (hs * n))
    if name == "rwkv_s":
        h = cfg.d_model // cfg.rwkv_head_dim // hs
        return (b, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim)
    if name == "enc_k":
        return (cfg.n_layers, cfg.frontend.num_positions, b * kv_loc,
                cfg.resolved_head_dim)
    if name == "local_k":
        return (min(cfg.sliding_window, MAX_SEQ) // n, b * kv_loc,
                cfg.resolved_head_dim)
    assert name == "global_k", name
    return (MAX_SEQ // n, b * kv_loc, cfg.resolved_head_dim)


def _rowwise(a, scale):
    return a / np.abs(scale).max(axis=-1, keepdims=True)


def check_forward(results, key):
    """Hidden states within 2e-5 of the reference's f32 forward and the
    last position's greedy tokens equal.  RWKV-6 is held to 2e-5 of each
    row's largest element, the measure of ``tests/test_torch_rwkv6.py``:
    its per-head group norm divides by a head's standard deviation, so a
    matmul or a sum rounded in another order grows there — the
    reference's own forwards on one device and on this mesh differ by
    4.5e-5 elementwise (1.8e-5 of the row's largest) on these inputs."""
    c = results["forward"][key]
    h_ref = results["ref"]["forward"][key]["hidden"]
    cfg = cfgs(c["arch"], c["reduced"], c["replace"])[1]
    params = results["fwd"][key]
    table = params["embed" if cfg.tie_embeddings else "lm_head"]
    table = np.asarray(table, np.float32).reshape(-1, table.shape[-1])[
        :cfg.vocab_size]
    for rank in range(8):
        d = rank // 4
        got = results["port"][rank]["forward"][key]
        want = h_ref[2 * d:2 * d + 2]
        if cfg.is_attention_free:
            np.testing.assert_allclose(_rowwise(got["hidden"], want),
                                       _rowwise(want, want), rtol=0,
                                       atol=2e-5, err_msg=key)
        else:
            np.testing.assert_allclose(got["hidden"], want, rtol=2e-5,
                                       atol=2e-5, err_msg=key)
        logits = h_ref[2 * d:2 * d + 2, -1].astype(np.float64) \
            @ table.astype(np.float64).T
        np.testing.assert_array_equal(got["tokens"], logits.argmax(-1))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def check_slices(arch, hs, reduced_kw=None, replace=None):
    """The port's ``to_device_major`` of the reference's logical weights
    at ``Layout(4, hs)`` against the reference's own, rank by rank, bit
    for bit; ``from_reference_params(…, lay, rank)`` and
    ``shard_params`` give the same slice."""
    ref_cfg, cfg = cfgs(arch, reduced_kw, replace)
    lay, ref_lay = Layout(MS, heads_sub=hs), RefLayout(MS, heads_sub=hs)
    logical, want = jax.jit(lambda k: (lambda lg: (lg, ref_device_major(
        ref_cfg, ref_lay, lg)))(init_logical(ref_cfg, k)))(
        jax.random.PRNGKey(2))
    want = jax_tree_to_numpy(want)
    lifted = jax.tree.map(lambda a: np.asarray(a)[None], jax_tree_to_numpy(
        logical), is_leaf=lambda a: isinstance(a, np.ndarray))
    port_logical = from_reference_params(cfg, lifted, device="cpu")
    dm = dict(_leaves(to_device_major(cfg, lay, port_logical)))
    for rank in range(MS):
        got = dict(_leaves(from_reference_params(cfg, want, lay=lay,
                                                 rank=rank, device="cpu")))
        mine = dict(_leaves(shard_params(cfg, lay, port_logical, rank)))
        assert set(got) == set(mine) == set(dm), (arch, hs)
        for p, g in got.items():
            assert torch.equal(g, mine[p]), (arch, hs, rank, p)
            assert torch.equal(g, dm[p][rank]), (arch, hs, rank, p)


def check_seeded_init(arch, hs, reduced_kw=None, replace=None):
    """``init_params(…, lay, rank)`` equals the whole model's init sliced
    (every rank of a mesh serves one model)."""
    cfg = cfgs(arch, reduced_kw, replace)[1]
    lay = Layout(MS, heads_sub=hs)
    whole = init_params(cfg, seed=3, device="cpu")
    for rank in range(MS):
        part = dict(_leaves(init_params(cfg, seed=3, device="cpu", lay=lay,
                                        rank=rank)))
        want = dict(_leaves(shard_params(cfg, lay, whole, rank)))
        assert set(part) == set(want), (arch, rank)
        for p, a in part.items():
            assert torch.equal(a, want[p]), (arch, rank, p)


# the reference's (heads_sub, cluster) picks of the full configs at 8
# slots (its serving_layout; max_seq 4096 lists model axes 2 to 8)
FULL_PICKS = {
    "recurrentgemma-9b": {1024: [(1, 2), (2, 2), (2, 4), (4, 4)],
                          4096: [(1, 2), (1, 4), (1, 8)]},
    "rwkv6-3b": {1024: [(2, 1), (4, 1), (8, 1), (8, 2)],
                 4096: [(2, 1), (4, 1), (8, 1)]},
    "seamless-m4t-medium": {1024: [(2, 1), (4, 1), (8, 1), (16, 1)],
                            4096: [(2, 1), (4, 1), (8, 1)]},
    "internvl2-2b": {1024: [(2, 1), (4, 1), (8, 1), (8, 2)],
                     4096: [(2, 1), (4, 1), (8, 1)]},
}


def check_layout(arch):
    """``serving_layout`` against the reference's pick for the full-size
    and reduced configs at model axes 2–16, and the full configs' picks
    at 8 slots as listed."""
    for red in (False, True):
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        if red:
            ref_cfg, cfg = ref_reduced(ref_cfg), reduced(cfg)
        for ms in (1, 2, 4, 8, 16):
            for seq, b in ((1024, 8), (4096, 8), (MAX_SEQ, SLOTS)):
                want = ref_serving_layout(
                    ref_cfg, ShapeConfig("serve", seq, b, "decode"), ms)
                got = specs.serving_layout(cfg, ms, seq_len=seq, batch=b)
                assert (got.model_size, got.heads_sub) == (
                    want.model_size, want.heads_sub), (arch, red, ms, seq)
    for seq, picks in FULL_PICKS[arch].items():
        for ms, pick in zip((2, 4, 8, 16), picks):
            got = specs.serving_layout(get_config(arch), ms, seq_len=seq,
                                       batch=8)
            assert (got.heads_sub, got.cluster) == pick, (arch, seq, ms)
