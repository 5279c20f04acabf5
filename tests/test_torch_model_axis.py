"""The port on a data × model mesh (``launch/mesh.py``,
``launch/specs.py``, the ``ctx`` of ``models/ctx.py``) held against the
JAX package's ``build_engine_full(cfg, mesh, …)`` and ``forward`` on
``make_test_mesh()`` (2 × 4): the reference on 8 emulated devices (a
subprocess), the port on 8 gloo processes with the reference's weights
carried to each model rank by ``from_reference_params(…, lay, rank)``.

* Per-rank weight slices (``to_device_major``) equal the reference's
  bit for bit for every model the port shards, and the seeded init of a
  rank equals the whole model's init sliced.
* The f32 train-path forward on the mesh: hidden states to 2e-5 (the
  backend's all-reduce sums in its own order, the reference's ``psum``
  in XLA's: ROADMAP C2) and the greedy tokens of the last position equal.
* The engines, on both backends (the reference's ``"pallas"`` in
  interpret mode): Qwen2-72B ``dataclasses.replace``d to 32/4 heads (a
  rank then holds the 8/1 heads a rank of the full model holds on 8 GPUs)
  with seeded q/k/v biases, DeepSeek-V2-Lite with its MoE layers, and
  Llama2-7B; prefill and teacher-forced decode in bf16.  Tokens agree on
  ≥ 0.9 of (step, slot), and every difference is a near-tie: the two
  tokens' logits within ``NEAR_TIE`` in the port (C2).
* The scheduler on a 2-device model axis (a 4 × 2 mesh, one slot a data
  rank): the same events and ≥ 0.9 token agreement fused against
  unfused, the counterpart of ``tests/test_scheduler.py:281``.
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from _mesh_ranks import run_ranks
from helpers import run_multidevice
from test_torch_layers import jax_tree_to_numpy

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.transformer import Layout as RefLayout
from repro.models.transformer import init_logical
from repro.models.transformer import to_device_major as ref_device_major

from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs
from repro_torch.models.transformer import (Layout, from_reference_params,
                                            init_params, shard_params,
                                            to_device_major)

pytestmark = pytest.mark.multidevice

NEAR_TIE = 0.05          # bf16 logits: a few bf16 steps at |logit| ≈ 2
SLOTS, PROMPT, STEPS, MAX_SEQ = 4, 8, 5, 24
QWEN = dict(n_heads=32, n_kv_heads=4)
ENGINES = {f"{arch}-{backend}": dict(arch=arch, backend=backend,
                                     replace=QWEN if arch == "qwen2-72b"
                                     else {}, cluster=1)
           for arch in ("qwen2-72b", "deepseek-v2-lite", "llama2-7b")
           for backend in ("xla", "pallas")}
FORWARD = {arch: dict(arch=arch, replace=QWEN if arch == "qwen2-72b" else {})
           for arch in ("qwen2-72b", "deepseek-v2-lite", "llama2-7b")}

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

def to_np(tree):
    if hasattr(tree, "_asdict"):
        return {{k: to_np(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, dict):
        return {{k: to_np(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return [to_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)

def with_biases(tree, rng, put=True):
    # seeded q/k/v biases in place of the init's zeros, placed as the
    # engine's (put) or left for jit to place
    def blk(b):
        a = b["attn"]
        if getattr(a, "bq", None) is None:
            return b
        new = {{}}
        for n in ("bq", "bk", "bv"):
            old = getattr(a, n)
            t = jnp.asarray(rng.standard_normal(old.shape) * 0.5, old.dtype)
            new[n] = jax.device_put(t, old.sharding) if put else t
        return dict(b, attn=a._replace(**new))
    return dict(tree, blocks=[blk(b) for b in tree["blocks"]],
                tail=[blk(b) for b in tree["tail"]])

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
                                cluster=1))
    train = with_biases(eng.params["train"], np.random.default_rng(5))
    serve = eng.repack_fn(train)
    tok, st = eng.prefill_fn(train, eng.state, spec["prompts"], None)
    toks = [np.asarray(tok)]
    for forced in spec["forced"]:
        tok, st = eng.decode_fn(serve, st, forced)
        toks.append(np.asarray(tok))
    out["engines"][key] = dict(tokens=np.stack(toks), params=to_np(train),
                               heads_sub=eng.lay.heads_sub,
                               cache_lens=np.asarray(st["cache_lens"]))
for key, case in spec["forward"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              **case["replace"])
    lay = Layout(4)
    dm = init_device_major(cfg, lay, jax.random.PRNGKey(1), jnp.float32)
    dm = with_biases(dm, np.random.default_rng(6), put=False)
    ctx = ctx_for(mesh, lay)
    f = shard_map(lambda p, t: forward(ctx, cfg, unwrap_local(p), t,
                                       remat=False), mesh=mesh,
                  in_specs=(param_specs(cfg, dm), P("data")),
                  out_specs=P("data"), check_vma=False)
    h = np.asarray(jax.jit(f)(dm, spec["tokens"]))
    out["forward"][key] = dict(hidden=h, params=to_np(dm))
pickle.dump(out, open({out!r}, "wb"))
print("REF OK")
"""


def _cfgs(arch, replace):
    return (dataclasses.replace(ref_reduced(ref_get_config(arch)), **replace),
            dataclasses.replace(reduced(get_config(arch)), **replace))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    rng = np.random.default_rng(0)
    spec = dict(
        max_seq=MAX_SEQ,
        prompts=rng.integers(0, 512, (SLOTS, PROMPT)).astype(np.int32),
        forced=rng.integers(0, 512, (STEPS, SLOTS)).astype(np.int32),
        tokens=rng.integers(0, 512, (SLOTS, 12)).astype(np.int32),
        engines=ENGINES, forward=FORWARD)
    inp, out = tmp / "in.pkl", tmp / "ref.pkl"
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    run_multidevice(REF_BODY.format(inp=str(inp), out=str(out)), timeout=600)
    with open(out, "rb") as f:
        ref = pickle.load(f)
    cases = {k: dict(c, params=ref["engines"][k]["params"], max_seq=MAX_SEQ,
                     prompts=spec["prompts"], forced=spec["forced"],
                     want=ref["engines"][k]["tokens"])
             for k, c in ENGINES.items()}
    fwd_cases = {k: dict(c, params=ref["forward"][k]["params"],
                         tokens=spec["tokens"]) for k, c in FORWARD.items()}
    port = run_ranks("_mesh_ranks:model_axis_body", 8, tmp, cases,
                     fwd_cases, timeout=400)
    return (ref, [p["engines"] for p in port], [p["forward"] for p in port])


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_engine_on_2x4_mesh_matches_reference(results, key):
    ref, port, _ = results
    want = ref["engines"][key]["tokens"]
    assert ref["engines"][key]["heads_sub"] == 4       # head-parallel
    for rank in range(8):
        got = port[rank][key]
        # every rank holds the same global tokens
        np.testing.assert_array_equal(got["tokens"], port[0][key]["tokens"])
        # the reference's leaf is [data, model, slots a data rank]
        np.testing.assert_array_equal(
            got["cache_lens"],
            ref["engines"][key]["cache_lens"][:, 0].reshape(-1))
    got = port[0][key]
    agree = float((got["tokens"] == want).mean())
    assert agree >= 0.9, (key, agree, got["tokens"], want)
    assert all(g <= NEAR_TIE for r in range(8) for g in port[r][key]["gaps"]
               ), (key, port[0][key]["gaps"])
    cfg = _cfgs(ENGINES[key]["arch"], ENGINES[key]["replace"])[1]
    if cfg.mla is None:      # a rank's kv heads: replicated at 32/4 over 4
        assert got["kv_shape"][-2] == (SLOTS // 2) * max(
            1, cfg.n_kv_heads // 4)


@pytest.mark.parametrize("key", sorted(FORWARD))
def test_forward_f32_on_2x4_mesh_matches_reference(results, key):
    ref, _, fwd = results
    h_ref = ref["forward"][key]["hidden"]                 # [B, S, D]
    cfg = _cfgs(FORWARD[key]["arch"], FORWARD[key]["replace"])[1]
    params = ref["forward"][key]["params"]
    table = params["embed" if cfg.tie_embeddings else "lm_head"]
    table = table.reshape(-1, table.shape[-1])[:cfg.vocab_size]
    for rank in range(8):
        d = rank // 4
        got = fwd[rank][key]
        np.testing.assert_allclose(got["hidden"], h_ref[2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5)
        logits = h_ref[2 * d:2 * d + 2, -1].astype(np.float64) \
            @ table.astype(np.float64).T
        np.testing.assert_array_equal(got["tokens"], logits.argmax(-1))


SHARDED = ("qwen2-72b", "llama2-7b", "granite-8b", "minitron-4b",
           "gemma2-27b", "deepseek-v2-lite", "deepseek-v2-lite-dense")


def _ref_cfg_pair(name):
    arch = "deepseek-v2-lite" if name.startswith("deepseek") else name
    ref_cfg, cfg = _cfgs(arch, QWEN if arch == "qwen2-72b" else {})
    if name.endswith("-dense"):
        ref_cfg = dataclasses.replace(ref_cfg, moe=None)
        cfg = dataclasses.replace(cfg, moe=None)
    return ref_cfg, cfg


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", SHARDED)
def test_device_major_slices_match_reference(name):
    """The port's ``to_device_major`` of the reference's logical weights
    (carried across at model size 1) against the reference's own, rank
    by rank; ``from_reference_params(…, lay, rank)`` gives the same
    slice."""
    ref_cfg, cfg = _ref_cfg_pair(name)
    ms = 4
    logical, want = jax.jit(lambda k: (lambda lg: (lg, ref_device_major(
        ref_cfg, RefLayout(ms), lg)))(init_logical(ref_cfg, k)))(
        jax.random.PRNGKey(2))
    want = jax_tree_to_numpy(want)
    lifted = jax.tree.map(lambda a: np.asarray(a)[None], jax_tree_to_numpy(
        logical), is_leaf=lambda a: isinstance(a, np.ndarray))
    port_logical = from_reference_params(cfg, lifted, device="cpu")
    dm = to_device_major(cfg, Layout(ms), port_logical)
    for rank in range(ms):
        got = from_reference_params(cfg, want, lay=Layout(ms), rank=rank,
                                    device="cpu")
        mine = shard_params(cfg, Layout(ms), port_logical, rank)
        got, mine, dmd = (dict(_leaves(t)) for t in (got, mine, dm))
        assert set(got) == set(mine) == set(dmd)
        for p, g in got.items():
            assert torch.equal(g, mine[p]), (name, rank, p)
            assert torch.equal(g, dmd[p][rank]), (name, rank, p)


@pytest.mark.parametrize("name", ["qwen2-72b", "deepseek-v2-lite"])
def test_seeded_init_of_a_rank_is_the_model_sliced(name):
    """``init_params(…, lay, rank)`` cuts each leaf as it is drawn; the
    result equals the whole model's init sliced (so every rank of a mesh
    serves one model)."""
    _, cfg = _ref_cfg_pair(name)
    whole = init_params(cfg, seed=3, device="cpu")
    for rank in range(4):
        part = init_params(cfg, seed=3, device="cpu", lay=Layout(4),
                           rank=rank)
        want = dict(_leaves(shard_params(cfg, Layout(4), whole, rank)))
        got = dict(_leaves(part))
        assert set(got) == set(want)
        for p, a in got.items():
            assert torch.equal(a, want[p]), (name, rank, p)


def test_layout_and_data_axes_match_reference():
    """``layout_for`` (``pick_heads_sub``) for every model the port
    registers at model axes 1 to 16, and ``dp_axes_of``/``dp_size_of`` of a 2 × 4
    mesh, against the reference's (a mesh's names and shape are all
    the reference's functions read)."""
    import types
    from repro.launch import mesh as ref_mesh
    from repro.models.transformer import layout_for as ref_layout_for
    from repro_torch.launch.mesh import Mesh, dp_axes_of, dp_size_of
    from repro_torch.models.transformer import layout_for
    for arch in ("llama2-7b", "deepseek-v2-lite", "rwkv6-3b",
                 "recurrentgemma-9b", "granite-8b", "minitron-4b",
                 "gemma2-27b", "seamless-m4t-medium", "internvl2-2b",
                 "qwen2-72b"):
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        for ms in (1, 2, 4, 8, 16):
            want, got = ref_layout_for(ref_cfg, ms), layout_for(cfg, ms)
            assert (got.model_size, got.heads_sub, got.cluster) == (
                want.model_size, want.heads_sub, want.cluster), (arch, ms)
    shape = {"data": 2, "model": 4}
    ref = types.SimpleNamespace(axis_names=("data", "model"), shape=shape)
    port = Mesh(shape, {}, 0, torch.device("cpu"))
    assert dp_axes_of(port) == ref_mesh.dp_axes_of(ref) == ("data",)
    assert dp_size_of(port) == ref_mesh.dp_size_of(ref) == 2


def test_scheduler_fused_vs_unfused_on_2_device_model_axis(tmp_path):
    rng = np.random.default_rng(11)
    trace = [(rid // 2, [int(t) for t in rng.integers(
        0, 512, int(rng.integers(2, 7)))], int(rng.integers(2, 5)))
        for rid in range(4)]
    outs = run_ranks("_mesh_ranks:scheduler_body", 8, tmp_path, trace,
                     timeout=240)
    for rank in range(8):
        for backend in ("xla", "pallas"):
            assert outs[rank][backend]["tokens"] == outs[0][backend]["tokens"]
    xla, pallas = outs[0]["xla"], outs[0]["pallas"]
    assert pallas["prepack"] and not xla["prepack"]
    assert xla["events"] == pallas["events"]
    tok_x = np.concatenate([t for _, t in xla["tokens"]])
    tok_p = np.concatenate([t for _, t in pallas["tokens"]])
    assert (tok_x == tok_p).mean() >= 0.9, (xla, pallas)
    assert (xla["lens"] == -1).all() and (pallas["lens"] == -1).all()
    np.testing.assert_array_equal(xla["work"], pallas["work"])


def test_unsharded_layouts_raise_naming_a5b(monkeypatch):
    """The boundary after A.5b's second half, part 1: a cluster across
    devices serves (the reference's pick — a model axis past the heads
    gives a cluster above 1 — or an explicit ``cluster``), a ``cluster``
    that does not divide the axis or the heads raises ``ValueError``; the
    recurrent, RWKV-6 and modality models take the reference's picks
    (RecurrentGemma-9B a cluster across devices at every model axis) and
    a rank's seeded init; the fleet on a mesh raises
    ``NotImplementedError`` naming A.5b's remaining part; a CUDA mesh on
    a host with fewer GPUs than ranks raises, and no world falls back to
    gloo."""
    import types
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.ctx import ParallelCtx
    from repro_torch.serving.router import Router
    qwen = reduced(get_config("qwen2-72b"))                # 4 heads
    kw = dict(seq_len=24, batch=4)
    assert specs.serving_layout(qwen, 4, **kw).heads_sub == 4
    assert specs.serving_layout(qwen, 1, **kw).cluster == 1
    assert specs.serving_layout(qwen, 8, **kw).cluster == 2
    assert specs.serving_layout(dataclasses.replace(qwen, n_heads=16), 16,
                                **kw).cluster == 1
    assert specs.serving_layout(qwen, 4, cluster=4, **kw).heads_sub == 1
    for bad in (3, 8):
        with pytest.raises(ValueError, match="cluster"):
            specs.serving_layout(qwen, 4, cluster=bad, **kw)
    # (heads_sub, cluster) at model axes 2, 4, 8, 16, max_seq 1024, 8 slots
    picks = {"rwkv6-3b": [(2, 1), (4, 1), (8, 1), (8, 2)],
             "recurrentgemma-9b": [(1, 2), (2, 2), (2, 4), (4, 4)],
             "seamless-m4t-medium": [(2, 1), (4, 1), (8, 1), (16, 1)],
             "internvl2-2b": [(2, 1), (4, 1), (8, 1), (8, 2)]}
    for arch, want in picks.items():
        for ms, pick in zip((2, 4, 8, 16), want):
            lay = specs.serving_layout(get_config(arch), ms, seq_len=1024,
                                       batch=8)
            assert (lay.heads_sub, lay.cluster) == pick, (arch, ms)
        cfg = reduced(get_config(arch))
        part = init_params(cfg, device="cpu", lay=Layout(2), rank=1)
        assert part["embed"].shape[0] == cfg.vocab_size // 2
    sharded = types.SimpleNamespace(ctx=ParallelCtx(model=object(),
                                                    model_static=2))
    with pytest.raises(NotImplementedError, match="remaining part of "
                       "ROADMAP A.5b"):
        Router([sharded], prompt_cap=8, max_new_cap=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 8 GPUs"):
        mesh_mod.init_world(0, 8, device="cuda")
    with pytest.raises(RuntimeError, match="init_world"):
        mesh_mod.make_mesh(2, 4, device="cpu")
