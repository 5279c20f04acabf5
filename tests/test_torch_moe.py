"""DeepSeek-V2-Lite as the reference registers it — MLA attention and a
MoE FFN on every layer — and the unfused MLA path, held against the JAX
package at reduced size on the CPU, the weights carried across by
``from_reference_params``.

* ``_capacity``, ``route`` and ``moe_apply`` (``models/moe.py``) against
  the reference's, gated and ungated, with the router softcap and with
  Arctic's dense-residual branch: f32 to 1e-5, bf16 to 2e-2; one case at
  ``capacity_factor`` 1.0 where tokens really drop (``reduced()`` sets
  8.0, where none can), and ties routed to the lowest expert index;
* the unfused ``mla_attention`` (``core/dataflow.py``) against the
  reference's XLA branch on a ragged latent cache (lengths −1, 0, 1, 31,
  stale rows past each live prefix): f32 to 1e-5, bf16 to 2e-2;
* the f32 train-path forward of reduced DeepSeek-V2-Lite with its MoE at
  ``capacity_factor`` 1.25 (set on both sides, so that tokens drop):
  logits to 1e-5;
* lockstep serving on both port backends against the JAX engines
  (``"xla"``, and ``"pallas"`` in interpret mode): the prefill's first
  tokens and latent caches, then teacher-forced decode tokens on ≥ 0.9
  of (step, slot), each difference a near-tie (ROADMAP C2); the launch
  counts of a step; the step under the capture rules of
  ``tests/test_torch_step_graph.py``, graphed against eager bit for bit;
* the dense-MLA arm on ``"xla"`` through the staggered scheduler trace
  against the reference's XLA engine: events equal, tokens ≥ 0.9.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.core import dataflow as ref_df
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models.ctx import ParallelCtx
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import unwrap_local
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler
from repro.serving.scheduler import replay_trace as ref_replay

from test_torch_layers import dense_mla, jax_tree_to_numpy
from test_torch_step_graph import _assert_same_bits, _capture_rules

from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.core import autotune, tracecount
from repro_torch.core import dataflow as df
from repro_torch.kernels.fused_decode.fused_decode import rope_at
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models import layers, moe
from repro_torch.models.transformer import forward, from_reference_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import step_graph
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

SLOTS, MAX_SEQ, PROMPT_CAP = 3, 48, 16
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CTX = ParallelCtx()
CF = 1.25         # DeepSeek-V2-Lite's own capacity factor


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _both(a, bf16: bool):
    """(jax, torch) of a numpy array, in bf16 if asked."""
    if a is None:
        return None, None
    if bf16:
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x)).reshape(-1)


def _moe_configs(**kw):
    """(reference, port) MoE configs with the same fields."""
    return RefMoEConfig(**kw), MoEConfig(**kw)


def _drops(idx: torch.Tensor, moe_cfg) -> int:
    """Slots routed past their expert's capacity."""
    C = moe._capacity(idx.shape[0], moe_cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=moe_cfg.num_experts)
    return int(torch.clamp(counts - C, min=0).sum())


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens,k,E,cf", [(1, 6, 64, 1.25), (8, 6, 64, 1.25),
                                           (4096, 6, 64, 1.25),
                                           (64, 2, 8, 1.0), (30, 2, 8, 8.0),
                                           (1000, 1, 3, 0.7)])
def test_capacity_matches_reference(tokens, k, E, cf):
    ref_cfg, cfg = _moe_configs(num_experts=E, top_k=k, expert_d_ff=8,
                                capacity_factor=cf)
    assert moe._capacity(tokens, cfg) == ref_moe._capacity(tokens, ref_cfg)
    assert moe._capacity(tokens, cfg) % 8 == 0


@pytest.mark.parametrize("cap", [0.0, 3.0])
def test_route_matches_reference(cap):
    """f32 logits, softcap, softmax, top-k, renormalized: ids exact and
    weights to 1e-5; an exact tie between two experts goes to the lower
    index on both sides."""
    rng = np.random.default_rng(1)
    T, D, E, k = 24, 32, 8, 3
    ref_cfg, cfg = _moe_configs(num_experts=E, top_k=k, expert_d_ff=8,
                                router_softcap=cap)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    router[:, 5] = router[:, 2]                 # experts 2 and 5 tie
    router[:, 6] = router[:, 2] + 0.3           # and 6 beats both
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[:4] = np.abs(x[:4]) * np.sign(router[:, 2])  # 2 and 5 in the top 3
    want_i, want_w = ref_moe.route(ref_cfg, jnp.asarray(router),
                                   jnp.asarray(x, jnp.bfloat16))
    got_i, got_w = moe.route(cfg, torch.from_numpy(router),
                             torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **F32)
    tied = (got_i == 2).any(1) & (got_i == 5).any(1)
    assert tied[:4].all()
    for row in got_i[tied].tolist():
        assert row.index(2) < row.index(5)


CASES = {   # name: (gated, act, router softcap, dense residual, capacity)
    "gated": (True, "silu", 0.0, False, 1.25),
    "ungated-relu2": (False, "relu2", 0.0, False, 1.25),
    "softcap": (True, "gelu_tanh", 2.0, False, 1.25),
    "dense-residual": (True, "silu", 0.0, True, 1.25),
    "drops": (True, "silu", 0.0, False, 1.0),
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, bf16):
    """``[B, S, D]`` through the experts: f32 to 1e-5, bf16 to 2e-2.  The
    tokens lean towards expert 0, so tokens drop (counted on the port's
    routing) at capacity factor 1.25 and, more, at 1.0."""
    gated, act, cap, dense, cf = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    B, S, D, E, k, F, Fd = 2, 40, 32, 8, 2, 48, 24
    ref_cfg, cfg = _moe_configs(
        num_experts=E, top_k=k, expert_d_ff=F, router_softcap=cap,
        dense_ff_residual=dense, dense_residual_d_ff=Fd if dense else 0,
        capacity_factor=cf)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    router = f(D, E, sc=D ** -0.5)
    x = f(B, S, D)
    x += 0.5 * np.sign(router[:, 0])     # skewed: expert 0 is in demand
    arrs = dict(x=x, w_in=f(E, D, F, sc=D ** -0.5),
                w_gate=f(E, D, F, sc=D ** -0.5) if gated else None,
                w_out=f(E, F, D, sc=F ** -0.5))
    d_arrs = dict(w_in=f(D, Fd, sc=D ** -0.5),
                  w_gate=f(D, Fd, sc=D ** -0.5) if gated else None,
                  w_out=f(Fd, D, sc=Fd ** -0.5)) if dense else None
    j = {n: _both(a, bf16)[0] for n, a in arrs.items()}
    t = {n: _both(a, bf16)[1] for n, a in arrs.items()}
    p = dict(router=torch.from_numpy(router), w_in=t["w_in"],
             w_gate=t["w_gate"], w_out=t["w_out"])
    ref_dense = None
    if dense:
        p["dense"] = {n: _both(a, bf16)[1] for n, a in d_arrs.items()}
        jd = {n: _both(a, bf16)[0] for n, a in d_arrs.items()}
        ref_dense = ref_layers.FFNParams(jd["w_in"], jd["w_out"],
                                         jd["w_gate"])
    ref_p = ref_moe.MoEParams(router=jnp.asarray(router), w_in=j["w_in"],
                              w_out=j["w_out"], w_gate=j["w_gate"],
                              dense=ref_dense)
    want = jax.jit(lambda pp, xx: ref_moe.moe_apply(CTX, pp, xx, act,
                                                    ref_cfg))(ref_p, j["x"])
    got = moe.moe_apply(p, t["x"], act, cfg)
    assert got.dtype == t["x"].dtype and got.shape == (B, S, D)
    np.testing.assert_allclose(_np(got), _np(want), **(BF16 if bf16
                                                        else F32))
    idx, _ = moe.route(cfg, p["router"], t["x"].reshape(-1, D))
    assert _drops(idx, cfg) > 0


def test_moe_apply_decode_shape_and_repeatability():
    """``[B, D]`` (decode: ``B`` tokens share one capacity of at least 8,
    so no token drops) equals ``[B, 1, D]``, and a second call gives the
    same bits."""
    rng = np.random.default_rng(5)
    E, D, F = 8, 32, 16
    cfg = MoEConfig(num_experts=E, top_k=2, expert_d_ff=F)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, D, cfg, True)
    assert p["router"].dtype == torch.float32
    assert p["w_in"].shape == (E, D, F) and p["w_out"].shape == (E, F, D)
    x = torch.from_numpy(rng.standard_normal((5, D)).astype(
        np.float32)).to(torch.bfloat16)
    a = moe.moe_apply(p, x, "silu", cfg)
    b = moe.moe_apply(p, x[:, None], "silu", cfg)[:, 0]
    assert torch.equal(a, b) and torch.equal(a, moe.moe_apply(p, x, "silu",
                                                              cfg))


# ---------------------------------------------------------------------------
# The unfused MLA layer: the XLA branch of mla_attention at cluster 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
def test_mla_attention_matches_reference_xla_branch(bf16):
    """One layer on a latent cache at lengths −1 (free), 0, 1 and S − 1,
    with stale rows past every live prefix (``pos = row`` left by an
    earlier occupant, or −1): the output and the appended cache against
    the reference run under ``shard_map`` on a one-device mesh, its
    bucketed attention in buckets of 8 rows; a free slot gets zeros."""
    rng = np.random.default_rng(11)
    S, D, q, nope, rope, lat, v = 32, 64, 4, 16, 8, 32, 16
    lens = np.array([-1, 0, 1, S - 1], np.int32)
    B = len(lens)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    ws = (f(D, q, nope + rope, sc=D ** -0.5), f(D, lat + rope, sc=D ** -0.5),
          f(q, nope, lat, sc=0.3), f(q, lat, v, sc=0.3),
          f(q * v, D, sc=(q * v) ** -0.5))
    x, k = f(B, D), f(S, B, lat + rope)
    row = np.arange(S)[:, None]
    stale = rng.random((S, B)) < 0.5
    pos = np.where(row < lens[None, :], row,
                   np.where(stale, row, -1)).astype(np.int32)
    assert (pos[:, 0] >= 0).any() and (pos[S // 2:, 2] >= 0).any()
    k_v = np.ascontiguousarray(k[..., :1])

    mesh = jax.make_mesh((1,), ("c",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    spec = ref_df.ClusterSpec(heads="c", cluster="c", backend="xla",
                              block_s=8)

    def body(k, kv, pos, lens, x, *w):
        o, c = ref_df.mla_attention(
            spec, x, ref_df.MLAWeights(*w), ref_df.KVBlock(k, kv, pos), lens,
            nope_dim=nope, rope_dim=rope)
        return o, c.k, c.v, c.pos

    args = [_both(k, bf16)[0], _both(k_v, bf16)[0], jnp.asarray(pos),
            jnp.asarray(lens)] + [_both(a, bf16)[0] for a in (x,) + ws]
    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),) * len(args),
                             out_specs=(P(),) * 4, check_vma=False))(*args)

    cache = df.KVBlock(_both(k, bf16)[1].clone(), _both(k_v, bf16)[1].clone(),
                       torch.from_numpy(pos.copy()))
    t_lens = torch.from_numpy(lens)
    cos, sin = rope_at(t_lens, rope)
    w = df.MLAWeights(*(_both(a, bf16)[1] for a in ws))
    tracecount.reset()
    got = df.mla_attention(_both(x, bf16)[1], w, cache, t_lens, cos, sin,
                           nope_dim=nope, rope_dim=rope)
    assert sum(tracecount.calls().values()) == 0       # no kernel of ours
    assert got.dtype == cache.k.dtype and got.shape == (B, D)
    assert not got[0].any()                           # a free slot: zeros
    tol = BF16 if bf16 else F32
    np.testing.assert_allclose(_np(got), _np(want[0]), **tol)
    for name, g, r in zip(("k", "v"), cache[:2], want[1:3]):
        np.testing.assert_allclose(_np(g), _np(r), **tol, err_msg=name)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(want[3]))


# ---------------------------------------------------------------------------
# The model: the f32 forward, and the engines against the JAX engines
# ---------------------------------------------------------------------------
def _configs(dense: bool = False):
    """(reference, port) reduced DeepSeek-V2-Lite at its own capacity
    factor 1.25 (``reduced()`` sets 8.0), or its dense-MLA arm."""
    ref_cfg = ref_reduced(ref_get_config("deepseek-v2-lite"))
    cfg = reduced(get_config("deepseek-v2-lite"))
    if dense:
        return dense_mla(ref_cfg), dense_mla(cfg)
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=CF)) for c in (ref_cfg, cfg))


@pytest.fixture(scope="module")
def engines():
    """The reference's engines on ``"xla"`` and on ``"pallas"``
    (interpret mode, prepacked, the fused head), and the port's on both
    backends, all on the reference's weights."""
    cfg, port_cfg = _configs()
    mesh = make_test_mesh(data=1, model=1)
    refs = {b: ref_build(cfg, mesh, max_seq=MAX_SEQ, batch_global=SLOTS,
                         options=opt)
            for b, opt in (("xla", RefOptions(backend="xla")),
                           ("pallas", RefOptions(backend="pallas",
                                                 interpret=True,
                                                 prepack="on",
                                                 fuse_head=True)))}
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(refs["xla"].params["train"]),
        device="cpu")
    ports = {b: build_engine_full(port_cfg, max_seq=MAX_SEQ,
                                  batch_global=SLOTS, device="cpu",
                                  train_params=train,
                                  options=EngineOptions(backend=b))
             for b in ("xla", "pallas")}
    return refs, ports


def test_f32_forward_with_drops_matches_reference(engines, monkeypatch):
    """The train-path forward on the reference's weights upcast to f32,
    MoE on every layer at capacity factor 1.25 on both sides: hidden
    states and logits to 1e-5, every position's greedy token exact, and
    tokens dropped in every layer."""
    refs, ports = engines
    cfg, port_cfg = refs["xla"].cfg, ports["xla"].cfg
    tree = jax.tree.map(lambda leaf: leaf.astype(jnp.float32),
                        refs["xla"].params["train"])
    params = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                   device="cpu")
    assert moe.is_moe(params["blocks"][0]["ffn"])
    assert params["blocks"][0]["ffn"]["w_in"].shape == (
        cfg.n_layers, cfg.moe.num_experts, cfg.d_model,
        cfg.moe.expert_d_ff)
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    drops, real = [], moe.route

    def counted(moe_cfg, router, x):
        out = real(moe_cfg, router, x)
        drops.append(_drops(out[0], moe_cfg))
        return out

    monkeypatch.setattr(moe, "route", counted)
    local = unwrap_local(tree)
    want = jax.jit(lambda p, t: ref_forward(CTX, cfg, p, t, remat=False))(
        local, jnp.asarray(toks))
    got = forward(port_cfg, params, torch.from_numpy(toks))
    assert len(drops) == cfg.n_layers and all(drops), drops
    lg = layers.lm_head_logits(params["lm_head"], got)
    lw = ref_layers.lm_head_logits(CTX, local["lm_head"], want)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(lg), _np(lw), **F32)
    np.testing.assert_array_equal(lg.argmax(-1).numpy(),
                                  np.asarray(lw).argmax(-1))


def _forced(eng, prompts, forced, *, ref=False):
    """Prefill, then teacher-forced decode steps: the tokens of every
    step ``[steps + 1, B]`` and each layer's latent cache ``(k, pos)``
    after the prefill, as float32 and int32 arrays ``[G, S, B, …]``."""
    if ref:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                                 None)
    else:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts)
    # the port appends in place: keep copies before the decode steps
    after_prefill = [(_np(c.k[0, 0] if ref else c.k),
                      np.array(c.pos[0, 0] if ref else c.pos))
                     for c in st["layers"]]
    out = [_host(tok)]
    for t in range(len(forced)):
        f = forced[t] if ref else torch.from_numpy(forced[t])
        tok, st = eng.decode_fn(eng.params["serve"], st, f)
        out.append(_host(tok))
    return np.stack(out), after_prefill


def test_serve_layout_and_launches(engines):
    """``"pallas"``: B4 packed, the experts, router and ``ln2`` aliased
    (no copy), ``L`` B4 calls and one B3 a step and no B2; ``"xla"``: the
    train tree as serve tree and no kernel call at all."""
    _, ports = engines
    fused, unfused = ports["pallas"], ports["xla"]
    cfg = fused.cfg
    blk, train_blk = (e.params[k]["blocks"][0] for e, k in
                      ((fused, "serve"), (fused, "train")))
    assert isinstance(blk["attn"], df.PackedMLAWeights)
    assert blk["ffn"] is train_blk["ffn"] and blk["ln2"] is train_blk["ln2"]
    assert unfused.params["serve"] is unfused.params["train"]
    for eng, want in ((fused, {"fused_mla_decode": cfg.n_layers,
                               "fused_head": 1}), (unfused, {})):
        nxt, st = eng.prefill_fn(eng.params["train"], eng.state,
                                 np.ones((SLOTS, 4), np.int32))
        tracecount.reset()
        eng.decode_fn(eng.params["serve"], st, nxt)
        assert {k: n for k, n in tracecount.calls().items() if n} == want


def test_lockstep_decode_matches_reference(engines, monkeypatch):
    """Both port backends against both JAX engines, the same prompts and
    forced tokens: the first tokens and the prefill's latent caches
    equal (``pos`` exactly in every layer; the entries of the first
    layer, which come straight from the embedding, to bf16 tolerance —
    deeper layers' follow bf16 rounding flips that compound elementwise,
    as ``tests/test_torch_engine.py`` notes), then ≥ 0.9 of (step, slot)
    agree, each difference a near-tie among the port's candidates; and
    the port's two backends against each other."""
    refs, ports = engines
    rng = np.random.default_rng(9)
    vocab = ports["xla"].cfg.vocab_size
    prompts = rng.integers(0, vocab, (SLOTS, 10)).astype(np.int32)
    forced = rng.integers(0, vocab, (8, SLOTS)).astype(np.int32)
    cands = []
    for tail in ("_loose_head_tail", "_fused_head_tail"):
        real = getattr(engine_mod, tail)
        monkeypatch.setattr(engine_mod, tail, lambda *a, _r=real:
                            cands.append(_r(*a)) or cands[-1])
    wants = {rb: _forced(ref, prompts, forced, ref=True)
             for rb, ref in refs.items()}
    toks = {}
    for b, port in ports.items():
        cands.clear()
        got, p_caches = _forced(port, prompts, forced)
        assert len(cands) == len(forced)
        toks[b] = got
        for rb, (want, r_caches) in wants.items():
            np.testing.assert_array_equal(got[0], want[0])
            for (pk, ppos), (rk, rpos) in zip(p_caches, r_caches):
                np.testing.assert_array_equal(ppos, rpos)
                np.testing.assert_allclose(pk[0], rk[0], **BF16)
            assert (got == want).mean() >= 0.9, (b, rb, got, want)
            for t, s in zip(*np.nonzero(got[1:] != want[1:])):
                vals, ids = (c[s].numpy() for c in cands[t])
                assert want[1 + t, s] in ids, (b, rb, t, s, ids)
                gap = vals[0] - vals[list(ids).index(want[1 + t, s])]
                assert gap <= NEAR_TIE, (b, rb, t, s, gap)
    assert (toks["xla"] == toks["pallas"]).mean() >= 0.9


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_graphed_generate_equals_eager(engines, monkeypatch, backend):
    """The MoE step captured under the capture rules (no host sync, no
    host-built tensor: the dispatch's sort, positions and combine stay on
    the device) and replayed: two ``generate`` batches give the eager
    engine's tokens and final state bit for bit."""
    _, ports = engines
    eager = ports[backend]
    captured = []

    def fake_capture(step, device, pool=None):
        captured.append(step)
        with _capture_rules():
            step()

        def replay():
            with _capture_rules():
                step()
        return replay

    monkeypatch.setattr(step_graph, "capture_graph", fake_capture)
    train = eager.params["train"]
    a, b = (build_engine_full(eager.cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              device="cpu", train_params=train,
                              options=EngineOptions(backend=backend))
            for _ in range(2))
    graphed = b._replace(decode_fn=step_graph.StepGraph(
        b.cfg, b.scfg, b.params["serve"], b.state))
    assert len(captured) == 2          # the greedy and the sampled step
    rng = np.random.default_rng(4)
    states = {}
    for name, eng in (("eager", a), ("graphed", graphed)):
        st, out = eng.state, []
        for n_prompt, n_new in ((10, 5), (12, 4)):
            prompts = torch.from_numpy(rng.integers(
                0, eng.cfg.vocab_size, (SLOTS, n_prompt)).astype(np.int32))
            toks, st = generate(eng.params, eng.prefill_fn, eng.decode_fn,
                                st, prompts, n_new)
            out.append(toks)
        states[name] = (out, st)
        rng = np.random.default_rng(4)
    for x, y in zip(states["eager"][0], states["graphed"][0]):
        assert torch.equal(x, y)
    assert graphed.decode_fn.replays == 4 + 3
    _assert_same_bits(states["graphed"][1], states["eager"][1])


def test_scheduler_refuses_moe_and_backends_resolve(engines):
    """MoE serves lockstep: the port's ``SlotScheduler`` refuses it, as
    the reference's does; MLA and MoE resolve on both backends."""
    refs, ports = engines
    msg = "MoE capacity routing makes tokens depend on co-resident slots"
    with pytest.raises(AssertionError, match=msg):
        RefScheduler(refs["xla"], prompt_cap=PROMPT_CAP)
    with pytest.raises(AssertionError, match=msg):
        SlotScheduler(ports["xla"], prompt_cap=PROMPT_CAP)
    cfg = ports["xla"].cfg
    for c in (cfg, dense_mla(cfg)):
        assert autotune.resolve_serving(c, "xla", "auto") == ("xla", False)
        assert autotune.resolve_serving(c, "auto", "auto") == ("pallas",
                                                               True)


def test_dense_mla_xla_staggered_trace_matches_reference():
    """The dense-MLA arm on ``"xla"``: 4 requests on 3 slots through the
    scheduler (one slot re-admitted), events equal to the reference's XLA
    engine's, tokens ≥ 0.9, every slot freed at the end."""
    cfg, port_cfg = _configs(dense=True)
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train)
    assert port.scfg.backend == "xla"
    rng = np.random.default_rng(10)
    spec = [(0, 5, 3), (0, 7, 8), (1, 4, 6), (2, 9, 5)]  # arrival, len, new
    prompts = [rng.integers(0, port_cfg.vocab_size, n).tolist()
               for _, n, _ in spec]
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    r_res = ref_replay(r_sched, [(a, RefRequest(i, prompts[i], m))
                                 for i, (a, _, m) in enumerate(spec)])
    p_sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
    tracecount.reset()
    p_res = replay_trace(p_sched, [(a, Request(i, prompts[i], m))
                                   for i, (a, _, m) in enumerate(spec)])
    assert tracecount.calls()["fused_ffn"] == 0
    assert p_sched.events == r_sched.events
    readmitted = [s for _, k, _, s in p_sched.events if k == "admit"]
    assert len(readmitted) > len(set(readmitted))       # a slot was reused
    got = np.concatenate([p_res[r].tokens for r in sorted(p_res)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.9, (got, want)
    assert (p_sched.cache_lens() == -1).all()


def test_moe_admit_runs_the_whole_batch_as_the_reference(engines,
                                                        monkeypatch):
    """A targeted prefill insert on the MoE config at its capacity factor
    1.25, where tokens drop: prefill runs every slot's whole padded row
    through every layer, as the reference does (capacity is over all
    ``B·S`` tokens), so the admitted slots' first tokens and caches equal
    the reference's; the slot left out keeps its cache.  The port's
    engine is built afresh (its caches are written in place)."""
    refs, ports = engines
    ref, cfg = refs["xla"], ports["xla"].cfg
    port = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu",
                             train_params=ports["xla"].params["train"])
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT_CAP)).astype(
        np.int32)
    lens = np.array([5, 0, 11], np.int32)
    seen, real = [], moe.route

    def counted(moe_cfg, router, x):
        out = real(moe_cfg, router, x)
        seen.append((x.shape[0], _drops(out[0], moe_cfg)))
        return out

    monkeypatch.setattr(moe, "route", counted)
    r_tok, r_st = ref.admit_fn(ref.params["train"], ref.state, toks, lens)
    p_tok, p_st = port.admit_fn(port.params["train"], port.state, toks, lens)
    assert [t for t, _ in seen] == [SLOTS * PROMPT_CAP] * cfg.n_layers
    assert all(d for _, d in seen), seen
    adm = lens > 0                # the port's token is 0 elsewhere
    np.testing.assert_array_equal(_host(p_tok)[adm], _host(r_tok)[adm])
    np.testing.assert_array_equal(_host(p_st["cache_lens"]),
                                  _host(r_st["cache_lens"]))
    for r, p in zip(r_st["layers"], p_st["layers"]):
        np.testing.assert_array_equal(p.pos.numpy(), np.asarray(r.pos)[0, 0])
        got, want = _np(p.k), np.asarray(r.k[0, 0], np.float32)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got[0], want[0], **BF16)
