"""The port's unfused ``backend="xla"`` decode path (the reference's
default backend, the paper's baseline) held against the JAX package's
XLA path at reduced size, with the same weights carried across by
``from_reference_params``: the attention layer (``split_token_attention``
at cluster 1) and the whole engine, on reduced Llama2-7B and on RWKV-6
(where ``"auto"`` picks ``"xla"``); plus the backend/prepack resolution.

The port's layer runs B5's function, which keeps ``p`` in f32 for
``p·v``; the reference's XLA branch rounds q and p to the cache dtype
(``core/dataflow.py:552``, ``:320``), so outputs agree to the bf16
tolerance 1e-2 of ``tests/test_backend_parity.py`` and not to f32
(ROADMAP C5).  Token streams are bf16 greedy decodes: per-step tokens
must agree on at least 90 % of (step, active slot) and every
difference must be a near-tie, the reference's token within
``NEAR_TIE`` of the port's best logit (ROADMAP C2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import autotune as ref_autotune
from repro.core import dataflow as ref_df
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler
from repro.serving.scheduler import replay_trace as ref_replay

from test_torch_layers import dense_mla, jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import autotune, tracecount
from repro_torch.core import dataflow as df
from repro_torch.kernels.fused_decode.fused_decode import rope_at
from repro_torch.launch.serve import build_engine_full
from repro_torch.models.transformer import from_reference_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

SLOTS, MAX_SEQ, PROMPT_CAP = 3, 48, 16
NEAR_TIE = 0.05   # bf16 logits of a reduced random model: ~0.06 spread


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x)).reshape(-1)


# ---------------------------------------------------------------------------
# The attention layer: XLA branch of split_token_attention at cluster 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_loc,kv_loc,bias,cap", [(4, 4, False, 0.0),
                                                   (4, 2, True, 2.0)])
def test_split_token_attention_matches_reference_xla_branch(q_loc, kv_loc,
                                                            bias, cap):
    """One layer on a bf16 cache at lengths −1 (free), 0, 1, S − 1 and S
    (full: no append, attend to all S), with stale rows past every live
    prefix (``pos = row`` left by an earlier occupant, or −1): the
    output within 1e-2 (measured ≤ 7.9e-3 on values up to ≈ 2), the
    appended cache exactly, against the reference run under
    ``shard_map`` on a one-device mesh."""
    rng = np.random.default_rng(0)
    S, D, hd = 16, 64, 16
    lens = np.array([-1, 0, 1, S - 1, S], np.int32)
    B = len(lens)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x = f(B, D)
    wq, wk, wv = (f(D, n, hd, sc=D ** -0.5) for n in (q_loc, kv_loc, kv_loc))
    wo = f(q_loc * hd, D, sc=(q_loc * hd) ** -0.5)
    bs = ((f(q_loc, hd, sc=0.1), f(kv_loc, hd, sc=0.1),
           f(kv_loc, hd, sc=0.1)) if bias else (None,) * 3)
    k, v = f(S, B * kv_loc, hd), f(S, B * kv_loc, hd)
    row = np.arange(S)[:, None]
    stale = rng.random((S, B)) < 0.5
    pos = np.where(row < lens[None, :], row,
                   np.where(stale, row, -1)).astype(np.int32)
    assert (pos[:, 0] >= 0).any() and (pos[S // 2:, 2] >= 0).any()

    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    mesh = jax.make_mesh((1,), ("c",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    spec = ref_df.ClusterSpec(heads="c", cluster="c", backend="xla",
                              block_s=4)

    def body(k, v, pos, lens, x, wq, wk, wv, wo, *b):
        w = ref_df.SplitTokenWeights(wq, wk, wv, wo, *b)
        o, c = ref_df.split_token_attention(
            spec, x, w, ref_df.KVBlock(k, v, pos), lens, attn_softcap=cap)
        return o, c.k, c.v, c.pos

    args = [bf(k), bf(v), jnp.asarray(pos), jnp.asarray(lens)] + [
        bf(a) for a in (x, wq, wk, wv, wo) + (bs if bias else ())]
    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),) * len(args),
                             out_specs=(P(),) * 4, check_vma=False))(*args)

    tb = lambda a: None if a is None else torch.from_numpy(a).to(
        torch.bfloat16)
    cache = df.KVBlock(tb(k), tb(v), torch.from_numpy(pos.copy()))
    t_lens = torch.from_numpy(lens)
    cos, sin = rope_at(t_lens, hd)
    w = df.SplitTokenWeights(tb(wq), tb(wk), tb(wv), tb(wo),
                             *(tb(b) for b in bs))
    tracecount.reset()
    got = df.split_token_attention(tb(x), w, cache, t_lens, cos, sin,
                                   attn_softcap=cap)
    assert tracecount.calls()["flash_decode"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, D)
    assert not got[0].any()                          # a free slot: zeros
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want[0], np.float32),
                               rtol=1e-2, atol=1e-2)
    for name, g, r in zip(("k", "v", "pos"), cache, want[1:]):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r, np.float32),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# The engine on reduced Llama2-7B against the reference's XLA engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    """(reference on "xla", port on the default backend, port on
    "pallas"), all three on the reference's weights."""
    cfg = ref_reduced(ref_get_config("llama2-7b"))
    port_cfg = reduced(get_config("llama2-7b"))
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train)
    fused = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              device="cpu", train_params=train,
                              options=EngineOptions(backend="pallas"))
    return ref, port, fused


def test_default_backend_is_xla_with_the_train_tree_as_serve_tree(engines):
    """The reference's defaults: ``backend="xla"``, prepack ``"auto"`` →
    off; the serve tree is the train tree (no ``wqkv``, no bundles) and
    the decode state has the reference's layout."""
    ref, port, _ = engines
    assert (port.scfg.backend, port.scfg.prepack) == ("xla", False)
    assert (ref.scfg.backend, ref.scfg.prepack) == ("xla", False)
    assert port.params["serve"] is port.params["train"]
    assert "head" not in port.params["serve"]
    unwrap = lambda leaf: tuple(leaf.shape[2:])     # drop the [dp, ms] wrap
    for r, p in zip(ref.state["layers"], port.state["layers"]):
        for name in ("k", "v", "pos"):
            assert tuple(getattr(p, name).shape) == unwrap(getattr(r, name))
    assert tuple(port.state["cache_lens"].shape) == unwrap(
        ref.state["cache_lens"])


def test_xla_decode_step_makes_one_flash_decode_call_per_layer(engines):
    _, port, _ = engines
    nxt, st = port.prefill_fn(port.params["train"], port.state,
                              np.ones((SLOTS, 4), np.int32))
    tracecount.reset()
    port.decode_fn(port.params["serve"], st, nxt)
    calls = tracecount.calls()
    assert calls == {"flash_decode": port.cfg.n_layers, "fused_decode": 0,
                     "fused_ffn": 0, "fused_head": 0, "fused_mla_decode": 0,
                     "rwkv6_scan": 0, "rglru_scan": 0}
    assert sum(tracecount.launches().values()) == 0     # CPU: no kernels


def _forced(eng, prompts, forced, *, ref=False, cands=None):
    """Prefill then teacher-forced decode steps: the tokens of every
    step, ``[steps + 1, B]``."""
    if ref:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts,
                                 None)
    else:
        tok, st = eng.prefill_fn(eng.params["train"], eng.state, prompts)
    out = [_host(tok)]
    for t in range(len(forced)):
        f = forced[t] if ref else torch.from_numpy(forced[t])
        tok, st = eng.decode_fn(eng.params["serve"], st, f)
        out.append(_host(tok))
    return np.stack(out), st


def _capture_loose_head(monkeypatch):
    """Every decode step's loose-head candidates, in order."""
    cands = []
    real = engine_mod.head_candidates

    def capture(logits, k):
        out = real(logits, k)
        cands.append(out)
        return out

    monkeypatch.setattr(engine_mod, "head_candidates", capture)
    return cands


def _assert_near_ties(got, want, cands):
    """Every (decode step, slot) where the port's token differs: the
    reference's token among the port's candidates, within NEAR_TIE of
    its best."""
    for t, b in zip(*np.nonzero(got[1:] != want[1:])):
        vals, ids = (c[b].numpy() for c in cands[t])
        assert want[1 + t, b] in ids, (t, b, ids)
        gap = vals[0] - vals[list(ids).index(want[1 + t, b])]
        assert gap <= NEAR_TIE, (t, b, gap)


def test_xla_teacher_forced_decode_matches_reference(engines, monkeypatch):
    """Same prompts, then the same forced input tokens on both sides each
    step: greedy tokens agree on ≥ 0.9 of (step, slot) and every
    difference is a near-tie (with these seeds 25 of 27 agree; at the
    other two the reference's token is 0.006 and 0.013 below the port's
    best)."""
    ref, port, _ = engines
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, port.cfg.vocab_size, (SLOTS, 10)).astype(
        np.int32)
    forced = rng.integers(0, port.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    want, r_st = _forced(ref, prompts, forced, ref=True)
    cands = _capture_loose_head(monkeypatch)
    got, p_st = _forced(port, prompts, forced)
    assert len(cands) == len(forced)
    assert (got == want).mean() >= 0.9, (got, want)
    _assert_near_ties(got, want, cands)
    np.testing.assert_array_equal(_host(p_st["cache_lens"]),
                                  _host(r_st["cache_lens"]))


def test_xla_staggered_trace_matches_reference(engines):
    """4 requests on 3 slots through ``SlotScheduler``: one retires
    mid-run and its slot is re-admitted; events agree event for event
    and tokens on ≥ 0.9 (with these seeds all 22)."""
    ref, port, _ = engines
    rng = np.random.default_rng(1)
    spec = [(0, 5, 3), (0, 7, 8), (1, 4, 6), (2, 9, 5)]  # arrival, len, new
    prompts = [rng.integers(0, port.cfg.vocab_size, n).tolist()
               for _, n, _ in spec]
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    p_sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
    r_res = ref_replay(r_sched, [(a, RefRequest(i, prompts[i], m))
                                 for i, (a, _, m) in enumerate(spec)])
    p_res = replay_trace(p_sched, [(a, Request(i, prompts[i], m))
                                   for i, (a, _, m) in enumerate(spec)])
    assert p_sched.events == r_sched.events
    readmitted = [s for _, k, _, s in p_sched.events if k == "admit"]
    assert len(readmitted) > len(set(readmitted))       # a slot was reused
    got = np.concatenate([p_res[r].tokens for r in sorted(p_res)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.9, (got, want)
    assert (p_sched.cache_lens() == -1).all()


def test_xla_and_pallas_engines_agree(engines):
    """The unfused and the fused port engines on the same weights: the
    same teacher-forced tokens on ≥ 0.9 of (step, slot) (with these
    seeds all 27; the card's counterpart is ``chip_smoke.py`` phase
    5)."""
    _, port, fused = engines
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, port.cfg.vocab_size, (SLOTS, 12)).astype(
        np.int32)
    forced = rng.integers(0, port.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    tracecount.reset()
    unfused, _ = _forced(port, prompts, forced)
    assert tracecount.calls()["fused_decode"] == 0
    fused_toks, _ = _forced(fused, prompts, forced)
    assert tracecount.calls()["fused_decode"] == len(forced) * \
        port.cfg.n_layers
    assert (unfused == fused_toks).mean() >= 0.9, (unfused, fused_toks)


# ---------------------------------------------------------------------------
# RWKV-6: "auto" resolves to "xla"
# ---------------------------------------------------------------------------
def test_rwkv6_auto_resolves_to_xla_and_matches_reference(monkeypatch):
    """An attention-free model on ``"auto"``: the XLA backend, the train
    tree as serve tree, the loose head (no B3 call), one B7 call a layer;
    teacher-forced tokens against the reference's XLA engine on ≥ 0.9
    of (step, slot), every difference a near-tie (with these seeds all
    21 agree)."""
    cfg = ref_reduced(ref_get_config("rwkv6-3b"))
    port_cfg = reduced(get_config("rwkv6-3b"))
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="auto"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train,
                             options=EngineOptions(backend="auto"))
    assert (port.scfg.backend, port.scfg.prepack) == ("xla", False)
    assert ref.scfg.backend == "xla"
    assert port.params["serve"] is port.params["train"]
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, port_cfg.vocab_size, (SLOTS, 10)).astype(
        np.int32)
    forced = rng.integers(0, port_cfg.vocab_size, (6, SLOTS)).astype(
        np.int32)
    want, _ = _forced(ref, prompts, forced, ref=True)
    cands = _capture_loose_head(monkeypatch)
    tracecount.reset()
    got, _ = _forced(port, prompts, forced)
    calls = tracecount.calls()
    assert calls["rwkv6_scan"] == (len(forced) + 1) * port_cfg.n_layers
    assert calls["fused_head"] == 0 and calls["flash_decode"] == 0
    assert (got == want).mean() >= 0.9, (got, want)
    _assert_near_ties(got, want, cands)


# ---------------------------------------------------------------------------
# Backend and prepack resolution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama2-7b", "rwkv6-3b",
                                  "deepseek-v2-lite", "recurrentgemma-9b"])
def test_backend_and_prepack_resolve_as_the_reference(arch):
    cfg, ref_cfg = reduced(get_config(arch)), ref_reduced(ref_get_config(
        arch))
    for backend in ("auto", "xla", "pallas"):
        b = autotune._backend_for(cfg, backend)
        assert b == ref_autotune._backend_for(ref_cfg, backend)
        for prepack in ("auto", None, "on", "off", "true", "0", True, False):
            assert autotune._prepack_for(b, prepack) == \
                ref_autotune._prepack_for(b, prepack)
    with pytest.raises(ValueError, match="prepack"):
        autotune._prepack_for("xla", "sometimes")
    with pytest.raises(ValueError, match="backend"):
        autotune._backend_for(cfg, "triton")


def test_unservable_combinations_raise_naming_the_roadmap():
    """MLA on ``"xla"`` (item 4b) and ``"pallas"`` with prepack off on an
    attention model (B1's ``fuse_out=False`` mode, Queue B) raise before
    any weight is made; an attention-free model may turn prepack off."""
    mla = dense_mla(reduced(get_config("deepseek-v2-lite")))
    llama = reduced(get_config("llama2-7b"))
    with pytest.raises(NotImplementedError, match="item 4b"):
        build_engine_full(mla, max_seq=16, batch_global=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue B"):
        build_engine_full(llama, max_seq=16, batch_global=2, device="cpu",
                          options=EngineOptions(backend="pallas",
                                                prepack="off"))
    assert autotune.resolve_serving(
        reduced(get_config("rwkv6-3b")), "pallas", "off") == ("pallas",
                                                               False)
