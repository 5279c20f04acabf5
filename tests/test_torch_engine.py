"""The port's serving slice as a whole held against the JAX package's
single-device engine on the fused, prepacked Pallas path (interpret
mode), with the same weights carried across by
``from_reference_params``, at the reduced Llama2-7B config and the
reduced dense-MLA DeepSeek-V2-Lite (``moe=None``): the ``engines``
fixture runs every engine test on both.

Token streams are bf16 greedy decodes: a near-tie may flip the argmax
under another summation order (ROADMAP fault C2), so per-step tokens
must agree on at least 90 % of (step, active slot) — the bar the
reference's own backend-parity tests use.  With the seeds below the
Llama teacher-forced run agrees on 25 of 27 cells (the other two are
near-ties, the port's top two logits within 0.015) and the trace on
every token.  The dense-MLA teacher-forced run agrees on 27 of 27.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler
from repro.serving.scheduler import replay_trace as ref_replay

from test_torch_layers import dense_mla, jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models.transformer import from_reference_params
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

SLOTS, MAX_SEQ, PROMPT_CAP = 3, 48, 16
ARCHS = ("llama2-7b", "deepseek-v2-lite")


def _configs(arch):
    """(reference, port) reduced configs; DeepSeek-V2-Lite as its dense-MLA
    arm (the MoE model's engines: ``tests/test_torch_moe.py``)."""
    ref_cfg = ref_reduced(ref_get_config(arch))
    port_cfg = reduced(get_config(arch))
    if ref_cfg.moe is not None:
        ref_cfg, port_cfg = dense_mla(ref_cfg), dense_mla(port_cfg)
    return ref_cfg, port_cfg


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    cfg, port_cfg = _configs(request.param)
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS,
                    options=RefOptions(backend="pallas", interpret=True,
                                       prepack="on", fuse_head=True))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train,
                             options=EngineOptions(backend="pallas"))
    return ref, port


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x)).reshape(-1)


def test_decode_state_layout_matches_reference(engines):
    ref, port = engines
    unwrap = lambda leaf: tuple(leaf.shape[2:])     # drop the [dp, ms] wrap
    for r, p in zip(ref.state["layers"], port.state["layers"]):
        for name in ("k", "v", "pos"):
            assert tuple(getattr(p, name).shape) == unwrap(getattr(r, name))
            assert str(getattr(p, name).dtype).split(".")[-1] == \
                str(getattr(r, name).dtype)
    assert tuple(port.state["cache_lens"].shape) == unwrap(
        ref.state["cache_lens"])
    assert set(port.state["sampling"]) == set(ref.state["sampling"])


def test_decode_step_makes_two_calls_per_layer_plus_head(engines):
    _, port = engines
    cfg = port.cfg
    nxt, st = port.prefill_fn(port.params["train"], port.state,
                              np.ones((SLOTS, 4), np.int32))
    tracecount.reset()
    port.decode_fn(port.params["serve"], st, nxt)
    calls = tracecount.calls()
    attn, other = (("fused_mla_decode", "fused_decode") if cfg.mla
                   else ("fused_decode", "fused_mla_decode"))
    assert calls == {attn: cfg.n_layers, other: 0, "rwkv6_scan": 0,
                     "flash_decode": 0, "rglru_scan": 0,
                     "fused_ffn": cfg.n_layers, "fused_head": 1}
    assert sum(calls.values()) == 2 * cfg.n_layers + 1
    assert sum(tracecount.launches().values()) == 0     # CPU: no kernels


def test_teacher_forced_decode_matches_reference(engines):
    """Prefill the same prompts, then force the same input tokens on both
    sides each step (no cascade from an earlier disagreement)."""
    ref, port = engines
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, port.cfg.vocab_size, (SLOTS, 10)).astype(
        np.int32)
    forced = rng.integers(0, port.cfg.vocab_size, (8, SLOTS)).astype(
        np.int32)
    r_tok, r_st = ref.prefill_fn(ref.params["train"], ref.state, prompts,
                                 None)
    p_tok, p_st = port.prefill_fn(port.params["train"], port.state, prompts)
    r_out, p_out = [_host(r_tok)], [_host(p_tok)]
    for t in range(len(forced)):
        r_tok, r_st = ref.decode_fn(ref.params["serve"], r_st, forced[t])
        p_tok, p_st = port.decode_fn(port.params["serve"], p_st,
                                     torch.from_numpy(forced[t]))
        r_out.append(_host(r_tok))
        p_out.append(_host(p_tok))
    agree = (np.stack(r_out) == np.stack(p_out)).mean()
    assert agree >= 0.9, (agree, np.stack(r_out), np.stack(p_out))
    np.testing.assert_array_equal(_host(p_st["cache_lens"]),
                                  _host(r_st["cache_lens"]))


def test_staggered_trace_matches_reference(engines):
    """4 requests on 3 slots: one retires mid-run and its slot is
    re-admitted.  Admission and finish events agree event for event."""
    ref, port = engines
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
    assert any(k == "finish" and t < p_sched.events[-1][0]
               for t, k, _, _ in p_sched.events)
    readmitted = [s for _, k, _, s in p_sched.events if k == "admit"]
    assert len(readmitted) > len(set(readmitted))       # a slot was reused
    got = np.concatenate([p_res[r].tokens for r in sorted(p_res)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.9, (got, want)
    assert (p_sched.cache_lens() == -1).all()


def test_generate_and_sampling_limits(engines):
    _, port = engines
    prompts = torch.ones((SLOTS, 3), dtype=torch.int32)
    toks, st = generate(port.params, port.prefill_fn, port.decode_fn,
                        port.state, prompts, 4)
    assert toks.shape == (SLOTS, 4)
    assert _host(st["cache_lens"]).tolist() == [6] * SLOTS
    sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
    # sampled requests are served (tests/test_torch_sampling.py)
    sampled = SamplingParams(temperature=0.7, top_k=4, seed=3)
    sched.submit(Request(0, [1, 2], 3, sampling=sampled))
    assert sched.run()[0].sampling == sampled
    assert len(sched.results[0].tokens) == 3
    with pytest.raises(ValueError, match="top_k"):
        sched.submit(Request(1, [1, 2], 3, sampling=SamplingParams(top_k=9)))
    with pytest.raises(ValueError, match="prompt_cap"):
        sched.submit(Request(2, [1] * (PROMPT_CAP + 1), 3))
    with pytest.raises(ValueError, match=r"params\['serve'\]"):
        port.decode_fn(port.params, st, prompts[:, 0])


def test_check_finite_sentinel_counts_only_corrupt_active_slots():
    """``check_finite``: a NaN in one slot's residual stream is counted
    for that slot while it is active, and a retire clears it."""
    cfg = reduced(get_config("llama2-7b"))
    eng = build_engine_full(cfg, max_seq=16, batch_global=2, device="cpu",
                            options=EngineOptions(backend="pallas",
                                                  check_finite=True))
    tok, st = eng.prefill_fn(eng.params["train"], eng.state,
                             np.ones((2, 3), np.int32))
    _, st = eng.decode_fn(eng.params["serve"], st, tok)
    assert _host(st["nonfinite"]).tolist() == [0, 0]
    embed = eng.params["serve"]["embed"]
    saved = embed[5].clone()
    embed[5] = float("nan")                     # slot 1 feeds token 5
    try:
        _, st = eng.decode_fn(eng.params["serve"], st, torch.tensor([1, 5]))
    finally:
        embed[5] = saved
    assert _host(st["nonfinite"]).tolist() == [0, 1]
    st = eng.retire_fn(st, np.array([0, 1]))
    assert _host(st["nonfinite"]).tolist() == [0, 0]


def test_kv_append_matches_reference():
    """The ragged KV append around B1: free slots (−1) and a full cache
    (length S, owned by no rank at cluster size 1) write nothing."""
    import jax.numpy as jnp
    from repro.core import dataflow as ref_df
    from repro_torch.core import dataflow as df
    rng = np.random.default_rng(2)
    S, B, kv, hd = 6, 4, 2, 4
    k, v = (rng.standard_normal((S, B * kv, hd)).astype(np.float32)
            for _ in range(2))
    pos = rng.integers(-1, S, (S, B)).astype(np.int32)
    k_new, v_new = (rng.standard_normal((B, kv, hd)).astype(np.float32)
                    for _ in range(2))
    lens = np.array([-1, 0, 3, S], np.int32)
    want = ref_df._insert_kv_ragged(
        ref_df.KVBlock(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(lens // S),
        jnp.asarray(lens % S), jnp.int32(0), jnp.asarray(lens))
    cache = df.KVBlock(*(torch.from_numpy(a.copy()) for a in (k, v, pos)))
    t_lens = torch.from_numpy(lens)
    df._insert_kv_ragged(cache, torch.from_numpy(k_new),
                         torch.from_numpy(v_new), t_lens)
    for g, w in zip(cache, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prefill_insert_matches_reference_cache(engines):
    """A targeted prefill insert: slots with length 0 keep their cache,
    the others hold their prompt's k/v at positions below the length and
    ``pos = −1`` (and zeros) beyond it, as in the reference's cache.
    Values are compared for the first layer, whose k/v come straight from
    the embedding; deeper layers' k/v follow a layer of bf16 rounding
    flips, which compound elementwise (the forward test compares bf16 by
    tokens for the same reason)."""
    ref, port = engines
    rng = np.random.default_rng(3)
    toks = rng.integers(0, port.cfg.vocab_size, (SLOTS, PROMPT_CAP)).astype(
        np.int32)
    first = np.array([4, 7, 2], np.int32)
    second = np.array([0, 9, 0], np.int32)
    r_tok, r_st = ref.admit_fn(ref.params["train"], ref.state, toks, first)
    p_tok, p_st = port.admit_fn(port.params["train"], port.state, toks,
                                first)
    r_tok, r_st = ref.admit_fn(ref.params["train"], r_st, toks[::-1].copy(),
                               second)
    p_tok, p_st = port.admit_fn(port.params["train"], p_st,
                                toks[::-1].copy(), second)
    assert _host(p_tok)[1] == _host(r_tok)[1]
    np.testing.assert_array_equal(_host(p_st["cache_lens"]), [4, 9, 2])
    np.testing.assert_array_equal(_host(r_st["cache_lens"]), [4, 9, 2])
    for r, p in zip(r_st["layers"], p_st["layers"]):
        np.testing.assert_array_equal(p.pos.numpy(), np.asarray(r.pos)[0, 0])
        for name in ("k", "v"):
            got = getattr(p, name).float().numpy()
            want = np.asarray(getattr(r, name)[0, 0], np.float32)
            np.testing.assert_array_equal(got == 0, want == 0)
            np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)


def test_pack_mla_matches_reference():
    """``wproj = W_UV·W_O`` per head: within one bf16 ulp of the
    reference's ``_pack_mla`` (both sum in f32, in different orders, and
    round once); ``wq`` is a view of the train tensor, ``wdkv``/``wuk``
    alias it."""
    from repro.models.transformer import Layout, init_device_major
    from repro.serving import prepack as ref_prepack
    from repro_torch.serving import prepack
    cfg, port_cfg = _configs("deepseek-v2-lite")
    tree = init_device_major(cfg, Layout(1), jax.random.PRNGKey(3))
    train = from_reference_params(port_cfg, jax_tree_to_numpy(tree),
                                  device="cpu")
    blk = train["blocks"][0]
    got = prepack._pack_mla(blk["attn"], blk["ln1"])
    assert got.wq.data_ptr() == blk["attn"]["wq"].data_ptr()
    assert got.wdkv is blk["attn"]["wdkv"] and got.wuk is blk["attn"]["wuk"]
    assert got.ln1 is blk["ln1"]
    ref_attn = tree["blocks"][0]["attn"]
    for g in range(port_cfg.n_layers):
        want = ref_prepack._pack_mla(
            cfg, Layout(1), "pallas",
            jax.tree.map(lambda leaf: leaf[:, g], ref_attn))
        w = np.asarray(want.wproj[0], np.float32)
        gw = got.wproj[g].float().numpy()
        assert gw.shape == w.shape
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(gw - w) <= ulp).all(), np.abs(gw - w).max()
        np.testing.assert_array_equal(got.wq[g].float().numpy(), np.asarray(
            want.wq[0], np.float32))
