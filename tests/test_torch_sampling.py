"""Sampled decoding in the port (``core/threefry.py``,
``serving/sampling.py``) held against the JAX package on the CPU.

* Threefry: ``fold_in(PRNGKey(seed), n)``'s key words and the random
  bits drawn from it equal ``jax.random``'s exactly, for seeds 0, 1,
  2^31 and 2^32 − 1 and several emit offsets.
* Gumbel: the port takes each logarithm in float64 and rounds it to
  float32 (so the card and the CPU agree); XLA's float32 ``log`` differs
  from that by at most 1 ulp, measured on 20 000 draws: the inner
  ``−log u`` within 1 ulp, the Gumbel value within 1 ulp of
  ``max(|g|, 1)`` (near g = 0 one ulp of the inner value is many ulps of
  the result, so the bound is absolute there: 2^-23).
* ``finalize_candidates``: the port's tokens equal the reference's on
  4096 random rows mixing temperature 0, top-k, top-p and seeds; a row
  may differ only where the two best perturbed scores lie within 1e-5
  (a near-tie the ulp above can flip), and at most 0.1 % may: the
  measured count is 0.  Temperature 0 is candidate 0, bit for bit.
* Validation messages name the offending field, the reference's
  messages; a scheduler with greedy and sampled requests records each
  request's params and seeds the state leaves as the reference's does,
  and a sampled stream reruns equal under its seed and moves under
  another.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.serving import sampling as ref_sampling
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import threefry
from repro_torch.launch.serve import build_engine_full
from repro_torch.models.transformer import from_reference_params
from repro_torch.serving import sampling
from repro_torch.serving.engine import EngineOptions
from repro_torch.serving.sampling import (CAND_K, GREEDY, SamplingParams,
                                          finalize_candidates,
                                          greedy_candidates,
                                          validate_sampling)
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace

SEEDS = (0, 1, 2 ** 31, 2 ** 32 - 1)
OFFSETS = (0, 1, 7, 1000, 2 ** 31 - 1)
SLOTS, MAX_SEQ, PROMPT_CAP = 2, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and
    beside other test workers torch's thread pool only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_key(seed, n):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)),
                              jnp.uint32(n))


def _port_key(seed, n):
    return threefry.fold_in(threefry.prng_key(torch.tensor([seed])),
                            torch.tensor([n]))


def _ints(x) -> np.ndarray:
    return np.asarray(x).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_equal_jax(seed):
    for n in OFFSETS:
        key = _jax_key(seed, n)
        k1, k2 = _port_key(seed, n)
        assert [int(k1[0]), int(k2[0])] == \
            np.asarray(jax.random.key_data(key)).tolist(), (seed, n)
        bits = threefry.random_bits((k1, k2), CAND_K)[0].tolist()
        assert bits == np.asarray(
            jax.random.bits(key, (CAND_K,), jnp.uint32)).tolist(), (seed, n)


def test_threefry_batched_rows_equal_one_at_a_time():
    """The ``[B]`` keys of a batch hash independently: row b of a batched
    draw is the draw of row b alone (what the per-slot leaves rely on)."""
    seeds = torch.tensor(SEEDS, dtype=torch.int64)
    steps = torch.tensor(OFFSETS[:4], dtype=torch.int32)
    batch = threefry.positional_gumbel(seeds, steps, CAND_K)
    for b in range(4):
        one = threefry.positional_gumbel(seeds[b:b + 1], steps[b:b + 1],
                                         CAND_K)
        assert torch.equal(batch[b:b + 1], one)


def test_gumbel_within_one_ulp_of_jax():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 32, 2500, dtype=np.uint64).astype(np.uint32)
    steps = rng.integers(0, 5000, 2500).astype(np.int32)
    draw = jax.vmap(lambda s, n: jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(s), n), (CAND_K,),
        jnp.float32))
    want = np.asarray(draw(jnp.asarray(seeds), jnp.asarray(steps)))
    got = threefry.positional_gumbel(torch.as_tensor(seeds.astype(np.int64)),
                                     torch.as_tensor(steps), CAND_K).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    # the inner −log u: one ulp at most
    inner = jax.vmap(lambda s, n: -jnp.log(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(s), n), (CAND_K,),
        jnp.float32, minval=jnp.finfo(jnp.float32).tiny)))
    key = threefry.fold_in(threefry.prng_key(
        torch.as_tensor(seeds.astype(np.int64))), torch.as_tensor(steps))
    u = threefry.uniform_from_bits(threefry.random_bits(key, CAND_K),
                                   threefry.TINY_F32)
    p_inner = (-torch.log(u.double())).float().numpy()
    r_inner = np.asarray(inner(jnp.asarray(seeds), jnp.asarray(steps)))
    assert np.abs(_ints(p_inner) - _ints(r_inner)).max() <= 1
    # the Gumbel value: within one ulp of max(|g|, 1)
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    assert (got == want).mean() > 0.7


def test_gumbel_uniform_edges():
    """Bits 0 give ``minval`` (the tiniest normal, clamped), all ones
    ``1 − 2^-23`` (23 random mantissa bits), as jax's ``_uniform``."""
    bits = torch.tensor([[0, 0xFFFFFFFF, 1 << 9]], dtype=torch.int64)
    u = threefry.uniform_from_bits(bits, threefry.TINY_F32)[0]
    assert float(u[0]) == np.float32(threefry.TINY_F32)
    assert float(u[1]) == 1.0 - 2.0 ** -23
    assert float(u[2]) == 2.0 ** -23


def _random_rows(rng, B):
    vals = np.sort(rng.standard_normal((B, CAND_K)).astype(np.float32) * 3,
                   axis=1)[:, ::-1].copy()
    ids = np.stack([rng.choice(1000, CAND_K, replace=False)
                    for _ in range(B)]).astype(np.int32)
    leaves = {
        "temp": rng.choice([0.0, 0.5, 0.8, 1.0, 2.0], B).astype(np.float32),
        "topk": rng.integers(1, CAND_K + 1, B).astype(np.int32),
        "topp": rng.choice([1.0, 0.9, 0.5, 0.1, 1e-6], B).astype(np.float32),
        "seed": rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32),
        "step": rng.integers(0, 100, B).astype(np.int32)}
    return vals, ids, leaves


def _port_leaves(leaves):
    return {k: torch.as_tensor(v.astype(np.int64) if k == "seed" else v)
            for k, v in leaves.items()}


def _noise(leaves):
    """Each row's positional noise, as the step looks it up."""
    return threefry.positional_gumbel(
        torch.as_tensor(leaves["seed"].astype(np.int64)),
        torch.as_tensor(leaves["step"]), CAND_K)


def _finalize(vals, ids, leaves):
    return finalize_candidates(torch.as_tensor(vals), torch.as_tensor(ids),
                               _port_leaves(leaves), _noise(leaves))


def test_finalize_candidates_equal_reference_but_counted_near_ties():
    rng = np.random.default_rng(1)
    B = 4096
    vals, ids, leaves = _random_rows(rng, B)
    r_tok, r_val = ref_sampling.finalize_candidates(
        jnp.asarray(vals), jnp.asarray(ids),
        {k: jnp.asarray(v) for k, v in leaves.items()})
    p_tok, p_val = _finalize(vals, ids, leaves)
    r_tok, r_val = np.asarray(r_tok), np.asarray(r_val)
    differ = np.nonzero(r_tok != p_tok.numpy())[0]
    assert len(differ) <= B // 1000, differ
    if len(differ):                  # each one a near-tie of the draw
        gum = _noise(leaves).numpy()
        for b in differ:
            s = vals[b] / max(leaves["temp"][b], 1e-6) + gum[b]
            top = np.sort(s)[-2:]
            assert top[1] - top[0] < 1e-5, b
    same = r_tok == p_tok.numpy()
    np.testing.assert_array_equal(r_val[same], p_val.numpy()[same])
    assert (leaves["temp"] > 0).sum() > B // 2      # most rows sampled
    # the draw moved most sampled rows off candidate 0
    assert (p_tok.numpy() != ids[:, 0])[leaves["temp"] > 0].mean() > 0.05


def test_temperature_zero_is_candidate_zero_whatever_the_seed():
    rng = np.random.default_rng(2)
    vals, ids, leaves = _random_rows(rng, 64)
    leaves["temp"][:] = 0.0
    tok, val = _finalize(vals, ids, leaves)
    assert torch.equal(tok, torch.as_tensor(ids[:, 0]))
    assert torch.equal(val, torch.as_tensor(vals[:, 0]))
    g_tok, g_val = greedy_candidates(torch.as_tensor(vals),
                                     torch.as_tensor(ids))
    assert torch.equal(g_tok, tok) and torch.equal(g_val, val)


def test_top_k_and_top_p_restrict_the_support():
    rng = np.random.default_rng(3)
    vals, ids, leaves = _random_rows(rng, 256)
    leaves["temp"][:] = 1.5
    leaves["topp"][:] = 1.0
    for j in (1, 2, 3):
        leaves["topk"][:] = j
        tok, val = _finalize(vals, ids, leaves)
        rank = (torch.as_tensor(ids) == tok[:, None]).int().argmax(dim=1)
        assert (rank < j).all()
        assert torch.equal(val, torch.as_tensor(vals)[torch.arange(256),
                                                      rank])
    leaves["topk"][:] = CAND_K
    leaves["topp"][:] = 1e-6                 # the nucleus is rank 0 alone
    tok, _ = _finalize(vals, ids, leaves)
    assert torch.equal(tok, torch.as_tensor(ids[:, 0]))


def test_sampling_params_validation_names_offending_field():
    validate_sampling(0, GREEDY)
    validate_sampling(0, SamplingParams(temperature=0.7, top_k=4, top_p=0.9,
                                        seed=3))
    for sp, field in (
            (SamplingParams(temperature=-0.1), "temperature"),
            (SamplingParams(top_k=0), "top_k"),
            (SamplingParams(top_k=CAND_K + 1), "top_k"),
            (SamplingParams(top_p=0.0), "top_p"),
            (SamplingParams(top_p=1.5), "top_p")):
        with pytest.raises(ValueError, match=field) as ei:
            validate_sampling(7, sp)
        assert "request 7" in str(ei.value)
        with pytest.raises(ValueError) as ri:
            ref_sampling.validate_sampling(
                7, ref_sampling.SamplingParams(**dataclasses.asdict(sp)))
        assert str(ei.value) == str(ri.value)
    with pytest.raises(ValueError, match="CAND_K"):
        validate_sampling(0, SamplingParams(top_k=99))


@pytest.fixture(scope="module")
def engines():
    """The reference's XLA engine and the port's on its weights
    (reduced Llama2-7B, two slots)."""
    cfg = ref_reduced(ref_get_config("llama2-7b"))
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    port_cfg = reduced(get_config("llama2-7b"))
    train = from_reference_params(
        port_cfg, jax_tree_to_numpy(ref.params["train"]), device="cpu")
    port = build_engine_full(port_cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                             device="cpu", train_params=train)
    return ref, port


def _trace(seed, temperature=0.9):
    sp = SamplingParams(temperature=temperature, top_k=6, top_p=0.95,
                        seed=seed)
    return [(0, Request(0, [5, 9, 2, 8], 8)),
            (0, Request(1, [4, 4, 1], 8, sampling=sp))]


def _run(port, trace):
    return replay_trace(SlotScheduler(port, prompt_cap=PROMPT_CAP), trace)


def test_scheduler_heterogeneous_sampling_recorded_and_seeded(engines):
    """One greedy and one sampled request in one batch: the params land
    on ``RequestResult``; the admit writes the state leaves the
    reference's admit writes; the sampled stream reruns equal under its
    seed and moves under another; the greedy stream rides along
    unchanged."""
    ref, port = engines
    res = _run(port, _trace(41))
    assert res[0].sampling == GREEDY
    assert res[1].sampling == SamplingParams(temperature=0.9, top_k=6,
                                             top_p=0.95, seed=41)
    assert _run(port, _trace(41))[1].tokens == res[1].tokens
    other = _run(port, _trace(1234))
    assert other[0].tokens == res[0].tokens
    assert other[1].tokens != res[1].tokens
    greedy = _run(port, _trace(41, temperature=0.0))
    assert greedy[1].tokens != res[1].tokens
    assert greedy[0].tokens == res[0].tokens

    # the admitted leaves against the reference's, after one tick each
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    p_sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
    for (_, req) in _trace(41):
        r_sched.submit(RefRequest(req.rid, req.prompt, req.max_new,
                                  sampling=ref_sampling.SamplingParams(
                                      **dataclasses.asdict(req.sampling))))
        p_sched.submit(req)
    r_sched.step()
    p_sched.step()
    for name in sampling.SAMPLING_LEAVES:
        want = np.asarray(jax.device_get(
            r_sched.state["sampling"][name])).reshape(-1)
        got = p_sched.state["sampling"][name].numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), name)
    assert p_sched.state["sampling"]["seed"].dtype == torch.int64


def test_sampled_trace_tokens_against_the_reference(engines):
    """The same weights, trace and seeds through both schedulers: the
    sampled streams agree on ≥ 0.9 of the tokens (a near-tie of the
    logits, ROADMAP C2, or of the draw may move one)."""
    ref, port = engines
    rng = np.random.default_rng(5)
    trace = []
    for rid in range(5):
        sp = SamplingParams(temperature=0.8, top_k=int(rng.integers(1, 9)),
                            top_p=float(rng.choice([1.0, 0.9])), seed=rid)
        trace.append((rid // 2, Request(
            rid, rng.integers(1, port.cfg.vocab_size, 4).tolist(), 6,
            sampling=sp)))
    p_res = _run(port, trace)
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    from repro.serving.scheduler import replay_trace as ref_replay
    r_res = ref_replay(r_sched, [(t, RefRequest(
        r.rid, r.prompt, r.max_new, sampling=ref_sampling.SamplingParams(
            **dataclasses.asdict(r.sampling)))) for t, r in trace])
    got = np.concatenate([p_res[r].tokens for r in sorted(p_res)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    assert (got == want).mean() >= 0.9, (got, want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_both_backends_serve_sampled_requests(backend):
    """Sampled requests through ``SlotScheduler`` on either backend, from
    one seed: every token in the vocabulary, a rerun equal token for
    token, and the greedy request's stream the one it has with no
    sampled neighbour."""
    cfg = reduced(get_config("llama2-7b"))
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu", seed=0,
                            options=EngineOptions(backend=backend))
    extra = [(1, Request(2, [3, 1, 4, 1, 5], 5, sampling=SamplingParams(
        temperature=0.5, seed=9)))]
    res = _run(eng, _trace(7) + extra)
    toks = np.concatenate([r.tokens for r in res.values()])
    assert len(toks) == 21 and (0 <= toks).all() \
        and (toks < cfg.vocab_size).all()
    again = _run(eng, _trace(7) + extra)
    assert {r: again[r].tokens for r in again} == \
        {r: res[r].tokens for r in res}
    greedy = _run(eng, _trace(7, temperature=0.0))
    assert greedy[0].tokens == res[0].tokens


def test_the_admit_writes_each_slots_noise_table(engines):
    """The admit writes ``state["gumbel"]`` for each admitted slot: row
    ``(b, t)`` is the positional draw of its seed at offset ``t``, which
    the step looks up by the slot's emit offset."""
    _, port = engines
    sched = SlotScheduler(port, prompt_cap=PROMPT_CAP)
    sched.submit(Request(0, [3, 1, 4], 4, sampling=SamplingParams(
        temperature=0.8, seed=2 ** 32 - 7)))
    sched.step()
    table = sched.state["gumbel"]
    assert table.shape == (SLOTS, MAX_SEQ, CAND_K)
    want = threefry.positional_gumbel(
        torch.full((MAX_SEQ,), 2 ** 32 - 7, dtype=torch.int64),
        torch.arange(MAX_SEQ, dtype=torch.int32), CAND_K)
    assert torch.equal(table[0], want)
    assert torch.equal(table[1], torch.zeros_like(table[1]))


def test_greedy_batches_never_reach_the_sampler(monkeypatch):
    """A step or an admit with no live sampled slot takes candidate 0
    without the sampler's arithmetic: an all-greedy trace calls
    ``finalize_candidates`` never; beside one sampled request it is
    called by its admit and by each decode step while it is live, and
    the greedy stream is the one it has alone."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import prefill as prefill_mod
    calls = []

    def counted(*args):
        calls.append(args[0].shape[0])
        return finalize_candidates(*args)

    monkeypatch.setattr(engine_mod, "finalize_candidates", counted)
    monkeypatch.setattr(prefill_mod, "finalize_candidates", counted)
    cfg = reduced(get_config("llama2-7b"))
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu", seed=0)
    greedy = _run(eng, _trace(7, temperature=0.0))
    assert calls == []
    sched = SlotScheduler(eng, prompt_cap=PROMPT_CAP)
    mixed = replay_trace(sched, [(0, Request(0, [5, 9, 2, 8], 8)),
                                 (0, Request(1, [4, 4, 1], 3, sampling=(
                                     SamplingParams(temperature=0.9,
                                                    seed=7))))])
    # one admit of both, then the sampled request's two decode steps;
    # the greedy request's last five steps run alone
    assert calls == [2, SLOTS, SLOTS]
    assert sched.decode_calls == 7
    assert mixed[0].tokens == greedy[0].tokens
