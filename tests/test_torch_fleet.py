"""The port's fault-tolerant fleet (``serving/router.py``,
``serving/faults.py``, ``serving/integrity.py``, ``serving/sweep.py``)
on the CPU at reduced size, with the plain kernels.

* Checksums: ``kv_entry_fp`` and ``leaf_checksum`` equal, as integers,
  the reference's ``kv_entry_fp``, ``np_kv_entry_fp`` and
  ``leaf_checksum`` on the same bf16 and f32 bytes; the step's in-place
  update equals a full recompute after every step of a trace that
  appends and wraps a ring.
* The fault matrix on reduced Llama2-7B and the dense-MLA arm of
  DeepSeek-V2-Lite, built as the reference's fleet fixture builds them
  (two replicas, two slots, ``max_seq`` 32, the unfused backend, every
  probe on), over a trace whose odd requests are sampled: each kind
  fires its expected signal (the reference's ``EXPECTED_SIGNAL`` of
  ``tests/test_router.py``, the KV fingerprint for ``flip_kv_bit``, the
  weight fingerprint or the shadow recompute for ``flip_weight_bit``),
  KV flips within one tick, every journaled stream equal to the port's
  fault-free oracle, sampled requests requeued and continued on the
  survivor; the heal, ``max_requeues``, the shadow probe, the sub-sweep.
* Against the reference's router on the same trace and ``FaultSpec``s
  (one JAX fleet for the module, its own weights): the same signals on
  the same ticks, the same replica drained, the same request ids
  requeued, and the heal on the same tick.
"""
import dataclasses
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import tracecount as ref_tracecount
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import EngineOptions as RefOptions
from repro.launch.serve import build_replicas as ref_build_replicas
from repro.serving import faults as ref_faults
from repro.serving import integrity as ref_integrity
from repro.serving.router import Router as RefRouter
from repro.serving.sampling import SamplingParams as RefSamplingParams
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.core.dataflow import KVBlock
from repro_torch.launch.serve import (EngineOptions, build_engine_full,
                                      build_replicas)
from repro_torch.serving.engine import WORK_BLOCK_S
from repro_torch.serving.faults import (ALL_FAULT_KINDS, BIT_FAULT_KINDS,
                                        FaultInjector, FaultSpec, FaultSweep,
                                        ReplicaKilled)
from repro_torch.serving.integrity import (IntegrityConfig, IntegrityMonitor,
                                           as_u32, kv_entry_fp,
                                           leaf_checksum, weight_leaves)
from repro_torch.serving.router import Router
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace
from repro_torch.serving.sweep import format_coverage, run_sdc_sweep

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tensors are tiny, and
    beside other test workers torch's thread pool only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

EXPECTED_SIGNAL = {
    "kill": "detect_heartbeat",
    "blackhole": "detect_journal_stale",
    "corrupt_kv": "detect_nonfinite",
    "corrupt_lens": "detect_lens_bounds",
    "poison_weight": "detect_nonfinite",
    "drop_admit": "detect_journal_stale",
    "dup_admit": "detect_journal_stale",
    "flip_kv_bit": "detect_kv_fingerprint",
}
WEIGHT_SIGNALS = {"detect_weight_fingerprint", "detect_shadow_recompute"}
ICFG = IntegrityConfig(weight_leaves_per_tick=4)
OPTIONS = dict(backend="xla", check_finite=True, kv_fingerprint=True,
               shadow_head=True, track_work=True)


def _cfg(arch):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, moe=None) if cfg.moe else cfg


def _trace(vocab, seed=0, n_req=6):
    """The reference fixture's trace (``tests/test_router.py:_mk_trace``),
    odd requests sampled at temperature 0.8 with a seed each."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n_req):
        plen = int(rng.integers(2, 7))
        arrival = int(rng.integers(0, 4))
        prompt = [int(t) for t in rng.integers(1, vocab, plen)]
        max_new = int(rng.integers(3, 7))
        sp = (SamplingParams(temperature=0.8, top_k=5 if rid % 4 == 1 else 8,
                             top_p=0.9, seed=1000 + rid)
              if rid % 2 else SamplingParams())
        out.append((arrival, prompt, max_new, sp))
    return out


def _requests(trace):
    return [(t, Request(i, list(p), m, sampling=sp))
            for i, (t, p, m, sp) in enumerate(trace)]


def _streams(journal):
    return {rid: list(e.tokens) for rid, e in journal.items()}


def _run(engines, trace, *, injectors=None, integrity=None,
         max_requeues=None):
    router = Router(engines, prompt_cap=8, max_new_cap=8,
                    injectors=injectors, integrity=integrity,
                    max_requeues=max_requeues)
    return router, router.run(_requests(trace))


@pytest.fixture(scope="module", params=["llama2-7b", "deepseek-v2-lite"],
                ids=["gqa", "mla"])
def fleet(request):
    cfg = _cfg(request.param)
    engines = build_replicas(cfg, n_replicas=2, max_seq=32, batch_global=2,
                             device="cpu",
                             options=EngineOptions(**OPTIONS))
    trace = _trace(cfg.vocab_size)
    _, journal = _run(engines, trace)
    return cfg, engines, trace, _streams(journal)


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------
def _bf16(rng, shape):
    return (rng.standard_normal(shape) * 4).astype(ml_dtypes.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def test_checksums_equal_the_reference_as_integers():
    rng = np.random.default_rng(0)
    B = 3
    k, v = _bf16(rng, (2, 5, B * 2, 8)), _bf16(rng, (2, 5, B * 2, 8))
    entry = KVBlock(_torch_bf16(k), _torch_bf16(v),
                    torch.zeros((2, 5, B), dtype=torch.int32))
    got = as_u32(kv_entry_fp(entry, B)).numpy()
    from types import SimpleNamespace
    dev = np.asarray(ref_integrity.kv_entry_fp(
        SimpleNamespace(k=jnp.asarray(k), v=jnp.asarray(v)), B))
    host = ref_integrity.np_kv_entry_fp(k[None, None], v[None, None], B)[0, 0]
    np.testing.assert_array_equal(got, ref_integrity._np_u32(dev))
    np.testing.assert_array_equal(got, host)
    # one flipped bit moves exactly its (group, slot) checksum
    for trial in range(8):
        r2 = np.random.default_rng(100 + trial)
        flat = k.reshape(-1).view(np.uint16).copy()
        i, bit = int(r2.integers(flat.size)), int(r2.integers(16))
        flat[i] ^= np.uint16(1 << bit)
        k2 = flat.view(k.dtype).reshape(k.shape)
        moved = as_u32(kv_entry_fp(KVBlock(_torch_bf16(k2), entry.v,
                                           entry.pos), B)).numpy() != got
        g, _, row, _ = np.unravel_index(i, k.shape)
        assert moved.sum() == 1 and moved[g, row // 2], (trial, bit)
    for a in (_bf16(rng, (7, 33)), rng.standard_normal((4, 9))
              .astype(np.float32), np.full((3,), -1.5, np.float32)):
        t = (_torch_bf16(a) if a.dtype == ml_dtypes.bfloat16
             else torch.from_numpy(a))
        assert leaf_checksum(t) == ref_integrity.leaf_checksum(
            jnp.asarray(a))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_incremental_fingerprint_equals_full_recompute(backend):
    """Reduced Gemma-2 with a 16-row window (its local layers ring caches
    of 16 rows, its global layers linear ones of 40): after every step
    of a trace whose slots append past the wrap and are re-admitted, the
    in-place checksums equal a full recompute of every entry."""
    cfg = dataclasses.replace(reduced(get_config("gemma2-27b")),
                              sliding_window=16)
    eng = build_engine_full(cfg, max_seq=40, batch_global=2, device="cpu",
                            options=EngineOptions(backend=backend,
                                                  kv_fingerprint=True))
    sched = SlotScheduler(eng, prompt_cap=20)
    rng = np.random.default_rng(4)
    for rid, (plen, n_new) in enumerate(((5, 18), (19, 12), (3, 9))):
        sched.submit(Request(rid, rng.integers(1, cfg.vocab_size,
                                               plen).tolist(), n_new))
    wrapped = False
    while not sched.idle():
        sched.step()
        st = sched.state
        for cache, fp in zip(st["layers"] + st["tail"],
                             st["kv_fp"] + st["kv_fp_tail"]):
            assert torch.equal(kv_entry_fp(cache, 2), fp), sched.tick
        wrapped |= bool((sched.cache_lens() > 16).any())
    assert wrapped and sched.decode_calls >= 18


def test_flags_gate_the_leaves_and_the_monitor_checks_them():
    cfg = _cfg("llama2-7b")
    for flag in (False, True):
        eng = build_engine_full(
            cfg, max_seq=16, batch_global=2, device="cpu",
            options=EngineOptions(kv_fingerprint=flag, shadow_head=flag,
                                  track_work=flag))
        for name in ("kv_fp", "kv_fp_tail", "head_resid", "head_val",
                     "head_tok", "work_blocks"):
            assert (name in eng.state) == flag, name
        if not flag:
            with pytest.raises(ValueError, match="kv_fingerprint"):
                IntegrityMonitor(eng, IntegrityConfig())
            with pytest.raises(ValueError, match="shadow_head"):
                IntegrityMonitor(eng, IntegrityConfig(kv=False))
    with pytest.raises(ValueError, match="weight_leaves_per_tick"):
        IntegrityMonitor(eng, IntegrityConfig(weight_leaves_per_tick=0))


def test_live_attend_blocks_and_work_equal_the_reference():
    """``live_attend_blocks`` on random lengths, windows and rings, and a
    scheduler's ``work_blocks`` after a staggered trace, against the
    reference's at the same ``block_s``."""
    from repro.core.tracecount import live_attend_blocks as ref_blocks

    from repro_torch.core.tracecount import live_attend_blocks
    rng = np.random.default_rng(6)
    for _ in range(40):
        s_blk = int(rng.choice([16, 40, 64, 96]))
        blk = int(rng.choice([8, 16, 32, 256]))
        window = int(rng.choice([0, 8, 24]))
        ring = bool(rng.integers(2)) and window > 0
        lens = rng.integers(-1, 2 * s_blk, 8).astype(np.int32)
        want = np.asarray(ref_blocks(jnp.asarray(lens), s_blk=s_blk,
                                     block_s=blk, rank=0, window=window,
                                     ring=ring))
        got = live_attend_blocks(torch.as_tensor(lens), s_blk=s_blk,
                                 block_s=blk, window=window, ring=ring)
        np.testing.assert_array_equal(got.numpy(), want)
    ref_cfg = ref_reduced(ref_get_config("llama2-7b"))
    from repro.launch.serve import build_engine_full as ref_build
    from repro.serving.scheduler import replay_trace as ref_replay
    ref = ref_build(ref_cfg, make_test_mesh(data=1, model=1), max_seq=32,
                    batch_global=2,
                    options=RefOptions(backend="xla", track_work=True))
    assert ref.scfg.block_s == WORK_BLOCK_S
    port = build_engine_full(_cfg("llama2-7b"), max_seq=32, batch_global=2,
                             device="cpu",
                             options=EngineOptions(track_work=True))
    trace = _trace(ref_cfg.vocab_size, n_req=4)
    r_sched = RefScheduler(ref, prompt_cap=8)
    ref_replay(r_sched, [(t, RefRequest(i, p, m))
                         for i, (t, p, m, _) in enumerate(trace)])
    p_sched = SlotScheduler(port, prompt_cap=8)
    replay_trace(p_sched, [(t, Request(i, p, m))
                           for i, (t, p, m, _) in enumerate(trace)])
    assert p_sched.events == r_sched.events
    np.testing.assert_array_equal(p_sched.work_blocks(),
                                  r_sched.work_blocks())
    assert p_sched.work_blocks().sum() > 0


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------
def test_fault_spec_validation_names_offending_field():
    for kw, field in ((dict(kind="kill", step=-1), "step"),
                      (dict(kind="kill", step=0, replica=-2), "replica"),
                      (dict(kind="kill", step=0, target=-1), "target"),
                      (dict(kind="flip_kv_bit", step=0), "bit"),
                      (dict(kind="flip_kv_bit", step=0, bit=16), "bit"),
                      (dict(kind="kill", step=0, bit=3), "bit"),
                      (dict(kind="rowhammer", step=0),
                       "unknown fault kind")):
        with pytest.raises(ValueError, match=field) as ei:
            FaultSpec(**kw)
        with pytest.raises(ValueError) as ri:
            ref_faults.FaultSpec(**kw)
        assert str(ei.value) == str(ri.value)
    FaultSpec("flip_kv_bit", step=0, bit=0)
    FaultSpec("flip_weight_bit", step=0, bit=15)
    a = FaultSpec("flip_kv_bit", step=2, target=0, bit=3)
    with pytest.raises(ValueError, match="duplicate"):
        FaultInjector([a, FaultSpec("flip_kv_bit", step=2, target=0, bit=9)])
    inj = FaultInjector([FaultSpec("kill", step=0)])

    class _T:
        tick = 0
    with pytest.raises(ReplicaKilled):
        inj.pre_step(_T())
    assert len(inj.fired) == 1


def test_fault_sweep_grid_and_coverage_table():
    sw = FaultSweep(targets=(0, 1), bits=(0, 7, 15), steps=(2, 4))
    specs = sw.specs()
    assert len(specs) == len(set(specs)) == 2 * 2 * 3 * 2
    ref = ref_faults.FaultSweep(targets=(0, 1), bits=(0, 7, 15),
                                steps=(2, 4)).specs()
    assert [dataclasses.astuple(s) for s in specs] == \
        [dataclasses.astuple(s) for s in ref]
    assert {s.bit for s in FaultSweep().specs()} == set(range(16))
    assert set(ALL_FAULT_KINDS) == set(ref_faults.ALL_FAULT_KINDS)
    out = format_coverage({
        "fault_free": {"false_positive_signals": 0.0, "streams_match": 1.0,
                       "probe_bytes_per_tick": 1234.0},
        "flip_kv_bit_bit7": {"detected_pct": 100.0, "detect_steps": 0.0,
                             "oracle_exact_pct": 100.0}})
    assert "flip_kv_bit_bit7" in out and "signals=0" in out


def test_router_validation(fleet):
    cfg, engines, _, _ = fleet
    with pytest.raises(ValueError, match="max_seq"):
        Router(engines, prompt_cap=30, max_new_cap=8)
    with pytest.raises(ValueError, match="replica"):
        Router(engines, prompt_cap=8, max_new_cap=8,
               injectors={7: FaultInjector([])})
    with pytest.raises(ValueError, match="replica"):
        Router(engines, prompt_cap=8, max_new_cap=8, injectors={
            0: FaultInjector([FaultSpec("kill", step=0, replica=5)])})
    with pytest.raises(ValueError, match="max_requeues"):
        Router(engines, prompt_cap=8, max_new_cap=8, max_requeues=-1)
    r = Router(engines, prompt_cap=8, max_new_cap=4)
    with pytest.raises(ValueError, match="max_new_cap"):
        r.submit(Request(0, [1, 2], 9))
    with pytest.raises(ValueError, match="top_k"):
        r.submit(Request(1, [1, 2], 3, sampling=SamplingParams(top_k=9)))
    r.submit(Request(0, [1, 2], 3))
    with pytest.raises(ValueError, match="duplicate"):
        r.submit(Request(0, [1, 2], 3))


# ---------------------------------------------------------------------------
# The fault matrix
# ---------------------------------------------------------------------------
def test_fault_free_all_probes_zero_signals_streams_equal(fleet):
    cfg, engines, trace, oracle = fleet
    tracecount.reset_signals()
    tracecount.reset_probes()
    router, journal = _run(engines, trace, integrity=ICFG)
    assert router.commit_lag == math.ceil(
        len(weight_leaves(engines[0].params["serve"])) / 4)
    assert sum(tracecount.signal_totals().values()) == 0
    assert not router.detections and router.availability() == 1.0
    assert _streams(journal) == oracle
    assert {i for e in journal.values() for i in e.replicas} == {0, 1}
    pt = tracecount.probe_totals()
    assert pt["probe_ticks"] == router.tick * len(engines)
    for fam in ("probe_bytes_kv", "probe_bytes_weights",
                "probe_bytes_shadow"):
        assert pt[fam] > 0, fam
    sampled = [e for e in journal.values() if e.sampling.temperature > 0]
    assert len(sampled) == 3 and all(e.seed == e.sampling.seed
                                     for e in sampled)


@pytest.mark.parametrize("kind", ALL_FAULT_KINDS)
def test_chaos_matrix_detect_recover_exact(fleet, kind):
    cfg, engines, trace, oracle = fleet
    tracecount.reset_signals()
    bit = 7 if kind in BIT_FAULT_KINDS else -1
    inj = FaultInjector([FaultSpec(kind, step=2, target=0, replica=0,
                                   bit=bit)])
    router, journal = _run(engines, trace, injectors={0: inj},
                           integrity=ICFG)
    try:
        assert len(inj.fired) == 1
        lat = router.detection_latency(inj)
        det = router.detections[0]
        if kind == "flip_weight_bit":
            assert 0 <= lat[0] <= router.commit_lag, lat
            assert WEIGHT_SIGNALS & set(det["signals"]), det
            assert [e[1] for e in router.events
                    if e[1].startswith("heal")] == ["heal"]
            assert router.live_frac[-1] == 1.0
        else:
            assert lat[0] in (0, 1), (kind, lat)
            assert EXPECTED_SIGNAL[kind] in det["signals"], det
            assert [r.alive for r in router.replicas] == [False, True]
        assert det["replica"] == 0 and len(router.detections) == 1
        sig = tracecount.signal_totals()
        assert sig["replica_failed"] == 1
        assert sig["detect_journal_mismatch"] == 0
        assert _streams(journal) == oracle, kind
        assert all(e.done for e in journal.values())
        requeued = [e for e in journal.values() if e.requeues]
        assert requeued and 0 < router.recovery_steps() <= 16
        # a sampled stream was cut over and finished on replica 1
        if kind != "flip_weight_bit":
            assert any(e.sampling.temperature > 0 and e.replicas[-1] == 1
                       for e in requeued), kind
    finally:
        for eng in engines:
            eng.repack_fn(eng.params["train"])


@pytest.mark.parametrize("bit", [0, 14])
def test_flip_weight_bit_heals_and_reverifies(fleet, bit):
    cfg, engines, trace, oracle = fleet
    tracecount.reset_signals()
    inj = FaultInjector([FaultSpec("flip_weight_bit", step=2, target=1,
                                   bit=bit)])
    router, journal = _run(engines, trace, injectors={0: inj},
                           integrity=ICFG)
    assert inj.flipped_weight
    assert 0 <= router.detection_latency(inj)[0] <= router.commit_lag
    assert tracecount.signal_totals()["replica_healed"] == 1
    assert any(inj.flipped_weight[0] in d
               for d in router.detections[0]["details"])
    assert router.replicas[0].monitor.verify_weights_full() == []
    assert len(router.heal_ms) == 1
    assert _streams(journal) == oracle
    assert 0.0 < router.availability() < 1.0


def test_heal_fails_without_a_seed():
    """An engine built from ``train_params`` has no ``repack_fn``: a
    flipped weight cannot be made clean again, so the replica stays
    quarantined with a ``heal_failed`` event and the streams still
    finish, exact, on the survivor."""
    cfg = _cfg("llama2-7b")
    seeded = build_replicas(cfg, n_replicas=1, max_seq=32, batch_global=2,
                            device="cpu", options=EngineOptions(**OPTIONS))
    clone = {k: v for k, v in seeded[0].params["train"].items()}
    from_train = build_engine_full(
        cfg, max_seq=32, batch_global=2, device="cpu",
        train_params=_clone_tree(clone), options=EngineOptions(**OPTIONS))
    assert from_train.repack_fn is None
    engines = [from_train, seeded[0]]
    trace = _trace(cfg.vocab_size)
    _, oracle = _run(engines, trace)
    inj = FaultInjector([FaultSpec("flip_weight_bit", step=2, target=1,
                                   bit=14)])
    router, journal = _run(engines, trace, injectors={0: inj},
                           integrity=ICFG)
    assert [e[1] for e in router.events if e[1].startswith("heal")] == \
        ["heal_failed"]
    assert not router.replicas[0].alive
    assert _streams(journal) == _streams(oracle)


def _clone_tree(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree


def test_shadow_recompute_catches_head_corruption(fleet):
    cfg, engines, _, _ = fleet
    eng = engines[0]
    mon = IntegrityMonitor(eng, IntegrityConfig(kv=False, weights=False))
    assert mon.commit_lag() == 0
    sched = SlotScheduler(eng, prompt_cap=8)
    sched.submit(Request(0, [3, 1, 4, 1], 6, sampling=SamplingParams(
        temperature=0.8, seed=5)))
    for _ in range(3):
        sched.step()
    st = sched.state
    assert mon.verify_shadow(st, 0) and mon.verify_shadow(st, 1)
    val = st["head_val"].clone()
    val.view(torch.int32)[0] ^= 1 << 23             # exactly 2×
    assert not mon.verify_shadow(dict(st, head_val=val), 0)
    tok = st["head_tok"].clone()
    tok[0] = (tok[0] + 1) % cfg.vocab_size
    assert not mon.verify_shadow(dict(st, head_tok=tok), 0)
    resid = st["head_resid"].clone()
    resid.view(torch.int16)[0] ^= 1 << 7
    assert not mon.verify_shadow(dict(st, head_resid=resid), 0)
    assert mon.verify_shadow(sched.state, 0)


def test_max_requeues_terminal_failed_status(fleet):
    cfg, engines, trace, _ = fleet
    tracecount.reset_signals()
    inj = FaultInjector([FaultSpec("kill", step=2, replica=0)])
    router, journal = _run(engines, trace, injectors={0: inj},
                           max_requeues=0)
    failed = [e for e in journal.values() if e.failed]
    assert failed and all(not e.done and e.requeues == 1 for e in failed)
    assert tracecount.signal_totals()["request_failed"] == len(failed)
    done = [e for e in journal.values() if e.done]
    assert done and all(not e.failed for e in done)


def test_sub_sweep_full_coverage(fleet):
    """The reference's CI sub-sweep, with sampled streams: both flip
    kinds at bits 0, 7 and 14 — 100 % detected, 100 % oracle-exact, no
    false positive, KV flips within one tick."""
    cfg, engines, _, _ = fleet
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 4)]
               for _ in range(3)]
    sampling = [SamplingParams(), SamplingParams(temperature=0.8, seed=3),
                SamplingParams(temperature=0.8, top_k=4, top_p=0.9, seed=4)]
    cells = run_sdc_sweep(engines, prompts=prompts, max_new=6, prompt_cap=8,
                          sweep=FaultSweep(bits=(0, 7, 14)), icfg=ICFG,
                          sampling=sampling)
    ff = cells.pop("fault_free")
    assert ff["false_positive_signals"] == 0 and ff["streams_match"] == 1.0
    assert ff["probe_bytes_per_tick"] > 0
    assert len(cells) == 6
    for key, c in cells.items():
        assert c["detected_pct"] == 100.0, key
        assert c["oracle_exact_pct"] == 100.0, key
        if key.startswith("flip_kv_bit"):
            assert c["detect_steps"] <= 1, (key, c)


# ---------------------------------------------------------------------------
# Against the reference's router
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_fleet():
    """The reference's fleet (reduced Llama2-7B, as its fixture builds
    it) and the port's, each from its own seed: the comparison is of
    the router's decisions, which do not depend on the token values
    (no EOS)."""
    cfg = ref_reduced(ref_get_config("llama2-7b"))
    ref = ref_build_replicas(cfg, make_test_mesh(data=1, model=1),
                             n_replicas=2, max_seq=32, batch_global=2,
                             options=RefOptions(**OPTIONS))
    port = build_replicas(_cfg("llama2-7b"), n_replicas=2, max_seq=32,
                          batch_global=2, device="cpu",
                          options=EngineOptions(**OPTIONS))
    return ref, port, _trace(cfg.vocab_size)


def _decisions(router):
    return ([(d["tick"], d["replica"], sorted(d["signals"]))
             for d in router.detections],
            [e for e in router.events
             if e[1] in ("fail", "requeue", "heal", "heal_failed",
                         "request_failed")])


@pytest.mark.parametrize("kind", ALL_FAULT_KINDS)
def test_router_decisions_equal_the_reference(ref_fleet, kind):
    """Every weight leaf checked every tick on both sides (the port's
    serve tree lists other leaves than the reference's, so the rotation
    would reach a flipped one on another tick): the same signals on the
    same ticks, the same drains, requeues and heals."""
    ref, port, trace = ref_fleet
    bit = 7 if kind in BIT_FAULT_KINDS else -1
    every = 10 ** 6
    ref_tracecount.reset_signals()
    r_router = RefRouter(
        ref, prompt_cap=8, max_new_cap=8,
        injectors={0: ref_faults.FaultInjector([ref_faults.FaultSpec(
            kind, step=2, target=0, replica=0, bit=bit)])},
        integrity=ref_integrity.IntegrityConfig(weight_leaves_per_tick=every))
    r_router.run([(t, RefRequest(i, p, m, sampling=RefSamplingParams(
        **dataclasses.asdict(sp)))) for i, (t, p, m, sp) in enumerate(trace)])
    tracecount.reset_signals()
    p_router, _ = _run(port, trace, injectors={0: FaultInjector([FaultSpec(
        kind, step=2, target=0, replica=0, bit=bit)])},
        integrity=IntegrityConfig(weight_leaves_per_tick=every))
    try:
        assert _decisions(p_router) == _decisions(r_router), kind
        assert p_router.commit_lag == r_router.commit_lag == 1
        assert p_router.tick == r_router.tick
        assert {k: v for k, v in tracecount.signal_totals().items() if v} \
            == {k: v for k, v in ref_tracecount.signal_totals().items() if v}
    finally:
        if kind == "flip_weight_bit":
            for eng in ref:
                eng.params["serve"] = eng.repack_fn(eng.params["train"])
            for eng in port:
                eng.repack_fn(eng.params["train"])
