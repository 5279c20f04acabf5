"""Fleet front end — the port of ``repro/serving/router.py``: a
multi-replica router with a journal, per-tick probes, deferred commits
and reconstructive recovery.

1. **Journal**: every request's prompt, sampling params and committed
   tokens live in the router (:class:`JournalEntry`).  A replica's tick
   emissions commit only after that tick's probes pass; a failed probe
   drops them, so the journal never holds a token of a corrupt replica.
2. **Probes**, per replica per tick: the ``check_finite`` sentinel,
   ``cache_lens`` bounds, the expected-lengths cross-check (dropped or
   duplicated admits, a blackholed replica), replay mismatches, the
   heartbeat (the step raising), and with ``integrity`` the SDC probes of
   ``serving/integrity.py`` (KV and weight fingerprints summed on the
   device, the shadow recompute on the host).  Each firing is recorded
   with ``core/tracecount.py:record_signal``.
3. **Recovery**: a failed replica is drained; its in-flight requests
   requeue onto survivors as ``Request(prompt, max_new,
   replay=committed_tokens, sampling=...)``: the survivor re-prefills
   the prompt and force-feeds the journaled tokens through the same
   captured step.  The replicas are made from one seed
   (``launch/serve.py:build_replicas``) and the sampling noise is
   positional (``core/threefry.py``), so the continuation is the
   uninterrupted stream's, sampled streams included.  A replica failed
   by the weight fingerprint heals: ``EngineHandle.repack_fn`` writes
   clean bits back into its serve tensors in place, every leaf
   re-verifies against the construction-time table, and it rejoins with
   a fresh scheduler at the next tick; an engine without a
   ``repack_fn`` (built from ``train_params``) fails re-verification and
   stays quarantined (``heal_failed``).

The rotating weight probe covers every leaf once per
``IntegrityMonitor.commit_lag()`` ticks, so commits wait that long
(deferred commits); without integrity the lag is 0.  ``max_requeues``
caps a request's recoveries.  Dispatch goes to the live replica with
the fewest queued + active requests, ties to the lowest index.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tracecount
from repro_torch.launch.serve import EngineHandle
from repro_torch.serving.faults import ReplicaKilled
from repro_torch.serving.integrity import IntegrityConfig, IntegrityMonitor
from repro_torch.serving.sampling import (GREEDY, SamplingParams,
                                          validate_sampling)
from repro_torch.serving.scheduler import (Request, SchedulerHooks,
                                           SlotScheduler)


@dataclass
class JournalEntry:
    """The router's durable record of one request: everything needed to
    reconstruct the stream on any replica, plus the committed tokens."""
    rid: int
    prompt: List[int]
    max_new: int
    sampling: SamplingParams = GREEDY   # journaled per-request params —
                                # with the positional PRNG stream
                                # (seed × emit offset) these plus the
                                # committed tokens are ALL the state a
                                # survivor needs to resume a sampled
                                # stream bit-exactly
    seed: int = 0               # ``sampling.seed``, a column of its own
                                # as in the reference's journal
    tokens: List[int] = field(default_factory=list)   # COMMITTED only
    replicas: List[int] = field(default_factory=list)  # dispatch history
    submit_tick: int = -1
    finish_tick: int = -1
    requeues: int = 0
    # (requeue_tick, first_new_commit_tick) per recovery — the bench's
    # recovery-latency column is the max delta over these
    recoveries: List[Tuple[int, int]] = field(default_factory=list)
    done: bool = False
    failed: bool = False        # terminal: hit the max_requeues cap

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.tokens)


class _Replica:
    """One engine replica as the router sees it: its scheduler (with
    the replica's fault-injection hooks, if any), the local→router
    request-id map, and per-request commit watermarks."""

    def __init__(self, idx: int, eng: EngineHandle, prompt_cap: int,
                 eos_id: Optional[int], hooks: Optional[SchedulerHooks],
                 monitor: Optional[IntegrityMonitor] = None):
        self.idx = idx
        self.eng = eng
        self.prompt_cap = prompt_cap
        self.eos_id = eos_id
        self.hooks = hooks
        self.monitor = monitor
        # integrity_latch: snapshot violations before a same-tick retire
        # can reset the offending slot (the probe below would otherwise
        # miss a fault whose victim finishes on the fault tick and
        # commit its corrupt final token)
        self.sched = SlotScheduler(eng, prompt_cap=prompt_cap,
                                   eos_id=eos_id, hooks=hooks,
                                   integrity_latch=True)
        self.alive = True
        self.owner: Dict[int, int] = {}       # local rid → router rid
        self.committed: Dict[int, int] = {}   # local rid → commit mark
        self.staged_mark: Dict[int, int] = {}  # local rid → staged mark
        # deferred-commit staging: (emit_tick, local rid, tokens) —
        # flushed to the journal once every probe through emit_tick +
        # commit_lag has passed; dropped wholesale on failure
        self.staged: List[Tuple[int, int, List[int]]] = []

    def load(self) -> int:
        """Queue depth + active slots — the dispatch cost metric."""
        return len(self.sched.queue) + sum(
            not s.free for s in self.sched.slots)

    def reset_sched(self) -> None:
        """Fresh scheduler over the (healed) engine — construction
        retires every slot, so the replica rejoins with clean device
        state and zero in-flight bookkeeping."""
        self.sched = SlotScheduler(self.eng, prompt_cap=self.prompt_cap,
                                   eos_id=self.eos_id, hooks=self.hooks,
                                   integrity_latch=True)

    def probe(self) -> List[str]:
        """Post-step probes; returns the fired signal labels (empty:
        healthy).  The router's own probes read ``[B]`` vectors; the
        monitor's fingerprints are summed on the device."""
        fired = list(self.sched.latched)   # pre-retire snapshots first
        st = self.sched.state
        if "nonfinite" in st and bool((st["nonfinite"] > 0).any()):
            fired.append("detect_nonfinite")
        lens = self.sched.cache_lens()
        if (lens < -1).any() or (lens > self.eng.scfg.max_seq).any():
            fired.append("detect_lens_bounds")
        if (lens != self.sched.expected_cache_lens()).any():
            fired.append("detect_journal_stale")
        if self.sched.replay_mismatches() > 0:
            fired.append("detect_journal_mismatch")
        if self.monitor is not None:
            fired += self.monitor.probe(self.sched)
        return list(dict.fromkeys(fired))   # latch + probe may agree


class Router:
    """Load-balance a request stream over N replicas with journaled,
    probe-gated commits and reconstructive recovery.

    ``injectors`` maps replica index → :class:`SchedulerHooks` (chaos
    tests pass a :class:`~repro_torch.serving.faults.FaultInjector`); omitted
    replicas run clean.  All replicas must share weights (same init
    seed — :func:`repro_torch.launch.serve.build_replicas`): recovery moves a
    stream between replicas and is only exact if they agree.

    ``integrity`` enables the SDC probes (one
    :class:`~repro_torch.serving.integrity.IntegrityMonitor` per replica) and
    turns on the deferred-commit window (see the module docstring).
    ``max_requeues`` is the requeue-storm guard (``None``: unbounded).
    """

    def __init__(self, engines: Sequence[EngineHandle], *,
                 prompt_cap: int, max_new_cap: int,
                 eos_id: Optional[int] = None,
                 injectors: Optional[Dict[int, SchedulerHooks]] = None,
                 integrity: Optional[IntegrityConfig] = None,
                 max_requeues: Optional[int] = None):
        if not engines:
            raise ValueError("router needs at least one replica")
        if any(eng.ctx.model is not None for eng in engines):
            raise NotImplementedError(
                "the fleet on a mesh (replicas of a sharded engine) is the "
                "remaining part of ROADMAP A.5b")
        max_seq = engines[0].scfg.max_seq
        # a full-length stream appends prompt + (max_new − 1) inputs
        if prompt_cap + max_new_cap - 1 > max_seq:
            raise ValueError(
                f"prompt_cap={prompt_cap} + max_new_cap={max_new_cap} - 1 "
                f"exceeds the engines' cache capacity max_seq={max_seq}")
        if max_requeues is not None and max_requeues < 0:
            raise ValueError(
                f"max_requeues must be ≥ 0 or None, got {max_requeues}")
        injectors = injectors or {}
        for idx, hooks in injectors.items():
            if not 0 <= idx < len(engines):
                raise ValueError(
                    f"injector replica={idx} out of range for a "
                    f"{len(engines)}-replica fleet")
            for s in getattr(hooks, "specs", ()):
                if getattr(s, "replica", 0) >= len(engines):
                    raise ValueError(
                        f"FaultSpec.replica={s.replica} out of range "
                        f"for a {len(engines)}-replica fleet")
        self.max_new_cap = max_new_cap
        self.max_requeues = max_requeues
        self.replicas = [
            _Replica(i, eng, prompt_cap, eos_id, injectors.get(i),
                     IntegrityMonitor(eng, integrity)
                     if integrity is not None else None)
            for i, eng in enumerate(engines)]
        # the weight rotation's full-coverage period: the window commits
        # defer by, so no committed token predates the probe that could
        # have vetoed it (0 without integrity — immediate commits)
        self.commit_lag = max(
            (r.monitor.commit_lag() for r in self.replicas
             if r.monitor is not None), default=0)
        self.journal: Dict[int, JournalEntry] = {}
        self.pending: List[int] = []          # rids awaiting dispatch
        self.tick = 0
        self.events: List[Tuple[int, str, Any, Any]] = []
        self.detections: List[Dict[str, Any]] = []
        self.live_frac: List[float] = []      # per-tick availability
        self._next_local = 0
        self._to_heal: List[_Replica] = []
        self.heal_ms: List[float] = []        # repack + full re-verify

    # -- intake -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.rid in self.journal:
            raise ValueError(f"request {req.rid}: duplicate request id")
        if req.max_new > self.max_new_cap:
            raise ValueError(
                f"request {req.rid}: max_new={req.max_new} exceeds the "
                f"router's max_new_cap={self.max_new_cap}")
        sampling = getattr(req, "sampling", GREEDY)
        validate_sampling(req.rid, sampling)
        self.journal[req.rid] = JournalEntry(
            rid=req.rid, prompt=list(req.prompt), max_new=req.max_new,
            sampling=sampling, seed=sampling.seed, submit_tick=self.tick)
        self.pending.append(req.rid)

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self) -> None:
        for rid in self.pending:
            live = [r for r in self.replicas if r.alive]
            if not live:
                raise RuntimeError(
                    "no live replicas left — the fleet cannot make "
                    "progress (all replicas failed probes or died)")
            r = min(live, key=lambda rr: (rr.load(), rr.idx))
            e = self.journal[rid]
            lr = self._next_local
            self._next_local += 1
            r.owner[lr] = rid
            # already-committed tokens replay on the new replica and are
            # never re-committed
            r.committed[lr] = len(e.tokens)
            r.staged_mark[lr] = len(e.tokens)
            # the replay carries the committed prefix; the SAME sampling
            # params ride along, so the survivor's positional PRNG keys
            # (seed × emit offset) line up with the dead replica's and
            # the live continuation stays bit-exact for sampled streams
            r.sched.submit(Request(lr, list(e.prompt), e.max_new,
                                   replay=list(e.tokens),
                                   sampling=e.sampling))
            e.replicas.append(r.idx)
            self.events.append((self.tick, "dispatch", rid, r.idx))
        self.pending.clear()

    # -- commit / failure -------------------------------------------------
    def _stage(self, r: _Replica) -> None:
        """Pull this tick's emissions into the replica's staging buffer;
        they reach the journal only after every probe through the
        deferred-commit window has passed (:meth:`_commit`)."""
        for lr in list(r.owner):
            res = r.sched.results.get(lr)
            if res is None:
                continue
            new = res.tokens[r.staged_mark[lr]:]
            if new:
                r.staged.append((self.tick, lr, list(new)))
                r.staged_mark[lr] = len(res.tokens)

    def _commit(self, r: _Replica) -> None:
        """Flush staged emissions whose deferred-commit window has
        closed (emit_tick ≤ now − commit_lag; with integrity off the
        lag is 0 and this commits the tick's tokens immediately)."""
        cutoff = self.tick - self.commit_lag
        keep: List[Tuple[int, int, List[int]]] = []
        for emit_tick, lr, toks in r.staged:
            rid = r.owner.get(lr)
            if rid is None:
                continue                  # request left this replica
            if emit_tick > cutoff:
                keep.append((emit_tick, lr, toks))
                continue
            e = self.journal[rid]
            e.tokens.extend(toks)
            r.committed[lr] += len(toks)
            if e.recoveries and e.recoveries[-1][1] < 0:
                rq_tick, _ = e.recoveries[-1]
                e.recoveries[-1] = (rq_tick, self.tick)
        r.staged = keep
        pending_lrs = {lr for _, lr, _ in r.staged}
        for lr, rid in list(r.owner.items()):
            res = r.sched.results.get(lr)
            if res is None or res.finish_tick < 0 or lr in pending_lrs:
                continue                  # still emitting or still staged
            e = self.journal[rid]
            e.done = True
            e.finish_tick = self.tick
            del r.owner[lr], r.committed[lr], r.staged_mark[lr]
            self.events.append((self.tick, "finish", rid, r.idx))

    def _fail(self, r: _Replica, signals: Sequence[str]) -> None:
        """Drain a failed replica: nothing uncommitted survives — the
        staging buffer is dropped wholesale — and every in-flight
        request re-queues onto survivors from its last committed state
        (zero-corruption invariant).  Requests past the requeue cap are
        terminally FAILED instead (requeue-storm guard); a weight-SDC
        failure schedules the heal for the start of the next tick."""
        r.alive = False
        for sig in signals:
            tracecount.record_signal(sig)
        tracecount.record_signal("replica_failed")
        details = list(r.monitor.last_details) if r.monitor else []
        self.detections.append({"tick": self.tick, "replica": r.idx,
                                "signals": list(signals),
                                "details": details})
        self.events.append((self.tick, "fail", r.idx, tuple(signals)))
        for lr, rid in r.owner.items():
            e = self.journal[rid]
            if e.done:
                continue
            e.requeues += 1
            if self.max_requeues is not None \
                    and e.requeues > self.max_requeues:
                e.failed = True
                tracecount.record_signal("request_failed")
                self.events.append(
                    (self.tick, "request_failed", rid, r.idx))
                continue
            e.recoveries.append((self.tick, -1))
            self.pending.append(rid)
            self.events.append((self.tick, "requeue", rid, r.idx))
        r.owner.clear()
        r.committed.clear()
        r.staged_mark.clear()
        r.staged.clear()
        if "detect_weight_fingerprint" in signals and r.monitor is not None:
            self._to_heal.append(r)

    def _heal_pending(self) -> None:
        """Heal weight-SDC replicas quarantined last tick: re-materialize
        the serve layout from the (uncorrupted) train view, re-verify
        EVERY leaf fingerprint, and rejoin with a fresh scheduler.  A
        replica whose heal fails re-verification (train view also
        corrupt — outside the fault model) stays quarantined."""
        heals, self._to_heal = self._to_heal, []
        for r in heals:
            t0 = time.perf_counter()
            if r.eng.repack_fn is not None:
                # in place: the serve tree stays the object the graph
                # was captured on
                r.eng.params["serve"] = r.eng.repack_fn(
                    r.eng.params["train"])
            bad = r.monitor.verify_weights_full()
            self.heal_ms.append(1e3 * (time.perf_counter() - t0))
            if bad:
                self.events.append(
                    (self.tick, "heal_failed", r.idx, tuple(bad)))
                continue
            r.reset_sched()
            r.alive = True
            tracecount.record_signal("replica_healed")
            self.events.append((self.tick, "heal", r.idx, None))

    # -- one fleet tick ---------------------------------------------------
    def step(self, arrivals: Sequence[Request] = ()) -> None:
        for req in arrivals:
            self.submit(req)
        self._heal_pending()     # last tick's quarantines rejoin first
        self._dispatch()
        for r in self.replicas:
            if not r.alive:
                continue
            try:
                r.sched.step()
            except ReplicaKilled:
                self._fail(r, ["detect_heartbeat"])
                continue
            signals = r.probe()
            if signals:
                self._fail(r, signals)
            else:
                self._stage(r)
                self._commit(r)
        self.live_frac.append(
            sum(r.alive for r in self.replicas) / len(self.replicas))
        self.tick += 1

    def idle(self) -> bool:
        return (not self.pending and not self._to_heal
                and all(not r.staged for r in self.replicas)
                and all(e.done or e.failed
                        for e in self.journal.values()))

    def run(self, trace: Sequence[Tuple[int, Request]] = (),
            max_ticks: int = 10_000) -> Dict[int, JournalEntry]:
        """Drive the fleet from an arrival trace (``(arrival_tick,
        Request)`` pairs, joining at the START of their tick) until
        every journaled request completes."""
        pending = sorted(trace, key=lambda ar: ar[0])
        i = 0
        while (i < len(pending) or not self.idle()) \
                and self.tick < max_ticks:
            arrivals = []
            while i < len(pending) and pending[i][0] <= self.tick:
                arrivals.append(pending[i][1])
                i += 1
            self.step(arrivals)
        if not self.idle():
            raise RuntimeError(f"fleet did not drain in {max_ticks} ticks")
        return self.journal

    # -- metrics ----------------------------------------------------------
    def availability(self) -> float:
        """Mean fraction of live replicas over the run (1.0 = no
        failures)."""
        return float(np.mean(self.live_frac)) if self.live_frac else 1.0

    def recovery_steps(self) -> int:
        """Worst-case ticks from a requeue to the affected stream's
        first NEW committed token (0 when no request was in flight
        across a failure)."""
        deltas = [ct - rt for e in self.journal.values()
                  for rt, ct in e.recoveries if ct >= 0]
        return max(deltas) if deltas else 0

    def detection_latency(self, injector) -> List[int]:
        """Ticks from each injected fault's firing to the first
        detection at or after it (chaos tests assert these bounded)."""
        out = []
        for spec, fire_tick in injector.fired:
            hits = [d["tick"] - fire_tick for d in self.detections
                    if d["tick"] >= fire_tick]
            out.append(min(hits) if hits else -1)
        return out
