"""Slot-based continuous batching over the ragged decode engine — the
port of ``repro/serving/scheduler.py``.

Same policy as the reference, so traces agree event for event: arrivals
enqueue FIFO; each tick admits queue-head requests into the
lowest-numbered free slots (one targeted prefill-insert for all of
them, emitting each request's first token), retires one-token requests,
runs one decode step for the active slots, then retires the finished
ones.

The fleet's arguments, as the reference's: ``hooks``
(:class:`SchedulerHooks`, the fault injector's only way in),
``Request.replay`` (journaled tokens force-fed through the same
captured step before a recovered request generates live) and
``integrity_latch`` (violations read before a same-tick retire can
erase them).  Sampled requests ride their ``SamplingParams`` into the
slot's state leaves; the positional PRNG makes a replayed request
sample its original stream.  A decode step asks for the sampler
(``decode_fn(..., sampled=True)``) only while a live slot samples.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.serve import EngineHandle
from repro_torch.serving.engine import reset_decode_state
from repro_torch.serving.sampling import (GREEDY, SamplingParams,
                                          fill_sampling_row,
                                          host_sampling_rows,
                                          validate_sampling)


@dataclass
class Request:
    """``prompt``: token ids (≤ the scheduler's ``prompt_cap``);
    ``max_new``: tokens to generate, counting the one the prefill insert
    samples.  ``replay``: journaled tokens to reconstruct before
    generating live (fleet recovery): the slot admits ``prompt``, then
    takes the replayed tokens as its decode inputs in order; the engine's
    re-emitted tokens are checked against them, and the journal's are
    kept.  ``max_new`` counts the replayed tokens.  ``sampling``: the
    request's :class:`SamplingParams` (default greedy)."""
    rid: int
    prompt: Sequence[int]
    max_new: int
    replay: Sequence[int] = ()
    sampling: SamplingParams = GREEDY


class SchedulerHooks:
    """Extension points for perturbing a live scheduler (the reference's
    ``scheduler.py:75–107``): the fault injector (``serving/faults.py``)
    is the hooks object the scheduler was built with, so every injected
    fault is in the call graph.  The base class does nothing.
    ``post_decode`` is the port's own: it runs right after the decode
    call, so a fault the reference feeds to the step as a corrupted copy
    (``poison_weight``) is applied in place for the call and taken back
    after it."""

    def pre_step(self, sched: "SlotScheduler") -> None:
        """Start of every tick; may raise (``faults.ReplicaKilled``)."""

    def admit_args(self, sched: "SlotScheduler", toks: np.ndarray,
                   lens: np.ndarray):
        """Rewrite what the device admit sees (host bookkeeping keeps the
        original request)."""
        return toks, lens

    def post_admit(self, sched: "SlotScheduler") -> None:
        """After the tick's admit call."""

    def decode_args(self, sched: "SlotScheduler", params, state, tokens):
        """Rewrite what the decode call consumes."""
        return params, state, tokens

    def post_decode(self, sched: "SlotScheduler") -> None:
        """Right after the decode call."""

    def decode_blackholed(self, sched: "SlotScheduler") -> bool:
        """True: the decode call never returns; the host loop goes on
        with a stale echo of its inputs while the device state freezes."""
        return False


@dataclass
class _Slot:
    rid: Optional[int] = None
    remaining: int = 0
    last_tok: int = 0
    prompt_len: int = 0         # admitted prompt length (journal model)
    emitted: int = 0            # tokens emitted so far, replayed included
    replay: List[int] = field(default_factory=list)
    replay_mismatch: int = 0    # engine token ≠ journaled token
    sampled: bool = False       # temperature > 0: the step must draw

    @property
    def free(self) -> bool:
        return self.rid is None


@dataclass
class RequestResult:
    rid: int
    tokens: List[int] = field(default_factory=list)
    slot: int = -1
    admit_tick: int = -1
    finish_tick: int = -1
    sampling: SamplingParams = GREEDY


class SlotScheduler:
    """Continuous batching over an :class:`EngineHandle` of a dense-FFN
    text decoder.  A model with a frontend or an encoder is refused, as
    the reference asserts (``scheduler.py:150``): its requests carry
    embeddings the targeted insert does not take.  A MoE model is
    refused, as the reference asserts (``scheduler.py:152–158``):
    capacity routing drops experts' tokens by per-batch capacity, so a
    request's tokens would depend on the slots beside it.  Both serve
    lockstep (``launch/serve.py:generate``)."""

    def __init__(self, engine: EngineHandle, *, prompt_cap: int,
                 eos_id: Optional[int] = None,
                 hooks: Optional[SchedulerHooks] = None,
                 integrity_latch: bool = False):
        if engine.cfg.frontend is not None or engine.cfg.encoder is not None:
            raise AssertionError(
                "SlotScheduler supports decoder-only text models")
        if engine.cfg.moe is not None:
            raise AssertionError(
                "SlotScheduler requires dense-FFN models: MoE capacity "
                "routing makes tokens depend on co-resident slots")
        self.eng = engine
        self.prompt_cap = int(prompt_cap)
        self.eos_id = eos_id
        self.hooks = hooks
        self.n_slots = engine.batch_global
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.queue: List[Request] = []
        self.results: Dict[int, RequestResult] = {}
        self.events: List[Tuple[int, str, int, int]] = []
        self.occupancy: List[float] = []
        self.tick = 0
        self.decode_calls = 0
        # violations read between the decode and a retire that would
        # erase them (the router's probes, DESIGN.md §9)
        self.integrity_latch = integrity_latch
        self.latched: List[str] = []
        self._replay_mismatch_retired = 0
        # a fresh start, as the reference's (its engine keeps the initial
        # state): the caches are written in place, so they are zeroed
        # and their checksums with them; then every slot is retired
        self.state = engine.retire_fn(
            reset_decode_state(engine.cfg, engine.scfg, engine.state),
            np.ones((self.n_slots,), np.int32))

    def cache_lens(self) -> np.ndarray:
        return self.eng.to_global(self.state["cache_lens"]).cpu().numpy()

    def work_blocks(self) -> np.ndarray:
        """Per-slot attend-step counters (``track_work``)."""
        if "work_blocks" not in self.state:
            raise ValueError("build the engine with track_work=True")
        return self.eng.to_global(self.state["work_blocks"]).cpu().numpy()

    def expected_cache_lens(self) -> np.ndarray:
        """What ``cache_lens`` must read if the device ran exactly the
        admits and decodes this host issued: an active slot holds its
        prompt and one entry per decode input so far (``prompt_len +
        emitted − 1``), a free slot −1.  The router compares it with the
        device each tick: a dropped or duplicated admit, a blackholed
        replica or a corrupted length shows as a mismatch."""
        out = np.full((self.n_slots,), -1, np.int64)
        for b, s in enumerate(self.slots):
            if not s.free:
                out[b] = s.prompt_len + s.emitted - 1
        return out

    def replay_mismatches(self) -> int:
        """Journal/engine token disagreements across recovery replays,
        live and retired."""
        return self._replay_mismatch_retired + sum(
            s.replay_mismatch for s in self.slots)

    def _latch_integrity(self) -> None:
        """Read the per-slot violations before the retire can reset
        them (``integrity_latch``)."""
        st = self.state
        if "nonfinite" in st and bool(
                (self.eng.to_global(st["nonfinite"]) > 0).any()):
            self.latched.append("detect_nonfinite")
        lens = self.cache_lens()
        if (lens < -1).any() or (lens > self.eng.scfg.max_seq).any():
            self.latched.append("detect_lens_bounds")
        if (lens != self.expected_cache_lens()).any():
            self.latched.append("detect_journal_stale")

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError(f"request {req.rid}: empty prompt — length 0 "
                             "means 'leave this slot untouched'")
        if plen > self.prompt_cap:
            raise ValueError(f"request {req.rid}: prompt length {plen} "
                             f"exceeds prompt_cap={self.prompt_cap}")
        if plen > self.eng.scfg.max_seq:
            raise ValueError(f"request {req.rid}: prompt length {plen} "
                             f"exceeds max_seq={self.eng.scfg.max_seq}")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be ≥ 1 "
                             f"(got {req.max_new})")
        if len(req.replay) >= req.max_new:
            raise ValueError(
                f"request {req.rid}: replay carries {len(req.replay)} "
                f"tokens but max_new={req.max_new} — a resumed request "
                "must have live tokens left to generate")
        validate_sampling(req.rid, req.sampling)
        if req.rid in self.results:
            raise ValueError(f"request {req.rid}: duplicate request id")
        self.queue.append(req)
        self.results[req.rid] = RequestResult(rid=req.rid,
                                              sampling=req.sampling)

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s.free]
        admitted: List[Tuple[int, Request]] = []
        while self.queue and free:
            admitted.append((free.pop(0), self.queue.pop(0)))
        if not admitted:
            return
        toks = np.zeros((self.n_slots, self.prompt_cap), np.int32)
        lens = np.zeros((self.n_slots,), np.int32)
        samp = host_sampling_rows(self.n_slots)
        for b, req in admitted:
            toks[b, :len(req.prompt)] = np.asarray(req.prompt, np.int32)
            lens[b] = len(req.prompt)
            fill_sampling_row(samp, b, req.sampling)
        if self.hooks is not None:
            toks, lens = self.hooks.admit_args(self, toks, lens)
        first, self.state = self.eng.admit_fn(
            self.eng.params["train"], self.state, toks, lens, samp)
        first = first.cpu().numpy()
        for b, req in admitted:
            self.slots[b] = _Slot(rid=req.rid, remaining=req.max_new,
                                  prompt_len=len(req.prompt),
                                  replay=list(req.replay),
                                  sampled=req.sampling.temperature > 0)
            res = self.results[req.rid]
            res.slot, res.admit_tick = b, self.tick
            self.events.append((self.tick, "admit", req.rid, b))
            self._emit(b, int(first[b]))
        if self.hooks is not None:
            self.hooks.post_admit(self)

    def _emit(self, b: int, tok: int) -> None:
        s = self.slots[b]
        if s.replay:
            # recovery replay: the journal's token stands, and the
            # engine's must match it
            want = s.replay.pop(0)
            if tok != want:
                s.replay_mismatch += 1
            tok = want
        s.last_tok = tok
        s.remaining -= 1
        s.emitted += 1
        self.results[s.rid].tokens.append(tok)

    def _finishing(self) -> bool:
        return any(not s.free and (s.remaining <= 0
                                   or (self.eos_id is not None
                                       and s.last_tok == self.eos_id))
                   for s in self.slots)

    def _retire_finished(self) -> None:
        fin = [b for b, s in enumerate(self.slots) if not s.free
               and (s.remaining <= 0
                    or (self.eos_id is not None
                        and s.last_tok == self.eos_id))]
        if not fin:
            return
        mask = np.zeros((self.n_slots,), np.int32)
        for b in fin:
            mask[b] = 1
            rid = self.slots[b].rid
            self.results[rid].finish_tick = self.tick
            self.events.append((self.tick, "finish", rid, b))
            self._replay_mismatch_retired += self.slots[b].replay_mismatch
            self.slots[b] = _Slot()
        self.state = self.eng.retire_fn(self.state, mask)

    def step(self) -> None:
        if self.hooks is not None:
            self.hooks.pre_step(self)
        self._admit()
        if self.integrity_latch and self._finishing():
            # a request admitted this tick finishes before the decode:
            # latch now, or the retire erases a bad admit's evidence
            self._latch_integrity()
        self._retire_finished()          # one-token / instant-EOS admits
        active = [b for b, s in enumerate(self.slots) if not s.free]
        if active:
            tok_in = np.asarray([s.last_tok for s in self.slots], np.int32)
            if self.hooks is not None and self.hooks.decode_blackholed(self):
                nxt = tok_in             # a stale echo; the device froze
            else:
                params, st, ti = self.eng.params["serve"], self.state, tok_in
                if self.hooks is not None:
                    params, st, ti = self.hooks.decode_args(self, params, st,
                                                            ti)
                nxt, self.state = self.eng.decode_fn(
                    params, st, ti,
                    sampled=any(self.slots[b].sampled for b in active))
                if self.hooks is not None:
                    self.hooks.post_decode(self)
                self.decode_calls += 1
                nxt = nxt.cpu().numpy()
            for b in active:
                self._emit(b, int(nxt[b]))
            if self.integrity_latch:
                self._latch_integrity()
            self._retire_finished()
        self.occupancy.append(len(active) / self.n_slots)
        self.tick += 1

    def idle(self) -> bool:
        return not self.queue and all(s.free for s in self.slots)

    def run(self, max_ticks: int = 10_000) -> Dict[int, RequestResult]:
        while not self.idle() and self.tick < max_ticks:
            self.step()
        if not self.idle():
            raise RuntimeError(f"scheduler did not drain in {max_ticks} ticks")
        return self.results


def replay_trace(sched: SlotScheduler,
                 trace: Sequence[Tuple[int, Request]],
                 max_ticks: int = 10_000) -> Dict[int, RequestResult]:
    """Drive ``sched`` from ``(arrival_tick, Request)`` pairs until drained."""
    pending = sorted(trace, key=lambda ar: ar[0])
    i = 0
    while (i < len(pending) or not sched.idle()) and sched.tick < max_ticks:
        while i < len(pending) and pending[i][0] <= sched.tick:
            sched.submit(pending[i][1])
            i += 1
        sched.step()
    if not sched.idle():
        raise RuntimeError("trace did not drain")
    return sched.results
