"""Slot-based continuous batching over the ragged decode engine — the
port of ``repro/serving/scheduler.py``.

Same policy as the reference, so traces agree event for event: arrivals
enqueue FIFO; each tick admits queue-head requests into the
lowest-numbered free slots (one targeted prefill-insert for all of
them, emitting each request's first token), retires one-token requests,
runs one decode step for the active slots, then retires the finished
ones.  The reference's fleet arguments (``hooks``, ``Request.replay``,
``integrity_latch``) belong to a later slice (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.serve import EngineHandle
from repro_torch.serving.sampling import (GREEDY, SamplingParams,
                                          fill_sampling_row,
                                          host_sampling_rows,
                                          validate_sampling)


@dataclass
class Request:
    """``prompt``: token ids (≤ the scheduler's ``prompt_cap``);
    ``max_new``: tokens to generate, counting the one the prefill insert
    samples."""
    rid: int
    prompt: Sequence[int]
    max_new: int
    sampling: SamplingParams = GREEDY


@dataclass
class _Slot:
    rid: Optional[int] = None
    remaining: int = 0
    last_tok: int = 0

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
                 eos_id: Optional[int] = None):
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
        self.n_slots = engine.batch_global
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self.queue: List[Request] = []
        self.results: Dict[int, RequestResult] = {}
        self.events: List[Tuple[int, str, int, int]] = []
        self.occupancy: List[float] = []
        self.tick = 0
        self.decode_calls = 0
        self.state = engine.retire_fn(engine.state,
                                      np.ones((self.n_slots,), np.int32))

    def cache_lens(self) -> np.ndarray:
        return self.state["cache_lens"].cpu().numpy()

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
        first, self.state = self.eng.admit_fn(
            self.eng.params["train"], self.state, toks, lens, samp)
        first = first.cpu().numpy()
        for b, req in admitted:
            self.slots[b] = _Slot(rid=req.rid, remaining=req.max_new)
            res = self.results[req.rid]
            res.slot, res.admit_tick = b, self.tick
            self.events.append((self.tick, "admit", req.rid, b))
            self._emit(b, int(first[b]))

    def _emit(self, b: int, tok: int) -> None:
        s = self.slots[b]
        s.last_tok = tok
        s.remaining -= 1
        self.results[s.rid].tokens.append(tok)

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
            self.slots[b] = _Slot()
        self.state = self.eng.retire_fn(self.state, mask)

    def step(self) -> None:
        self._admit()
        self._retire_finished()          # one-token / instant-EOS admits
        active = [b for b, s in enumerate(self.slots) if not s.free]
        if active:
            tok_in = np.asarray([s.last_tok for s in self.slots], np.int32)
            nxt, self.state = self.eng.decode_fn(self.eng.params["serve"],
                                                 self.state, tok_in)
            self.decode_calls += 1
            nxt = nxt.cpu().numpy()
            for b in active:
                self._emit(b, int(nxt[b]))
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
