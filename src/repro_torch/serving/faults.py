"""Deterministic fault injection for the fleet — the port of
``repro/serving/faults.py``.

Every fault is a declarative :class:`FaultSpec` ``(kind, step, target,
seed, replica, bit)`` applied by a :class:`FaultInjector` through the
scheduler's :class:`~repro_torch.serving.scheduler.SchedulerHooks`,
never by patching.  The kinds and the probe each trips:

* ``kill`` — :class:`ReplicaKilled` from ``pre_step`` → heartbeat;
* ``blackhole`` — the decode never returns, the host echoes its inputs
  → the expected-``cache_lens`` cross-check;
* ``corrupt_kv`` — NaN into the target slot's k rows at position 0 of
  the first attention entry (every layer group) → the non-finite
  sentinel;
* ``corrupt_lens`` — the slot's ``cache_lens`` forced to ``max_seq + 7``
  → the bounds check;
* ``poison_weight`` — NaN or ±Inf into one seed-chosen column of the
  serve embedding for every later decode call → the non-finite sentinel;
* ``drop_admit`` — the device admit sees length 0 for the slot →
  expected-lens mismatch;
* ``dup_admit`` — an extra device admit of another length into the slot
  → expected-lens mismatch;
* ``flip_kv_bit`` — XOR bit ``bit`` of one seed-chosen k element of the
  slot's rows at position 0 of the first attention entry → the KV
  fingerprint;
* ``flip_weight_bit`` — XOR bit ``bit`` of one seed-chosen element of
  serve leaf ``target`` (``serving/integrity.py:weight_leaves`` order),
  persistent until the router heals the replica → the weight
  fingerprint or the shadow recompute.

The reference corrupts host copies and puts them back as new arrays.
The port's captured step reads only its own tensors, so the faults land
in place: the KV faults in the live cache (as an HBM flip would);
``flip_weight_bit`` in the live serve tensor (which the train tree
aliases, so the replica's admits see it too until the heal);
``poison_weight`` in the serve embedding for the length of each decode
call — ``decode_args`` poisons the column, ``post_decode`` puts the
clean values back — which is the reference's poisoned copy fed to every
later decode call while the replica's params stay clean between calls.
A graph is never recaptured and the eager step never swapped in.
Every choice is seeded (numpy's ``default_rng(seed)``, drawn as the
reference draws), so a spec perturbs the same element every run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dataflow import KVBlock
from repro_torch.serving.integrity import weight_leaves
from repro_torch.serving.scheduler import SchedulerHooks, SlotScheduler

FAULT_KINDS = ("kill", "blackhole", "corrupt_kv", "corrupt_lens",
               "poison_weight", "drop_admit", "dup_admit")
BIT_FAULT_KINDS = ("flip_kv_bit", "flip_weight_bit")
ALL_FAULT_KINDS = FAULT_KINDS + BIT_FAULT_KINDS


class ReplicaKilled(RuntimeError):
    """The replica is gone mid-step; the router's heartbeat turns it into
    a drain and requeue."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault: ``kind`` fires at scheduler tick ``step`` on
    ``replica``; ``target`` is a batch slot (``corrupt_kv``,
    ``corrupt_lens``, ``drop_admit``, ``dup_admit``, ``flip_kv_bit``) or
    a serve-leaf index (``flip_weight_bit``); ``seed`` drives the
    generated corruption; ``bit`` is the XORed bit of the ``flip_*``
    kinds (bf16: 0–6 mantissa, 7–14 exponent, 15 sign) and −1 for the
    others."""
    kind: str
    step: int
    target: int = 0
    seed: int = 0
    replica: int = 0
    bit: int = -1

    def __post_init__(self):
        if self.kind not in ALL_FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {ALL_FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(
                f"FaultSpec.step must be ≥ 0, got step={self.step}")
        if self.replica < 0:
            raise ValueError(f"FaultSpec.replica must be ≥ 0, got "
                             f"replica={self.replica} (the router also "
                             f"rejects replica ≥ its fleet size)")
        if self.target < 0:
            raise ValueError(
                f"FaultSpec.target must be ≥ 0, got target={self.target}")
        if self.kind in BIT_FAULT_KINDS:
            if not 0 <= self.bit < 16:
                raise ValueError(
                    f"FaultSpec.bit must be in [0, 16) for "
                    f"{self.kind!r} (bf16 bit address), got "
                    f"bit={self.bit}")
        elif self.bit != -1:
            raise ValueError(f"FaultSpec.bit only applies to "
                             f"{BIT_FAULT_KINDS}, got bit={self.bit} "
                             f"for {self.kind!r}")


# ---------------------------------------------------------------------------
# In-place corruption
# ---------------------------------------------------------------------------
def _first_kv(state: Dict[str, Any]) -> Tuple[KVBlock, bool]:
    """The first attention entry of the groups, else of the tail, and
    whether it is stacked over layer groups."""
    for entry in state["layers"]:
        if isinstance(entry, KVBlock):
            return entry, True
    for entry in state["tail"]:
        if isinstance(entry, KVBlock):
            return entry, False
    raise ValueError("no attention cache in state to corrupt")


def _slot_rows(entry: KVBlock, slot: int) -> Tuple[int, int]:
    B = entry.pos.shape[-1]
    per = entry.k.shape[-2] // B
    return slot * per, per


def corrupt_kv_slot(state: Dict[str, Any], slot: int,
                    value: float = float("nan")) -> None:
    """``value`` into ``slot``'s k rows at sequence position 0 of the
    first attention entry, every layer group (the reference's
    ``k[0, 0, ..., 0, rows, :]``), in place."""
    entry, stacked = _first_kv(state)
    r0, per = _slot_rows(entry, slot)
    k = entry.k if stacked else entry.k[None]
    k[:, 0, r0:r0 + per, :] = value


def flip_kv_bit(state: Dict[str, Any], slot: int, bit: int,
                seed: int = 0) -> None:
    """XOR bit ``bit`` of one seed-chosen k element of ``slot``'s rows at
    position 0 of the first attention entry's first layer group, in
    place — one flipped bit, no NaN, so only the KV fingerprint sees
    it."""
    entry, stacked = _first_kv(state)
    r0, per = _slot_rows(entry, slot)
    rng = np.random.default_rng(seed)
    r = r0 + int(rng.integers(per))
    c = int(rng.integers(entry.k.shape[-1]))
    k = entry.k[0] if stacked else entry.k
    _xor_bit(k[0, r], c, bit)


def corrupt_cache_lens(state: Dict[str, Any], slot: int,
                       value: int) -> Dict[str, Any]:
    """A state whose ``cache_lens[slot]`` is ``value`` (a new tensor, as
    the step's small leaves are: the graph copies it in)."""
    lens = state["cache_lens"].clone()
    lens[slot] = value
    return dict(state, cache_lens=lens)


def _xor_bit(row: torch.Tensor, i: int, bit: int) -> None:
    """XOR bit ``bit`` of element ``i`` of the 1-D tensor ``row`` (a view
    of a live tensor), on its device, through the same-width int view."""
    ints = row.view(torch.int16 if row.element_size() == 2 else torch.int32)
    mask = (1 << bit) - (1 << 16 if row.element_size() == 2 and bit == 15
                         else 0)
    ints[i] = ints[i] ^ mask


def poison_column(embed: torch.Tensor, seed: int
                  ) -> Tuple[int, torch.Tensor]:
    """NaN or ±Inf (seed-chosen, as the reference draws) into one column
    of the embedding table, in place; returns the column and its clean
    values."""
    rng = np.random.default_rng(seed)
    bad = float(rng.choice([np.nan, np.inf, -np.inf]))
    col = int(rng.integers(embed.shape[-1]))
    clean = embed[..., col].clone()
    embed[..., col] = bad
    return col, clean


def flip_weight_bit(params: Dict[str, Any], target: int, bit: int,
                    seed: int = 0) -> str:
    """XOR bit ``bit`` of one seed-chosen element of serve leaf ``target
    mod n`` (``weight_leaves`` order, shared with the monitor), in place;
    returns the leaf's name."""
    leaves = weight_leaves(params)
    name, leaf = leaves[target % len(leaves)]
    rng = np.random.default_rng(seed)
    _xor_bit(leaf.reshape(-1), int(rng.integers(leaf.numel())), bit)
    return name


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------
class FaultInjector(SchedulerHooks):
    """Applies each spec once, at its step (or at the first chance after
    it, for a fault that needs an admit to ride on).  ``fired`` records
    ``(spec, tick)`` for the detection latency."""

    def __init__(self, specs: Sequence[FaultSpec]):
        seen: set = set()
        for s in specs:
            key = (s.kind, s.target, s.step, s.replica)
            if key in seen:
                raise ValueError(
                    f"duplicate FaultSpec (kind, target, step, replica)="
                    f"{key}: each fault fires exactly once, so two specs "
                    f"at the same address are a harness bug")
            seen.add(key)
        self.specs: List[FaultSpec] = sorted(specs, key=lambda s: s.step)
        self.fired: List[Tuple[FaultSpec, int]] = []
        self.flipped_weight: List[str] = []
        self._done: set = set()
        self._poison_seed = None
        self._poisoned = None          # (embed, column, clean values)
        self._blackholed = False

    def _due(self, sched: SlotScheduler,
             kind: str) -> List[Tuple[int, FaultSpec]]:
        return [(i, s) for i, s in enumerate(self.specs)
                if s.kind == kind and i not in self._done
                and sched.tick >= s.step]

    def _mark(self, i: int, spec: FaultSpec, tick: int) -> None:
        self._done.add(i)
        self.fired.append((spec, tick))

    def pre_step(self, sched: SlotScheduler) -> None:
        for i, s in self._due(sched, "kill"):
            self._mark(i, s, sched.tick)
            raise ReplicaKilled(f"fault-injected kill at tick {sched.tick}")

    def admit_args(self, sched: SlotScheduler, toks, lens):
        for i, s in self._due(sched, "drop_admit"):
            if lens[s.target] > 0:       # needs a carrier admit to drop
                lens = np.array(lens)
                lens[s.target] = 0
                self._mark(i, s, sched.tick)
        return toks, lens

    def post_admit(self, sched: SlotScheduler) -> None:
        for i, s in self._due(sched, "dup_admit"):
            self._mark(i, s, sched.tick)
            exp = int(sched.expected_cache_lens()[s.target])
            # a length other than the host's expected cache length: the
            # harmful, state-changing duplicate
            want = exp + 1
            plen = want if 1 <= want <= sched.prompt_cap \
                else max(1, exp - 1)
            rng = np.random.default_rng(s.seed)
            toks = np.zeros((sched.n_slots, sched.prompt_cap), np.int32)
            toks[s.target, :plen] = rng.integers(
                sched.eng.cfg.vocab_size, size=(plen,))
            lens = np.zeros((sched.n_slots,), np.int32)
            lens[s.target] = plen
            _, sched.state = sched.eng.admit_fn(
                sched.eng.params["train"], sched.state, toks, lens)

    def decode_args(self, sched: SlotScheduler, params, state, tokens):
        for i, s in self._due(sched, "corrupt_kv"):
            self._mark(i, s, sched.tick)
            corrupt_kv_slot(state, s.target)
        for i, s in self._due(sched, "corrupt_lens"):
            self._mark(i, s, sched.tick)
            state = corrupt_cache_lens(state, s.target,
                                       sched.eng.scfg.max_seq + 7)
        for i, s in self._due(sched, "poison_weight"):
            self._mark(i, s, sched.tick)
            self._poison_seed = s.seed
        for i, s in self._due(sched, "flip_kv_bit"):
            self._mark(i, s, sched.tick)
            flip_kv_bit(state, s.target, s.bit, s.seed)
        for i, s in self._due(sched, "flip_weight_bit"):
            self._mark(i, s, sched.tick)
            # persistent: the replica's own serve tensor, until the heal
            self.flipped_weight.append(flip_weight_bit(
                sched.eng.params["serve"], s.target, s.bit, s.seed))
        if self._poison_seed is not None:   # every decode call from now on
            embed = params["embed"]
            col, clean = poison_column(embed, self._poison_seed)
            self._poisoned = (embed, col, clean)
        return params, state, tokens

    def post_decode(self, sched: SlotScheduler) -> None:
        if self._poisoned is not None:
            embed, col, clean = self._poisoned
            embed[..., col] = clean
            self._poisoned = None

    def decode_blackholed(self, sched: SlotScheduler) -> bool:
        if self._blackholed:
            return True
        for i, s in self._due(sched, "blackhole"):
            self._mark(i, s, sched.tick)
            self._blackholed = True     # the link stays dark
        return self._blackholed


# ---------------------------------------------------------------------------
# Systematic sweep grids
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultSweep:
    """A (kind × target × bit × step × replica) grid of single-bit fault
    specs; ``serving/sweep.py`` runs one spec per router run."""
    kinds: Tuple[str, ...] = BIT_FAULT_KINDS
    targets: Tuple[int, ...] = (0,)
    bits: Tuple[int, ...] = tuple(range(16))
    steps: Tuple[int, ...] = (2,)
    replicas: Tuple[int, ...] = (0,)
    seed: int = 0

    def specs(self) -> List[FaultSpec]:
        """The grid in (kind, target, bit, step, replica) order."""
        return [FaultSpec(kind, step, target=t, seed=self.seed,
                          replica=r, bit=b)
                for kind in self.kinds
                for t in self.targets
                for b in self.bits
                for step in self.steps
                for r in self.replicas]
