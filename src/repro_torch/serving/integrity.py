"""Silent-data-corruption probes — the port of
``repro/serving/integrity.py``.

Three probes, wired into the router's per-tick loop
(``serving/router.py``), as in the reference:

1. **KV fingerprints**: every attention cache entry carries a per-slot
   checksum leaf (``state["kv_fp"]``, one ``[G, B]`` int32 per
   block-pattern position, and ``state["kv_fp_tail"]``, one ``[B]`` per
   tail layer) over the bit patterns of its k and v rows: the sum, mod
   2^32, of bf16 bits taken through ``int16`` (sign-extended) and f32
   bits through ``int32``.  Integer sums are exact in any order, so only
   a changed bit moves one.  The decode step updates the leaf for the
   rows it appends (:func:`kv_rows_bitsum` before and after the step,
   ``serving/engine.py``) and the admit recomputes an admitted slot's
   from scratch (:func:`kv_entry_fp`).  The port's caches are updated in
   place, and so are these leaves, so a leaf always describes the
   tensor beside it, whichever scheduler drove it last.  The probe
   recomputes every entry's checksum **on the device** from the cache
   rows — independently of the incremental update — and compares it
   exactly; only a ``[B]`` vector of mismatches reaches the host (the
   reference copies every cache to the host each tick).
2. **Weight fingerprints**: per-leaf checksums of the serve tree taken
   at construction, re-summed on the device on a rotation of
   ``weight_leaves_per_tick`` leaves a tick; a full rotation takes
   :meth:`IntegrityMonitor.commit_lag` ticks, the window the router
   defers commits by.
3. **Shadow recompute**: the step stashes each slot's pre-head
   residual, winning logit and token (``head_resid``/``head_val``/
   ``head_tok``); the probe re-derives one rotating slot's logit on the
   host — final RMSNorm, bf16 round, f32 dot, softcap — against a
   pristine host copy of the head table and final norm taken at
   construction, so a corrupt device head cannot vouch for itself.

:func:`kv_entry_fp` and :func:`leaf_checksum` equal, as integers, the
reference's ``kv_entry_fp``, ``np_kv_entry_fp`` and ``leaf_checksum``
on the same bytes (``tests/test_torch_fleet.py``).  Probe costs go to
``core/tracecount.py``'s probe counters: the bytes each probe reads.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch

from repro_torch.core import tracecount
from repro_torch.core.dataflow import KVBlock

MASK32 = 0xFFFFFFFF
_CHUNK = 1 << 26          # elements summed at once: bounds the int copies


# ---------------------------------------------------------------------------
# Bit-pattern sums (mod 2^32), on whatever device the tensor lives
# ---------------------------------------------------------------------------
def _bits(x: torch.Tensor) -> torch.Tensor:
    """The bit patterns as signed integers: 16-bit floats through
    ``int16`` (sign-extended into int32), 32-bit floats through ``int32``
    (into int64, so a row sum cannot overflow), integers as int64."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.view(torch.int16).to(torch.int32)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64)
    return x.to(torch.int64)


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """int64 sums of the bit patterns along the last axis.  16-bit rows
    sum in int32 first: a row of fewer than 2^16 elements of at most
    2^15 in size cannot overflow it."""
    b = _bits(x)
    if b.dtype == torch.int32 and x.shape[-1] < (1 << 16):
        return b.sum(dim=-1, dtype=torch.int32).to(torch.int64)
    return b.to(torch.int64).sum(dim=-1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 sum, mod 2^32, as the int32 of the same bits."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 checksum bits as their uint32 value (int64)."""
    return x.to(torch.int64) & MASK32


def _slot_sums(x: torch.Tensor, B: int) -> torch.Tensor:
    """``[..., S, B·r, hd]`` (batch-slot-major rows) → int64 ``[..., B]``:
    each slot's bit sum over its rows at every position."""
    *lead, S, rows, hd = x.shape
    return _row_sums(x.reshape(*lead, S, B, (rows // B) * hd)).sum(dim=-2)


def kv_entry_fp(cache: KVBlock, B: int) -> torch.Tensor:
    """Full per-slot checksum of one cache entry, int32 ``[..., B]`` (the
    leading axis of a stacked entry kept): k and v, every row of each
    slot.  Stacked entries are summed one layer at a time, so the int
    copies stay one layer's size."""
    if cache.k.dim() == 4:
        return torch.stack([kv_entry_fp(KVBlock(cache.k[g], cache.v[g],
                                                cache.pos[g]), B)
                            for g in range(cache.k.shape[0])])
    return wrap_i32(_slot_sums(cache.k, B) + _slot_sums(cache.v, B))


def kv_rows_bitsum(cache: KVBlock, rows: torch.Tensor) -> torch.Tensor:
    """int64 ``[G, B]`` (``[B]`` unstacked): the bit sum of the k and v
    row ``rows[b]`` of every slot b — the rows a decode step appends
    (``core/dataflow.py:_append_slot``).  Read before and after the step,
    the difference is the step's change to the entry's checksum."""
    B = rows.shape[0]
    b = torch.arange(B, device=rows.device)
    total = 0
    for t in (cache.k, cache.v):
        S = t.shape[-3]
        v = t.reshape(*t.shape[:-3], S, B, -1)
        total = total + _row_sums(v[..., rows, b, :])
    return total


def leaf_checksum(t: torch.Tensor) -> int:
    """Mod-2^32 bit-pattern checksum of one tensor, summed where it lives
    (in chunks, so the integer copy stays small); one scalar reaches the
    host."""
    flat = t.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), _CHUNK):
        total = total + _bits(flat[i:i + _CHUNK]).to(torch.int64).sum()
    return int(total) & MASK32


def _flatten(tree: Any, path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _flatten(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")


def weight_leaves(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of a param tree, in one fixed
    order (dicts by sorted key, lists and named tuples in order, ``None``
    skipped — jax's tree-flatten order).  The monitor's fingerprint
    table and ``FaultSpec.target`` of ``flip_weight_bit`` index the same
    list.  A tensor the tree holds twice (the head bundle aliases
    ``lm_head``) is listed twice, as in the reference."""
    return list(_flatten(tree, ""))


def weight_fingerprints(tree: Any) -> Dict[str, int]:
    return {name: leaf_checksum(t) for name, t in weight_leaves(tree)}


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class IntegrityConfig:
    """Which probes the router runs, and how hard (the reference's
    fields and defaults): ``weight_leaves_per_tick`` bounds the rotating
    weight check, whose full rotation is the commit window; the shadow
    tolerances absorb the summation order of the head's dot product."""
    kv: bool = True
    weights: bool = True
    weight_leaves_per_tick: int = 1
    shadow: bool = True
    shadow_rtol: float = 1e-3
    shadow_atol: float = 1e-4


class IntegrityMonitor:
    """One replica's probe state: the weight fingerprint table, the
    pristine host copy of the head, and the rotation cursor.
    ``probe(sched)`` is the router's per-tick entry; it returns the
    signals that fired (empty: clean).  ``probe_ms`` sums each probe's
    host-clock time over the ticks."""

    def __init__(self, eng, icfg: IntegrityConfig):
        self.eng = eng
        self.icfg = icfg
        self.tick = 0
        self.last_details: List[str] = []
        self.probe_ms = {"kv": 0.0, "weights": 0.0, "shadow": 0.0}
        if icfg.kv and not eng.scfg.kv_fingerprint:
            raise ValueError(
                "IntegrityConfig.kv needs engines built with "
                "kv_fingerprint=True (build_engine_full / build_replicas)")
        if icfg.shadow and not eng.scfg.shadow_head:
            raise ValueError(
                "IntegrityConfig.shadow needs engines built with "
                "shadow_head=True (build_engine_full / build_replicas)")
        if icfg.weights and icfg.weight_leaves_per_tick < 1:
            raise ValueError("weight_leaves_per_tick must be ≥ 1")
        self.weight_ref: Dict[str, int] = (
            weight_fingerprints(eng.params["serve"]) if icfg.weights else {})
        self._leaf_names = list(self.weight_ref)
        if icfg.shadow:
            from repro_torch.serving.prepack import head_view
            hv = head_view(eng.cfg, eng.params["serve"])
            # taken while the tree is known clean: the shadow recompute
            # must not consult the device table it exists to check
            self._table = hv.table.float().cpu()
            self._ln = hv.ln.float().cpu()

    def commit_lag(self) -> int:
        """Ticks the router defers commits: the weight rotation's full
        period (0 without the weight probe)."""
        if not self.icfg.weights or not self._leaf_names:
            return 0
        return math.ceil(len(self._leaf_names)
                         / self.icfg.weight_leaves_per_tick)

    def probe(self, sched) -> List[str]:
        """The configured probes on ``sched``'s live state: one call, one
        router tick."""
        fired: List[str] = []
        self.last_details = []
        tracecount.record_probe("probe_ticks")
        t0 = time.perf_counter()
        if self.icfg.kv and not self.verify_kv(sched.state):
            fired.append("detect_kv_fingerprint")
        t1 = time.perf_counter()
        if self.icfg.weights:
            bad = self.verify_weights(self._rotation(self.tick))
            if bad:
                fired.append("detect_weight_fingerprint")
                self.last_details += [f"weight:{n}" for n in bad]
        t2 = time.perf_counter()
        if self.icfg.shadow:
            slot = self.tick % sched.n_slots
            if not self.verify_shadow(sched.state, slot):
                fired.append("detect_shadow_recompute")
                self.last_details.append(f"shadow:slot{slot}")
        # host clock: each probe ends in a read of its result, so its
        # device work is inside its window
        for name, a, b in (("kv", t0, t1), ("weights", t1, t2),
                           ("shadow", t2, time.perf_counter())):
            self.probe_ms[name] += 1e3 * (b - a)
        self.tick += 1
        return fired

    def verify_kv(self, state: Dict[str, Any]) -> bool:
        """Recompute every attention entry's per-slot checksum on the
        device and compare it exactly with the step's leaves; one
        ``[B]`` mismatch vector comes back to the host."""
        pairs = [(c, f) for c, f in zip(state["layers"], state["kv_fp"])
                 if isinstance(c, KVBlock)]
        pairs += [(c, f) for c, f in zip(state["tail"], state["kv_fp_tail"])
                  if isinstance(c, KVBlock)]
        B = state["cache_lens"].shape[0]
        bad = torch.zeros((B,), dtype=torch.bool,
                          device=state["cache_lens"].device)
        nbytes = 0
        for cache, fp in pairs:
            nbytes += sum(t.numel() * t.element_size()
                          for t in (cache.k, cache.v, fp))
            diff = kv_entry_fp(cache, B) != fp
            bad |= diff.reshape(-1, B).any(dim=0)
        tracecount.record_probe("probe_bytes_kv", nbytes)
        slots = torch.nonzero(bad).flatten().tolist()
        if slots:
            self.last_details.append("kv:slots" + ",".join(map(str, slots)))
        return not slots

    def _rotation(self, tick: int) -> List[int]:
        n = len(self._leaf_names)
        if n == 0:
            return []
        k = self.icfg.weight_leaves_per_tick
        return [(tick * k + j) % n for j in range(min(k, n))]

    def verify_weights(self, idxs: Sequence[int]) -> List[str]:
        """Re-sum the given leaves of the live serve tree on the device;
        the names whose checksum left the construction-time one."""
        leaves = weight_leaves(self.eng.params["serve"])
        bad, nbytes = [], 0
        for i in idxs:
            name, t = leaves[i]
            nbytes += t.numel() * t.element_size()
            if leaf_checksum(t) != self.weight_ref[name]:
                bad.append(name)
        tracecount.record_probe("probe_bytes_weights", nbytes)
        return bad

    def verify_weights_full(self) -> List[str]:
        """Every leaf (the heal's re-verification before a rejoin)."""
        return self.verify_weights(range(len(self._leaf_names)))

    def verify_shadow(self, state: Dict[str, Any], slot: int) -> bool:
        """Re-derive ``slot``'s winning logit from its stashed residual
        with the pristine head copy, on the host, and compare it with
        the device's ``head_val``.  One step writes the (residual, value,
        token) triple together, so a stale slot cannot false-positive."""
        cfg = self.eng.cfg
        resid = state["head_resid"][slot].cpu()
        val = float(state["head_val"][slot])
        t = int(state["head_tok"][slot])
        tracecount.record_probe(
            "probe_bytes_shadow", resid.numel() * resid.element_size() + 8)
        if not 0 <= t < cfg.vocab_size:
            return False
        # the device tail: f32 RMSNorm → bf16 round → f32 dot → softcap
        xf = resid.float()
        y = xf * torch.rsqrt(torch.mean(xf * xf) + cfg.norm_eps) \
            * (1.0 + self._ln)
        y = y.to(torch.bfloat16).float()
        logit = float(y @ self._table[t])
        if cfg.logit_softcap:
            logit = math.tanh(logit / cfg.logit_softcap) * cfg.logit_softcap
        return abs(logit - val) <= (self.icfg.shadow_atol
                                    + self.icfg.shadow_rtol * abs(logit))
