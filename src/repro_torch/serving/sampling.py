"""Per-request sampling over the fused head's top-k candidates — the
port of ``repro/serving/sampling.py``.

The per-slot parameters ride the decode state as ``state["sampling"]``
(five ``[B]`` leaves, as in the reference), so one ragged batch serves
greedy and sampled requests side by side and the captured step never
changes.  :func:`finalize_candidates` applies temperature, then top-k
(a rank mask: the candidates arrive sorted), then top-p (keep while the
cumulative probability before a candidate is < p; rank 0 always kept),
then the Gumbel-max draw over the ``CAND_K`` candidates of B3 or of
:func:`head_candidates`.  The noise is positional: slot ``b``'s draw for
its ``n``-th emitted token is ``gumbel(fold_in(PRNGKey(seed_b), n))``
(``core/threefry.py``, the reference's words bit for bit), a function
of the request's seed and emit offset alone, so a journaled stream
replayed on another replica samples the same tokens
(``serving/router.py``).  Temperature 0 takes candidate 0 whatever the
noise; a step or an admit in which no slot samples skips the sampler
altogether (:func:`greedy_candidates`): the greedy tokens, bit for bit,
and no sampling arithmetic on a greedy batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.threefry import positional_gumbel
from repro_torch.kernels.fused_head.topk import select_topk

CAND_K = 8


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_k: int = CAND_K
    top_p: float = 1.0
    seed: int = 0


GREEDY = SamplingParams()


def validate_sampling(rid: int, sp: SamplingParams) -> None:
    """Reject out-of-range params, naming the offending field (the
    reference's messages)."""
    if sp.temperature < 0:
        raise ValueError(f"request {rid}: temperature must be ≥ 0 "
                         f"(got {sp.temperature})")
    if sp.top_k < 1:
        raise ValueError(f"request {rid}: top_k must be ≥ 1 (got {sp.top_k})")
    if sp.top_k > CAND_K:
        raise ValueError(
            f"request {rid}: top_k must be ≤ the fused head's candidate "
            f"width CAND_K={CAND_K} (got {sp.top_k})")
    if not 0.0 < sp.top_p <= 1.0:
        raise ValueError(f"request {rid}: top_p must be in (0, 1] "
                         f"(got {sp.top_p})")


SAMPLING_LEAVES = ("temp", "topk", "topp", "seed", "step")
_LEAF_DTYPES = {"temp": torch.float32, "topk": torch.int32,
                "topp": torch.float32, "seed": torch.int64,
                "step": torch.int32}
_NP_DTYPES = {"temp": np.float32, "topk": np.int32, "topp": np.float32,
              "seed": np.uint32, "step": np.int32}
_LEAF_DEFAULTS = {"temp": 0.0, "topk": CAND_K, "topp": 1.0, "seed": 0,
                  "step": 0}


def init_sampling_state(batch: int, device) -> Dict[str, torch.Tensor]:
    """Greedy-default leaves; ``step`` counts each slot's emitted tokens
    (the emit offset the PRNG folds in).  ``seed`` is int64 holding a
    uint32 value: torch has no uint32 arithmetic."""
    return {name: torch.full((batch,), _LEAF_DEFAULTS[name],
                             dtype=_LEAF_DTYPES[name], device=device)
            for name in SAMPLING_LEAVES}


def reset_sampling_state(samp: Dict[str, torch.Tensor], mask: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Retire: masked slots return to the greedy defaults."""
    return {name: torch.where(mask, torch.tensor(_LEAF_DEFAULTS[name],
                                                 dtype=v.dtype,
                                                 device=v.device), v)
            for name, v in samp.items()}


def admit_sampling_state(samp: Dict[str, torch.Tensor],
                         incoming: Dict[str, np.ndarray],
                         adm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Admitted slots take the incoming host rows (``step`` 0); the
    others ride through."""
    return {name: torch.where(adm, torch.as_tensor(
                np.asarray(incoming[name]).astype(np.int64)
                if name == "seed" else incoming[name],
                device=v.device).to(v.dtype), v)
            for name, v in samp.items()}


def host_sampling_rows(batch: int) -> Dict[str, np.ndarray]:
    return {name: np.full((batch,), _LEAF_DEFAULTS[name], _NP_DTYPES[name])
            for name in SAMPLING_LEAVES}


def fill_sampling_row(rows: Dict[str, np.ndarray], b: int,
                      sp: SamplingParams) -> None:
    rows["temp"][b] = sp.temperature
    rows["topk"][b] = sp.top_k
    rows["topp"][b] = sp.top_p
    rows["seed"][b] = np.uint32(sp.seed)
    rows["step"][b] = 0


def head_candidates(logits: torch.Tensor, k: int = CAND_K
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unfused tail: top-k over full f32 logits ``[B, V]`` — the same
    sorted candidate set the fused head streams."""
    lf = logits.float()
    ids = torch.arange(lf.shape[-1], dtype=torch.int32,
                       device=lf.device).expand_as(lf)
    return select_topk(lf, ids, k)


def gumbel_table(seed: torch.Tensor, steps: int, k: int = CAND_K
                 ) -> torch.Tensor:
    """The positional noise of slots with seeds ``seed [n]`` for their
    emit offsets ``0 … steps − 1``: f32 ``[n, steps, k]``, row ``(b, t)``
    being ``gumbel(fold_in(PRNGKey(seed[b]), t), (k,))``.  The admit
    writes it for each admitted slot (``state["gumbel"]``), so the
    captured step reads its noise instead of hashing it: two threefry
    hashes are some 300 small tensor ops, a third of a millisecond and
    more inside every step."""
    n = seed.shape[0]
    t = torch.arange(steps, dtype=torch.int64, device=seed.device)
    g = positional_gumbel(seed.to(torch.int64)[:, None].expand(n, steps)
                          .reshape(-1), t.repeat(n), k)
    return g.reshape(n, steps, k)


def greedy_candidates(vals: torch.Tensor, ids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate 0 of every slot: ``(token [B] int32, head_val [B] f32)``
    — what :func:`finalize_candidates` gives a slot at temperature 0, bit
    for bit, with none of its arithmetic (``sampling.py:224`` of the
    reference).  The step takes it when no live slot samples."""
    return ids[:, 0].to(torch.int32), vals[:, 0]


def finalize_candidates(vals: torch.Tensor, ids: torch.Tensor,
                        samp: Dict[str, torch.Tensor], gumbel: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [B, K] sorted, indices [B, K], leaves, noise)`` →
    ``(token [B] int32, head_val [B] f32)`` (``sampling.py:183–230`` of
    the reference).  ``head_val`` is the chosen candidate's raw
    (pre-temperature) value, which the ``check_finite`` sentinel tests
    and the shadow probe re-derives.  ``gumbel [B, K]``: each slot's
    noise for its emit offset, ``gumbel(fold_in(PRNGKey(seed), step),
    (K,))`` — looked up in ``state["gumbel"]`` (:func:`gumbel_table`) by
    the step and the admit.  Tensor arithmetic only: no host sync, so it
    runs inside the captured step."""
    B, K = vals.shape
    temp = samp["temp"]
    rank = torch.arange(K, device=vals.device).expand(B, K)
    keep = rank < torch.clamp(samp["topk"], 1, K)[:, None]
    scaled = vals / torch.clamp(temp, min=1e-6)[:, None]
    scaled = scaled.masked_fill(~keep, float("-inf"))
    # jax.nn.softmax's arithmetic: exp(x − max) over its sum
    e = torch.exp(scaled - scaled.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_p = (cum_before < samp["topp"][:, None]) | (rank == 0)
    scaled = scaled.masked_fill(~keep_p, float("-inf"))
    choice = torch.argmax(scaled + gumbel, dim=-1)
    j = torch.where(temp > 0, choice, torch.zeros_like(choice))[:, None]
    tok = torch.gather(ids, 1, j)[:, 0]
    return tok.to(torch.int32), torch.gather(vals, 1, j)[:, 0]


def advance_sampling_step(samp: Dict[str, torch.Tensor],
                          active: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(samp, step=torch.where(active, samp["step"] + 1,
                                       samp["step"]))
