"""Per-request sampling over the fused head's top-k candidates — the
port of ``repro/serving/sampling.py`` for temperature 0.

The per-slot parameters ride the decode state as ``state["sampling"]``
(five ``[B]`` leaves, as in the reference).  Only greedy decoding is
ported: a request with ``temperature > 0`` raises
``NotImplementedError`` (ROADMAP item 9 — the reference's positional
threefry PRNG must be ported bit-exactly first).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

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
    """Reject out-of-range params (naming the field) and the stochastic
    modes this port does not run yet."""
    if sp.temperature < 0:
        raise ValueError(f"request {rid}: temperature must be ≥ 0 "
                         f"(got {sp.temperature})")
    if not 1 <= sp.top_k <= CAND_K:
        raise ValueError(f"request {rid}: top_k must be in [1, {CAND_K}] "
                         f"(got {sp.top_k})")
    if not 0.0 < sp.top_p <= 1.0:
        raise ValueError(f"request {rid}: top_p must be in (0, 1] "
                         f"(got {sp.top_p})")
    if sp.temperature > 0:
        raise NotImplementedError(
            f"request {rid}: temperature > 0 needs the positional threefry "
            "PRNG, not ported yet (ROADMAP item 9)")


SAMPLING_LEAVES = ("temp", "topk", "topp", "seed", "step")
_LEAF_DTYPES = {"temp": torch.float32, "topk": torch.int32,
                "topp": torch.float32, "seed": torch.int64,
                "step": torch.int32}
_NP_DTYPES = {"temp": np.float32, "topk": np.int32, "topp": np.float32,
              "seed": np.uint32, "step": np.int32}
_LEAF_DEFAULTS = {"temp": 0.0, "topk": CAND_K, "topp": 1.0, "seed": 0,
                  "step": 0}


def init_sampling_state(batch: int, device) -> Dict[str, torch.Tensor]:
    """Greedy-default leaves; ``step`` counts each slot's emitted tokens.
    (``seed`` is int64 here: torch has no uint32 arithmetic.)"""
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
    """Admitted slots take the incoming host rows; the others ride
    through."""
    if (np.asarray(incoming["temp"]) > 0).any():
        raise NotImplementedError(
            "temperature > 0 needs the positional threefry PRNG, not "
            "ported yet (ROADMAP item 9)")
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


def finalize_candidates(vals: torch.Tensor, ids: torch.Tensor,
                        samp: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [B, K] sorted, indices [B, K], leaves)`` → ``(token [B]
    int32, head_val [B] f32)``.  Temperature 0 takes candidate 0
    (``sampling.py:224`` of the reference); temperature > 0 never gets
    here — it is rejected at submit and at admit."""
    return ids[:, 0].to(torch.int32), vals[:, 0]


def advance_sampling_step(samp: Dict[str, torch.Tensor],
                          active: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(samp, step=torch.where(active, samp["step"] + 1,
                                       samp["step"]))
