"""Prefill — the port of ``repro/serving/prefill.py`` for dense attention
decoders: run the prompt through the train-path forward (plain torch, as
the reference leaves prefill to XLA), scatter each layer's k/v into the
decode cache, and sample each admitted slot's first token from its last
real position.

Per-slot ``lengths`` make prefill a targeted insert: ``lengths[b] == 0``
leaves slot b untouched.  Rows are independent in every op of this
path, so only the admitted rows are computed, and only up to their
longest prompt (causal attention: a padded tail never reaches the
positions before it).  The caches are written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dataflow import KVBlock
from repro_torch.models.layers import embed_lookup, lm_head_logits, rms_norm
from repro_torch.models.transformer import apply_block, layer_params
from repro_torch.serving.engine import (ServeConfig, _check_not_param_pair,
                                        _finite_violations)
from repro_torch.serving.sampling import (admit_sampling_state,
                                          finalize_candidates,
                                          head_candidates)


def _fill_global(cache: KVBlock, k: torch.Tensor, v: torch.Tensor,
                 rows: torch.Tensor, lens: torch.Tensor) -> None:
    """Write the prompt k/v ``[n, S_p, kv, hd]`` of the admitted slots
    ``rows [n]`` (lengths ``lens [n]``) into one layer's cache, in place:
    positions below the length hold the prompt, the rest zeros and
    ``pos = −1`` (the reference's ``_fill_global`` + ``_merge_admitted``
    at cluster 1)."""
    S = cache.k.shape[0]
    B = cache.pos.shape[1]
    n, S_p = k.shape[:2]
    idx = torch.arange(S, device=k.device)
    valid = idx[:, None] < lens[None, :]                        # [S, n]
    take = torch.clamp(idx, max=S_p - 1)
    for full, new in ((cache.k, k), (cache.v, v)):
        rows_new = new.reshape(n, S_p, -1).transpose(0, 1)[take]  # [S, n, R]
        full.view(S, B, -1)[:, rows] = torch.where(
            valid[..., None], rows_new, torch.zeros((), dtype=full.dtype,
                                                    device=full.device))
    cache.pos[:, rows] = torch.where(valid, idx[:, None].to(torch.int32),
                                     torch.tensor(-1, dtype=torch.int32,
                                                  device=k.device))


def prefill(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
            state: Dict[str, Any], tokens, *, lengths=None,
            sampling: Optional[Dict[str, np.ndarray]] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens ``[B, S_prompt]`` → ``(first token [B] int32, state)``.

    ``lengths [B]``: per-slot prompt lengths (default: every slot uses
    ``S_prompt``); 0 leaves the slot untouched, and its returned token
    is 0.  ``sampling``: host rows of the sampling leaves for the
    admitted slots (``serving/sampling.py``)."""
    _check_not_param_pair(params, "train")
    dev = state["cache_lens"].device
    tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    B, S = tokens.shape
    lens_np = (np.full((B,), S, np.int64) if lengths is None
               else np.asarray(lengths, np.int64))
    adm_np = lens_np > 0
    rows = torch.as_tensor(np.nonzero(adm_np)[0], device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    adm = lens > 0
    new_state = dict(state)
    samp = state["sampling"]
    if sampling is not None:
        samp = admit_sampling_state(samp, sampling, adm)
    nxt = torch.zeros((B,), dtype=torch.int32, device=dev)
    bad = torch.zeros((B,), dtype=torch.int32, device=dev)
    if adm_np.any():
        s_eff = int(lens_np[adm_np].max())
        lens_a = lens[rows]
        x = embed_lookup(params["embed"], tokens[rows, :s_eff])
        blocks = layer_params(params, cfg)
        caches = [KVBlock(c.k[g], c.v[g], c.pos[g])
                  for g in range(cfg.n_layers // len(cfg.block_pattern))
                  for c in state["layers"]]
        for blk, cache in zip(blocks, caches):
            x, (k, v) = apply_block(cfg, blk, x, return_kv=True)
            _fill_global(cache, k, v, rows, lens_a)
        last_raw = x[torch.arange(len(rows), device=dev), lens_a - 1]
        last = rms_norm(last_raw, params["final_norm"], cfg.norm_eps)
        logits = lm_head_logits(params["lm_head"], last)
        cand_v, cand_i = head_candidates(logits)
        tok, head_val = finalize_candidates(
            cand_v, cand_i, {n: t[rows] for n, t in samp.items()})
        nxt[rows] = tok
        if scfg.check_finite:
            bad[rows] = _finite_violations(cfg, last, head_val, tok,
                                           torch.ones_like(tok, dtype=bool))
    new_state["sampling"] = dict(samp, step=torch.where(
        adm, torch.ones_like(samp["step"]), samp["step"]))
    new_state["cache_lens"] = torch.where(adm, lens.to(torch.int32),
                                          state["cache_lens"])
    if scfg.check_finite:
        # admitted slots restart their count (a one-token request admits
        # and retires with no decode step in between)
        new_state["nonfinite"] = torch.where(adm, bad, state["nonfinite"])
    return nxt, new_state
