"""Prefill — the port of ``repro/serving/prefill.py``: run the prompt
through the train-path forward (plain torch, as the reference leaves
prefill to XLA), scatter each attention layer's k/v (for MLA its latent
entries) into the decode cache, and sample each admitted slot's first
token from its last real position.

RWKV-6 layers (``_prefill_block``'s RWKV6 branch, ``prefill.py:116–126``)
run the time mix from the zero state and the zero shift through the B7
scan and write the decode state: ``s_fin`` and the NORMED last inputs
``h1[:, -1]``, ``h2[:, -1]``.

Per-slot ``lengths`` make prefill a targeted insert on attention models:
``lengths[b] == 0`` leaves slot b untouched.  Rows are independent in
every op of this path, so only the admitted rows are computed, and only
up to their longest prompt (causal attention: a padded tail never
reaches the positions before it).  A recurrent state would fold a padded
tail into itself, so ``lengths`` on an RWKV-6 config raises, as the
reference's assertion does.  The caches and states are written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RWKV6, ModelConfig
from repro_torch.core.dataflow import KVBlock
from repro_torch.models.layers import embed_lookup, lm_head_logits, rms_norm
from repro_torch.models.rwkv6 import (RWKV6State, rwkv6_channel_mix,
                                      rwkv6_time_mix)
from repro_torch.models.transformer import apply_block, layer_params
from repro_torch.serving.engine import (ServeConfig, _check_not_param_pair,
                                        _finite_violations, _layer)
from repro_torch.serving.sampling import (admit_sampling_state,
                                          finalize_candidates,
                                          head_candidates)


def _fill_global(cache: KVBlock, k: torch.Tensor, v: torch.Tensor,
                 rows: torch.Tensor, lens: torch.Tensor) -> None:
    """Write the prompt k/v ``[n, S_p, kv, hd]`` (MLA: the latent entries
    ``[n, S_p, l+rope]`` and their first column) of the admitted slots
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


def _prefill_rwkv(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
                  st: RWKV6State) -> torch.Tensor:
    """One RWKV-6 layer over every slot's whole prompt, from the zero state
    whatever the slot held; writes ``s_fin`` (through B7) and the normed
    last inputs into the layer's state ``st`` in place."""
    p, eps = blk["rwkv"], cfg.norm_eps
    h1 = rms_norm(x, blk["ln1"], eps)
    a, _ = rwkv6_time_mix(p, h1, cfg.rwkv_head_dim, s_out=st.s)
    x = x + a
    h2 = rms_norm(x, blk["ln2"], eps)
    x = x + rwkv6_channel_mix(p, h2)
    st.x_prev_t.copy_(h1[:, -1])
    st.x_prev_c.copy_(h2[:, -1])
    return x


def prefill(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
            state: Dict[str, Any], tokens, *, lengths=None,
            sampling: Optional[Dict[str, np.ndarray]] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens ``[B, S_prompt]`` → ``(first token [B] int32, state)``.

    ``lengths [B]``: per-slot prompt lengths (default: every slot uses
    ``S_prompt``); 0 leaves the slot untouched, and its returned token
    is 0 (attention models only).  ``sampling``: host rows of the
    sampling leaves for the admitted slots (``serving/sampling.py``)."""
    _check_not_param_pair(params, "train")
    rwkv = RWKV6 in cfg.block_pattern
    if rwkv and lengths is not None:            # prefill.py:204–206
        raise AssertionError(
            "per-slot prefill insert supports attention-only models")
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
        caches = [_layer(c, g)
                  for g in range(cfg.n_layers // len(cfg.block_pattern))
                  for c in state["layers"]]
        for blk, cache in zip(blocks, caches):
            if rwkv:                  # every slot admitted (lengths None)
                x = _prefill_rwkv(cfg, blk, x, cache)
                continue
            x, kv = apply_block(cfg, blk, x, return_kv=True)
            if cfg.mla is not None:            # prefill.py:145–149
                kv = (kv, kv[..., :1])
            _fill_global(cache, *kv, rows, lens_a)
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
