"""Prefill — the port of ``repro/serving/prefill.py``: run the prompt
through the train-path forward (plain torch, as the reference leaves
prefill to XLA), scatter each attention layer's k/v (for MLA its latent
entries) into the decode cache, and sample each admitted slot's first
token from its last real position.

RWKV-6 layers (``_prefill_block``'s RWKV6 branch, ``prefill.py:116–126``)
run the time mix from the zero state and the zero shift through the B7
scan and write the decode state: ``s_fin`` and the NORMED last inputs
``h1[:, -1]``, ``h2[:, -1]``.  RG-LRU layers (``prefill.py:127–146``) run
the block from the zero state, the recurrence through the B6 scan, and
write ``h`` from the scan's LAST OUTPUT, rounded to the model dtype as
the reference's scan returns it (``rglru.py:95``, ROADMAP C6), and the
conv tail from the last ``width − 1`` conv inputs.  Local-attention
layers fill their ring cache (``_fill_ring``).  The ``tail`` layers run
after the groups, and with tied embeddings the input is scaled by
``√d_model`` and the head reads ``embed``.

Per-slot ``lengths`` make prefill a targeted insert on attention models:
``lengths[b] == 0`` leaves slot b untouched.  Rows are independent in
every op of this path, so only the admitted rows are computed, and only
up to their longest prompt (causal attention: a padded tail never
reaches the positions before it).  A recurrent state would fold a padded
tail into itself, so ``lengths`` on a config with RWKV-6 or RG-LRU
layers raises, as the reference's assertion does.  The caches and states
are written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, RWKV6, ModelConfig
from repro_torch.core.dataflow import KVBlock
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import (ffn_apply, lm_head_logits, rms_norm,
                                       softcap)
from repro_torch.models.rwkv6 import (RWKV6State, rwkv6_channel_mix,
                                      rwkv6_time_mix)
from repro_torch.models.transformer import (apply_block, embed_tokens,
                                            head_table, layer_params)
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


def _fill_ring(cache: KVBlock, k: torch.Tensor, v: torch.Tensor,
               rows: torch.Tensor, lens: torch.Tensor) -> None:
    """Sliding-window ring of ``S`` rows, per admitted slot (the
    reference's ``_fill_ring`` + ``_merge_admitted`` at cluster 1), in
    place: ring row ``r`` of slot ``rows[j]`` holds the largest prompt
    position ``p < lens[j]`` with ``p ≡ r (mod S)`` and ``pos = p``, or
    zeros and ``pos = −1`` where there is none — every row is rewritten,
    so nothing of an earlier occupant survives.  The reference takes the
    window as the modulus; the ring has ``min(window, max_seq)`` rows,
    the same number whenever a prompt can wrap it."""
    S = cache.k.shape[0]
    B = cache.pos.shape[1]
    n, S_p = k.shape[:2]
    base = torch.arange(S, device=k.device)[:, None]            # [S, 1]
    have = base < lens[None, :]                                 # [S, n]
    p = base + torch.clamp(lens[None, :] - 1 - base, min=0) // S * S
    take = torch.clamp(p, max=S_p - 1)
    b_ix = torch.arange(n, device=k.device)[None, :]
    for full, new in ((cache.k, k), (cache.v, v)):
        rows_new = new.reshape(n, S_p, -1)[b_ix, take]          # [S, n, R]
        full.view(S, B, -1)[:, rows] = torch.where(
            have[..., None], rows_new, torch.zeros((), dtype=full.dtype,
                                                   device=full.device))
    cache.pos[:, rows] = torch.where(have, p.to(torch.int32),
                                     torch.tensor(-1, dtype=torch.int32,
                                                  device=k.device))


def _prefill_rglru(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
                   st: rglru_mod.RGLRUState) -> torch.Tensor:
    """One RG-LRU layer over every slot's whole prompt, from the zero
    state whatever the slot held (``prefill.py:127–146``); writes the
    decode state ``st`` in place: ``h`` is the scan's last output in the
    model dtype, cast to f32 (ROADMAP C6), ``conv`` the last ``width −
    1`` conv inputs (zeros before the prompt)."""
    p, eps = blk["rglru"], cfg.norm_eps
    h1 = rms_norm(x, blk["ln1"], eps)
    u = h1 @ p["w_x"]
    h_seq = rglru_mod.rglru_scan(p, rglru_mod._causal_conv(p, u))
    x = x + (h_seq * rglru_mod._gate(p, h1)) @ p["w_out"]
    n_tail = st.conv.shape[1]
    pad = torch.zeros((u.shape[0], n_tail, u.shape[2]), dtype=u.dtype,
                      device=u.device)
    st.h.copy_(h_seq[:, -1])
    st.conv.copy_(torch.cat([pad, u[:, -n_tail:]], dim=1)[:, -n_tail:])
    return x + ffn_apply(blk["ffn"], rms_norm(x, blk["ln2"], eps),
                         cfg.ffn_act)


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
    kinds = cfg.layer_kinds
    if lengths is not None and (RWKV6 in kinds or RECURRENT in kinds):
        # prefill.py:204–206
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
        x = embed_tokens(cfg, params["embed"], tokens[rows, :s_eff])
        caches = [_layer(c, g)
                  for g in range(cfg.n_layers // len(cfg.block_pattern))
                  for c in state["layers"]] + list(state["tail"])
        for kind, blk, cache in zip(kinds, layer_params(params, cfg),
                                    caches):
            # the recurrent kinds run with every slot admitted
            if kind == RWKV6:
                x = _prefill_rwkv(cfg, blk, x, cache)
                continue
            if kind == RECURRENT:
                x = _prefill_rglru(cfg, blk, x, cache)
                continue
            x, kv = apply_block(cfg, blk, x, kind=kind, return_kv=True)
            if cfg.mla is not None:            # prefill.py:145–149
                kv = (kv, kv[..., :1])
            fill = _fill_ring if kind == ATTN_LOCAL else _fill_global
            fill(cache, *kv, rows, lens_a)
        last_raw = x[torch.arange(len(rows), device=dev), lens_a - 1]
        last = rms_norm(last_raw, params["final_norm"], cfg.norm_eps)
        logits = softcap(lm_head_logits(head_table(cfg, params), last),
                         cfg.logit_softcap)
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
