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
conv tail from the last ``width − 1`` conv inputs.  MoE FFNs
(``prefill.py:140``) run ``moe_apply`` over the layer's whole token
batch.  Post-norm blocks (Gemma-2) norm each branch's output before its
residual add (``apply_block``).  Local-attention layers fill their ring
cache (``_fill_ring``), wrapping it when a prompt is longer than the
ring.  The ``tail`` layers run after the groups, with tied embeddings
the input is scaled by ``√d_model`` and the head reads ``embed``, and
the logit softcap caps the first token's logits (Gemma-2's 30).

With a frontend, ``frontend_embeds [B, P, F]`` comes with the prompt.
On a VLM (InternVL2-2B) their projection replaces the first ``P`` token
embeddings (``prefill.py:213–215``).  On an encoder-decoder
(SeamlessM4T-medium) prefill encodes them once, projects every decoder
layer's cross-attention k and v from the encoder's output into
``state["enc_kv"]`` — in place, so a decode graph captured on those
tensors reads them (``prefill.py:217–236``) — and each layer
cross-attends the encoder's output after its self-attention.

Under the fleet's flags (``prefill.py:297–336``) an admitted slot's
``work_blocks`` restarts at 0, its KV checksums are recomputed from its
whole cache entries (in place, as the caches), and its raw last
residual, head value and first token are stashed for the shadow probe.

Per-slot ``lengths`` make prefill a targeted insert on attention models:
``lengths[b] == 0`` leaves slot b untouched.  On a dense-FFN model rows
are independent in every op of this path, so each admitted request is
computed alone, over its own prompt: its caches and first token are then
the same bits whatever else the admit carries and wherever its slot is
— on the card a product's rounding depends on its shape, and a recovery
replay (``serving/router.py``) re-admits a request beside other
neighbours than the first time.  On a mesh (``ctx``) each rank runs its
own heads, FFN columns, experts and vocabulary shard, with the
reference's collectives (``psum_heads``, ``psum_model``, the head's
tree merge), the same runs on every rank.  A MoE layer is not
row-independent: its capacity is per call, over all ``T = B·S`` tokens,
so which tokens drop depends on the whole batch.  On a MoE config
prefill therefore runs every slot's whole ``[B, S]`` row through every
layer, as the reference does, even under ``lengths``, and writes only
the admitted slots.  A recurrent state would fold a padded tail into
itself, and an encoder's k/v are the whole batch's, so ``lengths`` on a
config with RWKV-6 or RG-LRU layers or an encoder raises, as the
reference's assertion does.  The caches and states are written
in place.

On a mesh an RG-LRU layer runs the rank's channels and an RWKV-6 layer
its heads, each writing the rank's part of the state, with the
reference's ``psum_model`` and ``psum_heads``; an encoder-decoder
encodes on the rank's encoder heads and writes its kv heads of
``enc_kv``; RecurrentGemma's local layers fill their cluster rank's
share of the ring.  Where a cluster pads a run to its query blocks, a
recurrent layer runs the real positions only (the padding would fold
into its state).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, RWKV6, ModelConfig
from repro_torch.core.dataflow import KVBlock
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.layers import lm_head_logits, rms_norm, softcap
from repro_torch.models.rwkv6 import (RWKV6State, rwkv6_channel_mix,
                                      rwkv6_time_mix)
from repro_torch.models.transformer import (apply_block, block_ffn,
                                            cross_params, embed_tokens,
                                            encode, head_table,
                                            layer_params, splice_frontend)
from repro_torch.serving.engine import (ServeConfig, _check_not_param_pair,
                                        _finite_violations, _layer,
                                        _merge_vocab_shards)
from repro_torch.serving.integrity import kv_entry_fp
from repro_torch.serving.sampling import (admit_sampling_state,
                                          finalize_candidates, gumbel_table,
                                          greedy_candidates,
                                          head_candidates)


def _fill_global(cache: KVBlock, k: torch.Tensor, v: torch.Tensor,
                 rows: torch.Tensor, lens: torch.Tensor,
                 c_rank: int = 0) -> None:
    """Write the prompt k/v ``[n, S_p, kv, hd]`` (MLA: the latent entries
    ``[n, S_p, l+rope]`` and their first column) of the admitted slots
    ``rows [n]`` (lengths ``lens [n]``) into one layer's cache, in place:
    this rank's shard of ``S`` rows holds positions ``c_rank·S …``
    (cluster rank ``c_rank``; 0 on one device), those below the length
    the prompt's, the rest zeros and ``pos = −1`` (the reference's
    ``_fill_global`` + ``_merge_admitted``, ``prefill.py:47–74``)."""
    S = cache.k.shape[0]
    B = cache.pos.shape[1]
    n, S_p = k.shape[:2]
    idx = c_rank * S + torch.arange(S, device=k.device)
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
               rows: torch.Tensor, lens: torch.Tensor, c_rank: int = 0,
               n_cluster: int = 1) -> None:
    """Sliding-window ring of ``W = n_cluster·S`` slots, this cluster
    rank's ``S`` of them (slots ``c_rank·S …``), per admitted slot (the
    reference's ``_fill_ring`` + ``_merge_admitted``, ``prefill.py:77–
    91``), in place: ring slot ``r`` of slot ``rows[j]`` holds the
    largest prompt position ``p < lens[j]`` with ``p ≡ r (mod W)`` and
    ``pos = p``, or zeros and ``pos = −1`` where there is none — every
    row is rewritten, so nothing of an earlier occupant survives.  The
    reference takes the window as the modulus; the ring has
    ``min(window, max_seq)`` slots, the same number whenever a prompt
    can wrap it."""
    S = cache.k.shape[0]
    B = cache.pos.shape[1]
    n, S_p = k.shape[:2]
    W = n_cluster * S
    base = c_rank * S + torch.arange(S, device=k.device)[:, None]  # [S, 1]
    have = base < lens[None, :]                                 # [S, n]
    p = base + torch.clamp(lens[None, :] - 1 - base, min=0) // W * W
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
                   st: rglru_mod.RGLRUState, ctx: ParallelCtx = SINGLE
                   ) -> torch.Tensor:
    """One RG-LRU layer over every slot's whole prompt, from the zero
    state whatever the slot held (``prefill.py:127–146``); writes the
    decode state ``st`` in place: ``h`` is the scan's last output in the
    model dtype, cast to f32 (ROADMAP C6), ``conv`` the last ``width −
    1`` conv inputs (zeros before the prompt).  On a mesh the rank's
    channels, the block's output summed by ``psum_model``."""
    p, eps = blk["rglru"], cfg.norm_eps
    h1 = rms_norm(x, blk["ln1"], eps)
    u = h1 @ p["w_x"]
    h_seq = rglru_mod.rglru_scan(p, rglru_mod._causal_conv(p, u))
    x = x + ctx.psum_model((h_seq * rglru_mod._gate(p, h1)) @ p["w_out"])
    n_tail = st.conv.shape[1]
    pad = torch.zeros((u.shape[0], n_tail, u.shape[2]), dtype=u.dtype,
                      device=u.device)
    st.h.copy_(h_seq[:, -1])
    st.conv.copy_(torch.cat([pad, u[:, -n_tail:]], dim=1)[:, -n_tail:])
    return x + block_ffn(cfg, blk["ffn"], rms_norm(x, blk["ln2"], eps),
                         ctx)


def _prefill_rwkv(cfg: ModelConfig, blk: Dict[str, Any], x: torch.Tensor,
                  st: RWKV6State, ctx: ParallelCtx = SINGLE
                  ) -> torch.Tensor:
    """One RWKV-6 layer over every slot's whole prompt, from the zero state
    whatever the slot held; writes ``s_fin`` (through B7; the rank's
    heads on a mesh) and the normed last inputs into the layer's state
    ``st`` in place."""
    p, eps = blk["rwkv"], cfg.norm_eps
    h1 = rms_norm(x, blk["ln1"], eps)
    a, _ = rwkv6_time_mix(p, h1, cfg.rwkv_head_dim, s_out=st.s, ctx=ctx)
    x = x + a
    h2 = rms_norm(x, blk["ln2"], eps)
    x = x + rwkv6_channel_mix(p, h2, ctx=ctx)
    st.x_prev_t.copy_(h1[:, -1])
    st.x_prev_c.copy_(h2[:, -1])
    return x


def _recurrent_rows(fn, x: torch.Tensor, s_eff: int) -> torch.Tensor:
    """``fn`` over the first ``s_eff`` positions of ``x``, the rest (a
    cluster's padding, which a recurrent state must not fold in) passed
    through: causal attention keeps them out of every real position."""
    if x.shape[1] == s_eff:
        return fn(x)
    return torch.cat([fn(x[:, :s_eff]), x[:, s_eff:]], dim=1)


def _write_enc_kv(cfg: ModelConfig, params: Dict[str, Any],
                  state: Dict[str, Any], enc_out: torch.Tensor,
                  ctx: ParallelCtx = SINGLE) -> None:
    """Every decoder layer's cross-attention k and v of ``enc_out
    [B, P, D]``, as ``[P, B·kv, hd]`` rounded to bf16, copied into
    ``state["enc_kv"]`` in place (``prefill.py:217–236``); on a mesh the
    rank's kv heads, whole (their head-dim segments gathered over a
    cluster above 1)."""
    P = enc_out.shape[1]
    for i, cross in enumerate(cross_params(params, cfg)):
        for name in ("k", "v"):
            t = ctx.gather_cluster(torch.einsum(
                "bpd,dkh->pbkh", enc_out, cross["attn"]["w" + name]), 3)
            state["enc_kv"][name][i].copy_(t.reshape(P, -1, t.shape[-1]))


def prefill(cfg: ModelConfig, scfg: ServeConfig, params: Dict[str, Any],
            state: Dict[str, Any], tokens, frontend_embeds=None, *,
            lengths=None, sampling: Optional[Dict[str, np.ndarray]] = None,
            ctx: ParallelCtx = SINGLE
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens ``[B, S_prompt]`` → ``(first token [B] int32, state)``.

    ``frontend_embeds [B, P, F]``: the stub frontend's embeddings, which a
    model with a frontend needs.  ``lengths [B]``: per-slot prompt lengths
    (default: every slot uses ``S_prompt``); 0 leaves the slot untouched,
    and its returned token is 0 (attention models without an encoder
    only).  ``sampling``: host rows of the sampling leaves for the
    admitted slots (``serving/sampling.py``)."""
    _check_not_param_pair(params, "train")
    kinds = cfg.layer_kinds
    if lengths is not None and (RWKV6 in kinds or RECURRENT in kinds
                                or cfg.encoder is not None):
        # prefill.py:204–206
        raise AssertionError(
            "per-slot prefill insert supports attention-only models")
    dev = state["cache_lens"].device
    tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    if frontend_embeds is not None:
        frontend_embeds = torch.as_tensor(frontend_embeds, device=dev)
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
        adm_rows = np.nonzero(adm_np)[0]
        if cfg.moe is not None:    # every row: capacity couples them
            runs = [(np.arange(B), adm_rows, S)]
        elif lengths is None:      # a lockstep batch, every row S long
            runs = [(adm_rows, adm_rows, S)]
        else:                      # each admitted request alone
            runs = [([r], [r], int(lens_np[r])) for r in adm_rows]
        outs = [_prefill_rows(cfg, params, state, tokens, frontend_embeds,
                              run, sel, s_eff, lens_np, ctx)
                for run, sel, s_eff in runs]
        last_raw, cand_v, cand_i = (torch.cat([o[i] for o in outs])
                                    for i in range(3))
        temp = (np.zeros((B,), np.float32) if sampling is None
                else np.asarray(sampling["temp"]))
        drawn = np.nonzero(adm_np & (temp > 0))[0]
        if len(drawn):
            # the sampled slots' noise for every emit offset, in place (a
            # greedy slot never reads its rows); the first token draws
            # at offset 0
            d = torch.as_tensor(drawn, device=dev)
            state["gumbel"][d] = gumbel_table(samp["seed"][d],
                                              state["gumbel"].shape[1])
            tok, head_val = finalize_candidates(
                cand_v, cand_i, {n: t[rows] for n, t in samp.items()},
                state["gumbel"][rows, 0])
        else:
            tok, head_val = greedy_candidates(cand_v, cand_i)
        nxt[rows] = tok
        if scfg.check_finite:
            last = rms_norm(last_raw, params["final_norm"], cfg.norm_eps)
            bad[rows] = _finite_violations(cfg, last, head_val, tok,
                                           torch.ones_like(tok, dtype=bool))
        if scfg.kv_fingerprint:
            _refingerprint(state, rows)
        if scfg.shadow_head:
            for name, new in (("head_resid", last_raw.to(torch.bfloat16)),
                              ("head_val", head_val.float()),
                              ("head_tok", tok)):
                new_state[name] = state[name].clone()
                new_state[name][rows] = new
    new_state["sampling"] = dict(samp, step=torch.where(
        adm, torch.ones_like(samp["step"]), samp["step"]))
    new_state["cache_lens"] = torch.where(adm, lens.to(torch.int32),
                                          state["cache_lens"])
    if scfg.check_finite:
        # admitted slots restart their count (a one-token request admits
        # and retires with no decode step in between)
        new_state["nonfinite"] = torch.where(adm, bad, state["nonfinite"])
    if scfg.track_work:              # admitted slots start a fresh count
        new_state["work_blocks"] = torch.where(
            adm, torch.zeros_like(state["work_blocks"]),
            state["work_blocks"])
    return nxt, new_state


def _prefill_rows(cfg: ModelConfig, params: Dict[str, Any],
                  state: Dict[str, Any], tokens: torch.Tensor,
                  frontend_embeds, run, sel, s_eff: int, lens_np: np.ndarray,
                  ctx: ParallelCtx = SINGLE
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward of slots ``run`` over their first ``s_eff`` tokens,
    writing the caches of slots ``sel`` (a subset of ``run``) in place;
    returns ``sel``'s raw last residual rows and their head candidates
    (values, indices)."""
    dev = tokens.device
    run_t = torch.as_tensor(np.asarray(run), device=dev)
    sel_t = torch.as_tensor(np.asarray(sel), device=dev)
    pick = torch.as_tensor(np.searchsorted(np.asarray(run), np.asarray(sel)),
                           device=dev)
    lens_a = torch.as_tensor(lens_np[np.asarray(sel)], device=dev)
    fe = None if frontend_embeds is None else frontend_embeds[run_t]
    toks = tokens[run_t, :s_eff]
    n_cl = ctx.cluster_size
    if s_eff % n_cl:
        # a cluster splits the sequence into n_cl query blocks
        # (attention.py:168): pad the run to a multiple of them; causal
        # attention keeps the padding out of every real position
        toks = torch.cat([toks, toks.new_zeros(
            (toks.shape[0], n_cl - s_eff % n_cl))], dim=1)
    x = splice_frontend(cfg, params, embed_tokens(
        cfg, params["embed"], toks, ctx), fe)
    enc_out = None
    if cfg.encoder is not None:     # every slot: lengths refused above
        enc_out = encode(cfg, params, fe, ctx)
        _write_enc_kv(cfg, params, state, enc_out, ctx)
    caches = [_layer(c, g)
              for g in range(cfg.n_layers // len(cfg.block_pattern))
              for c in state["layers"]] + list(state["tail"])
    for kind, blk, cache, cross in zip(cfg.layer_kinds,
                                       layer_params(params, cfg), caches,
                                       cross_params(params, cfg)):
        # the recurrent kinds run with every slot admitted
        if kind in (RWKV6, RECURRENT):
            fn = _prefill_rwkv if kind == RWKV6 else _prefill_rglru
            x = _recurrent_rows(lambda t: fn(cfg, blk, t, cache, ctx), x,
                                s_eff)
            continue
        x, kv = apply_block(cfg, blk, x, kind=kind, return_kv=True,
                            enc_out=enc_out, cross_blk=cross, ctx=ctx)
        if cfg.mla is not None:            # prefill.py:145–149
            kv = (kv, kv[..., :1])
        if kind == ATTN_LOCAL:
            _fill_ring(cache, *(t[pick] for t in kv), sel_t, lens_a,
                       ctx.cluster_index(), n_cl)
        else:
            _fill_global(cache, *(t[pick] for t in kv), sel_t, lens_a,
                         ctx.cluster_index())
    last_raw = x[pick, lens_a - 1]
    last = rms_norm(last_raw, params["final_norm"], cfg.norm_eps)
    table = head_table(cfg, params)
    logits = softcap(lm_head_logits(table, last), cfg.logit_softcap)
    cand_v, cand_i = _merge_vocab_shards(ctx, table.shape[0],
                                         *head_candidates(logits))
    return last_raw, cand_v, cand_i


def _refingerprint(state: Dict[str, Any], rows: torch.Tensor) -> None:
    """The admitted slots' KV checksums recomputed from their whole cache
    entries, in place (``prefill.py:308–328``): a re-admit may rewrite
    rows whose ``pos`` does not move, which the step's append delta
    cannot see."""
    B = state["cache_lens"].shape[0]
    for cache, fp in zip(state["layers"] + state["tail"],
                         state["kv_fp"] + state["kv_fp_tail"]):
        if isinstance(cache, KVBlock):
            fp[..., rows] = kv_entry_fp(cache, B)[..., rows]
