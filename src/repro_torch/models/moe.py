"""Mixture-of-Experts FFN — the port of ``repro/models/moe.py``.  On one
GPU every expert is local and ``psum_model`` is the identity; on a mesh
(``ctx``) a rank holds ``E / ms`` experts, routes every token as every
rank does, computes only the slots its experts own, and ``psum_model``
adds the ranks' outputs (``moe.py:61–118``).

Dispatch is the reference's, capacity-based with static shapes
(GShard): each token's top-k experts, a slot's position inside its
expert from a stable argsort by expert (earlier tokens win capacity),
slots at or past the capacity ``C`` dropped, the kept tokens gathered
into an ``[E, C, D]`` table (the sentinel row ``T`` — a zero row — for
empty and dropped slots), the expert FFNs as batched products over
every expert, and the outputs combined back with the routing weights.
Every expert's weights are read whatever the routing: that is the
reference's semantics.

Capacity is per call (``T`` tokens of the whole batch), so a token's
output depends on the other tokens of its batch: MoE models are served
lockstep (``serving/scheduler.py`` refuses them, as the reference's
does).  No op here syncs with the host or has a data-dependent shape,
so the decode step's CUDA graph (``serving/step_graph.py``) captures
the dispatch; the combine adds each token's ``k`` contributions in slot
order (no atomics), so it gives the same bits on every run.

``MoEParams`` is a dict, like the port's other blocks: ``router [D, E]``
f32, ``w_in``/``w_gate [E, D, F]`` (no ``w_gate`` when ungated),
``w_out [E, F, D]`` and, for Arctic's dense-residual branch, ``dense``
(a dense FFN dict).  ``moe_apply_dff`` (the decode path that also
slices each expert's ``d_ff`` over the data axis) and
``aux_load_balance_loss`` (training) wait for ROADMAP A.5b and A.11.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.ctx import SINGLE, ParallelCtx
from repro_torch.models.layers import (activation, ffn_apply, seeded_normal,
                                       softcap)


def is_moe(ffn: Any) -> bool:
    """Whether a block's ``ffn`` entry is ``MoEParams`` (not a dense FFN)."""
    return isinstance(ffn, dict) and "router" in ffn


def _capacity(tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for ``tokens`` tokens (``moe.py:44``), padded to a
    multiple of 8 with a minimum of 8: the pad decides which tokens
    drop, so it is kept."""
    c = int(math.ceil(tokens * moe.top_k / moe.num_experts
                      * moe.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def route(moe: MoEConfig, router: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing (``moe.py:50``), ``x [T, D]`` → ``(expert ids [T, k]
    int64, weights [T, k] f32)``: f32 logits, the router softcap,
    softmax, top-k, then the weights renormalized.  Equal probabilities
    go to the lowest expert index, as ``lax.top_k`` breaks ties: a
    stable descending sort keeps equal values in index order
    (``torch.topk`` promises no order among ties)."""
    logits = softcap(x.float() @ router.float(), moe.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :moe.top_k], idx[:, :moe.top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return idx, w


def moe_apply(p: Dict[str, Any], x: torch.Tensor, act: str,
              moe: MoEConfig, ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    """``x [..., D]`` → ``[..., D]`` in ``x.dtype`` (``moe.py:61``): every
    token of ``x`` — ``B·S`` at prefill, ``B`` at decode — shares one
    capacity ``C = _capacity(T)``; this rank's experts are ``shard ·
    E_loc … (shard + 1) · E_loc − 1`` (``moe.py:69``)."""
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T, dev = xt.shape[0], x.device
    E, k = moe.num_experts, moe.top_k
    e_loc = p["w_in"].shape[-3]
    C = _capacity(T, moe)

    idx, w = route(moe, p["router"], xt)                  # [T, k]
    # GShard position-in-expert: a stable argsort by expert keeps slot
    # order, so earlier tokens win capacity
    flat_e = idx.reshape(-1)                              # [T·k]
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.empty_like(flat_e)
    pos_in_e[order] = torch.arange(tk, device=dev) - start[sorted_e]
    keep = pos_in_e < C
    # the slots this rank's experts own (every kept slot off a mesh)
    local_e, mine = flat_e, keep
    if ctx.model is not None:
        local_e = flat_e - ctx.model_index() * e_loc
        mine = (local_e >= 0) & (local_e < e_loc) & keep
        local_e = torch.clamp(local_e, 0, e_loc - 1)
    slot_addr = local_e * C + torch.clamp(pos_in_e, 0, C - 1)

    # the [E_loc·C] dispatch table of token ids; dropped and foreign
    # slots write the sentinel row E_loc·C (cut off), empty ones keep T
    # (the zero row)
    tok_ids = torch.arange(tk, device=dev) // k
    addr = torch.where(mine, slot_addr, e_loc * C)
    table = torch.full((e_loc * C + 1,), T, dtype=torch.int64, device=dev)
    table.scatter_(0, addr, torch.where(mine, tok_ids, T))
    x_pad = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    xe = x_pad[table[:e_loc * C]].view(e_loc, C, D)

    h = torch.bmm(xe, p["w_in"])                          # [E, C, F]
    if p.get("w_gate") is not None:
        h = activation(act)(torch.bmm(xe, p["w_gate"])) * h
    else:
        h = activation(act)(h)
    ye = torch.bmm(h, p["w_out"])                         # [E, C, D]

    # combine: each token's k contributions, weights in ye's dtype, added
    # in slot order in ye's dtype — the reference's scatter-add
    flat_w = w.reshape(-1).to(ye.dtype)
    gathered = ye.view(e_loc * C, D)[slot_addr]
    contrib = torch.where(mine[:, None], gathered * flat_w[:, None],
                          torch.zeros((), dtype=ye.dtype, device=dev))
    contrib = contrib.view(T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    y = ctx.psum_model(y).to(x.dtype).view(x.shape)
    if p.get("dense") is not None:                        # Arctic residual
        y = y + ffn_apply(p["dense"], x, act, ctx)
    return y


def moe_init(gen: torch.Generator, d_model: int, moe: MoEConfig,
             gated: bool, *, lead: Tuple[int, ...] = (),
             dtype=torch.bfloat16,
             cut: Callable = lambda t, rule: t) -> Dict[str, Any]:
    """Seeded ``MoEParams`` with the reference's scales (``moe.py:138``):
    the router f32 ``N(0, 1)/√D``, ``w_in``/``w_gate`` ``1/√D``, ``w_out``
    ``1/√F``; Arctic's dense branch at the dense FFN's scales.  ``lead``
    prefixes every shape (the layer-group axis); ``cut(tensor, rule)``
    takes each leaf as drawn to a rank's slice (``models/transformer.py``
    rules: ``rep``, ``expert``, ``col``, ``row``)."""
    E, F = moe.num_experts, moe.expert_d_ff
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(F)

    def draw(shape, scale, rule, dt=dtype):
        return cut(seeded_normal(gen, lead + shape, scale, dt), rule)

    p = {"router": draw((d_model, E), s_in, "rep", torch.float32),
         "w_in": draw((E, d_model, F), s_in, "expert")}
    if gated:
        p["w_gate"] = draw((E, d_model, F), s_in, "expert")
    p["w_out"] = draw((E, F, d_model), s_out, "expert")
    if moe.dense_ff_residual:
        Fd = moe.dense_residual_d_ff
        p["dense"] = {"w_in": draw((d_model, Fd), s_in, "col")}
        if gated:
            p["dense"]["w_gate"] = draw((d_model, Fd), s_in, "col")
        p["dense"]["w_out"] = draw((Fd, d_model), 1.0 / math.sqrt(Fd), "row")
    return p
