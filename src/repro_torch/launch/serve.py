"""Serving entry points — the port of ``repro/launch/serve.py`` on one GPU.

:func:`build_engine_full` makes the weights (seeded random, on the
device, or carried over from the reference with
``models/transformer.py:from_reference_params``), resolves the backend
and the prepack as the reference does (``core/autotune.py``: the
unfused ``"xla"`` path by default, ``"auto"`` → the fused ``"pallas"``
kernels for attention models), builds the serve tree once (the
prepacked layout on ``"pallas"``, the train tree itself on ``"xla"``),
allocates the decode state and returns the steps a serving loop
drives: ``prefill_fn``/``decode_fn`` for lockstep batches
(:func:`generate`) and ``admit_fn``/``retire_fn`` for continuous
batching (``serving/scheduler.py``).  Models with recurrent layers
(RWKV-6, RecurrentGemma's RG-LRU) are served lockstep only: their
``admit_fn`` raises, as the reference's does (a recurrent state cannot
take a per-slot insert).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.autotune import resolve_serving
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import (EngineOptions, ServeConfig,
                                        decode_step, init_decode_state)
from repro_torch.serving.prefill import prefill
from repro_torch.serving.prepack import prepack_for_serving
from repro_torch.serving.sampling import (host_sampling_rows,
                                          reset_sampling_state)


class EngineHandle(NamedTuple):
    """Everything a serving loop needs.  ``params`` is the ``{"train",
    "serve"}`` pair (on ``"pallas"`` the serve tree aliases every train
    tensor except the packed ``wqkv`` or MLA's ``wproj``; on ``"xla"`` it
    is the train tree).

    * ``prefill_fn(params["train"], state, tokens [B, S])``;
    * ``decode_fn(params["serve"], state, tokens [B])``;
    * ``admit_fn(params["train"], state, tokens [B, S_cap], lengths [B],
      samp=None)`` — targeted prefill-insert of the slots with
      ``lengths[b] > 0`` (attention models; raises on recurrent layers);
    * ``retire_fn(state, mask [B])`` — frees the masked slots.

    Every step returns ``(tokens, new state)``; the KV caches and
    recurrent states inside are shared with (and updated in place from)
    the state passed in."""
    params: Any
    prefill_fn: Callable
    decode_fn: Callable
    admit_fn: Callable
    retire_fn: Callable
    state: Any
    scfg: ServeConfig
    cfg: ModelConfig
    batch_global: int


def build_engine_full(cfg: ModelConfig, *, max_seq: int, batch_global: int,
                      options: Optional[EngineOptions] = None,
                      device="cuda", seed: int = 0,
                      train_params: Optional[dict] = None) -> EngineHandle:
    """Build the serving steps for ``cfg`` on ``device`` (default CUDA;
    raises when no card is present and the CPU was not asked for).

    ``options.backend``/``options.prepack`` resolve as in the reference
    (``core/autotune.py``); ``"pallas"`` with prepack off, ``"pallas"``
    (or ``"auto"``) for RecurrentGemma and MLA on ``"xla"`` raise
    ``NotImplementedError`` naming their ROADMAP items.
    Prefill does not depend on the backend.  ``train_params``:
    train-layout weights to serve (e.g. from ``from_reference_params``);
    default: :func:`init_params` from ``seed``."""
    dev = resolve_device(device)
    opt = options or EngineOptions()
    backend, prepack = resolve_serving(cfg, opt.backend, opt.prepack)
    train = (train_params if train_params is not None
             else init_params(cfg, seed=seed, device=dev))
    serve = (prepack_for_serving(cfg, train, backend=backend) if prepack
             else train)
    params = {"train": train, "serve": serve}
    scfg = ServeConfig(max_seq=max_seq, batch_local=batch_global,
                       backend=backend, prepack=prepack,
                       check_finite=opt.check_finite)
    state = init_decode_state(cfg, scfg, device=dev)

    def prefill_fn(p, st, tokens):
        return prefill(cfg, scfg, p, st, tokens)

    def decode_fn(p, st, tokens):
        return decode_step(cfg, scfg, p, st, tokens)

    def admit_fn(p, st, tokens, lengths, samp=None):
        if samp is None:
            samp = host_sampling_rows(batch_global)
        return prefill(cfg, scfg, p, st, tokens, lengths=lengths,
                       sampling=samp)

    def retire_fn(st, mask):
        m = torch.as_tensor(np.asarray(mask), device=dev) > 0
        new = dict(st)
        new["cache_lens"] = torch.where(
            m, torch.tensor(-1, dtype=torch.int32, device=dev),
            st["cache_lens"])
        new["sampling"] = reset_sampling_state(st["sampling"], m)
        if "nonfinite" in st:        # a retired slot's sentinel clears
            new["nonfinite"] = torch.where(m, 0, st["nonfinite"])
        return new

    return EngineHandle(params, prefill_fn, decode_fn, admit_fn, retire_fn,
                        state, scfg, cfg, batch_global)


def generate(params, pf, dec, state, prompts, n_new: int):
    """prompts ``[B, S]`` → greedy tokens ``[B, n_new]`` and the state: a
    lockstep batch, one prefill of every slot and ``n_new − 1`` decode
    steps (the reference's ``generate``; the one serving loop of the
    recurrent models)."""
    nxt, state = pf(params["train"], state, prompts)
    out = [nxt]
    for _ in range(n_new - 1):
        nxt, state = dec(params["serve"], state, nxt)
        out.append(nxt)
    return torch.stack(out, dim=-1), state
