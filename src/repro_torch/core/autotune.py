"""Backend and prepack resolution — the port's copy of
``repro/core/autotune.py:_backend_for`` (line 256) and ``_prepack_for``
(line 266).  The autotuner's TPU cost model is not ported (ROADMAP item
18): the port has no block sizes to tune.

* ``"xla"``: the unfused dataflow, the paper's baseline — q/k/v
  products, RoPE, the append, B5 ``flash_decode``, the ``wo`` product, a
  separate FFN and the loose head (full logits, then top-k);
* ``"pallas"``: the fused kernels on the prepacked serve layout (B1 or
  B4, B2, B3);
* ``"auto"``: ``"pallas"`` for models with attention layers, ``"xla"``
  for attention-free ones (the fusion scope the paper targets does not
  apply, DESIGN.md §4) — so the dense MHA and GQA models (Llama2-7B,
  Granite-8B, Minitron-4B) and the dense-MLA arm resolve to the fused
  kernels, and RecurrentGemma, which has local-attention layers,
  resolves to ``"pallas"`` as in the reference and raises: its fused arm
  is not ported (ROADMAP item 10).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, ModelConfig

BACKENDS = ("xla", "pallas")


def _backend_for(cfg: ModelConfig, backend: str) -> str:
    """Resolve ``"auto"``; an unknown name raises."""
    if backend == "auto":
        return "xla" if cfg.is_attention_free else "pallas"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be auto/xla/pallas, got {backend!r}")
    return backend


def _prepack_for(backend_resolved: str, prepack) -> bool:
    """``"auto"`` (or None) turns the serve layout on exactly for
    ``"pallas"``; ``"on"``/``"off"`` (and their synonyms, or a bool) are
    taken as they are; an unknown string raises."""
    if prepack in ("auto", None):
        return backend_resolved == "pallas"
    if isinstance(prepack, str):
        if prepack in ("on", "true", "1"):
            return True
        if prepack in ("off", "false", "0"):
            return False
        raise ValueError(f"prepack must be auto/on/off, got {prepack!r}")
    return bool(prepack)


def resolve_serving(cfg: ModelConfig, backend: str, prepack
                    ) -> Tuple[str, bool]:
    """``(backend, prepack)`` for ``cfg``, raising on the combinations the
    port cannot serve yet (never falling back to another backend): the
    fused arm of RG-LRU and local-attention models (Gemma-2's modes and
    fused RecurrentGemma, ROADMAP item 10), ``"pallas"`` with prepack off
    on an attention model (B1's ``fuse_out=False``), and MLA on
    ``"xla"`` (item 4b).  Dense MHA and GQA models, gated or ungated, tied
    or not, serve on both backends."""
    b = _backend_for(cfg, backend)
    pp = _prepack_for(b, prepack)
    if b == "pallas" and {RECURRENT, ATTN_LOCAL} & set(cfg.layer_kinds):
        raise NotImplementedError(
            f"backend='pallas' for {cfg.name}: the fused arm of RG-LRU and "
            "local-attention models needs B1's head_dim 256, window, "
            "ring-cache and softcap modes, B2's post_ln1, B3's logit "
            "softcap and the serve layout of tail layers (ROADMAP item "
            "10, the Gemma-2 slice); serve it on backend='xla'")
    if b == "pallas" and not pp and not cfg.is_attention_free:
        raise NotImplementedError(
            "backend='pallas' with prepack off needs B1's fuse_out=False "
            "mode on the train layout (ROADMAP.md, Queue B: B1's unported "
            "modes)")
    if b == "xla" and cfg.mla is not None:
        raise NotImplementedError(
            "the XLA-backend MLA path (latent flash attention around no "
            "Pallas kernel) is ROADMAP item 4b")
    return b, pp
