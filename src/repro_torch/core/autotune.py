"""Backend and prepack resolution — the port's copy of
``repro/core/autotune.py:_backend_for`` (line 256) and ``_prepack_for``
(line 266).  The autotuner's TPU cost model is not ported (ROADMAP item
18): the port has no block sizes to tune.

* ``"xla"``: the unfused dataflow, the paper's baseline — q/k/v
  products, RoPE, the append, B5 ``flash_decode``, the ``wo`` product, a
  separate FFN and the loose head (full logits, then top-k); for MLA the
  latent attention in torch and cuBLAS, with no kernel of the port's;
* ``"pallas"``: the fused kernels on the prepacked serve layout (B1 or
  B4, B2, B3; a MoE FFN stays the expert dispatch in torch and cuBLAS,
  and an RG-LRU layer the unfused recurrent block around B6, as the
  reference's do);
* ``"auto"``: ``"pallas"`` for models with attention layers, ``"xla"``
  for attention-free ones (the fusion scope the paper targets does not
  apply, DESIGN.md §4) — so the dense MHA and GQA models (Llama2-7B,
  Granite-8B, Minitron-4B), Gemma-2 27B (local and global attention),
  DeepSeek-V2-Lite (MoE or its dense-MLA arm), RecurrentGemma-9B
  (its local-attention layers through B1 and B2, as in the reference)
  and the modality models — SeamlessM4T-medium (its decoder's
  self-attention through B1's MHA mode at ``head_dim`` 64; the
  cross-attention and the FFN stay in torch and cuBLAS, as the
  reference's stay in XLA) and InternVL2-2B (B1, B2, B3 once its prefill
  has spliced the patch embeddings in) — resolve to the fused kernels.

Every model the port registers serves on both backends.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig

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
    """``(backend, prepack)`` for ``cfg``, raising on the combination the
    port cannot serve yet (never falling back to another backend):
    ``"pallas"`` with prepack off on an attention model (B1's and B4's
    ``fuse_out=False``).  Dense MHA and GQA models, gated or ungated,
    tied or not, with local (sliding-window) layers or not (Gemma-2),
    with RG-LRU layers (RecurrentGemma), with a frontend spliced into the
    prompt (InternVL2-2B) or feeding an encoder (SeamlessM4T-medium), and
    MLA models with a dense or a MoE FFN serve on both backends."""
    b = _backend_for(cfg, backend)
    pp = _prepack_for(b, prepack)
    if b == "pallas" and not pp and not cfg.is_attention_free:
        raise NotImplementedError(
            "backend='pallas' with prepack off needs B1's fuse_out=False "
            "mode on the train layout (ROADMAP.md, Queue B: B1's unported "
            "modes)")
    return b, pp
