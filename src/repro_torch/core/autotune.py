"""Backend and prepack resolution — the port's copy of
``repro/core/autotune.py:_backend_for`` (line 256) and ``_prepack_for``
(line 266) — and the reference's serve-cluster rule
(:func:`tune_cluster`, ``autotune.py:85``), which
``launch/specs.py:serving_layout`` applies.  The reference's block-size
tuning is not ported (ROADMAP item 18): the port has no block sizes to
tune.

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

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dataflow as df

BACKENDS = ("xla", "pallas")

# The reference's latency model picks the serve cluster from these — its
# TPU v5e constants (reference ``autotune.py:29–33``), kept so the port
# picks the reference's layouts.  They are not this card's numbers: the
# model has yet to be re-derived for the H100 and NVLink (ROADMAP A.12).
REF_PEAK_FLOPS = 197e12
REF_HBM_BW = 819e9
REF_ICI_BW = 50e9
REF_ICI_LAT = 1e-6


@dataclass(frozen=True)
class TunePoint:
    cluster_size: int
    dataflow: str               # "split_token" | "split_head" | "mla"
    est_seconds: float
    terms: Dict[str, float]


def _attn_decode_time(cfg: ModelConfig, seq_len: int, batch: int,
                      model_axis: int, n: int, flow: str
                      ) -> Tuple[float, Dict[str, float]]:
    """The reference's per-layer decode latency estimate at cluster ``n``
    (``autotune.py:48–82``): the KV and weight bytes a device reads over
    its memory rate against the FLOPs over its peak, plus the paper's
    collective traffic over the link rate and a latency a round."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    heads_axis = model_axis // n
    q_local = max(1, cfg.n_heads // heads_axis)
    kv_local = max(1, cfg.n_kv_heads // heads_axis)
    bpe = 2
    if cfg.mla is not None and flow == "mla":
        l_rank = cfg.mla.kv_lora_rank
        kv_bytes = batch * seq_len * (l_rank + cfg.mla.rope_head_dim) * bpe
        traffic = df.traffic_mla(hd, l_rank, cfg.n_heads * hd, n,
                                 bytes_per_el=bpe, batch=batch) * q_local
        flops = (2 * batch * q_local * seq_len
                 * (l_rank + cfg.mla.rope_head_dim) * 2)
    elif flow == "split_head":
        kv_bytes = batch * seq_len * kv_local * hd * 2 * bpe
        traffic = df.traffic_split_head(seq_len, d, n, batch=batch) * q_local
        flops = 2 * batch * q_local * seq_len * hd * 2 / n
    else:
        kv_bytes = batch * seq_len * kv_local * hd * 2 * bpe / n
        traffic = df.traffic_split_token(hd, d, n, bytes_per_el=bpe,
                                         batch=batch) * q_local
        flops = 2 * batch * q_local * seq_len * hd * 2 / n
    w_bytes = (d * (q_local + 2 * kv_local) * hd
               / (1 if flow == "split_head" else n)
               + q_local * hd * d / n) * bpe
    t_mem = (kv_bytes + w_bytes) / REF_HBM_BW
    t_comp = flops / REF_PEAK_FLOPS
    t_ici = (traffic / (n * REF_ICI_BW)
             + math.log2(max(n, 2)) * REF_ICI_LAT * (0 if n == 1 else 1))
    return max(t_mem, t_comp) + t_ici, {"mem": t_mem, "comp": t_comp,
                                        "ici": t_ici,
                                        "traffic_bytes": traffic}


def tune_cluster(cfg: ModelConfig, *, seq_len: int, batch: int,
                 model_axis: int = 16,
                 flows: Optional[List[str]] = None) -> TunePoint:
    """The reference's serve-cluster pick (``autotune.py:85``): the
    ``(cluster, dataflow)`` of least :func:`_attn_decode_time` over the
    powers of two up to ``model_axis`` (ties to the smaller cluster).
    This is the reference's model with its TPU constants, so the port
    serves the layouts the reference serves; ROADMAP A.12 re-derives it
    for the H100."""
    if flows is None:
        flows = (["mla"] if cfg.mla is not None
                 else ["split_token", "split_head"])
    best: Optional[TunePoint] = None
    n = 1
    while n <= model_axis:
        heads_axis = model_axis // n
        if cfg.n_heads % heads_axis == 0 or heads_axis <= cfg.n_heads:
            for flow in flows:
                t, terms = _attn_decode_time(cfg, seq_len, batch,
                                             model_axis, n, flow)
                if best is None or t < best.est_seconds:
                    best = TunePoint(n, flow, t, terms)
        n *= 2
    assert best is not None
    return best


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
