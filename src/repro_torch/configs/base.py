"""Model configuration: the port's own copy of ``repro/configs/base.py``.

Field for field the same dataclasses, so a test can hold the two
against each other.  The port keeps a copy instead of importing
``repro.configs``: importing anything under ``repro`` pulls in JAX.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

# Block kinds
ATTN_GLOBAL = "attn_global"        # full causal attention
ATTN_LOCAL = "attn_local"          # sliding-window causal attention
RECURRENT = "recurrent"            # RG-LRU (Griffin) block
RWKV6 = "rwkv6"                    # RWKV-6 time-mix block
BLOCK_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    dense_ff_residual: bool = False
    dense_residual_d_ff: int = 0
    router_softcap: float = 0.0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class FrontendConfig:
    kind: str
    num_positions: int
    feature_dim: int


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    sliding_window: int = 4096
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 10000.0
    rglru_d_state: int = 0
    conv1d_width: int = 4
    rwkv_head_dim: int = 64
    ffn_act: str = "silu"
    ffn_gated: bool = True
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    frontend: Optional[FrontendConfig] = None
    encoder: Optional[EncoderConfig] = None
    tie_embeddings: bool = False
    use_post_norm: bool = False
    norm_eps: float = 1e-6
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        reps = math.ceil(self.n_layers / len(pat))
        return tuple((pat * reps)[: self.n_layers])

    @property
    def is_attention_free(self) -> bool:
        return all(k in (RECURRENT, RWKV6) for k in self.layer_kinds)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def reduced(cfg: ModelConfig, *, d_model: int = 128, n_layers: int = 0,
            vocab: int = 512) -> ModelConfig:
    """Shrink a config to test size, keeping its structure (the same
    rule as ``repro.configs.base.reduced``)."""
    pat = cfg.block_pattern
    nl = n_layers or max(len(pat), 2)
    n_heads = 4
    n_kv = max(1, n_heads // max(1, cfg.q_per_kv))
    head_dim = max(8, d_model // n_heads)
    kw = dict(
        name=cfg.name + "-smoke", family=cfg.family, n_layers=nl,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=d_model * 3, vocab_size=vocab,
        block_pattern=pat, sliding_window=min(cfg.sliding_window, 64),
        qkv_bias=cfg.qkv_bias, logit_softcap=cfg.logit_softcap,
        attn_softcap=cfg.attn_softcap, ffn_act=cfg.ffn_act,
        ffn_gated=cfg.ffn_gated, tie_embeddings=cfg.tie_embeddings,
        rglru_d_state=0, conv1d_width=cfg.conv1d_width, rwkv_head_dim=16,
        source=cfg.source,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8, top_k=min(2, cfg.moe.top_k),
            expert_d_ff=d_model * 2,
            dense_ff_residual=cfg.moe.dense_ff_residual,
            dense_residual_d_ff=d_model if cfg.moe.dense_ff_residual else 0,
            capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                              nope_head_dim=16, v_head_dim=16)
    if cfg.frontend is not None:
        kw["frontend"] = FrontendConfig(cfg.frontend.kind, 16, 64)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_heads=4, n_kv_heads=4,
                                      d_ff=d_model * 3)
    return ModelConfig(**kw)
