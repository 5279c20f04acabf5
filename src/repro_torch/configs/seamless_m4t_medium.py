"""SeamlessM4T-medium: encoder-decoder, multimodal (audio frontend stub).

[arXiv:2308.11596; hf] 12L decoder, d_model=1024 16H (kv=16) of
``head_dim`` 64, d_ff=4096 (ungated ``relu``), vocab=256206.  The speech
frontend is a stub: the caller gives precomputed frame embeddings
``[B, 1024, 1024]``, which ``frontend_proj`` takes into a 12-layer
bidirectional encoder; every decoder layer cross-attends its output
(``models/transformer.py:encode``, ``cross_attention``).
"""
from repro_torch.configs.base import (EncoderConfig, FrontendConfig,
                                      ModelConfig, register)


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        ffn_act="relu",
        ffn_gated=False,
        encoder=EncoderConfig(n_layers=12, n_heads=16, n_kv_heads=16,
                              d_ff=4096),
        frontend=FrontendConfig(kind="audio", num_positions=1024,
                                feature_dim=1024),
        source="[arXiv:2308.11596; hf]",
    )
