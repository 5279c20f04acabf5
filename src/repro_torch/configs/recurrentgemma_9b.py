"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2:1.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1 => MQA,
``head_dim`` 256) d_ff=12288 (gated ``gelu_tanh``) vocab=256000, tied
embeddings.  Block pattern (recurrent, recurrent, local-attn): twelve
whole groups and a tail of two recurrent layers.  A recurrent layer's
RG-LRU recurrence runs through the B6 kernel (``kernels/rglru_scan``)
over ``rglru_d_state`` 4096 channels (16 gate blocks of 256); a local
layer attends over a 2048-position ring cache through B5
(``kernels/flash_decode``).
"""
from repro_torch.configs.base import (ATTN_LOCAL, RECURRENT, ModelConfig,
                                      register)


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
        sliding_window=2048,
        ffn_act="gelu_tanh",
        ffn_gated=True,
        rglru_d_state=4096,
        conv1d_width=4,
        tie_embeddings=True,
        source="[arXiv:2402.19427; unverified]",
    )
