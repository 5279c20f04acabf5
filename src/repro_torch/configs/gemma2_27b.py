"""Gemma-2 27B: local and global attention in turn, both softcaps.

[arXiv:2408.00118; hf] 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  Pattern (local, global): 23 whole groups, no tail; the
local layers attend a 4096-position sliding window (a ring cache of
``min(4096, max_seq)`` rows), attention softcap 50, final logit softcap
30, a gated ``gelu_tanh`` FFN, post-attention and post-FFN norms and
tied embeddings.  Scores scale by ``1/√head_dim`` as the reference's
dataflow scales them (ROADMAP Queue C).
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ModelConfig,
                                      register)


@register("gemma2-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        block_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        ffn_act="gelu_tanh",
        ffn_gated=True,
        use_post_norm=True,
        tie_embeddings=True,
        source="[arXiv:2408.00118; hf]",
    )
