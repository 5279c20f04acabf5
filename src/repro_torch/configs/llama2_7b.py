"""Llama2-7B — the paper's primary evaluation model (MHA).

[arXiv:2307.09288; hf] 32L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama2-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=32000,
        ffn_act="silu",
        ffn_gated=True,
        source="[arXiv:2307.09288; hf]",
    )
