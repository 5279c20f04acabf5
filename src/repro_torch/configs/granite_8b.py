"""IBM Granite-8B (code): llama-architecture dense GQA.

[arXiv:2405.04324; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        ffn_act="silu",
        ffn_gated=True,
        tie_embeddings=True,
        source="[arXiv:2405.04324; hf]",
    )
