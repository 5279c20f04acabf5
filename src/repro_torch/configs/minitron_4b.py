"""Minitron-4B: pruned Nemotron (squared-ReLU FFN, no gating).

[arXiv:2407.14679; hf] 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register


@register("minitron-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        ffn_act="relu2",
        ffn_gated=False,
        source="[arXiv:2407.14679; hf]",
    )
