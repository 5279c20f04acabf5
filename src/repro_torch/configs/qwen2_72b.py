"""Qwen2-72B: dense GQA with q/k/v biases.

[arXiv:2407.10671; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  About 145 GB of bf16 weights: one H100 serves it at full
width with its depth cut (``chip_smoke.py``: 32 of the 80 layers), and
the whole model needs the multi-GPU model axis (``launch/mesh.py``).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        ffn_act="silu",
        ffn_gated=True,
        source="[arXiv:2407.10671; hf]",
    )
