"""RWKV-6 (Finch) 3B: attention-free, data-dependent decay.

[arXiv:2404.05892; hf] 32L d_model=2560 d_ff=8960 vocab=65536, 40 heads
of 64 (``d_model // rwkv_head_dim``).  Every layer is an RWKV-6 block:
a time mix whose WKV recurrence runs through the B7 kernel
(``kernels/rwkv6_scan``) and a squared-ReLU channel mix.  Its per-slot
decode state is the recurrence's ``[H, 64, 64]`` f32 matrix per layer
plus two shift rows, not a KV cache.
"""
from repro_torch.configs.base import RWKV6, ModelConfig, register


@register("rwkv6-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,            # 2560 / rwkv_head_dim(64)
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        block_pattern=(RWKV6,),
        rwkv_head_dim=64,
        ffn_act="relu2",
        ffn_gated=False,
        source="[arXiv:2404.05892; hf]",
    )
