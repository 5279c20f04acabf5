"""DeepSeek-V2-Lite — the paper's MLA evaluation model.

[arXiv:2405.04434; hf] 27L d_model=2048 16H MLA (kv_lora_rank=512,
rope_head_dim=64, nope=128, v=128), MoE 64 experts top-6, expert d_ff=1408,
vocab=102400.

Registered field for field as the reference registers it, and served
so: every layer is MLA attention and a 64-expert top-6 MoE FFN
(``models/moe.py``), on both backends.  Its dense-MLA arm,
``dataclasses.replace(cfg, moe=None)`` (every FFN the dense gated-SiLU
one of width ``d_ff``), is served too: it exercises B2 beside B4.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      register)


@register("deepseek-v2-lite")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,          # MLA: all heads share one latent KV
        head_dim=128,
        d_ff=10944,
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                      capacity_factor=1.25),
        ffn_act="silu",
        ffn_gated=True,
        source="[arXiv:2405.04434; hf]",
    )
