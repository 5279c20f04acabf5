"""InternVL2-2B: InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The vision frontend is a stub: the caller gives
precomputed patch embeddings ``[B, 256, 1024]``, whose projection
through ``frontend_proj`` replaces the first 256 token embeddings of the
prompt (``models/transformer.py:splice_frontend``).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register


@register("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        ffn_act="silu",
        ffn_gated=True,
        frontend=FrontendConfig(kind="vision", num_positions=256,
                                feature_dim=1024),
        source="[arXiv:2404.16821; hf]",
    )
