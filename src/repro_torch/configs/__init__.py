"""Architecture registry.  The port registers the architectures whose
serving path it runs so far: Llama2-7B (the paper's primary model),
DeepSeek-V2-Lite (its MLA model, with its MoE layers, and its dense-MLA
arm),
RWKV-6 3B (attention-free; lockstep serving through the WKV scan),
and, on both backends, RecurrentGemma-9B (RG-LRU and local attention;
lockstep serving), the GQA dense models
Granite-8B (32/8 heads, tied embeddings) and Minitron-4B (24/8 heads, an
ungated squared-ReLU FFN) and Gemma-2 27B (32/16 heads, local and global
attention in turn, both softcaps, post-norms, tied embeddings), and the
two modality models: SeamlessM4T-medium (an encoder over stub audio
frames, cross-attended by every decoder layer) and InternVL2-2B (stub
patch embeddings spliced into the prompt), and Qwen2-72B (64/8 heads
with q/k/v biases at d_model 8192: on one H100 with its depth cut, whole
on the multi-GPU model axis)."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6,
    EncoderConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    get_config, reduced, register,
)
from repro_torch.configs import (deepseek_v2_lite, gemma2_27b,  # noqa: F401
                                  granite_8b, internvl2_2b, llama2_7b,
                                  minitron_4b, qwen2_72b,
                                  recurrentgemma_9b, rwkv6_3b,
                                  seamless_m4t_medium)
