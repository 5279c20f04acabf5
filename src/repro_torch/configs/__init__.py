"""Architecture registry.  The port registers the architectures whose
serving path it runs so far: Llama2-7B (the paper's primary model),
DeepSeek-V2-Lite (its MLA model; the port serves the dense-MLA arm),
RWKV-6 3B (attention-free; lockstep serving through the WKV scan),
RecurrentGemma-9B (RG-LRU and local attention; lockstep serving on the
unfused backend), and the GQA dense models Granite-8B (32/8 heads, tied
embeddings) and Minitron-4B (24/8 heads, an ungated squared-ReLU FFN),
on both backends."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6,
    EncoderConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    get_config, reduced, register,
)
from repro_torch.configs import (deepseek_v2_lite, granite_8b,  # noqa: F401
                                  llama2_7b, minitron_4b, recurrentgemma_9b,
                                  rwkv6_3b)
