"""Architecture registry.  The port registers the architectures whose
serving path it runs so far: Llama2-7B (the paper's primary model),
DeepSeek-V2-Lite (its MLA model; the port serves the dense-MLA arm),
RWKV-6 3B (attention-free; lockstep serving through the WKV scan) and
RecurrentGemma-9B (RG-LRU and local attention; lockstep serving on the
unfused backend)."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6,
    EncoderConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    get_config, reduced, register,
)
from repro_torch.configs import (deepseek_v2_lite, llama2_7b,  # noqa: F401
                                  recurrentgemma_9b, rwkv6_3b)
