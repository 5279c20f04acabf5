"""Architecture registry.  The port registers the architectures whose
serving path it runs so far: Llama2-7B (the paper's primary model),
DeepSeek-V2-Lite (its MLA model; the port serves the dense-MLA arm) and
RWKV-6 3B (attention-free; lockstep serving through the WKV scan)."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6,
    EncoderConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    get_config, reduced, register,
)
from repro_torch.configs import (deepseek_v2_lite, llama2_7b,  # noqa: F401
                                  rwkv6_3b)
