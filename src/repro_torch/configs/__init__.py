"""Architecture registry.  The port registers the architectures whose
serving path it runs so far: Llama2-7B (the paper's primary model)."""
from repro_torch.configs.base import (  # noqa: F401
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV6,
    EncoderConfig, FrontendConfig, MLAConfig, MoEConfig, ModelConfig,
    get_config, reduced, register,
)
from repro_torch.configs import llama2_7b  # noqa: F401
