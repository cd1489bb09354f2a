from .modeling import (  # noqa: F401
    GPTConfig,
    GPTDecoderLayer,
    GPTForCausalLM,
    GPTModel,
)
