from .modeling import (  # noqa: F401
    LlamaConfig,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaPretrainingCriterion,
)
