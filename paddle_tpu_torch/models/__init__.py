"""Model families of the port: Llama and GPT (serving and training), BERT
(fine-tuning) and the diffusion UNet (training)."""

from .bert import (BertConfig, BertForMaskedLM,  # noqa: F401
                   BertForSequenceClassification)
from .gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
from .unet import UNet2DConditionModel, UNetConfig  # noqa: F401
