"""Model families of the port (Llama: serving and training)."""

from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
