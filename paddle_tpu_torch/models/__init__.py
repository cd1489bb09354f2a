"""Model families of the port (Llama serving in this slice)."""

from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel  # noqa: F401
