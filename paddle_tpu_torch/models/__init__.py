"""Models of the port."""

from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
