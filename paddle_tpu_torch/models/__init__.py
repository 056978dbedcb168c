"""Models of the port."""

from .llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
)
