"""Models of the port."""

from .bert import (  # noqa: F401
    BertConfig,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertModel,
)
from .ernie import (  # noqa: F401
    ErnieConfig,
    ErnieForSequenceClassification,
    ErnieModel,
)
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTForCausalLM,
    GPTModel,
    GPTPretrainingCriterion,
)
from .llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
)
