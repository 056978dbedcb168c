"""The port's ``nn``: the layers, containers and initializers the Llama,
GPT, BERT and ERNIE models use."""

from . import initializer  # noqa: F401
from .common import Dropout, Embedding, Flatten, Identity, Linear  # noqa: F401
from .container import (  # noqa: F401
    LayerDict,
    LayerList,
    ParameterList,
    Sequential,
)
from .norm import LayerNorm, RMSNorm  # noqa: F401
