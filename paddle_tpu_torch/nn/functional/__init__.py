"""Functional ops of the port's ``nn`` subset."""

from .activation import *  # noqa: F401,F403
from .attention import (  # noqa: F401
    flash_attention,
    scaled_dot_product_attention,
    sequence_mask,
)
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm, rms_norm  # noqa: F401
