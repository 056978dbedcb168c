"""``paddle.vision`` of the port: the image-classification models
(``datasets`` and ``transforms`` wait for ROADMAP A13's rest)."""

from . import models  # noqa: F401
