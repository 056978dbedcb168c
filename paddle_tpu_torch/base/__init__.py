"""``paddle.base`` of the port: ``ParamAttr``."""

from .param_attr import ParamAttr  # noqa: F401
