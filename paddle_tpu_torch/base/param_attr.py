"""``ParamAttr``: the port of ``paddle_tpu/base/param_attr.py``."""

from __future__ import annotations

from typing import Optional


class ParamAttr:
    """How ``Layer.create_parameter`` makes a parameter: its name,
    initializer, learning-rate factor, regularizer, and whether it trains
    and takes part in gradient clipping."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` / ``False`` / a name / an initializer / a ``ParamAttr``
        as a ``ParamAttr``, or None for ``False`` (no parameter, e.g.
        ``bias_attr=False``)."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)
