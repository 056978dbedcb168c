"""``paddle.regularizer``: the port of ``paddle_tpu/regularizer.py``, the
L1 / L2 decay objects an optimizer's ``weight_decay`` takes."""

from __future__ import annotations


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """The lasso penalty ``coeff * |w|``."""


class L2Decay(WeightDecayRegularizer):
    """The ridge penalty ``coeff * ||w||^2``: the form an optimizer applies
    as its (coupled) ``weight_decay``."""
