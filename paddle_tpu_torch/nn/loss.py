"""Loss layers: the port of ``paddle_tpu/nn/loss.py``, each a module over
the port's functional (``nn/functional/loss.py``) with the JAX layer's
arguments.  ``HSigmoidLoss`` owns its ``[num_classes - 1, feature_size]``
node weights (``Uniform(-1/sqrt(F), 1/sqrt(F))``) and node biases
(zeros)."""

from __future__ import annotations

import math

from torch import nn

from . import functional as F
from .common import make_parameter
from .initializer import Constant, Uniform


def _loss(fname, params, n_inputs=2):
    """A loss layer: its constructor takes ``params`` ((name, default)
    pairs, in the JAX layer's order); ``forward`` passes its inputs and
    then those values, by keyword, to ``F.<fname>``."""
    fn = getattr(F, fname)

    class Loss(nn.Module):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            values = dict(params)
            if len(args) > len(params):
                raise TypeError(f"at most {len(params)} positional arguments")
            for (key, _), value in zip(params, args):
                values[key] = value
            unknown = set(kwargs) - set(values)
            if unknown:
                raise TypeError(f"unexpected arguments {sorted(unknown)}")
            values.update(kwargs)
            self._cfg = values
            for key, value in values.items():
                setattr(self, key, value)

        def forward(self, *inputs):
            if len(inputs) != n_inputs:
                raise TypeError(f"{type(self).__name__} takes {n_inputs} "
                                f"inputs, got {len(inputs)}")
            return fn(*inputs, **self._cfg)

    return Loss


_LOSSES = {
    "CrossEntropyLoss": _loss("cross_entropy", (
        ("weight", None), ("ignore_index", -100), ("reduction", "mean"),
        ("soft_label", False), ("axis", -1), ("use_softmax", True),
        ("label_smoothing", 0.0))),
    "MSELoss": _loss("mse_loss", (("reduction", "mean"),)),
    "L1Loss": _loss("l1_loss", (("reduction", "mean"),)),
    "NLLLoss": _loss("nll_loss", (("weight", None), ("ignore_index", -100),
                                  ("reduction", "mean"))),
    "BCELoss": _loss("binary_cross_entropy", (("weight", None),
                                              ("reduction", "mean"))),
    "BCEWithLogitsLoss": _loss("binary_cross_entropy_with_logits", (
        ("weight", None), ("reduction", "mean"), ("pos_weight", None))),
    "KLDivLoss": _loss("kl_div", (("reduction", "mean"),
                                  ("log_target", False))),
    "SmoothL1Loss": _loss("smooth_l1_loss", (("reduction", "mean"),
                                             ("delta", 1.0))),
    "HuberLoss": _loss("huber_loss", (("reduction", "mean"),
                                      ("delta", 1.0))),
    "MarginRankingLoss": _loss("margin_ranking_loss", (
        ("margin", 0.0), ("reduction", "mean")), 3),
    "CosineEmbeddingLoss": _loss("cosine_embedding_loss", (
        ("margin", 0), ("reduction", "mean")), 3),
    "TripletMarginLoss": _loss("triplet_margin_loss", (
        ("margin", 1.0), ("p", 2.0), ("epsilon", 1e-6), ("swap", False),
        ("reduction", "mean")), 3),
    "MultiLabelSoftMarginLoss": _loss("multi_label_soft_margin_loss", (
        ("weight", None), ("reduction", "mean"))),
    "SoftMarginLoss": _loss("soft_margin_loss", (("reduction", "mean"),)),
    "HingeEmbeddingLoss": _loss("hinge_embedding_loss", (
        ("margin", 1.0), ("reduction", "mean"))),
    "PoissonNLLLoss": _loss("poisson_nll_loss", (
        ("log_input", True), ("full", False), ("epsilon", 1e-8),
        ("reduction", "mean"))),
    "GaussianNLLLoss": _loss("gaussian_nll_loss", (
        ("full", False), ("epsilon", 1e-6), ("reduction", "mean")), 3),
    "MultiMarginLoss": _loss("multi_margin_loss", (
        ("p", 1), ("margin", 1.0), ("weight", None), ("reduction", "mean"))),
    "TripletMarginWithDistanceLoss": _loss(
        "triplet_margin_with_distance_loss", (
            ("distance_function", None), ("margin", 1.0), ("swap", False),
            ("reduction", "mean")), 3),
}
for _name, _cls in _LOSSES.items():
    _cls.__name__ = _cls.__qualname__ = _name
    globals()[_name] = _cls
del _name, _cls


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class RNNTLoss(nn.Module):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__()
        self._cfg = dict(blank=blank, fastemit_lambda=fastemit_lambda,
                         reduction=reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           **self._cfg)


class HSigmoidLoss(nn.Module):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        self._num_classes = num_classes
        scale = 1.0 / math.sqrt(feature_size)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = make_parameter(weight_attr, Uniform(-scale, scale),
                                     (num_classes - 1, feature_size), **kw)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = make_parameter(bias_attr, Constant(0.0),
                                       (num_classes - 1,), **kw)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


__all__ = list(_LOSSES) + ["CTCLoss", "RNNTLoss", "HSigmoidLoss"]
