"""The port's model zoo against the JAX package's, constructor by
constructor where ``tests/test_torch_vision_zoo.py`` runs no forward: the
parameters in the JAX order (``convert.paddle_parameter_order``) with the
JAX shapes (linear weights transposed), and the buffers' names.  VGG-13,
16, 19 without their classifier (VGG-11's is here, with it), DenseNet-
161/169/201/264, ShuffleNetV2 in the widths and the activation no forward
takes.
"""

import pytest

from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert
from paddle_tpu_torch.vision import models
from torch_zoo_pairs import numpy_init  # noqa: F401


STRUCTURE = [
    ("vgg13", {"num_classes": 0}), ("vgg16", {"num_classes": 0}),
    ("vgg19", {"num_classes": 0}),
    ("vgg16", {"num_classes": 0, "batch_norm": True}),
    ("densenet161", {}), ("densenet169", {}), ("densenet201", {}),
    ("densenet264", {}), ("shufflenet_v2_x0_33", {}),
    ("shufflenet_v2_x0_5", {}), ("shufflenet_v2_x1_0", {}),
    ("shufflenet_v2_x1_5", {}), ("shufflenet_v2_x2_0", {}),
    ("shufflenet_v2_swish", {}), ("vgg11", {"num_classes": 10}),
]


@pytest.mark.parametrize("ctor,kwargs", STRUCTURE,
                         ids=[f"{c}-{'-'.join(map(str, k.values()))}"
                              for c, k in STRUCTURE])
def test_parameters_in_the_jax_order(ctor, kwargs, numpy_init):
    jm = getattr(jmodels, ctor)(**kwargs)
    tm = getattr(models, ctor)(device="cpu", **kwargs)
    want = [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
    linear = convert.linear_weights(tm)
    params = dict(tm.named_parameters())
    got = [(n, tuple(params[n].shape)[::-1] if n in linear
            else tuple(params[n].shape))
           for n in convert.paddle_parameter_order(tm)]
    assert got == want
    assert ({n for n, _ in jm.named_buffers()}
            == {n for n, _ in tm.named_buffers()})
