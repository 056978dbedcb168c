"""The port's model zoo (``paddle_tpu_torch/vision/models/vgg.py``,
``mobilenetv2.py``, ``small_nets.py``) held to the JAX package's on the
CPU, on the JAX models' weights (``convert.load_paddle_tpu_state``) and
the same seeded numpy images; the parameter lists of the variants run
here by no forward are in ``tests/test_torch_vision_zoo_order.py``.

One forward per family in eval mode (BatchNorm on its running
statistics, drawn at random; dropout off), at the smallest scale and
image each family takes (as ``tests/test_extras.py:762-800`` and
``tests/test_models.py:226-262`` size them): VGG-11-BN (its features and
pool: the classifier's 103M-parameter layer only in the order test),
MobileNetV1/V2/V3-Large/V3-Small at scale 0.25 and ShuffleNetV2 x0.25 at
32x32, SqueezeNet 1.0/1.1 at 64x64, with B=2 where the net is light,
and the gradient of the outputs' sum with respect to every parameter;
AlexNet (64x64), DenseNet-121 (32x32), GoogLeNet (64x64, its three
heads) and InceptionV3 (96x96) forward only, B=1.  Outputs within 1e-4 of
the largest JAX output, each gradient within 1e-3 of its largest entry
plus 1e-6 of the net's largest gradient (XLA's convolutions and torch's
sum in other orders).  The JAX side runs as one XLA program a net (its
state swapped in as ``jit.save`` does), its initializers drawing from
numpy (``tests/torch_zoo_pairs.py``); a module fixture builds every pair
and runs the JAX programs once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert
from paddle_tpu_torch.vision import models
from torch_zoo_pairs import _Jax


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(ctor, kwargs):
    """The JAX net and the port's on its weights.  What the JAX package
    starts at a constant (BatchNorm's statistics and shift, biases) is
    drawn at random first: at zero mean and shift, the zero padding of a
    depthwise convolution reaches ReLU6 at exactly 0, where the gradient
    is a convention, not arithmetic."""
    jm = getattr(jmodels, ctor)(**kwargs)
    rng = np.random.default_rng(1)
    state = {}
    for k, v in _state(jm).items():
        if k.endswith("_variance"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif np.all(v == v.flat[0]):
            v = rng.standard_normal(v.shape) * 0.1
        state[k] = v.astype(np.float32)
    jm.set_state_dict(state)
    tm = getattr(models, ctor)(device="cpu", **kwargs)
    convert.load_paddle_tpu_state(tm, state)
    jm.eval()
    tm.eval()
    return jm, tm


def _jax_program(jm, grads):
    """The JAX model's eval forward as one XLA program of ``(parameter
    values, buffer values, x)`` (the state swapped in as ``jit.save``
    does), with ``grads`` the gradient of the outputs' sum by parameter
    in the same program: ``x -> (outputs, gradients or None)``.  One
    compile a net instead of one an op."""
    state = jm.state_dict()
    pnames = [n for n, _ in jm.named_parameters()]
    bnames = [n for n in state if n not in pnames]

    def forward(pvals, bvals, x):
        saved = [(state[n], state[n]._value) for n in pnames + bnames]
        for n, v in zip(pnames + bnames, list(pvals) + list(bvals)):
            state[n]._value = v
        try:
            out = jm(Tensor(x))
        finally:
            for t, v in saved:
                t._value = v
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o._value for o in outs]

    def total(pvals, bvals, x):
        outs = forward(pvals, bvals, x)
        return sum(jnp.sum(o) for o in outs), outs

    args = ([state[n]._value for n in pnames],
            [state[n]._value for n in bnames])
    if not grads:
        return lambda x: (jax.jit(forward)(*args, x), None)

    def both(x):
        (_, outs), g = jax.jit(jax.value_and_grad(total, has_aux=True))(
            *args, x)
        return outs, dict(zip(pnames, g))

    return both


FORWARD = [
    # constructor, kwargs, image size, batch, gradients too
    ("vgg11", {"batch_norm": True, "num_classes": 0}, 32, 1, True),
    ("mobilenet_v2", {"scale": 0.25, "num_classes": 10}, 32, 2, True),
    ("mobilenet_v1", {"scale": 0.25, "num_classes": 10}, 32, 2, True),
    ("mobilenet_v3_large", {"scale": 0.25, "num_classes": 10}, 32, 2, True),
    ("mobilenet_v3_small", {"scale": 0.25, "num_classes": 10}, 32, 2, True),
    ("alexnet", {"num_classes": 10}, 64, 1, False),
    ("squeezenet1_0", {"num_classes": 10}, 64, 1, True),
    ("squeezenet1_1", {"num_classes": 10}, 64, 1, True),
    ("densenet121", {"num_classes": 10}, 32, 1, False),
    ("googlenet", {"num_classes": 10}, 64, 1, False),
    ("inception_v3", {"num_classes": 10}, 96, 1, False),
    ("shufflenet_v2_x0_25", {"num_classes": 10}, 32, 2, True),
]


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _image(size, batch):
    return np.random.default_rng(2).standard_normal(
        (batch, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    """Every net of FORWARD: the port's model and the JAX program's
    outputs and gradients on its image, each pair built with the JAX
    initializers drawing from a fresh numpy generator
    (``torch_zoo_pairs.numpy_init``'s seed)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for ctor, kwargs, size, batch, grads in FORWARD:
            mp.setattr(jinit, "jax", _Jax(0))
            jm, tm = _pair(ctor, kwargs)
            jouts, jgrads = _jax_program(jm, grads)(
                jnp.asarray(_image(size, batch)))
            out[ctor] = (tm, [np.asarray(o) for o in jouts],
                         jgrads and {n: np.asarray(g)
                                     for n, g in jgrads.items()})
    return out


@pytest.mark.parametrize("ctor,kwargs,size,batch,grads", FORWARD,
                         ids=[f[0] for f in FORWARD])
def test_eval_forward_and_gradients_match_jax(ctor, kwargs, size, batch,
                                              grads, pairs):
    tm, jouts, jgrads = pairs[ctor]
    x = _image(size, batch)
    touts = _outputs(tm(torch.from_numpy(x)))
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert tuple(t.shape) == j.shape and j.shape[0] == batch
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max())
    if not grads:
        return
    sum(o.sum() for o in touts).backward()
    floor = 1e-6 * max(np.abs(g).max() for g in jgrads.values())
    linear = convert.linear_weights(tm)
    tparams = dict(tm.named_parameters())
    assert set(tparams) == set(jgrads)
    for name, jg in jgrads.items():
        tg = tparams[name].grad.numpy()
        if name in linear:
            tg = tg.T
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=1e-3 * np.abs(jg).max() + floor,
                                   err_msg=name)


def test_relu6_gradient_at_its_corners_is_the_jax_one():
    from paddle_tpu_torch.nn import functional as F

    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    F.relu6(t).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax.nn.relu6(v)))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(), [0, 0, 1, 0, 0])
