"""Shared checks of the port's training tests against the JAX package.

Adam divides each step by the root of the second moment, so a weight whose
gradient is zero but for rounding — a key bias (a softmax over keys does
not see a shift common to a query's scores), a span head's bias or the
last norm's bias before it (a softmax over positions) — moves by ``lr``
times a ratio of rounding noises, whichever package computes it.
:func:`assert_params_close` holds such a weight (its first gradient below
1e-5 of the largest one, in the JAX run) within the largest move the steps
can make, and every other weight within 1% of it.
"""

import numpy as np


def gradient_scales(jax_model):
    """Each parameter's largest absolute gradient, from the JAX model's
    ``.grad`` after a backward."""
    return {n: float(np.abs(np.asarray(p.grad.numpy())).max())
            for n, p in jax_model.named_parameters() if p.grad is not None}


def assert_params_close(got, jax_model, scales, most, rtol=1e-5):
    """``got`` (``convert.to_paddle_tpu`` of the port's model) against the
    JAX model's parameters; ``most`` is the sum of the steps' learning
    rates, ``scales`` the first step's :func:`gradient_scales`."""
    top = max(scales.values())
    for name, p in jax_model.named_parameters():
        noise = scales.get(name, 0.0) < 1e-5 * top
        np.testing.assert_allclose(got[name], np.asarray(p.numpy()),
                                   rtol=rtol,
                                   atol=most if noise else 0.01 * most,
                                   err_msg=name)
