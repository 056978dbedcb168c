"""Shared by the model-zoo tests: the JAX initializers drawing from numpy.

The JAX package's initializers call ``jax.random``, which compiles a
sampler for every new parameter shape (seconds a net on the CPU); the
zoo tests only need the same weights in both packages, so the fixture
``numpy_init`` hands ``paddle_tpu/nn/initializer.py`` a ``jax`` whose
``random`` draws from a seeded numpy generator, for one test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.nn import initializer as jinit


class _NumpyRandom:
    """``jax.random``'s draws the JAX initializers make, from a seeded
    numpy generator: the JAX package compiles a sampler for every new
    parameter shape, seconds a net; the weights only have to be the same
    in both packages."""

    def __init__(self, seed):
        self.g = np.random.default_rng(seed)

    def normal(self, key, shape, dtype=jnp.float32):
        return jnp.asarray(self.g.standard_normal(shape), dtype)

    def uniform(self, key, shape, dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return jnp.asarray(self.g.uniform(minval, maxval, shape), dtype)

    def truncated_normal(self, key, lower, upper, shape, dtype=jnp.float32):
        return jnp.asarray(np.clip(self.g.standard_normal(shape), lower,
                                   upper), dtype)


class _Jax:
    """``jax`` as ``paddle_tpu/nn/initializer.py`` sees it in these tests."""

    def __init__(self, seed):
        self.random = _NumpyRandom(seed)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture
def numpy_init(monkeypatch):
    monkeypatch.setattr(jinit, "jax", _Jax(0))
