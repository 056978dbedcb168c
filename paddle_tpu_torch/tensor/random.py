"""Random ops: the port of ``paddle_tpu/tensor/random.py``, over the port's
RNG (``core/random.py``: one torch generator a device, reseeded by
``paddle_tpu_torch.seed``).  The draws are torch's, not the JAX package's:
a seeded run repeats within the port, and the distributions, shapes and
dtypes are the JAX ones.  A ``seed`` argument other than 0 draws from a
generator of its own, as the JAX ops draw from a key of their own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import random as rng
from ..core.dispatch import run_op
from ..device import place_device
from .creation import _shape


def _d(dtype):
    d = dtype_mod.convert_dtype(dtype)
    return d if d is not None else dtype_mod.get_default_dtype()


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return rng.generator_for(device)


def rand(shape, dtype=None, name=None):
    dev = place_device()
    return torch.rand(_shape(shape), dtype=_d(dtype), device=dev,
                      generator=_gen(dev))


def randn(shape, dtype=None, name=None):
    dev = place_device()
    return torch.randn(_shape(shape), dtype=_d(dtype), device=dev,
                       generator=_gen(dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def standard_gamma(alpha, name=None):
    a = alpha if isinstance(alpha, torch.Tensor) else torch.as_tensor(
        alpha, dtype=dtype_mod.get_default_dtype(), device=place_device())
    # float64, as jax.random.gamma's default dtype under the JAX
    # package's x64
    return torch._standard_gamma(a.to(torch.float64),
                                 generator=_gen(a.device))


def standard_exponential(shape, dtype=None, name=None):
    dev = place_device()
    return torch.empty(_shape(shape), dtype=_d(dtype), device=dev) \
        .exponential_(1.0, generator=_gen(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = place_device()
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    return torch.empty(_shape(shape), dtype=_d(dtype), device=dev) \
        .uniform_(lo, hi, generator=_gen(dev, seed))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device, seed))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dev = place_device() if not isinstance(mean, torch.Tensor) \
        else mean.device
    if shape is None:
        shape = torch.broadcast_shapes(
            tuple(getattr(mean, "shape", ())), tuple(getattr(std, "shape",
                                                             ())))
    z = torch.randn(_shape(shape), dtype=dtype_mod.get_default_dtype(),
                    device=dev, generator=_gen(dev))
    return mean + std * z


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = place_device()
    return mean + std * torch.randn(_shape(shape), dtype=_d(dtype),
                                    device=dev, generator=_gen(dev, seed))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = place_device()
    return torch.randint(low, high, _shape(shape), device=dev,
                         dtype=dtype_mod.convert_dtype(dtype),
                         generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype) or x.dtype
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape), dtype=d, device=x.device,
                         generator=_gen(x.device))


def randperm(n, dtype="int64", name=None):
    dev = place_device()
    return torch.randperm(n, dtype=dtype_mod.convert_dtype(dtype),
                          device=dev, generator=_gen(dev))


def bernoulli(x, name=None):
    return run_op("bernoulli", lambda v: torch.bernoulli(
        v, generator=_gen(v.device)), x)


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return x.bernoulli_(p, generator=_gen(x.device))


def poisson(x, name=None):
    return run_op("poisson", lambda v: torch.poisson(
        v, generator=_gen(v.device)), x)


def binomial(count, prob, name=None):
    c = count if isinstance(count, torch.Tensor) else torch.as_tensor(
        count, device=place_device())
    p = prob if isinstance(prob, torch.Tensor) else torch.as_tensor(
        prob, device=c.device)
    cf = c.to(torch.float32)
    return torch.binomial(cf, p.to(torch.float32).expand_as(cf),
                          generator=_gen(c.device)).to(torch.int64)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return run_op("multinomial", lambda v: torch.multinomial(
        v, num_samples, replacement, generator=_gen(v.device)), x)


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))


def rand_like(x, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype) or x.dtype
    return torch.rand(tuple(x.shape), dtype=d, device=x.device,
                      generator=_gen(x.device))


def randn_like(x, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype) or x.dtype
    return torch.randn(tuple(x.shape), dtype=d, device=x.device,
                       generator=_gen(x.device))


def shuffle(x, axis=0, name=None):
    perm = torch.randperm(x.shape[axis], device=x.device,
                          generator=_gen(x.device))
    return torch.index_select(x, axis, perm)


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        return x.cauchy_(loc, scale, generator=_gen(x.device))


def geometric_(x, probs, name=None):
    """``floor(log1p(-u) / log1p(-p)) + 1`` with ``u`` uniform (the JAX
    formula), in place."""
    u = torch.rand(tuple(x.shape), device=x.device, generator=_gen(x.device))
    with torch.no_grad():
        return x.copy_(torch.floor(torch.log1p(-u) / np.log1p(-probs)) + 1)
