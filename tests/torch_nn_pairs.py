"""Shared checks of the port's ``nn`` functionals against the JAX
package's: the same numpy arrays through both, outputs within 1e-5 and the
gradients of ``sum(out * probe)`` within 1e-5 of their largest entries."""

import numpy as np
import torch

import paddle_tpu as paddle


def randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def as_numpy(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def assert_near(got, want, tol=1e-5):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def hold(jfn, pfn, arrays, grads=True):
    """``jfn`` / ``pfn`` on the same arrays: outputs within 1e-5; with
    ``grads``, the float inputs' gradients of ``sum(out * probe)`` too."""
    jin = [paddle.to_tensor(a, stop_gradient=not (
        grads and a.dtype == np.float32)) for a in arrays]
    pin = [torch.from_numpy(a) for a in arrays]
    if grads:
        for t in pin:
            if t.is_floating_point():
                t.requires_grad_()
    jout, pout = jfn(*jin), pfn(*pin)
    assert tuple(pout.shape) == tuple(jout.shape)
    assert_near(as_numpy(pout), as_numpy(jout))
    if not grads:
        return
    probe = randn(tuple(jout.shape), 99)
    (jout * paddle.to_tensor(probe)).sum().backward()
    (pout * torch.from_numpy(probe)).sum().backward()
    for j, p in zip(jin, pin):
        if p.requires_grad:
            if j.grad is None or p.grad is None:   # no path to the input
                for g in (j.grad, p.grad):
                    assert g is None or not as_numpy(g).any()
            else:
                assert_near(p.grad.numpy(), as_numpy(j.grad))
