"""``paddle.utils`` analog: custom-op extension mechanisms (the JAX
package's ``paddle_tpu/utils``).

The reference exposes runtime-compiled user ops via
``paddle.utils.cpp_extension`` (``python/paddle/utils/cpp_extension/``,
``PD_BUILD_OP`` in ``fluid/framework/custom_operator.cc``).  The two
registration paths are:

- :mod:`paddle_tpu_torch.utils.extension` — register a kernel over torch
  tensors (a torch composition or a hand-written CUDA kernel) as a
  framework op (autograd, custom VJP, profiler name); this is the path for
  on-card custom kernels.
- :mod:`paddle_tpu_torch.utils.cpp_extension` — runtime-compile C++
  sources with g++ and bind exported kernels as host ops (the CPU
  custom-op capability).

Importing this package builds nothing.
"""

from . import cpp_extension, extension  # noqa: F401
from .extension import get_custom_op, register_custom_op  # noqa: F401
from .host_build import host_build  # noqa: F401


def try_import(name):
    import importlib

    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def deprecated(update_to="", since="", reason="", level=0):
    """(``utils/deprecated.py``) decorator emitting a DeprecationWarning on
    the first call of each decorated function."""
    import functools
    import warnings

    def wrap(fn):
        warned = []

        @functools.wraps(fn)
        def inner(*a, **k):
            if not warned:
                warned.append(True)
                msg = f"API '{fn.__name__}' is deprecated since {since or '?'}"
                if update_to:
                    msg += f"; use {update_to} instead"
                if reason:
                    msg += f" ({reason})"
                warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*a, **k)

        return inner

    return wrap


def run_check(device=None):
    """(``utils/install_check.py`` run_check) verify the install: a tiny
    product and its backward on ``resolve_device(device)`` (the card unless
    the caller asks for the CPU), then report."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    x = torch.ones((4, 4), device=dev)
    w = torch.ones((4, 2), device=dev, requires_grad=True)
    (x @ w).sum().backward()
    if w.grad is None or not bool((w.grad == 4.0).all()):
        raise RuntimeError(f"run_check: wrong gradient on {dev}")
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"paddle_tpu_torch is installed successfully! "
          f"device={dev}, devices={count}")


def require_version(min_version: str, max_version=None):
    """(``utils/__init__.py`` require_version) assert the framework
    version lies in [min_version, max_version]."""
    from ..version import full_version

    def parse(v):
        return tuple(int(p) for p in str(v).split("+")[0].split(".")[:3])

    cur = parse(full_version)
    if parse(min_version) > cur:
        raise Exception(
            f"installed version {full_version} < required {min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"installed version {full_version} > allowed {max_version}")
    return True
