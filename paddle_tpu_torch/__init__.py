"""``paddle_tpu_torch`` — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (which stays as the JAX reference):
the same module layout and names, in PyTorch idiom, with every TPU kernel
of a ported path rewritten by hand for Hopper.  A Paddle user script
starts as it does on the JAX package::

    import paddle_tpu_torch as paddle

    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    y = paddle.matmul(x, x, transpose_y=True)

The top level mirrors ``paddle_tpu/__init__.py`` for what is ported: the
dtypes, flags, the RNG, the autograd controls, ``Tensor`` (``torch.Tensor``)
and ``Parameter``, ``to_tensor``, the ``paddle.tensor`` ops, ``amp``,
``nn`` (``Layer``), ``optimizer``, ``jit``, ``io``, ``vision``, ``serving``
and the rest.  Tensors and entry points run on ``cuda`` unless the caller
asks for the CPU (``set_device("cpu")``, ``place="cpu"``,
``device="cpu"``).

Importing the package builds nothing and needs neither ``nvcc`` nor
``triton``; a kernel is built the first time it launches.
"""

from __future__ import annotations

__version__ = "0.1.0"

from .core.dtype import (  # noqa: F401
    bfloat16,
    bool_ as bool,  # noqa: A001
    complex64,
    complex128,
    finfo,
    float16,
    float32,
    float64,
    float8_e4m3fn,
    float8_e5m2,
    get_default_dtype,
    iinfo,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import (  # noqa: F401
    Generator,
    get_rng_state,
    seed,
    set_rng_state,
)
from .core.autograd import (  # noqa: F401
    enable_grad,
    grad,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .device import get_device, resolve_device, set_device  # noqa: F401

from . import tensor  # noqa: F401,E402  (also adds Tensor's Paddle methods)
from .tensor import *  # noqa: F401,F403,E402
from .tensor import (  # noqa: F401,A004,E402
    abs,
    all,
    any,
    is_complex,
    is_floating_point,
    is_integer,
    is_tensor,
    max,
    min,
    numel,
    pow,
    rank,
    round,
    shape,
    sum,
)

from . import amp, io, jit, metric, nn, optimizer, text, vision  # noqa: F401,E402,E501
from . import base, regularizer, serving, static  # noqa: F401,E402
from . import distributed, parallel  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402
from .framework import CPUPlace, CUDAPlace, load, save  # noqa: F401,E402
from .hapi.model import Model  # noqa: F401,E402
from .hapi.summary import flops, summary  # noqa: F401,E402
from .jit import to_static  # noqa: F401,E402
from .nn.functional import pdist  # noqa: F401,E402
from .base.param_attr import ParamAttr  # noqa: F401,E402
from .nn.layers import Layer  # noqa: F401,E402


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False
