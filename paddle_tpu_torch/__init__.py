"""``paddle_tpu_torch`` — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside ``paddle_tpu`` (which stays as the JAX reference):
the same module layout and names, in PyTorch idiom, with every TPU kernel
of a ported path rewritten by hand for Hopper.  This slice serves greedy
and sampled requests through the unified ragged step:
``serving.LLM`` → ``EngineCore.step`` → ``_unified_exec`` → the Llama
forward → ``ops.ragged_paged.ragged_paged_attention`` (a CUDA kernel on the
card).  Entry points run on ``cuda`` unless given ``device="cpu"``.

Importing the package builds nothing and needs neither ``nvcc`` nor
``triton``; a kernel is built the first time it launches.  The top level
exports what the JAX package's does of the ported modules: ``io``,
``metric``, ``text``, ``Model``, ``summary``, ``flops`` and ``pdist``.
"""

from .device import resolve_device  # noqa: F401
from . import io, metric, text  # noqa: F401,E402
from .hapi.model import Model  # noqa: F401,E402
from .hapi.summary import flops, summary  # noqa: F401,E402
from .nn.functional import pdist  # noqa: F401,E402
