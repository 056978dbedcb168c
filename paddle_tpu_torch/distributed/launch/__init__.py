"""``python -m paddle_tpu_torch.distributed.launch``: the collective
launcher, the port of ``paddle_tpu/distributed/launch``.

``--nproc_per_node N`` (or ``--devices 0,1,...``) starts one process a
rank running the script, each with its launcher environment; a failing
rank's exit code becomes the launcher's, and the other ranks are stopped.
The elastic part of the JAX launcher (``--max_restarts``, ``--elastic``,
the TCPStore membership) waits for ROADMAP A11 with ``store.py``,
``elastic.py`` and ``rpc.py``.
"""

from .main import launch, main  # noqa: F401
