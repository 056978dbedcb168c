"""``paddle_tpu_torch.distributed`` — the parts of the JAX package's
``distributed/`` that the serving fleet needs: the step watchdog its
supervisor arms per replica.  Collectives, meshes and the rest of
``distributed/`` are ROADMAP A11."""

from .watchdog import StepWatchdog  # noqa: F401
