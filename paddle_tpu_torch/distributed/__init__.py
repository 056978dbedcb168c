"""``paddle_tpu_torch.distributed`` — the parts of the JAX package's
``distributed/`` that the port needs: the step watchdog the serving
fleet's supervisor arms per replica, and ``auto_tuner``'s training FLOP
count.  Collectives, meshes and the rest of ``distributed/`` are ROADMAP
A11."""

from .watchdog import StepWatchdog  # noqa: F401
