"""``paddle.distributed.fleet.utils``: ``recompute``.  The
sequence-parallel helpers of the JAX module are ROADMAP A11."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant, as the port's
    models checkpoint their layers); ``preserve_rng_state`` (default True)
    replays the same random draws."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)
