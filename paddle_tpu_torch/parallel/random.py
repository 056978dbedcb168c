"""The model-parallel RNG tracker: the port of
``paddle_tpu/parallel/random.py``.

Dropout inside a tensor-parallel block must draw different randomness on
each mp rank (each holds a different slice of the activation), and dropout
outside it the same randomness on every rank (the activation is
replicated).  :func:`model_parallel_random_seed` seeds the global RNG with
``seed`` on every rank and adds the tracker state ``model_parallel_rng``
seeded with ``seed + 1024 + mp_rank`` (the JAX package's ``seed + 1024`` on
mp rank 0): each mp rank has its own stream, and dp ranks at the same mp
rank share it.  Inside :func:`dropout_state` (``tracker.rng_state``) every
draw of the port comes from the tracker's stream: torch's default CPU
generator, the current card's, and the port's ``paddle.seed`` streams
(``core/random.py``) are swapped for the tracker's and swapped back after,
each keeping its own position.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..core import random as rng
from .utils import axis_rank

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _capture() -> dict:
    """Every stream the port draws from: torch's default CPU generator, the
    current card's (once CUDA is up) and the port's named streams."""
    state = {"cpu": torch.random.get_rng_state(),
             "port": {name: (g._seed, {k: d.get_state()
                                       for k, d in g._gens.items()})
                      for name, g in rng._named_generators.items()}}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state()
    return state


def _restore(state: dict) -> None:
    torch.random.set_rng_state(state["cpu"])
    if "cuda" in state:
        torch.cuda.set_rng_state(state["cuda"])
    for name, (seed, gens) in state["port"].items():
        g = rng._named_generators.get(name)
        if g is None:
            continue
        g._seed = seed
        for key in list(g._gens):
            if key not in gens:
                del g._gens[key]       # made inside: made again from seed
        for key, s in gens.items():
            g.for_device(key).set_state(s)


class RNGStatesTracker:
    """Named RNG states, each entered with :meth:`rng_state`."""

    def __init__(self):
        self.states_: Dict[str, dict] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        outer = _capture()
        rng.seed(seed)
        self.states_[name] = _capture()
        _restore(outer)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} not added via add()")
        outer = _capture()
        _restore(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = _capture()
            _restore(outer)


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 2048):
    """The global RNG seeded with ``seed`` on every rank; the tracker's
    ``model_parallel_rng`` with ``seed + 1024 + mp_rank``."""
    _tracker.reset()
    rng.seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + axis_rank("mp"))


@contextlib.contextmanager
def dropout_state(name: str = MODEL_PARALLEL_RNG):
    with _tracker.rng_state(name):
        yield
