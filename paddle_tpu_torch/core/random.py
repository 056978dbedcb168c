"""The global RNG: the port of ``paddle_tpu/core/random.py``.

A :class:`Generator` is a Paddle-style stream over explicit torch
generators, one per device, each made at first use from the stream's
seed.  The port's random ops (``tensor/random.py``) draw from
``default_generator.for_device(device)``.  ``seed(s)`` reseeds every
registered stream and torch's own default generators (which the
functionals use when no generator is passed), as ``paddle.seed`` seeds
everything.  The draws differ from the JAX package's (a JAX key split
against torch's Philox / MT19937); seeded runs repeat within the port.
"""

from __future__ import annotations

from typing import Dict

import torch


class Generator:
    """A seeded stream with one ``torch.Generator`` per device."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[str, torch.Generator] = {}

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self._seed)
        return self

    def seed(self):
        return self._seed

    initial_seed = seed

    def for_device(self, device) -> torch.Generator:
        key = str(torch.device(device))
        g = self._gens.get(key)
        if g is None:
            g = torch.Generator(device=key).manual_seed(self._seed)
            self._gens[key] = g
        return g

    def get_state(self):
        """``{device: state tensor}`` of the devices drawn from so far."""
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_state(self, state):
        for k, s in state.items():
            self.for_device(k).set_state(s)


default_generator = Generator(0)
_named_generators = {"default": default_generator}


def seed(s: int):
    """``paddle.seed``: reseed every registered stream and torch's default
    generators."""
    for g in _named_generators.values():
        g.manual_seed(s)
    torch.manual_seed(s)
    return default_generator


def register_generator(name: str, gen: Generator):
    _named_generators[name] = gen


def get_rng_state():
    return {k: g.get_state() for k, g in _named_generators.items()}


def set_rng_state(state):
    for k, v in state.items():
        if k in _named_generators:
            _named_generators[k].set_state(v)


def generator_for(device) -> torch.Generator:
    """The default stream's generator on ``device``."""
    return default_generator.for_device(device)
