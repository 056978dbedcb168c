"""``paddle.jit`` of the port: ``to_static`` (see ``api.py``),
``not_to_static``, ``in_to_static_trace``, ``enable_to_static`` and
``ignore_module``.  ``save`` / ``load`` of a compiled program wait for
ROADMAP A13's rest and raise naming it."""

from __future__ import annotations

from .api import (  # noqa: F401
    StaticFunction,
    enable_to_static,
    host_scalars,
    in_to_static_trace,
    not_to_static,
    to_static,
)

_ignored_modules: set = set()


def ignore_module(modules) -> None:
    """Functions defined in these modules are never captured: a direct call
    runs eagerly, and a call from inside a to_static function is a graph
    break of that function."""
    if not isinstance(modules, (list, tuple, set)):
        modules = [modules]
    for m in modules:
        _ignored_modules.add(m.__name__ if hasattr(m, "__name__") else str(m))


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(
        "jit.save waits for ROADMAP A13's rest (jit/partial.py and "
        "jit.save/load); save the state with framework.save")


def load(path, **configs):
    raise NotImplementedError(
        "jit.load waits for ROADMAP A13's rest (jit/partial.py and "
        "jit.save/load); load the state with framework.load")
