"""Shared by the port's slowest JAX-parity test modules: a persistent
compilation cache for the JAX side, one directory a module.

Each JAX engine jits its step functions as bound methods of its own, and
the eager JAX ops jit per model, so one module compiles the same XLA
programs again for every engine, model and test, and the modules
compile the same programs (one tiny Llama, one engine shape) again.  With
a cache directory (``jax.experimental.compilation_cache``; every compile
cached, however short) a repeated program is loaded instead of compiled;
what runs is the same program.  Importing ``jax_compile_cache`` into a
test module turns the cache on for that module, in one directory for the
session, and restores the process's setting after it.
"""

import os

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache as cc

_SETTINGS = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")


def _cache_dir(tmp_path_factory):
    """One directory for the whole session: under pytest-xdist the
    workers' temporary roots share a parent, so a program one worker
    compiled is loaded by the others (the cache's writes are atomic)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "jax_compile_cache"
    path.mkdir(exist_ok=True)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    saved = {name: getattr(jax.config, name) for name in _SETTINGS}
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    cc.set_cache_dir(_cache_dir(tmp_path_factory))
    cc.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    cc.reset_cache()
