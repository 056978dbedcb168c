"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` into its own shared library, which is loaded with
``ctypes``.  No PyTorch header is compiled, so a build takes seconds.

The library lands in ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``), or in the directory :func:`set_build_dir` names (a worker
process's ``--compile-cache``), keyed by a hash of the source, every
``csrc/*.cuh`` header and the flags: the first use after a change to any
of them builds it, later uses load it.  A build holds an exclusive
``fcntl`` lock on the directory, so processes sharing one directory run
``nvcc`` once per source; the lock is released by a process's death.  Nothing is built when this
module is imported; a kernel wrapper calls :func:`load` the first time it
launches.  When ``nvcc`` fails, :class:`KernelBuildFailed` carries its
standard error.  The repo's host C++ sources (``csrc/<name>.cpp`` at the
checkout's root, such as the data loader's shared-memory ring) take the
same route with ``g++``: :func:`load_host` builds one into the same
directory under the same lock, keyed by its source and flags, and a failed
build raises :class:`HostBuildFailed` carrying g++'s standard error.  :func:`load_library` loads a kernel's library from a
given file instead (an AOT artifact's ``kernels/``), with no ``nvcc``;
:func:`source_hash` is the key both ways.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

HOST_CSRC_DIR = PACKAGE_DIR.parent / "csrc"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpthread", "-lrt")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # ptxas report (registers, shared memory,
                                  # spills) of each kernel built here


class KernelBuildFailed(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class HostBuildFailed(RuntimeError):
    """``g++`` is missing or refused a host source."""


def set_build_dir(path) -> Path:
    """Build and load this process's kernels in ``path`` from now on (made
    if missing).  Call it before the first kernel loads."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def count_libraries(path: Optional[str]) -> int:
    """The built kernel libraries (``.so`` files) in ``path``; 0 for a
    missing directory or ``None``."""
    if not path or not os.path.isdir(path):
        return 0
    return sum(1 for f in os.listdir(path) if f.endswith(".so"))


@contextlib.contextmanager
def _directory_lock(directory: Path):
    """An exclusive lock on ``directory`` shared with every process that
    builds there.  ``flock`` dies with its holder, so a process killed
    mid-build leaves no stale lock behind."""
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildFailed(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels are built on a machine "
        "with the CUDA toolkit")


def source_hash(name: str) -> str:
    """The hash a library of ``csrc/<name>.cu`` is keyed by: the source,
    every header in ``csrc/`` (name and bytes) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries
    its :func:`source_hash`, so an edit to the source, a header or the
    flags rebuilds it."""
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), tmp, out


def build(names: Iterable[str]) -> None:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Raises :class:`KernelBuildFailed` with
    nvcc's standard error for the first source that fails."""
    with _lock:
        names = [n for n in names if not library_path(n).exists()]
        if not names:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with _directory_lock(BUILD_DIR):
            _build_locked(names)


def _build_locked(names) -> None:
    # under the directory lock: a sibling may have built some meanwhile,
    # and _start skips those
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, out = job
        stdout, stderr = proc.communicate()
        build_logs[name] = stdout + stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    if errors:
        raise KernelBuildFailed("\n".join(errors))


def load_library(name: str, path) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu`` from the file ``path``, with
    no ``nvcc``, and make it the one :func:`load` returns from now on.
    The caller checks that the file was built from this tree's sources
    (:func:`source_hash`).  Where to build other kernels does not change.
    Raises ``OSError`` when the file does not load; nothing is rebuilt."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def host_library_path(name: str) -> Path:
    """Where the library of the host source ``csrc/<name>.cpp`` is built:
    keyed by a hash of the source and the g++ flags."""
    h = hashlib.sha256((HOST_CSRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with ``g++`` first if needed.  Raises :class:`HostBuildFailed` with
    g++'s standard error when the build fails."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        out = host_library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with _directory_lock(BUILD_DIR):
                if not out.exists():
                    _build_host(name, out)
        lib = _libs[key] = ctypes.CDLL(str(out))
        return lib


def _build_host(name: str, out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise HostBuildFailed(f"g++ not found on PATH: csrc/{name}.cpp is "
                              f"built on first use")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, str(HOST_CSRC_DIR / f"{name}.cpp"), "-o",
         str(tmp), *GXX_LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostBuildFailed(f"g++ failed on csrc/{name}.cpp "
                              f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
