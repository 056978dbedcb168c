"""The shared-memory ring of the multi-process DataLoader: the port of
``paddle_tpu/io/shm_ring.py`` over the repo's ``csrc/shm_ring.cpp``.

The library is built with ``g++`` at first use (``ops/_build.py``'s host
route, into the git-ignored build directory); a failed build raises
``HostBuildFailed`` with g++'s standard error.  The ``ctypes`` ABI and the
batch framing are the JAX module's, byte for byte: a count, then for each
array its dtype string, its shape and its raw bytes, little-endian.

The consumer's side differs in one step.  The JAX ``_unpack`` copies each
array out of the reusable pop buffer (``a.copy()``) and the loader then
copies it again to the device.  :func:`unpack_tensors` copies each array
once, from the pop buffer straight into a torch tensor, page-locked when
``pin`` (the host side of a ``non_blocking`` copy to the card); the bytes
are unchanged.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import _build

SHM_DIR = "/dev/shm"


def _lib():
    lib = _build.load_host("shm_ring")
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
    lib.ring_attach.restype = ctypes.c_void_p
    lib.ring_attach.argtypes = [ctypes.c_char_p]
    lib.ring_slot_size.restype = ctypes.c_uint64
    lib.ring_slot_size.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64, ctypes.c_long]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64, ctypes.c_long]
    lib.ring_size.restype = ctypes.c_int
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.argtypes = [ctypes.c_char_p]
    return lib


def ring_bytes(n_slots: int, slot_size: int) -> int:
    """The bytes of ``/dev/shm`` a ring takes (``total_size`` of
    ``csrc/shm_ring.cpp``, its header rounded up to 4 KiB)."""
    return 4096 + n_slots * (16 + slot_size)


def shm_free_bytes() -> int:
    """Free bytes of ``/dev/shm`` as an unprivileged process may use them."""
    st = os.statvfs(SHM_DIR)
    return st.f_bavail * st.f_frsize


def check_shm_room(n_slots: int, slot_size: int) -> None:
    """Raise ``OSError`` naming both sizes when ``/dev/shm`` cannot hold
    the ring.  The ring's file is sized with ``ftruncate``, which succeeds
    beyond the free space; the first push past it then dies of ``SIGBUS``,
    so the room is checked before the ring is made."""
    need = ring_bytes(n_slots, slot_size)
    free = shm_free_bytes()
    if need > free:
        raise OSError(
            f"the DataLoader's shared-memory ring needs {need} bytes "
            f"({n_slots} slots of {slot_size}) and {SHM_DIR} has {free} "
            f"free: give {SHM_DIR} more room, or pass "
            f"use_shared_memory=False for the thread pool")


def _pack(arrays: Sequence[np.ndarray]) -> bytes:
    parts = [struct.pack("<I", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode()
        parts.append(struct.pack("<I", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<I", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape) if a.ndim else b"")
        raw = a.tobytes()
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _views(buf: memoryview) -> List[np.ndarray]:
    """The framed arrays as numpy views over ``buf`` (no copy)."""
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        (dlen,) = struct.unpack_from("<I", buf, off); off += 4
        dt = bytes(buf[off:off + dlen]).decode(); off += dlen
        (ndim,) = struct.unpack_from("<I", buf, off); off += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
        off += 8 * ndim
        (rlen,) = struct.unpack_from("<Q", buf, off); off += 8
        out.append(np.frombuffer(
            buf, dtype=np.dtype(dt), count=int(np.prod(shape)) if ndim else 1,
            offset=off).reshape(shape))
        off += rlen
    return out


def _unpack(buf: memoryview) -> List[np.ndarray]:
    """The JAX ``_unpack``: numpy copies detached from ``buf``."""
    return [a.copy() for a in _views(buf)]


def unpack_tensors(buf: memoryview, pin: bool = False) -> List[torch.Tensor]:
    """The framed arrays as torch tensors, each copied once out of ``buf``
    (page-locked when ``pin``)."""
    out = []
    for a in _views(buf):
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        dst = torch.empty(a.shape, dtype=dtype, pin_memory=pin)
        np.copyto(dst.numpy(), a)
        out.append(dst)
    return out


class ShmRing:
    """One shared ring; create on the consumer, attach from workers."""

    def __init__(self, name: str, n_slots: int = 8,
                 slot_size: int = 32 * 1024 * 1024, create: bool = True):
        self._lib = _lib()
        self.name = name.encode()
        self._ring = None
        if create:
            check_shm_room(n_slots, slot_size)
            self._ring = self._lib.ring_create(self.name, n_slots, slot_size)
        else:
            self._ring = self._lib.ring_attach(self.name)
        if not self._ring:
            raise OSError(f"shm ring '{name}' unavailable")
        self._creator = create
        self._slot = self._lib.ring_slot_size(self._ring)
        self._popbuf = ctypes.create_string_buffer(int(self._slot))

    def push_bytes(self, data: bytes, timeout_ms: int = -1):
        rc = self._lib.ring_push(self._ring, data, len(data), timeout_ms)
        if rc != 0:
            raise OSError(f"ring_push failed: {rc}")

    def pop_view(self, timeout_ms: int = -1) -> Optional[memoryview]:
        """The next message as a view of the pop buffer, valid until the
        next pop; ``None`` on a timeout."""
        n = self._lib.ring_pop(self._ring, self._popbuf, self._slot, timeout_ms)
        if n == -110:  # -ETIMEDOUT
            return None
        if n < 0:
            raise OSError(f"ring_pop failed: {n}")
        return memoryview(self._popbuf).cast("B")[:n]

    def push_arrays(self, arrays: Sequence[np.ndarray], timeout_ms: int = -1):
        self.push_bytes(_pack(arrays), timeout_ms)

    def pop_arrays(self, timeout_ms: int = -1) -> Optional[List[np.ndarray]]:
        view = self.pop_view(timeout_ms)
        return None if view is None else _unpack(view)

    def close(self):
        if self._ring:
            self._lib.ring_close(self._ring)
            if self._creator:
                self._lib.ring_destroy(self.name)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
