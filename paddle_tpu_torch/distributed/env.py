"""The per-rank process environment: the port of
``paddle_tpu/distributed/env.py``.

The JAX package is single-controller: one process drives every local
device, and "rank" is the process index.  PyTorch runs one process per
rank, as the reference Paddle does, so :func:`init_parallel_env` starts a
``torch.distributed`` process group from the launcher's environment
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` or
``MASTER_ADDR``/``MASTER_PORT``, set by ``distributed.spawn`` and
``distributed.launch``), and :func:`get_rank` / :func:`get_world_size`
mean this process's rank and the number of processes (ROADMAP C12: the
JAX ``get_world_size`` is the dp degree while a mesh is active).

The backend is NCCL for ranks on the card and gloo on the CPU.  An
explicit ``backend="gloo"`` (or ``PADDLE_DISTRI_BACKEND=gloo``) runs gloo
on CUDA tensors, so several ranks can share one card; NCCL refuses two
ranks on one card, and so does :func:`init_parallel_env`, before NCCL is
asked, naming the gloo option.  No choice is made silently.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .. import device as _device

BACKENDS = ("nccl", "gloo")

_state = {"backend": None, "device": None, "timeout": None}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(*names, default: int) -> int:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def _master() -> Optional[str]:
    if os.environ.get("PADDLE_MASTER"):
        return os.environ["PADDLE_MASTER"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def _on_card() -> bool:
    """Ranks run on the card unless the caller chose the CPU
    (``set_device("cpu")``) or there is no card."""
    return (torch.cuda.is_available()
            and (_device._current or "").split(":")[0] != "cpu")


def check_nccl_devices(local_size: int, device_count: int) -> None:
    """NCCL takes one card a rank: more local ranks than cards raises,
    naming the gloo option."""
    if local_size > device_count:
        raise RuntimeError(
            f"NCCL needs one card a rank: {local_size} ranks on this node "
            f"would share {device_count} card(s), and NCCL refuses two "
            f"ranks on one card; pass backend='gloo' to init_parallel_env "
            f"(or set PADDLE_DISTRI_BACKEND=gloo) to run the ranks over "
            f"gloo on a shared card")


def _rank_device(local_rank: int) -> torch.device:
    if not _on_card():
        return torch.device("cpu")
    selected = os.environ.get("FLAGS_selected_gpus", "")
    index = (int(selected.split(",")[0]) if selected
             else local_rank % torch.cuda.device_count())
    return torch.device("cuda", index)


def init_parallel_env(strategy=None, backend: Optional[str] = None,
                      timeout: Optional[float] = None):
    """``paddle.distributed.init_parallel_env``: join this process to the
    process group the launcher's environment describes and return the
    world :class:`~paddle_tpu_torch.distributed.collective.Group`.

    ``backend`` (else ``PADDLE_DISTRI_BACKEND``) is ``"nccl"`` or
    ``"gloo"``; the default is NCCL for ranks on the card, gloo on the CPU.
    ``timeout`` (else ``PADDLE_DISTRI_TIMEOUT``), in seconds, bounds every
    collective of the group, so a rank that never arrives fails the others
    instead of hanging them.  A process started with no launcher is a
    world of one.  Calling it again returns the same group."""
    from .collective import world_group

    if dist.is_initialized():
        return world_group()
    rank = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)
    local_rank = _env_int("PADDLE_RANK_IN_NODE", "LOCAL_RANK", default=rank)
    local_size = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE",
                          default=world)
    master = _master()
    if master is None:
        if world > 1:
            raise RuntimeError(
                "init_parallel_env: PADDLE_TRAINERS_NUM > 1 but no master "
                "address (PADDLE_MASTER or MASTER_ADDR/MASTER_PORT); start "
                "the ranks with distributed.spawn or distributed.launch")
        master = f"127.0.0.1:{free_port()}"
    dev = _rank_device(local_rank)
    backend = (backend or os.environ.get("PADDLE_DISTRI_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo")).lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port runs "
                         f"{' or '.join(BACKENDS)}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError(
                "NCCL runs on CUDA tensors and this rank has no card; use "
                "backend='gloo' on the CPU")
        check_nccl_devices(local_size, torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if timeout is None and os.environ.get("PADDLE_DISTRI_TIMEOUT"):
        timeout = float(os.environ["PADDLE_DISTRI_TIMEOUT"])
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{master}",
                            rank=rank, world_size=world, **kw)
    _state.update(backend=backend, device=dev, timeout=timeout)
    return world_group()


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` when given (-1 outside it), else
    in the world; before :func:`init_parallel_env`, the launcher's
    ``PADDLE_TRAINER_ID`` (0 without one)."""
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def get_world_size(group=None) -> int:
    """The number of ranks: of ``group`` when given, else of the world;
    before :func:`init_parallel_env`, the launcher's
    ``PADDLE_TRAINERS_NUM`` (1 without one)."""
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def is_initialized() -> bool:
    return dist.is_initialized()


def get_backend(group=None) -> Optional[str]:
    """The backend's name (``"nccl"`` or ``"gloo"``), None before
    :func:`init_parallel_env`."""
    if not dist.is_initialized():
        return None
    pg = getattr(group, "process_group", None)
    return dist.get_backend(pg) if pg is not None else _state["backend"]


def rank_device() -> torch.device:
    """The device this rank computes on: its card, or the CPU."""
    if _state["device"] is not None:
        return _state["device"]
    return _rank_device(_env_int("PADDLE_RANK_IN_NODE", "LOCAL_RANK",
                                 default=get_rank()))


def destroy_process_group(group=None) -> None:
    """Leave the process group (the world's: every group, the hybrid
    topology's too)."""
    from . import topology

    if group is not None and group.process_group is not None:
        dist.destroy_process_group(group.process_group)
        return
    topology.set_hybrid_communicate_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(backend=None, device=None, timeout=None)

