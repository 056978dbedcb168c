"""The hybrid-parallel topology: the port of
``paddle_tpu/distributed/topology.py``.

The JAX package's topology is one ``jax.sharding.Mesh`` over the axes
``(dp, pp, sharding, sep, mp)``, ``mp`` innermost; its groups are axis
names.  Here the same axes, in the same order, lay the job's ranks out as
``arange(world).reshape(dp, pp, sharding, sep, mp)``, and each axis is one
:class:`~paddle_tpu_torch.distributed.collective.Group` a rank: the ranks
that differ from it only along that axis (the reference Paddle's
``HybridCommunicateGroup``).  With ``mp`` innermost, an mp group is
consecutive ranks, so with one card a rank its ranks are neighbouring
cards of one host.

The port runs dp and mp; pipeline, sharding and sequence degrees above 1
raise (ROADMAP A11).  Serving replicas that span one mp group's ranks
each take a group of their own over those ranks
(:meth:`HybridCommunicateGroup.more_groups`, :meth:`~HybridCommunicateGroup
.using_group`): two replicas' collectives on one group, issued from two
threads, would meet in different orders on different ranks.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from . import collective, env

AXES = ("dp", "pp", "sharding", "sep", "mp")
_NOT_PORTED = {"pp": "pipeline", "sharding": "sharding",
               "sep": "sequence-parallel"}


class Mesh:
    """The rank layout: ``ranks`` an int array over :data:`AXES`;
    ``shape`` maps each axis to its degree, as a JAX mesh's does."""

    axis_names = AXES

    def __init__(self, ranks: np.ndarray):
        self.ranks = ranks
        self.shape = OrderedDict(zip(AXES, ranks.shape))

    def coord(self, rank: int) -> dict:
        idx = np.argwhere(self.ranks == rank)[0]
        return dict(zip(AXES, (int(i) for i in idx)))

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


_global_hcg: Optional["HybridCommunicateGroup"] = None
# held while a block builds under another group (using_group): two
# threads rebuilding two serving replicas must not swap each other's
_USING = threading.RLock()


def init_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sharding: int = 1,
              sep: int = 1, devices=None) -> Mesh:
    """Lay the world's ranks out over the five axes and create each axis's
    process groups (every rank calls this, with the same degrees).  The
    degrees' product must be the world size.  ``devices`` is accepted for
    the JAX signature: a rank's device is its own."""
    global _global_hcg
    for axis, degree in (("pp", pp), ("sharding", sharding), ("sep", sep)):
        if degree > 1:
            raise NotImplementedError(
                f"{_NOT_PORTED[axis]} parallelism ({axis}={degree}) is not "
                f"ported yet (ROADMAP A11); the port runs dp and mp")
    world = env.get_world_size()
    need = dp * mp * pp * sharding * sep
    if need != world:
        raise ValueError(f"a mesh of dp={dp} x mp={mp} needs {need} ranks; "
                         f"the world has {world}")
    if world > 1 and not env.is_initialized():
        raise RuntimeError("init_mesh needs the process group: call "
                           "distributed.init_parallel_env() first")
    mesh = Mesh(np.arange(need).reshape(dp, pp, sharding, sep, mp))
    _global_hcg = HybridCommunicateGroup(mesh)
    return mesh


def get_mesh() -> Optional[Mesh]:
    return None if _global_hcg is None else _global_hcg.mesh


def set_hybrid_communicate_group(hcg) -> None:
    global _global_hcg
    _global_hcg = hcg


def get_hybrid_communicate_group() -> Optional["HybridCommunicateGroup"]:
    return _global_hcg


def axis_rows(mesh: Mesh, axis: str) -> List[List[int]]:
    """The rank lists of every group along ``axis``, in one order."""
    a = AXES.index(axis)
    return np.moveaxis(mesh.ranks, a, -1).reshape(
        -1, mesh.ranks.shape[a]).tolist()


def _axis_groups(mesh: Mesh, axis: str, me: int, backend=None,
                 timeout=None) -> collective.Group:
    """Every group of ``axis`` (each rank creates them all, in one order:
    torch's ``new_group`` is collective), and this rank's."""
    mine = None
    for row in axis_rows(mesh, axis):
        g = (collective.new_group(row, backend=backend, timeout=timeout)
             if len(row) > 1 else collective.Group(row, None))
        if me in row:
            mine = g
    mine.name = f"{axis}_group"
    return mine


class HybridCommunicateGroup:
    """``fleet.base.topology.HybridCommunicateGroup``: this rank's
    coordinate on each axis and its group along each."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh
        self._sizes = dict(mesh.shape)
        self.global_rank = env.get_rank()
        self._coord = mesh.coord(self.global_rank)
        self._groups = {axis: _axis_groups(mesh, axis, self.global_rank)
                        for axis in AXES}

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def topology(self):
        return dict(self._sizes)

    def axis_group(self, axis: str) -> collective.Group:
        return self._groups[axis]

    def axis_rank(self, axis: str) -> int:
        return self._coord[axis]

    def more_groups(self, axis: str, count: int, backend=None,
                    timeout=None) -> List[collective.Group]:
        """``count`` more groups along ``axis``, each over the same ranks
        as this rank's own group along it (``backend``: the world's when
        None).  Collective: every rank calls it with the same arguments,
        and every rank creates every row's groups in one order."""
        return [_axis_groups(self._mesh, axis, self.global_rank, backend,
                             timeout) for _ in range(count)]

    @contextlib.contextmanager
    def using_group(self, axis: str, group: collective.Group):
        """Inside the block this rank's group along ``axis`` is ``group``:
        the layers and engines built inside take it as theirs.  One thread
        at a time builds so."""
        with _USING:
            old = self._groups[axis]
            self._groups[axis] = group
            try:
                yield group
            finally:
                self._groups[axis] = old

    def get_data_parallel_world_size(self) -> int:
        return self._sizes["dp"]

    def get_model_parallel_world_size(self) -> int:
        return self._sizes["mp"]

    def get_pipe_parallel_world_size(self) -> int:
        return self._sizes["pp"]

    def get_sharding_parallel_world_size(self) -> int:
        return self._sizes["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self._sizes["sep"]

    def get_data_parallel_rank(self) -> int:
        return self._coord["dp"]

    def get_model_parallel_rank(self) -> int:
        return self._coord["mp"]

    def get_stage_id(self) -> int:
        return self._coord["pp"]

    def get_sharding_parallel_rank(self) -> int:
        return self._coord["sharding"]

    def get_sep_parallel_rank(self) -> int:
        return self._coord["sep"]

    def get_data_parallel_group(self) -> collective.Group:
        return self._groups["dp"]

    def get_model_parallel_group(self) -> collective.Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> collective.Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> collective.Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> collective.Group:
        return self._groups["sep"]

    def __repr__(self):
        return (f"HybridCommunicateGroup({self._sizes}, rank "
                f"{self.global_rank} at {self._coord})")
