"""``paddle.distributed.fleet``: the port of
``paddle_tpu/distributed/fleet/__init__.py`` at dp x mp.

``fleet.init(is_collective=True, strategy=s)`` joins the process group
(``init_parallel_env``) and lays the ranks out over
``s.hybrid_configs``' degrees (``topology.init_mesh``; a dp degree left
at 1 takes the ranks the other degrees leave, as the reference's does);
``distributed_model`` wraps a model in :class:`DataParallel` over the dp
group when dp > 1 (the mp layers issue their own collectives);
``distributed_optimizer`` returns the optimizer (``ClipGradByGlobalNorm``
already sums sharded parameters' norms over their mp group).

Pipeline parallelism (``PipelineParallelModel``, pp > 1), sharding and
sequence parallelism raise, naming ROADMAP A11; the LARS, LAMB and
gradient-merge switches raise naming A12, whose optimizers they need.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional

from .. import collective, env, topology
from ..parallel import DataParallel
from .distributed_strategy import DistributedStrategy

__all__ = [
    "DistributedStrategy", "init", "distributed_model",
    "distributed_optimizer", "get_hybrid_communicate_group",
    "worker_index", "worker_num", "is_first_worker", "barrier_worker",
    "PipelineParallelModel",
]

_state = {"initialized": False, "strategy": None}


def init(role_maker: Any = None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, **kwargs):
    """Join the process group and build the hybrid topology from
    ``strategy.hybrid_configs``; returns the strategy."""
    if kwargs.get("auto"):
        raise NotImplementedError(
            "fleet.init(auto=True) plans with the auto-tuner over a device "
            "mesh; the port takes the degrees from the strategy (ROADMAP "
            "A11)")
    strategy = strategy or DistributedStrategy()
    env.init_parallel_env()
    h = dict(strategy.hybrid_configs)
    world = env.get_world_size()
    rest = (h["mp_degree"] * h["pp_degree"] * h["sharding_degree"]
            * h["sep_degree"])
    if h["dp_degree"] == 1 and rest and world % rest == 0:
        h["dp_degree"] = world // rest
    topology.init_mesh(dp=h["dp_degree"], mp=h["mp_degree"],
                       pp=h["pp_degree"], sharding=h["sharding_degree"],
                       sep=h["sep_degree"])
    _state["initialized"] = True
    _state["strategy"] = strategy
    return strategy


def _require_init():
    if not _state["initialized"]:
        raise RuntimeError("call fleet.init(...) first")


def get_hybrid_communicate_group():
    return topology.get_hybrid_communicate_group()


def worker_index() -> int:
    return env.get_rank()


def worker_num() -> int:
    return env.get_world_size()


def is_first_worker() -> bool:
    return env.get_rank() == 0


def barrier_worker() -> None:
    collective.barrier()


class PipelineParallelModel:
    """``fleet.distributed_model``'s wrapper at pp > 1: not ported."""

    def __init__(self, layers, strategy=None):
        raise NotImplementedError(
            "pipeline parallelism (PipelineParallelModel, pp_degree > 1) "
            "is not ported yet (ROADMAP A11); the port runs dp x mp")


def distributed_model(model):
    """The model as the active strategy runs it: ``DataParallel`` over the
    dp group when dp > 1, else the model itself."""
    _require_init()
    strategy: DistributedStrategy = _state["strategy"]
    if strategy.hybrid_configs["pp_degree"] > 1:
        return PipelineParallelModel(model, strategy)
    if strategy.sharding:
        raise NotImplementedError("sharding stages are not ported yet "
                                  "(ROADMAP A11)")
    if strategy.sequence_parallel:
        raise NotImplementedError("sequence parallelism is not ported yet "
                                  "(ROADMAP A11)")
    hcg = topology.get_hybrid_communicate_group()
    if hcg.get_data_parallel_world_size() > 1:
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer as the strategy runs it: unchanged at dp x mp."""
    _require_init()
    strategy = strategy or _state["strategy"]
    for switch in ("lars", "lamb", "gradient_merge"):
        if getattr(strategy, switch):
            raise NotImplementedError(
                f"strategy.{switch} needs an optimizer the port does not "
                f"have yet (ROADMAP A12)")
    if strategy.sharding:
        raise NotImplementedError("sharding stages are not ported yet "
                                  "(ROADMAP A11)")
    return optimizer


def __getattr__(name):
    # fleet.meta_parallel and fleet.utils import the parallel layers, which
    # import this package: load them on first use
    if name in ("meta_parallel", "utils"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
