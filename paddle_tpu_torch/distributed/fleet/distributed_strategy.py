"""``fleet.DistributedStrategy``: the config object that drives the fleet
wiring, the port of ``paddle_tpu/distributed/fleet/distributed_strategy.py``
(kept as it is: a plain Python object).

The port runs ``hybrid_configs``' dp and mp degrees; ``fleet.init`` raises
for pipeline, sharding and sequence degrees above 1, and
``fleet.distributed_optimizer`` for the strategy switches whose
optimizers are not ported (ROADMAP A11, A12).
"""

from __future__ import annotations

import copy
from typing import Any, Dict


_HYBRID_DEFAULTS: Dict[str, Any] = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
}

_AMP_DEFAULTS: Dict[str, Any] = {
    "level": "O1",
    "dtype": "bfloat16",          # the JAX package's default (fp16 on the reference)
    "init_loss_scaling": 32768.0,
    "use_dynamic_loss_scaling": True,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.5,
    "custom_white_list": [],
    "custom_black_list": [],
    "use_master_weights": True,
}

_RECOMPUTE_DEFAULTS: Dict[str, Any] = {
    "checkpoints": [],
    "enable_offload": False,
    "interval": 1,
}

_SHARDING_DEFAULTS: Dict[str, Any] = {
    "stage": 1,
    "degree": 1,
    "offload": False,
    "exclude_layers": [],
}

_PIPELINE_DEFAULTS: Dict[str, Any] = {
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "schedule_mode": "1F1B",      # "1F1B" | "F-then-B" (GPipe)
    "vpp_degree": 1,
    "enable_partial_send_recv": True,  # accepted for parity
}

_GRADIENT_MERGE_DEFAULTS: Dict[str, Any] = {"k_steps": 1, "avg": True}
_LARS_DEFAULTS: Dict[str, Any] = {
    "lars_coeff": 0.001, "lars_weight_decay": 0.0005,
    "epsilon": 0.0, "exclude_from_weight_decay": []}
_LAMB_DEFAULTS: Dict[str, Any] = {
    "lamb_weight_decay": 0.01, "exclude_from_weight_decay": []}


def _merge(defaults: Dict[str, Any], configs: Dict[str, Any],
           what: str) -> Dict[str, Any]:
    out = copy.deepcopy(defaults)
    for k, v in configs.items():
        if k not in out:
            raise ValueError(
                f"unknown {what} config '{k}'; valid: {sorted(out)}")
        out[k] = v
    return out


class DistributedStrategy:
    """Mutable strategy object; pass to ``fleet.init(strategy=...)``.

    Usage mirrors the reference::

        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                                   "pp_degree": 2}
        strategy.amp = True
        strategy.amp_configs = {"level": "O2"}
        strategy.sharding = True
        strategy.sharding_configs = {"stage": 2, "degree": 2}
        fleet.init(is_collective=True, strategy=strategy)
    """

    def __init__(self):
        self._hybrid = dict(_HYBRID_DEFAULTS)
        self.amp = False
        self._amp_configs = dict(_AMP_DEFAULTS)
        self.recompute = False
        self._recompute_configs = copy.deepcopy(_RECOMPUTE_DEFAULTS)
        self.sharding = False
        self._sharding_configs = copy.deepcopy(_SHARDING_DEFAULTS)
        self.pipeline = False
        self._pipeline_configs = copy.deepcopy(_PIPELINE_DEFAULTS)
        self.gradient_merge = False
        self._gradient_merge_configs = dict(_GRADIENT_MERGE_DEFAULTS)
        self.sequence_parallel = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True       # DataParallel buckets its all-reduces
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.lamb = False
        self._lamb_configs = dict(_LAMB_DEFAULTS)
        self.lars = False
        self._lars_configs = dict(_LARS_DEFAULTS)

    # -- hybrid ------------------------------------------------------------
    @property
    def hybrid_configs(self) -> Dict[str, Any]:
        return self._hybrid

    @hybrid_configs.setter
    def hybrid_configs(self, configs: Dict[str, Any]):
        pp_cfg = configs.get("pp_configs")
        configs = {k: v for k, v in configs.items() if k != "pp_configs"}
        self._hybrid = _merge(_HYBRID_DEFAULTS, configs, "hybrid")
        if pp_cfg:
            self.pipeline_configs = (pp_cfg if isinstance(pp_cfg, dict)
                                     else vars(pp_cfg))
        if self._hybrid["pp_degree"] > 1:
            self.pipeline = True
        if self._hybrid["sharding_degree"] > 1:
            self.sharding = True
            self._sharding_configs["degree"] = self._hybrid["sharding_degree"]

    # -- sub-config dicts --------------------------------------------------
    @property
    def amp_configs(self):
        return self._amp_configs

    @amp_configs.setter
    def amp_configs(self, configs):
        self._amp_configs = _merge(_AMP_DEFAULTS, configs, "amp")

    @property
    def recompute_configs(self):
        return self._recompute_configs

    @recompute_configs.setter
    def recompute_configs(self, configs):
        self._recompute_configs = _merge(_RECOMPUTE_DEFAULTS, configs,
                                         "recompute")

    @property
    def sharding_configs(self):
        return self._sharding_configs

    @sharding_configs.setter
    def sharding_configs(self, configs):
        self._sharding_configs = _merge(_SHARDING_DEFAULTS, configs,
                                        "sharding")

    @property
    def pipeline_configs(self):
        return self._pipeline_configs

    @pipeline_configs.setter
    def pipeline_configs(self, configs):
        self._pipeline_configs = _merge(_PIPELINE_DEFAULTS, configs,
                                        "pipeline")

    @property
    def gradient_merge_configs(self):
        return self._gradient_merge_configs

    @gradient_merge_configs.setter
    def gradient_merge_configs(self, configs):
        self._gradient_merge_configs = _merge(_GRADIENT_MERGE_DEFAULTS,
                                              configs, "gradient_merge")

    @property
    def lars_configs(self):
        return self._lars_configs

    @lars_configs.setter
    def lars_configs(self, configs):
        self._lars_configs = _merge(_LARS_DEFAULTS, configs, "lars")

    @property
    def lamb_configs(self):
        return self._lamb_configs

    @lamb_configs.setter
    def lamb_configs(self, configs):
        self._lamb_configs = _merge(_LAMB_DEFAULTS, configs, "lamb")

    # -- introspection -----------------------------------------------------
    def __repr__(self):
        on = [k for k in ("amp", "recompute", "sharding", "pipeline",
                          "gradient_merge", "sequence_parallel") if getattr(self, k)]
        return (f"DistributedStrategy(hybrid={self._hybrid}, "
                f"enabled={on or ['none']})")
