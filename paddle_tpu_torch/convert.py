"""Weights from ``paddle_tpu`` into the port.

:func:`llama_from_paddle_tpu` takes the JAX package's Llama
``state_dict()`` as numpy arrays (``{name: np.asarray(tensor)}``) and
builds the port's :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`
with the same weights, so both packages compute with one set of numbers.
Names map one to one; linear weights are ``[in, out]`` there and
``[out, in]`` here, so they are transposed.  A missing, extra or misshaped
key raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.llama import LlamaConfig, LlamaForCausalLM
from .parallel.mp_layers import ColumnParallelLinear, RowParallelLinear


def llama_from_paddle_tpu(state: Dict[str, np.ndarray], config: LlamaConfig,
                          device=None, dtype=None) -> LlamaForCausalLM:
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, (ColumnParallelLinear, RowParallelLinear))}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state dict does not match the port's Llama: "
                       f"missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(state[name])
            if name in linear:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {tuple(np.asarray(state[name]).shape)} "
                    f"does not map onto the port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))  # a writable copy
    return model
