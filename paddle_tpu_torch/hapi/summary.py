"""``paddle.summary`` / ``paddle.flops``: the port of
``paddle_tpu/hapi/summary.py``.  A layer table from forward hooks, and a
forward FLOPs estimate over ``Conv2D`` and ``Linear`` layers (2 a
multiply-add), counted as the JAX functions count them.  The input is
zeros of ``input_size`` in float32 on the network's device; like the JAX
functions, both leave the network in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.common import Linear
from ..nn.conv import Conv2D


def _zeros(net, size):
    p = next(net.parameters(), None)
    return torch.zeros(tuple(size), dtype=torch.float32,
                       device=p.device if p is not None else "cpu")


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):
    """Print a per-layer table of output shapes + param counts."""
    rows = []
    handles = []

    def hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        shape = list(out.shape) if isinstance(out, torch.Tensor) else None
        n_params = sum(p.numel() for p in layer.parameters(recurse=False))
        rows.append((type(layer).__name__, shape, n_params))

    for layer in net.modules():
        if layer is not net:
            handles.append(layer.register_forward_hook(hook))
    try:
        if input is not None:
            x = input if isinstance(input, (list, tuple)) else [input]
        else:
            sizes = input_size if isinstance(input_size, list) else [input_size]
            x = [_zeros(net, s) for s in sizes]
        net.eval()
        with torch.no_grad():
            net(*x)
    finally:
        for h in handles:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = 28
    lines = [f"{'Layer (type)':<{width}}{'Output Shape':<24}{'Param #':>12}",
             "-" * (width + 36)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    lines += ["-" * (width + 36),
              f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}"]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net: torch.nn.Module, input_size, custom_ops=None,
          print_detail: bool = False):
    """Estimate forward FLOPs (dynamic_flops.py analog) for conv/linear/
    norm/attention-bearing models via forward hooks."""
    total = [0]
    handles = []

    def conv_hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        k = int(np.prod(layer.weight.shape[2:]))
        cin = layer.weight.shape[1]
        total[0] += 2 * int(np.prod(out.shape)) * cin * k

    def linear_hook(layer, inputs, outputs):
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        total[0] += 2 * int(np.prod(out.shape)) * layer.in_features

    for layer in net.modules():
        if layer is net:
            continue
        if isinstance(layer, Conv2D):
            handles.append(layer.register_forward_hook(conv_hook))
        elif isinstance(layer, Linear):
            handles.append(layer.register_forward_hook(linear_hook))
    try:
        net.eval()
        with torch.no_grad():
            net(_zeros(net, input_size))
    finally:
        for h in handles:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
