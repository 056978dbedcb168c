"""Weights and optimizer state between ``paddle_tpu`` and the port.

``*_from_paddle_tpu(state, config)`` takes the JAX package's model
``state_dict()`` (numpy arrays, ``{name: np.asarray(tensor)}``, or the
tensors ``framework.load`` reads from a JAX checkpoint) and builds the
port's model with the same weights; :func:`to_paddle_tpu` is the inverse
for every family, the port's model as the JAX ``state_dict()``'s numpy
arrays.  Names map one to one, the persistent buffers too (BatchNorm's
``_mean`` and ``_variance``); linear weights are ``[in, out]`` there and
``[out, in]`` here, so they are transposed, and conv weights are OIHW in
both.  A missing, extra or misshaped key raises.

At mp > 1 (a hybrid topology with an mp group of more than one rank) a
model's tensor-parallel parameters are its rank's slices:
:func:`shard_paddle_tpu_state` cuts each rank's slice out of the JAX
package's full arrays (numpy, in the JAX layout), and
``llama_from_paddle_tpu`` / ``gpt_from_paddle_tpu`` load it, so the ranks
together hold the JAX model's weights and compute what it computes.

The optimizer's state crosses through :func:`optimizer_state_from_paddle_tpu`
and :func:`optimizer_state_to_paddle_tpu`.  Both optimizers key a slot
``"p{i}/{slot}"`` by the parameter's position in the list they were built
on — ``model.parameters()`` in each package, which differ: the JAX
``Layer`` walks its sub-layers breadth first (:func:`paddle_parameter_order`),
torch depth first.  The mapping goes through the parameter names and
transposes the moments and master weights of linear weights, as the
weights are.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models.bert import (
    BertConfig,
    BertForQuestionAnswering,
    BertForSequenceClassification,
    BertModel,
)
from .models.ernie import ErnieConfig, ErnieForSequenceClassification, ErnieModel
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .nn.common import Linear
from .nn.layers import walk_named
from .parallel.mp_layers import ColumnParallelLinear, RowParallelLinear
from .parallel.utils import is_sharded, local_shard
from .vision import models as vision_models

_LINEAR = (ColumnParallelLinear, RowParallelLinear, Linear)


def _as_tensor(v) -> torch.Tensor:
    """A CPU tensor of ``v``: a tensor, or a numpy array (an
    ``ml_dtypes.bfloat16`` one read through its 16-bit words)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def linear_weights(model) -> set:
    """Names of the model's parameters stored transposed here."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, _LINEAR)}


def paddle_parameter_order(model) -> List[str]:
    """The model's parameter names in the order the JAX package's
    ``Layer.parameters()`` gives them: each layer's own parameters, the
    layers taken breadth first (``Layer._walk``), each parameter once.  The
    port registers parameters and sub-layers in the JAX order, so the walk
    over the torch module gives the JAX model's list."""
    return [n for n, _ in walk_named(model, "_parameters")]


def _state_tensors(model) -> Dict[str, torch.Tensor]:
    """The model's parameters, then its persistent buffers, by name: the
    JAX ``state_dict()``'s keys."""
    out = dict(model.named_parameters())
    persistent = model.state_dict(keep_vars=True)
    for name, b in model.named_buffers():
        if name in persistent:
            out[name] = b
    return out


def state_from_paddle_tpu(jax_layer) -> Dict[str, np.ndarray]:
    """A JAX package ``Layer``'s ``state_dict()`` as numpy arrays under its
    keys and in its layout, bf16 as its 16-bit words (uint16): what the
    port's ``nn.Layer.set_state_dict`` loads.  Only the caller imports the
    JAX package; this reads the layer through ``state_dict()`` and
    ``numpy.asarray``."""
    out = {}
    for k, v in jax_layer.state_dict().items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        out[k] = np.array(a)
    return out


def _check_keys(model, params, state) -> None:
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state dict does not match the port's "
                       f"{type(model).__name__}: missing {missing}, "
                       f"unexpected {extra}")


def load_paddle_tpu_state(model, state) -> None:
    """Copy the JAX ``state_dict`` ``state`` into ``model`` in place."""
    linear = linear_weights(model)
    params = _state_tensors(model)
    _check_keys(model, params, state)
    with torch.no_grad():
        for name, p in params.items():
            t = _as_tensor(state[name])
            if name in linear:
                t = t.T
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {tuple(_as_tensor(state[name]).shape)} "
                    f"does not map onto the port's {tuple(p.shape)}")
            p.copy_(t)


def to_paddle_tpu(model) -> Dict[str, np.ndarray]:
    """The port's model as the JAX package's ``state_dict()`` of numpy
    arrays (linear weights transposed back; bf16 as float32, which holds
    every bf16 value exactly — numpy has no bf16, and the JAX
    ``set_state_dict`` casts to the parameter's dtype)."""
    linear = linear_weights(model)
    out = {}
    for name, p in _state_tensors(model).items():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if name in linear:
            t = t.T
        out[name] = np.ascontiguousarray(t.numpy())
    return out


def shard_paddle_tpu_state(state, model, mp_rank=None,
                           mp_degree=None) -> Dict[str, np.ndarray]:
    """The JAX ``state_dict`` ``state`` cut to ``model``'s parameters: the
    slice of each tensor-parallel one that rank ``mp_rank`` of ``mp_degree``
    holds, as numpy arrays in the JAX layout (the others whole).  The rank
    and degree default to the model's own (its mp group's), and must match
    them when given."""
    linear = linear_weights(model)
    params = _state_tensors(model)
    _check_keys(model, params, state)
    out = {}
    for name, p in params.items():
        a = state[name]
        if isinstance(a, torch.Tensor):
            a = _as_tensor(a).float().numpy() if a.dtype == torch.bfloat16 \
                else _as_tensor(a).numpy()
        a = np.asarray(a)
        if is_sharded(p):
            g = p.mp_group
            rank = g.rank if mp_rank is None else mp_rank
            degree = g.nranks if mp_degree is None else mp_degree
            if (rank, degree) != (g.rank, g.nranks):
                raise ValueError(
                    f"{name}: asked for rank {rank} of mp {degree}; the "
                    f"model is rank {g.rank} of mp {g.nranks}")
            dim = p.split_axis
            if name in linear:
                dim = 1 - dim       # the JAX layout is [in, out]
            a = local_shard(a, dim, rank, degree, p.split_blocks)
        out[name] = np.ascontiguousarray(a)
    return out


def llama_from_paddle_tpu(state, config: LlamaConfig, device=None,
                          dtype=None, mp_rank=None,
                          mp_degree=None) -> LlamaForCausalLM:
    """The port's Llama with the JAX model's weights: at mp > 1, rank
    ``mp_rank``'s slices of them (:func:`shard_paddle_tpu_state`)."""
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    load_paddle_tpu_state(model, shard_paddle_tpu_state(
        state, model, mp_rank, mp_degree))
    return model


def gpt_from_paddle_tpu(state, config: GPTConfig, device=None,
                        dtype=None, mp_rank=None,
                        mp_degree=None) -> GPTForCausalLM:
    """The port's GPT with the JAX model's weights: at mp > 1, rank
    ``mp_rank``'s slices of them (:func:`shard_paddle_tpu_state`)."""
    model = GPTForCausalLM(config, device=device, dtype=dtype)
    load_paddle_tpu_state(model, shard_paddle_tpu_state(
        state, model, mp_rank, mp_degree))
    return model


def _num_classes(state):
    return int(_as_tensor(state["classifier.weight"]).shape[1])


def bert_from_paddle_tpu(state, config: BertConfig, device=None, dtype=None,
                         dropout_generator=None):
    """The port's BERT of the JAX state's kind: ``BertForQuestionAnswering``
    when it has ``qa_outputs``, ``BertForSequenceClassification`` (its
    class count from the classifier) when it has ``classifier``, else
    ``BertModel``."""
    kw = dict(device=device, dtype=dtype,
              dropout_generator=dropout_generator)
    if "qa_outputs.weight" in state:
        model = BertForQuestionAnswering(config, **kw)
    elif "classifier.weight" in state:
        model = BertForSequenceClassification(
            config, _num_classes(state), **kw)
    else:
        model = BertModel(config, **kw)
    load_paddle_tpu_state(model, state)
    return model


def ernie_from_paddle_tpu(state, config: ErnieConfig, device=None,
                          dtype=None, dropout_generator=None):
    """``ErnieForSequenceClassification`` when the JAX state has a
    ``classifier``, else ``ErnieModel``."""
    kw = dict(device=device, dtype=dtype,
              dropout_generator=dropout_generator)
    model = (ErnieForSequenceClassification(config, _num_classes(state), **kw)
             if "classifier.weight" in state else ErnieModel(config, **kw))
    load_paddle_tpu_state(model, state)
    return model


def lenet_from_paddle_tpu(state, device=None, dtype=None, generator=None):
    """The port's ``LeNet`` with the JAX model's weights; ``num_classes``
    from its last ``Linear`` (0 without a head)."""
    classes = (int(_as_tensor(state["fc.2.weight"]).shape[1])
               if "fc.2.weight" in state else 0)
    model = vision_models.LeNet(num_classes=classes, device=device,
                                dtype=dtype, generator=generator)
    load_paddle_tpu_state(model, state)
    return model


def resnet_from_paddle_tpu(state, arch="resnet50", device=None, dtype=None,
                           generator=None, **kwargs):
    """The port's ``vision.models.<arch>`` (``"resnet18"``, ...,
    ``"wide_resnet101_2"``) with the JAX model's weights and BatchNorm
    buffers; ``num_classes`` from its ``fc`` (0 without one) unless given."""
    if "num_classes" not in kwargs:
        kwargs["num_classes"] = (int(_as_tensor(state["fc.weight"]).shape[1])
                                 if "fc.weight" in state else 0)
    model = getattr(vision_models, arch)(device=device, dtype=dtype,
                                         generator=generator, **kwargs)
    load_paddle_tpu_state(model, state)
    return model


def vit_from_paddle_tpu(state, num_heads, device=None, dtype=None,
                        generator=None, **kwargs):
    """The port's ``VisionTransformer`` with the JAX model's weights.  The
    widths (embed dim, depth, patch, input channels, image size, MLP ratio,
    classes) are read from the weights; ``num_heads`` is not in them."""
    proj = _as_tensor(state["patch_embed.proj.weight"])
    embed, chans, patch = proj.shape[0], proj.shape[1], proj.shape[2]
    n = _as_tensor(state["pos_embed"]).shape[1] - 1
    depth = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    hidden = _as_tensor(state["blocks.0.mlp.0.weight"]).shape[1]
    cfg = dict(img_size=patch * int(round(n ** 0.5)), patch_size=patch,
               in_chans=chans, embed_dim=embed, depth=depth,
               num_heads=num_heads, mlp_ratio=hidden / embed,
               class_num=(int(_as_tensor(state["head.weight"]).shape[1])
                          if "head.weight" in state else 0))
    cfg.update(kwargs)
    model = vision_models.VisionTransformer(device=device, dtype=dtype,
                                            generator=generator, **cfg)
    load_paddle_tpu_state(model, state)
    return model


def _remap(state, model, src: List[str], dst: List[str]):
    """``state``'s ``"p{i}/{slot}"`` keys re-indexed from the parameter order
    ``src`` to ``dst``, slots of linear weights transposed; ``"step"`` and
    ``"LR_Scheduler"`` unchanged."""
    linear = linear_weights(model)
    index = {name: i for i, name in enumerate(dst)}
    out = {}
    for k, v in state.items():
        if k in ("step", "LR_Scheduler"):
            out[k] = v
            continue
        pname, slot = k.split("/", 1)
        name = src[int(pname[1:])]
        t = _as_tensor(v)
        if name in linear and t.dim() == 2:
            t = t.T.contiguous()
        out[f"p{index[name]}/{slot}"] = t
    return out


def optimizer_state_from_paddle_tpu(state, model) -> dict:
    """The JAX optimizer's ``state_dict()`` (built on the JAX model's
    ``parameters()``) as the port's optimizer takes it (built on
    ``model.parameters()``); slots are CPU tensors (``set_state_dict``
    moves each onto its parameter's device)."""
    return _remap(state, model, paddle_parameter_order(model),
                  [n for n, _ in model.named_parameters()])


def optimizer_state_to_paddle_tpu(state, model) -> dict:
    """The port optimizer's ``state_dict()`` (built on
    ``model.parameters()``) in the JAX package's indices and layouts, CPU
    tensors in the slots' dtypes (``framework.save`` writes them in the
    JAX file format)."""
    return _remap(state, model, [n for n, _ in model.named_parameters()],
                  paddle_parameter_order(model))
