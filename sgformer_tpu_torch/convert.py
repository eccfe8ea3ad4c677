"""Copy a JAX SGFormer's variables into the port's modules.

``load_flax_variables(model, variables)`` takes the flax variable tree
``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy arrays, or
anything ``numpy.asarray`` reads) and fills the torch module in place. The
port's submodules carry the flax names (``trans_conv.conv_0.Wq``,
``graph_conv.bn_1``, ...), so the mapping is by path:

- ``TorchLinear``: ``kernel`` [in, out] -> ``weight`` [out, in] (transposed),
  ``bias`` -> ``bias``;
- ``LayerNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- ``MaskedBatchNorm``: ``scale``/``bias`` from params, ``mean``/``var`` from
  batch_stats -> ``running_mean``/``running_var``.

A key the module lacks, or a module tensor the tree lacks, raises KeyError;
a shape that differs raises ValueError.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from sgformer_tpu_torch.nn.layers import LayerNorm, TorchLinear
from sgformer_tpu_torch.nn.norm import MaskedBatchNorm


def _flatten(tree, prefix=()) -> dict:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _plan(model: nn.Module):
    """(flax path, torch tensor, transpose) for every tensor of the model."""
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, TorchLinear):
            yield ("params",) + path + ("kernel",), mod.weight, True
            if mod.bias is not None:
                yield ("params",) + path + ("bias",), mod.bias, False
        elif isinstance(mod, LayerNorm):
            yield ("params",) + path + ("scale",), mod.weight, False
            yield ("params",) + path + ("bias",), mod.bias, False
        elif isinstance(mod, MaskedBatchNorm):
            yield ("params",) + path + ("scale",), mod.weight, False
            yield ("params",) + path + ("bias",), mod.bias, False
            yield ("batch_stats",) + path + ("mean",), mod.running_mean, False
            yield ("batch_stats",) + path + ("var",), mod.running_var, False


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` from the flax tree ``variables``; returns ``model``."""
    flat = _flatten(variables)
    filled = set()
    with torch.no_grad():
        for path, tensor, transpose in _plan(model):
            if path not in flat:
                raise KeyError(f"flax variables lack {'/'.join(path)}")
            value = np.array(flat.pop(path), dtype=np.float32)
            if transpose:
                value = value.T
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"{'/'.join(path)}: shape {value.shape} does not fit "
                    f"{tuple(tensor.shape)}"
                )
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            filled.add(id(tensor))
    if flat:
        raise KeyError(f"unknown flax variables: {sorted('/'.join(p) for p in flat)}")
    missing = [n for n, t in list(model.named_parameters()) + list(model.named_buffers())
               if id(t) not in filled]
    if missing:
        raise KeyError(f"module tensors with no flax counterpart: {missing}")
    return model
