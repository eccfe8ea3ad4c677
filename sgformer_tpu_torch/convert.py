"""Copy a JAX model's variables into the port's modules.

``load_flax_variables(model, variables)`` takes the flax variable tree
``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy arrays, or
anything ``numpy.asarray`` reads) and fills the torch module in place. The
port's submodules carry the flax names (``trans_conv.conv_0.Wq``,
``graph_conv.bn_1``, ...), so the mapping is by path:

- ``TorchLinear``: ``kernel`` [in, out] -> ``weight`` [out, in] (transposed),
  ``bias`` -> ``bias``;
- ``LayerNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- ``MaskedBatchNorm``: ``scale``/``bias`` from params, ``mean``/``var`` from
  batch_stats -> ``running_mean``/``running_var``;
- parameters that flax declares with ``self.param`` rather than through a
  submodule, listed by the module in ``FLAX_PARAMS`` and kept in the flax
  layout, so each is copied by path with no transposition:
  ``GATConv.att_src``/``att_dst`` [1, H, D] and ``bias``;
  ``GCNConv.kernel`` [in, out] (applied as ``x @ kernel``) and ``bias``;
  ``MixHopLayer.lin_{j}_kernel`` [in, out] and ``lin_{j}_bias``;
  ``LINK.weight`` [N, C] and ``bias``; ``GPRGNN.gamma`` [K + 1];
  ``H2GCN.w_embed`` [in, hidden] and ``w_classify`` [width, C] (applied as
  ``x @ w``); ``DenseGeneral.kernel`` [*in, *out] (flax
  ``MultiHeadDotProductAttention``'s 3-D ``query``/``key``/``value``/``out``
  kernels) and ``bias``; ``NodeFormerConv.b`` [rb_order, H];
  ``QuantNoiseLinear.kernel`` [in, out] and ``bias``; ``Graphormer``'s
  ``graph_token``, ``graph_token_virtual_distance`` and
  ``lm_output_learned_bias``;
- ``Embed`` (an ``nn.Embedding``): ``embedding`` -> ``weight``;
- buffers that flax keeps in ``batch_stats``, listed by the module in
  ``FLAX_BATCH_STATS``: ``PerformerSelfAttention.projection`` [M, D].

A key the module lacks, or a module tensor the tree lacks, raises KeyError;
a shape that differs raises ValueError. Buffers outside the state dict (a
fixed random projection that the JAX package draws from a fixed key rather
than keeping as a variable) have no flax counterpart and are left as they
are.
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
        elif isinstance(mod, nn.Embedding):
            yield ("params",) + path + ("embedding",), mod.weight, False
        for pname in getattr(mod, "FLAX_PARAMS", ()):
            yield ("params",) + path + (pname,), getattr(mod, pname), False
        for bname in getattr(mod, "FLAX_BATCH_STATS", ()):
            yield ("batch_stats",) + path + (bname,), getattr(mod, bname), False


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
    state = model.state_dict()
    missing = [n for n, t in list(model.named_parameters()) + list(model.named_buffers())
               if id(t) not in filled and n in state]
    if missing:
        raise KeyError(f"module tensors with no flax counterpart: {missing}")
    return model
