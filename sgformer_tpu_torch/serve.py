"""Full-graph serving: the port of ``sgformer_tpu/serve.py``.

One forward computes the logits of all N nodes; a request for a subset of
nodes is answered from them. With ``compute_dtype="bf16"`` the activations
are bf16 and the logits f32. Node ids in and out are the caller's own: on a
graph with a clustering reorder (``Graph.node_perm``) the predictor permutes
x into the graph's order and its logits back, as the JAX ``Predictor``
does.

- :class:`Predictor` serves a model on one graph, with the keyword
  arguments some models take (``model_kwargs``) and the first element of a
  model's tuple output (NodeFormer's logits).
- :func:`load_predictor` restores the port's own checkpoints
  (``train/checkpoint.py``); a JAX checkpoint's variables enter through
  ``Predictor(..., state=)``.
- :meth:`Predictor.export_artifact` hands the forward to another process:
  a ``torch.export`` program that takes the flat tensor list of
  :meth:`Predictor.export_leaves`, which :func:`load_exported` restores.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.convert import load_flax_variables
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import Graph, NodeOrder, graph_from_leaves, graph_leaves
from sgformer_tpu_torch.kernels import _build
from sgformer_tpu_torch.train.checkpoint import read_state


def _to_device(value, device):
    """``value`` with every tensor and :class:`Graph` in it (through lists,
    tuples and dicts) on ``device``."""
    if isinstance(value, (torch.Tensor, Graph)):
        return value.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(_to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return value


def _logits(out) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


class _FlatForward(torch.nn.Module):
    """The model's eval forward as a function of flat tensors: its
    parameters and buffers, x and the graph's leaves, in that order. The
    model is held outside the module's attributes, so that its weights are
    inputs of an export and not constants."""

    def __init__(self, model, names: list, graph_spec: dict, model_kwargs: dict):
        super().__init__()
        self._model = [model]
        self._names = names
        self._graph_spec = graph_spec
        self._model_kwargs = model_kwargs

    def forward(self, *leaves):
        k = len(self._names)
        weights = dict(zip(self._names, leaves[:k]))
        graph = graph_from_leaves(leaves[k + 1:], self._graph_spec)
        out = torch.func.functional_call(self._model[0], weights, (leaves[k], graph),
                                         self._model_kwargs)
        return _logits(out)


class Predictor:
    """Inference on a trained model over one graph.

    Args:
      model: :class:`sgformer_tpu_torch.SGFormer` or a zoo model; its
        ``forward(x, graph, **model_kwargs)`` returns [N, C] logits, or a
        tuple whose first element they are (NodeFormer).
      graph: :class:`sgformer_tpu_torch.graph.Graph` from ``preprocess_graph``.
      x: [N, F] node features (numpy array or tensor).
      state: optional flax variables ``{"params", "batch_stats"}`` of a JAX
        model of the same config, copied into ``model`` by
        :func:`~sgformer_tpu_torch.convert.load_flax_variables`.
      model_kwargs: extra keyword arguments of every forward, as the JAX
        ``Predictor`` and the port's ``Trainer`` take them (``H2GCN``'s
        ``h2_graphs``, ``NodeFormer``'s ``adjs``, ``Graphormer``'s
        ``inputs``); their tensors and graphs are moved to ``device``.
      device: where the model runs; "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, model, graph, x, state: Optional[dict] = None,
                 model_kwargs: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        if state is not None:
            load_flax_variables(model, state)
        self.model = model.to(self.device).eval()
        self.graph = graph.to(self.device)
        self.model_kwargs = _to_device(model_kwargs or {}, self.device)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        if x.shape[0] != self.graph.num_nodes:
            raise ValueError(
                f"x has {x.shape[0]} rows for a graph of {self.graph.num_nodes} nodes"
            )
        self.order = NodeOrder(self.graph.node_perm, self.device)
        self.x = self.order.to_graph(x.to(self.device, torch.float32))

    def compile(self) -> "Predictor":
        """Build the kernels and run one forward, so that no request pays
        for either. Returns self."""
        if self.device.type == "cuda":
            _build.build_all()
        self._forward()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _forward(self) -> torch.Tensor:
        with torch.inference_mode():
            return self.order.to_caller(_logits(self.model(self.x, self.graph,
                                                           **self.model_kwargs)))

    def logits(self) -> np.ndarray:
        """[N, C] float32 logits, in the caller's node order."""
        return self._forward().cpu().numpy()

    def _rows(self, node_idx) -> torch.Tensor:
        out = self._forward()
        if node_idx is not None:
            idx = torch.as_tensor(np.asarray(node_idx), dtype=torch.long)
            out = out[idx.to(self.device)]
        return out

    def predict(self, node_idx=None) -> np.ndarray:
        """argmax class per node (all nodes, or ``node_idx``)."""
        return self._rows(node_idx).argmax(dim=-1).cpu().numpy()

    def predict_proba(self, node_idx=None) -> np.ndarray:
        """softmax probabilities per node (all nodes, or ``node_idx``)."""
        return torch.softmax(self._rows(node_idx), dim=-1).cpu().numpy()

    # -- the hand-off to another process -------------------------------------

    def _weights(self) -> tuple[list, list]:
        named = [*self.model.named_parameters(), *self.model.named_buffers()]
        return [name for name, _ in named], [t.detach() for _, t in named]

    def export_leaves(self) -> list:
        """The flat tensor list an exported artifact is called with: the
        model's parameters, then its buffers (the BatchNorm statistics), in
        ``named_parameters``/``named_buffers`` order, then x, then the
        graph's tensors (:func:`~sgformer_tpu_torch.graph.graph_leaves`).
        The weights are inputs, as in the JAX artifact, so one artifact
        serves every checkpoint of the same config and graph shapes. x is in
        the graph's node order."""
        return [*self._weights()[1], self.x, *graph_leaves(self.graph)[0]]

    def export_artifact(self, path: str, *, include_inputs: bool = False) -> str:
        """Write the bound forward, traced by ``torch.export`` under
        ``torch.no_grad()``, to ``path`` (``torch.export.save``); returns
        ``path``.

        The program takes :meth:`export_leaves` and returns the [N, C]
        logits in the graph's node order. Every forward kernel is in it as
        its custom op
        (``torch.ops.sgformer_tpu_torch.*``, :mod:`sgformer_tpu_torch.kernels.ops`),
        so the loaded program launches the same kernels, and counts them.
        ``model_kwargs`` are the program's constants (``torch.export`` lifts
        their tensors), as the JAX export's closure makes them. The program
        is for the bound shapes and types, and for the device it was traced
        on.

        With ``include_inputs=True`` the leaves are also written to ``path +
        ".inputs.npz"`` as ``arr_0..`` in :meth:`export_leaves` order, with
        ``inv_perm``, the map from the program's rows to the caller's node
        ids (``out[inv_perm]``; the identity unless the graph has a
        clustering reorder), the JAX bundle's layout. numpy has no bf16: a
        bf16 leaf would be stored as its bits in uint16
        (``arr.view(np.uint16)``; the bench model has none)."""
        names, _ = self._weights()
        spec = graph_leaves(self.graph)[1]
        leaves = self.export_leaves()
        fwd = _FlatForward(self.model, names, spec, self.model_kwargs)
        with torch.no_grad():
            program = torch.export.export(fwd, tuple(leaves))
        # the leaves are the caller's (or the bundle's), not the artifact's
        program.example_inputs = None
        torch.export.save(program, path)
        if include_inputs:
            arrays = []
            for leaf in leaves:
                leaf = leaf.cpu()
                arrays.append(leaf.view(torch.uint16).numpy() if leaf.dtype == torch.bfloat16
                              else leaf.numpy())
            inv_perm = (np.arange(self.graph.num_nodes, dtype=np.int64) if self.order.inv is None
                        else self.order.inv.cpu().numpy())
            np.savez(path + ".inputs.npz", *arrays, inv_perm=inv_perm)
        return path


def load_exported(path: str):
    """Read an artifact of :meth:`Predictor.export_artifact`: the
    ``torch.export.ExportedProgram``. Call ``.module()(*leaves)`` with the
    flat tensor list (:meth:`Predictor.export_leaves`, or the ``arr_0..``
    arrays of the ``.inputs.npz`` bundle as tensors on the device it was
    exported on) under ``torch.no_grad()``; rows come out in the graph's
    node order, mapped to the caller's ids by the bundle's ``inv_perm``.

    Unlike the JAX artifact, which runs without its package, this one needs
    ``sgformer_tpu_torch.kernels`` importable: the forward kernels are
    custom ops registered there, and this function imports it before
    loading."""
    import sgformer_tpu_torch.kernels.ops  # noqa: F401  (registers the ops)

    return torch.export.load(path)


def load_predictor(ckpt_path: str, model, graph, x, model_kwargs: Optional[dict] = None,
                   device="cuda") -> Predictor:
    """Restore a checkpoint of the port into ``model`` and return a compiled
    :class:`Predictor`. ``ckpt_path``: a file of
    :func:`~sgformer_tpu_torch.train.checkpoint.save_checkpoint` or
    :func:`~sgformer_tpu_torch.train.checkpoint.save_state` (the model's
    parameters and statistics are read; an optimizer's state is not)."""
    model.load_state_dict(read_state(ckpt_path))
    return Predictor(model, graph, x, model_kwargs=model_kwargs, device=device).compile()
