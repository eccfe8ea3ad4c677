"""Full-graph serving: the port of ``sgformer_tpu/serve.py::Predictor``.

One forward computes the logits of all N nodes; a request for a subset of
nodes is answered from them. With ``compute_dtype="bf16"`` the activations
are bf16 and the logits f32. The port never reorders nodes, so node ids in
and out are the caller's own.

Checkpoint loading (``load_predictor``) and the exported artifact
(``export_artifact``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.convert import load_flax_variables
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.kernels import _build


class Predictor:
    """Inference on a trained model over one graph.

    Args:
      model: :class:`sgformer_tpu_torch.SGFormer`.
      graph: :class:`sgformer_tpu_torch.graph.Graph` from ``preprocess_graph``.
      x: [N, F] node features (numpy array or tensor).
      state: optional flax variables ``{"params", "batch_stats"}`` of a JAX
        model of the same config, copied into ``model`` by
        :func:`~sgformer_tpu_torch.convert.load_flax_variables`.
      device: where the model runs; "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, model, graph, x, state: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        if state is not None:
            load_flax_variables(model, state)
        self.model = model.to(self.device).eval()
        self.graph = graph.to(self.device)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        self.x = x.to(self.device, torch.float32)
        if self.x.shape[0] != self.graph.num_nodes:
            raise ValueError(
                f"x has {self.x.shape[0]} rows for a graph of {self.graph.num_nodes} nodes"
            )

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
            return self.model(self.x, self.graph)

    def logits(self) -> np.ndarray:
        """[N, C] float32 logits."""
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
