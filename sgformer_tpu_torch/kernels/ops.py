"""The forward kernels as ``torch.library`` custom ops, in the namespace
``sgformer_tpu_torch``.

Each op has three implementations:

- for CPU tensors, the kernel's plain version;
- for CUDA tensors, the kernel's launch (``csr_spmm_cuda`` and the like in
  :mod:`.spmm` and :mod:`.attention`), which adds one to the kernel's launch
  count, so that the calls of an exported program are counted too; a failed
  build or launch raises, and the plain version is never called;
- a fake one, which computes only the result's shapes and types, so that
  ``torch.export`` traces a forward through the op (no data pointer, hub
  plan, walk order or scratch buffer is touched there).

The wrappers (:func:`.spmm.csr_spmm`, :func:`.spmm.csr_spmm_ev`,
:func:`.spmm.quantize_absmax`, :func:`.spmm.csr_spmm_q8_apply`,
:func:`.attention.reduce`, :func:`.attention.apply`) check their arguments
and call these ops; an exported forward calls them as
``torch.ops.sgformer_tpu_torch.<name>.default``, so a process that loads one
imports this module first (:func:`sgformer_tpu_torch.serve.load_exported`).

The backward kernels (``bwd_reduce``, ``bwd_apply``, ``csr_spmm_ev_bwd``,
``sddmm``) and the timing probes are not ops: no inference export reaches
them.
"""

from typing import Optional

import torch
from torch.library import custom_op

from sgformer_tpu_torch.kernels import attention, spmm
from sgformer_tpu_torch.ops.spmm import quantize_absmax as quantize_absmax_plain
from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain
from sgformer_tpu_torch.ops.spmm import spmm_edge_values, spmm_q8_apply

NAMESPACE = "sgformer_tpu_torch"
# each op and the launch count (``kernels.launch_counts()``) that its CUDA
# implementation adds one to
LAUNCH_COUNT = {
    "csr_spmm": "csr_spmm",
    "csr_spmm_ev": "csr_spmm_ev",
    "quantize_absmax": "quantize_absmax",
    "csr_spmm_q8_apply": "csr_spmm_q8",
    "linear_attention_reduce": "linear_attention_reduce",
    "linear_attention_apply": "linear_attention_apply",
}


@custom_op(f"{NAMESPACE}::csr_spmm", mutates_args=(), device_types="cpu")
def csr_spmm(x: torch.Tensor, indptr: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, weight: torch.Tensor, segments: Optional[torch.Tensor],
             segment_edges: Optional[int],
             schedule: Optional[torch.Tensor] = None) -> torch.Tensor:
    return spmm_plain(x, edge_src, edge_dst, weight, indptr.shape[0] - 1)


@custom_op(f"{NAMESPACE}::csr_spmm_ev", mutates_args=(), device_types="cpu")
def csr_spmm_ev(x: torch.Tensor, indptr: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor, values: torch.Tensor, out_dtype: torch.dtype,
                segments: Optional[torch.Tensor], segment_edges: Optional[int],
                schedule: Optional[torch.Tensor] = None) -> torch.Tensor:
    return spmm_edge_values(x, edge_src, edge_dst, values, indptr.shape[0] - 1, out_dtype)


@custom_op(f"{NAMESPACE}::quantize_absmax", mutates_args=(), device_types="cpu")
def quantize_absmax(x: torch.Tensor, rs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return quantize_absmax_plain(x, rs)


@custom_op(f"{NAMESPACE}::csr_spmm_q8_apply", mutates_args=(), device_types="cpu")
def csr_spmm_q8_apply(q: torch.Tensor, s: torch.Tensor, x_self: torch.Tensor,
                      indptr: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      weight: torch.Tensor, rs: torch.Tensor, out_dtype: torch.dtype,
                      segments: Optional[torch.Tensor], segment_edges: Optional[int],
                      schedule: Optional[torch.Tensor] = None) -> torch.Tensor:
    return spmm_q8_apply(q, s, x_self, edge_src, edge_dst, weight, rs, indptr.shape[0] - 1,
                         out_dtype)


@custom_op(f"{NAMESPACE}::linear_attention_reduce", mutates_args=(), device_types="cpu")
def linear_attention_reduce(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            guard: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return attention.reduce_plain(q, k, v, guard)


@custom_op(f"{NAMESPACE}::linear_attention_apply", mutates_args=(), device_types="cpu")
def linear_attention_apply(q: torch.Tensor, v: torch.Tensor, kvs: torch.Tensor,
                           ksum: torch.Tensor, scal: torch.Tensor, n_total: torch.Tensor,
                           guard: bool) -> torch.Tensor:
    return attention.apply_plain(q, v, kvs, ksum, scal, n_total, guard)


csr_spmm.register_kernel("cuda")(spmm.csr_spmm_cuda)
csr_spmm_ev.register_kernel("cuda")(spmm.csr_spmm_ev_cuda)
quantize_absmax.register_kernel("cuda")(spmm.quantize_absmax_cuda)
csr_spmm_q8_apply.register_kernel("cuda")(spmm.csr_spmm_q8_apply_cuda)
linear_attention_reduce.register_kernel("cuda")(attention.reduce_cuda)
linear_attention_apply.register_kernel("cuda")(attention.apply_cuda)


@csr_spmm.register_fake
def _(x, indptr, edge_src, edge_dst, weight, segments, segment_edges, schedule=None):
    return x.new_empty((indptr.shape[0] - 1, x.shape[1]))


@csr_spmm_ev.register_fake
def _(x, indptr, edge_src, edge_dst, values, out_dtype, segments, segment_edges,
      schedule=None):
    return x.new_empty(x.shape, dtype=out_dtype)


@quantize_absmax.register_fake
def _(x, rs):
    return x.new_empty(x.shape, dtype=torch.int8), x.new_empty((), dtype=torch.float32)


@csr_spmm_q8_apply.register_fake
def _(q, s, x_self, indptr, edge_src, edge_dst, weight, rs, out_dtype, segments,
      segment_edges, schedule=None):
    return q.new_empty(q.shape, dtype=out_dtype)


@linear_attention_reduce.register_fake
def _(q, k, v, guard):
    m, d = q.shape[1], v.shape[1]
    return (q.new_empty((m, d), dtype=torch.float32), q.new_empty((m,), dtype=torch.float32),
            q.new_empty((4,), dtype=torch.float32))


@linear_attention_apply.register_fake
def _(q, v, kvs, ksum, scal, n_total, guard):
    return q.new_empty((q.shape[0], v.shape[1]))


OPS = {name: getattr(torch.ops.sgformer_tpu_torch, name).default for name in LAUNCH_COUNT}


def op_calls(program) -> dict:
    """How many call nodes of each op the graph of ``program`` (an
    ``ExportedProgram`` or a ``GraphModule``) holds, by op name."""
    names = {op: name for name, op in OPS.items()}
    calls = dict.fromkeys(OPS, 0)
    for node in program.graph.nodes:
        if node.op == "call_function" and node.target in names:
            calls[names[node.target]] += 1
    return calls
