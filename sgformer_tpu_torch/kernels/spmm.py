"""CSR SpMM and SDDMM wrappers over the dst-sorted CSR graph.

On CUDA tensors each wrapper launches its kernel of ``csrc/spmm.cu`` or
raises; on CPU tensors it runs its plain version. The forward wrappers
(:func:`csr_spmm`, :func:`csr_spmm_ev`, :func:`quantize_absmax`,
:func:`csr_spmm_q8_apply`) check their arguments and call their
``torch.library`` custom op (:mod:`.ops`), whose CUDA implementation is the
launch (``csr_spmm_cuda`` and the like) and whose CPU implementation is the
plain version, so that ``torch.export`` can trace a forward through them:

- :func:`csr_spmm`, ``out = A_norm @ x`` with the graph's fixed weights,
  replaces the TPU kernels ``kernels/slab_spmm.py::_ssel_kernel``,
  ``::_slab_kernel`` and ``kernels/spmm.py::_spmm_kernel`` of the JAX
  package; plain version :func:`sgformer_tpu_torch.ops.spmm.spmm`.
- :func:`csr_spmm_ev`, the same sum per head with runtime per-edge values
  (GAT's attention weights), replaces ``kernels/spmm.py::_spmm_kernel`` as
  ``chunked_spmm_edge_values`` drives it; plain version
  :func:`sgformer_tpu_torch.ops.spmm.spmm_edge_values`. It is the same
  kernel as :func:`csr_spmm`, which is its one-head case.
- :func:`csr_spmm_ev_bwd`, the whole gradient of :func:`csr_spmm_ev` from
  one walk of the transposed CSR that gathers g once per edge: dx (the
  JAX package's ``_spmm_ev_bwd`` runs ``_spmm_kernel`` on the backward
  plan) and dv (``g[dst_e] . x[src_e]``, which it leaves to XLA); plain
  version :func:`sgformer_tpu_torch.ops.spmm.spmm_edge_values_backward`.
- :func:`sddmm`, ``dv[e, h] = g[dst_e, h] . x[src_e, h]`` alone, the same
  walk on the dst-sorted CSR; plain version
  :func:`sgformer_tpu_torch.ops.sddmm.sddmm`.
- :func:`csr_spmm_q8`, the int8 GCN aggregation of a ``slab_dtype="int8"``
  graph, replaces the int8 branch of ``kernels/slab_spmm.py::_ssel_kernel``
  with ``_apply_side``'s quantiser and epilogue: :func:`quantize_absmax`,
  the absmax int8 quantiser (plain version
  :func:`sgformer_tpu_torch.ops.spmm.quantize_absmax`, which it equals bit
  for bit), then :func:`csr_spmm_q8_apply`, the integer sums and the
  epilogue; plain version :func:`sgformer_tpu_torch.ops.spmm.spmm_q8`.

:func:`csr_spmm_autograd`, :func:`csr_spmm_ev_autograd` and
:func:`csr_spmm_q8_autograd` are the differentiable forms. The gradient of
``A @ x`` in x is ``A^T @ g``, the same kernel on the transposed CSR (the
JAX package's ``_slab_core_bwd`` and ``_spmm_ev_bwd`` likewise run their
forward kernels on the transpose plan); for fixed weights and a symmetric A
the transpose is A's own CSR, but runtime values belong to directed edges,
so the per-edge-value gradient always reads the values permuted into the
transposed order.

Hub rows: :func:`csr_spmm`, :func:`csr_spmm_ev`, :func:`csr_spmm_ev_bwd`,
:func:`sddmm` and :func:`csr_spmm_q8` split every row of more than
``segment_edges`` (:data:`HUB_EDGES` by default) in-edges into segments of
at most that many edges, each walked by a warp of its own, and add each
row's segment sums in a fixed order in a second pass (see
``csrc/spmm.cu``; the int8 sums are integers, exact in any order; a
segment's per-edge dots need no second pass).
The plan, :func:`hub_plan` of the CSR's ``indptr``, is built once per
graph on the graph's device by ``preprocess_graph`` (or by the batch
trainer's ``build_subgraph_batch``, once per batch) and kept on the
``Graph`` beside each CSR (``hub_segments``, ``t_hub_segments``, ...), with
the segment length it was built with (``Graph.hub_edges``); a call without
it builds it from ``indptr``, which waits for the device to count the
segments. The kernel's row
walk skips every row longer than the plan's segment length and leaves it to
the plan, so a plan is only taken together with its length, which the
kernel is given: a plan passed without one is refused (it cannot be read
back to check), since one built for a longer segment would leave the rows
between the two lengths unwritten.

The row walk (``csrc/spmm.cu``'s ``csr_spmm_kernel``, :data:`ROW_WALK`):
:func:`csr_spmm`, :func:`csr_spmm_ev` and :func:`csr_spmm_q8` (and
:func:`csr_spmm_q8_apply`) take a walk order, ``schedule``
([rows] int32, a permutation of the CSR's rows, built once per graph by
``preprocess_graph`` from the clustering of :mod:`sgformer_tpu_torch.native.
reorder`, ``Graph.schedule``), and walk the rows in that order, each
written in place and summed edge for edge as without the order, so the
result is the same bit for bit with or without one. Heads of at most 128
columns walk on persistent warps, as many as the card holds, that read the
row pointers of 32 rows at once and prefetch each next row's edge ids and
values into L1 while they gather for the current one. On CPU tensors the
order is checked and then ignored. :func:`csr_spmm_ev_bwd` takes the
transposed CSR's (``t_schedule``) for its row walk, and the int8 gradient
(:func:`csr_spmm_q8_autograd`) walks Aᵀ in it. The int8 walk
(:data:`Q8_WALK`) sums integers, so its result is the same bit for bit in
any order.

``launches``, ``ev_launches``, ``ev_bwd_launches``, ``sddmm_launches``,
``q8_launches`` and ``quantize_launches`` count the calls that launched
their kernels (one a call, whether or not the hub rows' second pass ran,
and one for the quantiser's two passes), forward and backward alike, and
an exported program's calls of the ops too: a forward kernel's count is
kept in its op's CUDA implementation. Set them to 0 to start a count.
"""

from __future__ import annotations

import numpy as np
import torch

from sgformer_tpu_torch.kernels import _build
from sgformer_tpu_torch.ops.sddmm import sddmm as sddmm_plain
from sgformer_tpu_torch.ops.spmm import (
    spmm_edge_values_backward as spmm_edge_values_backward_plain)

# the forward kernels' custom ops, registered by .ops (which the package
# imports after this module)
_OPS = torch.ops.sgformer_tpu_torch

launches = 0
ev_launches = 0
ev_bwd_launches = 0
sddmm_launches = 0
q8_launches = 0
quantize_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# a row of more in-edges than this is summed in segments of at most this
# many edges, one warp each: on the H100, on the JAX package's power-law
# bench graph, 128 edges (4,894 segments) timed best of 64 to 1,024
HUB_EDGES = 128

# the quantiser: blocks of each of its two passes (at most)
QUANTIZE_BLOCKS = 1024

# the design of csr_spmm_kernel's row walk, beside its lane groups
# (walk_design)
ROW_WALK = ("rows in the graph's walk order (its clusters together, so L2 holds the rows they "
            "gather); heads of at most 128 columns on persistent warps, as many as the card "
            "holds, that read 32 rows' pointers at once into shared memory and prefetch each "
            "next row's edge ids and values into L1 while they gather for the row")
# csr_spmm_q8's walk (csrc/spmm.cu, csr_spmm_q8_kernel)
Q8_WALK = ("rows in the graph's walk order, one warp a row, 8-byte gathers (8 columns a "
           "lane), exact int32 sums")


def hub_plan(indptr: torch.Tensor, max_edges: int = HUB_EDGES) -> torch.Tensor:
    """The segment plan of a CSR: every row with more than ``max_edges``
    edges cut into runs of at most ``max_edges`` consecutive edges, as an
    [S, 3] int32 tensor of (row, begin, end) edge ranges in row and edge
    order, built on ``indptr``'s device (integer work only, so the same
    plan on every device; counting the segments waits for the device)."""
    indptr = indptr.long()
    deg = indptr[1:] - indptr[:-1]
    rows = torch.nonzero(deg > max_edges).flatten()
    counts = (deg[rows] + max_edges - 1) // max_edges
    row = torch.repeat_interleave(rows, counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    begin = indptr[row] + (torch.arange(row.numel(), device=row.device) - first) * max_edges
    end = torch.minimum(begin + max_edges, indptr[row + 1])
    return torch.stack([row, begin, end], dim=1).int().reshape(-1, 3).contiguous()


def walk_design(d: int, aligned: bool = True) -> str:
    """The lanes of the row walk that :func:`csr_spmm`, :func:`csr_spmm_ev`,
    :func:`csr_spmm_ev_bwd` and :func:`sddmm` launch for a head of ``d``
    columns (``csrc/spmm.cu``'s ``lane_groups``): on the 16-byte path (d %
    8 == 0 and ``aligned`` rows) groups of the fewest of 4, 8, 16 or 32
    lanes whose 8 columns each cover the head, each group on its own edges;
    else the whole warp at one column a lane."""
    if not aligned or d % 8:
        return "1 group of 32 lanes, 1 column a lane"
    lanes = next(n for n in (4, 8, 16, 32) if 8 * n >= d or n == 32)
    groups = 32 // lanes
    return f"{groups} group{'s' * (groups > 1)} of {lanes} lanes, 8 columns a lane"


def _check_device(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")
    return kind


def _check_csr(indptr, edge_src, **per_edge) -> None:
    for name, t, dt in (("indptr", indptr, torch.int32), ("edge_src", edge_src, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-d {dt} tensor")
    for name, t in per_edge.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor")
        if t.shape[0] != edge_src.shape[0]:
            raise ValueError(f"edge_src and {name} must have one entry per edge")


def _aligned(d: int, *tensors) -> int:
    """1 when the kernels may move 8 columns with 16-byte accesses."""
    return int(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _segment_length(segments, segment_edges) -> int:
    """The row walk's segment length for a call given ``segments`` and
    ``segment_edges``: the plan's own length, which must come with it."""
    if segment_edges is None:
        if segments is not None:
            raise ValueError(
                "a hub plan needs the segment length it was built with (segment_edges; "
                "Graph.hub_edges for a graph's plans): the kernel leaves every row of more "
                "in-edges than that length to the plan, so a plan of another length would "
                "leave rows unwritten")
        return HUB_EDGES
    if (not isinstance(segment_edges, (int, np.integer)) or isinstance(segment_edges, bool)
            or segment_edges < 1):
        raise ValueError(f"segment_edges must be a positive integer, got {segment_edges!r}")
    return int(segment_edges)


def _plan(segments, indptr, segment_edges=None) -> tuple[torch.Tensor, int]:
    """The hub plan on indptr's device and its segment length, which the
    kernel's row walk takes: ``segments`` as given (checked) with the length
    it was built with, ``segment_edges``, which may not be left out; or,
    when ``segments`` is None, the plan built from ``indptr`` (:func:`hub_plan`)
    with segments of ``segment_edges`` (:data:`HUB_EDGES` when None)."""
    length = _segment_length(segments, segment_edges)
    if segments is None:
        return hub_plan(indptr, length), length
    if segments.device != indptr.device:
        raise ValueError(f"segments on {segments.device}, the CSR on {indptr.device}")
    if (segments.dtype != torch.int32 or segments.dim() != 2 or segments.shape[1] != 3
            or not segments.is_contiguous()):
        raise TypeError("segments must be a contiguous [S, 3] int32 tensor (hub_segments)")
    return segments, length


def _check_schedule(schedule, indptr) -> None:
    """A walk order for the CSR of ``indptr``: None, or a contiguous [rows]
    int32 tensor on indptr's device. That it is a permutation of the rows is
    checked where the graph is built (``graph_from_sorted``): here it would
    wait for the device on every call."""
    if schedule is None:
        return
    n = indptr.shape[0] - 1
    if (not isinstance(schedule, torch.Tensor) or schedule.dtype != torch.int32
            or schedule.shape != (n,) or not schedule.is_contiguous()):
        raise TypeError(f"schedule must be a contiguous [{n}] int32 tensor (the CSR's walk "
                        f"order), got {getattr(schedule, 'dtype', type(schedule))} "
                        f"{tuple(getattr(schedule, 'shape', ()))}")
    if schedule.device != indptr.device:
        raise ValueError(f"schedule on {schedule.device}, the CSR on {indptr.device}")


def _launch_spmm(x, indptr, edge_src, values, out, heads: int, d: int, segments,
                 segment_edges, schedule) -> bool:
    """Launch the kernel (and the hub rows' second pass) unless the output
    is empty; True if it launched."""
    n = indptr.shape[0] - 1
    if n == 0 or d == 0 or heads == 0:
        return False
    segments, length = _plan(segments, indptr, segment_edges)
    n_seg = segments.shape[0]
    part = (torch.empty(n_seg, heads * d, dtype=torch.float32, device=x.device)
            if n_seg else None)
    err = _build.library("spmm").sgf_csr_spmm(
        indptr.data_ptr(), edge_src.data_ptr(), values.data_ptr(), x.data_ptr(),
        out.data_ptr(), segments.data_ptr() if n_seg else None, n_seg,
        part.data_ptr() if n_seg else None, length, n, heads, d, _DTYPES[x.dtype],
        _DTYPES[out.dtype], _aligned(d, x, out),
        schedule.data_ptr() if schedule is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "csr_spmm")
    return True


def csr_spmm(
    x: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
    segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
    num_cols: int | None = None,
    schedule: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[i] = sum_{e in [indptr[i], indptr[i+1])} weight[e] * x[edge_src[e]].

    A is [len(indptr) - 1, num_cols] (square when ``num_cols`` is None) and
    x must be [num_cols, F], every ``edge_src`` below num_cols: a node
    shard's CSR reads the gathered rows of every shard or its halo table
    (:mod:`sgformer_tpu_torch.parallel.partition`). The result has A's rows.
    x: float32 or bfloat16 (any F; the kernel takes 256 columns per
    pass); indptr [N+1], edge_src and edge_dst [E] int32, sorted by dst;
    weight [E] float32; segments: the hub plan of this CSR,
    ``hub_plan(indptr, segment_edges)`` (on the graph as
    ``hub_segments`` and the like, with ``hub_edges``), given with its
    ``segment_edges`` or refused; built from ``indptr`` when None, with
    segments of ``segment_edges`` (:data:`HUB_EDGES` when None). The sum is
    f32 and the result has x's type. ``schedule``: the CSR's walk order
    (``Graph.schedule``), the rows in the order the kernel walks them, or
    None for row order; the result is the same bit for bit. ``edge_dst`` is
    read only by the plain version, ``segments`` and ``schedule`` only by
    the kernel. Runs the op ``sgformer_tpu_torch::csr_spmm`` (:mod:`.ops`).
    """
    num_cols = indptr.shape[0] - 1 if num_cols is None else num_cols
    if x.dim() != 2 or x.shape[0] != num_cols:
        raise ValueError(f"x must be [{num_cols}, F], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _segment_length(segments, segment_edges)
    _check_device(x, indptr, edge_src, edge_dst, weight)
    _check_schedule(schedule, indptr)
    return _OPS.csr_spmm(x, indptr, edge_src, edge_dst, weight, segments, segment_edges,
                         schedule)


def csr_spmm_cuda(x, indptr, edge_src, edge_dst, weight, segments, segment_edges,
                  schedule=None):
    """The CUDA implementation of the op :func:`csr_spmm` runs: the kernel's
    launch, counted."""
    global launches
    _check_csr(indptr, edge_src, weight=weight)
    if weight.dim() != 1:
        raise ValueError("weight must be [E]")
    x = x.contiguous()
    out = torch.empty(indptr.shape[0] - 1, x.shape[1], dtype=x.dtype, device=x.device)
    if _launch_spmm(x, indptr, edge_src, weight, out, 1, x.shape[1], segments, segment_edges,
                    schedule):
        launches += 1
    return out


def csr_spmm_ev(
    x: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    values: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
    schedule: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[i, h] = sum_{e in [indptr[i], indptr[i+1])} values[e, h] * x[edge_src[e], h].

    x: [N, H, D] float32 or bfloat16, the messages in the type they are
    sent in; values: [E, H] float32 in the CSR's edge order; all heads in one
    launch. The sum is f32 and the result, [N, H, D], has ``out_dtype``
    (x's type when None). ``segments`` and ``segment_edges`` are the CSR's
    hub plan and its segment length, ``schedule`` its walk order, as in
    :func:`csr_spmm`. ``edge_dst`` is read only by the plain version. Runs
    the op ``sgformer_tpu_torch::csr_spmm_ev``.
    """
    n = indptr.shape[0] - 1
    out_dtype = out_dtype or x.dtype
    if x.dim() != 3 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, H, D], got {tuple(x.shape)}")
    if values.dim() != 2 or values.shape[1] != x.shape[1]:
        raise ValueError(f"values must be [E, {x.shape[1]}], got {tuple(values.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"x and the result must be float32 or bfloat16, got {x.dtype}, "
                        f"{out_dtype}")
    _segment_length(segments, segment_edges)
    _check_device(x, indptr, edge_src, edge_dst, values)
    _check_schedule(schedule, indptr)
    return _OPS.csr_spmm_ev(x, indptr, edge_src, edge_dst, values, out_dtype, segments,
                            segment_edges, schedule)


def csr_spmm_ev_cuda(x, indptr, edge_src, edge_dst, values, out_dtype, segments,
                     segment_edges, schedule=None):
    """The CUDA implementation of the op :func:`csr_spmm_ev` runs."""
    global ev_launches
    _check_csr(indptr, edge_src, values=values)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if _launch_spmm(x, indptr, edge_src, values, out, x.shape[1], x.shape[2], segments,
                    segment_edges, schedule):
        ev_launches += 1
    return out


def quantize_absmax(x: torch.Tensor, rs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The absmax int8 quantisation of ``x`` pre-scaled by ``rs``, bit for
    bit :func:`sgformer_tpu_torch.ops.spmm.quantize_absmax` (the JAX
    ``_apply_side``'s): ``xs = bf16(bf16(x) * bf16(rs)[:, None])``, ``s =
    max(max|xs|, 1e-30)`` (NaN if x holds one) and ``q = int8(clamp(rint(xs
    * (127/s)), -127, 127))``, rounding half to even.

    x: [N, F] float32 or bfloat16, N * F > 0; rs: [N] float32. Returns (q
    [N, F] int8, s 0-d float32 on x's device: the host never reads it). On
    the card two launches (``csrc/spmm.cu``: the blocks' partial maxima,
    then every block reduces them and quantises its share, walking x from
    the end, where the first ended). Runs the op
    ``sgformer_tpu_torch::quantize_absmax``."""
    if x.dim() != 2 or rs.shape != (x.shape[0],):
        raise ValueError(f"x must be [N, F] and rs [N], got {tuple(x.shape)}, "
                         f"{tuple(rs.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check_device(x, rs)
    return _OPS.quantize_absmax(x, rs)


def quantize_absmax_cuda(x, rs):
    """The CUDA implementation of the op :func:`quantize_absmax` runs."""
    global quantize_launches
    if rs.dtype != torch.float32 or not rs.is_contiguous():
        raise TypeError("rs must be a contiguous float32 tensor")
    x = x.contiguous()
    n, f = x.shape
    vec8 = f % 8 == 0 and x.data_ptr() % 16 == 0
    items, per_row = (n * f // 8, f // 8) if vec8 else (n * f, f)
    if not 0 < items < 2 ** 31:
        raise ValueError(f"x must be non-empty with fewer than 2^31 items, got {tuple(x.shape)}")
    parts = min(QUANTIZE_BLOCKS, -(-items // 256))
    part = torch.empty(parts, dtype=torch.int32, device=x.device)
    q = torch.empty(n, f, dtype=torch.int8, device=x.device)
    s = torch.empty((), dtype=torch.float32, device=x.device)
    err = _build.library("spmm").sgf_quantize_absmax(
        x.data_ptr(), rs.data_ptr(), part.data_ptr(), parts, s.data_ptr(), q.data_ptr(), items,
        per_row, _DTYPES[x.dtype], int(vec8), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "quantize_absmax")
    quantize_launches += 1
    return q, s


def csr_spmm_q8_apply(
    q: torch.Tensor,
    s: torch.Tensor,
    x_self: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
    rs: torch.Tensor,
    out_dtype: torch.dtype,
    segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
    schedule: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel of :func:`csr_spmm_q8` on rows already quantised:
    ``out[i] = ((acc[i] * (s/127)) * rs[i]) + w_self[i] * x_self[i]`` with
    ``acc[i]`` the int32 sum of ``q[src_e]`` over the non-self edges into i
    and ``w_self[i]`` the sum of the self edges' ``weight``.

    q: [N, F] int8; s: 0-d float32 (read by the kernel from the device);
    x_self: [N, F] bfloat16; rs: [N] float32; weight: [E] float32, read at
    self edges only. ``segments`` and ``segment_edges``: the CSR's hub plan
    and its segment length, ``schedule`` its walk order, as in
    :func:`csr_spmm`; the integer sums make the result the same bit for bit
    in any order. The result is [N, F] of ``out_dtype`` (float32 or
    bfloat16). Plain version
    :func:`sgformer_tpu_torch.ops.spmm.spmm_q8_apply`. Runs the op
    ``sgformer_tpu_torch::csr_spmm_q8_apply``.
    """
    n = indptr.shape[0] - 1
    if q.dim() != 2 or q.shape[0] != n or x_self.shape != q.shape:
        raise ValueError(f"q and x_self must both be [{n}, F], got {tuple(q.shape)}, "
                         f"{tuple(x_self.shape)}")
    if q.dtype != torch.int8 or x_self.dtype != torch.bfloat16 or out_dtype not in _DTYPES:
        raise TypeError(f"q must be int8, x_self bfloat16 and the result float32 or "
                        f"bfloat16, got {q.dtype}, {x_self.dtype}, {out_dtype}")
    if rs.shape != (n,) or s.numel() != 1:
        raise ValueError(f"rs must be [{n}] and s one value")
    _segment_length(segments, segment_edges)
    _check_device(q, s, x_self, indptr, edge_src, edge_dst, weight, rs)
    _check_schedule(schedule, indptr)
    return _OPS.csr_spmm_q8_apply(q, s, x_self, indptr, edge_src, edge_dst, weight, rs,
                                  out_dtype, segments, segment_edges, schedule)


def csr_spmm_q8_apply_cuda(q, s, x_self, indptr, edge_src, edge_dst, weight, rs, out_dtype,
                           segments, segment_edges, schedule=None):
    """The CUDA implementation of the op :func:`csr_spmm_q8_apply` runs."""
    global q8_launches
    n = indptr.shape[0] - 1
    _check_csr(indptr, edge_src, weight=weight)
    for name, t in (("rs", rs), ("s", s)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor")
    q, x_self = q.contiguous(), x_self.contiguous()
    f = q.shape[1]
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if n and f:
        segments, length = _plan(segments, indptr, segment_edges)
        n_seg = segments.shape[0]
        part = torch.empty(n_seg, f, dtype=torch.int32, device=q.device) if n_seg else None
        wpart = torch.empty(n_seg, dtype=torch.float32, device=q.device) if n_seg else None
        err = _build.library("spmm").sgf_csr_spmm_q8(
            indptr.data_ptr(), edge_src.data_ptr(), weight.data_ptr(), q.data_ptr(),
            x_self.data_ptr(), rs.data_ptr(), s.data_ptr(), out.data_ptr(),
            segments.data_ptr() if n_seg else None, n_seg,
            part.data_ptr() if n_seg else None, wpart.data_ptr() if n_seg else None, length, n,
            f, _DTYPES[out_dtype], _aligned(f, q, x_self, out),
            schedule.data_ptr() if schedule is not None else None,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(err, "csr_spmm_q8")
        q8_launches += 1
    return out


def csr_spmm_q8(
    x: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    weight: torch.Tensor,
    rs: torch.Tensor,
    segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
    schedule: torch.Tensor | None = None,
) -> torch.Tensor:
    """The int8 GCN aggregation of a graph whose weights factor as
    ``weight[e] = rs[src_e] * rs[dst_e]`` (self edges aside):

    ``out[i] = rs[i] * (s/127) * sum_{e into i, src != i} q[src_e]
    + sum_{e into i, src == i} weight[e] * x_bf16[i]``

    with ``(q, s) = quantize_absmax(x, rs)``, the quantiser kernel (a device
    scalar s, no host sync), then the aggregation kernel: two ops,
    ``quantize_absmax`` and ``csr_spmm_q8_apply``. x: [N, F] float32 or
    bfloat16 (any F); the result has x's type. ``segments`` and
    ``segment_edges``: the CSR's hub plan and its segment length,
    ``schedule`` its walk order, as in :func:`csr_spmm`. On CPU tensors the two plain versions make the plain
    :func:`sgformer_tpu_torch.ops.spmm.spmm_q8`."""
    n = indptr.shape[0] - 1
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}, F], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _segment_length(segments, segment_edges)
    _check_device(x, indptr, edge_src, edge_dst, weight, rs)
    _check_schedule(schedule, indptr)
    q, s = quantize_absmax(x, rs)
    return csr_spmm_q8_apply(q, s, x.to(torch.bfloat16), indptr, edge_src, edge_dst, weight,
                             rs, x.dtype, segments, segment_edges, schedule)


def _check_ev_operands(g, x, n):
    if x.dim() != 3 or x.shape[0] != n or g.shape != x.shape:
        raise ValueError(f"g and x must both be [{n}, H, D], got {tuple(g.shape)}, "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"g and x must share a type, float32 or bfloat16, got {g.dtype}, "
                        f"{x.dtype}")


def sddmm(
    g: torch.Tensor,
    x: torch.Tensor,
    indptr: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
) -> torch.Tensor:
    """dv[e, h] = g[dst_e, h] . x[src_e, h] for every edge e of the CSR, in
    its edge order, f32.

    g, x: [N, H, D] of one type, float32 or bfloat16, each read as it is
    (x is not rounded to a message type); the products and sums are f32.
    Returns [E, H] float32. ``segments`` and ``segment_edges``: the CSR's
    hub plan and its segment length, as in :func:`csr_spmm`. On the card
    the dv mode of :func:`csr_spmm_ev_bwd`'s walk, with g held and x
    gathered: the same dots bit for bit. ``edge_dst`` is read only by the
    plain version.
    """
    global sddmm_launches
    n = indptr.shape[0] - 1
    _check_ev_operands(g, x, n)
    _segment_length(segments, segment_edges)
    if _check_device(g, x, indptr, edge_src, edge_dst) == "cpu":
        return sddmm_plain(g.float(), x.float(), edge_src, edge_dst)
    _check_csr(indptr, edge_src)
    g, x = g.contiguous(), x.contiguous()
    heads, d = x.shape[1], x.shape[2]
    dv = torch.empty(edge_src.shape[0], heads, dtype=torch.float32, device=x.device)
    if n and heads and d and edge_src.shape[0]:
        segments, length = _plan(segments, indptr, segment_edges)
        n_seg = segments.shape[0]
        err = _build.library("spmm").sgf_sddmm(
            indptr.data_ptr(), edge_src.data_ptr(), g.data_ptr(), x.data_ptr(), dv.data_ptr(),
            segments.data_ptr() if n_seg else None, n_seg, length, n, heads, d,
            _DTYPES[x.dtype], _aligned(d, g, x), torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "sddmm")
        sddmm_launches += 1
    elif d == 0:
        dv.zero_()
    return dv


def csr_spmm_ev_bwd(
    g: torch.Tensor,
    x: torch.Tensor,
    values: torch.Tensor,
    t_indptr: torch.Tensor,
    t_edge_src: torch.Tensor,
    t_edge_dst: torch.Tensor,
    t_perm: torch.Tensor,
    msg_dtype: torch.dtype,
    t_segments: torch.Tensor | None = None,
    segment_edges: int | None = None,
    need_dx: bool = True,
    need_dv: bool = True,
    t_schedule: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradient of ``out = csr_spmm_ev(x.to(msg_dtype), <CSR>, values,
    x.dtype)`` for the cotangent g, from one walk of the transposed CSR:

    - dx[s, h] = sum over the edges e' out of s of ``values[t_perm[e'], h]
      * g[t_edge_src[e'], h]`` with g rounded to ``msg_dtype``, f32 sums,
      in x's type (None unless ``need_dx``);
    - dv[e, h] = g[dst_e, h] . x[src_e, h] of the unrounded g and x, f32,
      [E, H] in the dst-sorted order (None unless ``need_dv``).

    g, x: [N, H, D] of one type, float32 or bfloat16; values: [E, H]
    float32 in the dst-sorted order; t_indptr [N+1], t_edge_src (the
    original destinations), t_edge_dst (the sources) and t_perm (the
    dst-sorted id of each edge) [E] int32: the graph's ``t_*`` arrays.
    ``t_segments`` and ``segment_edges``: the transposed CSR's hub plan and
    its segment length, ``t_schedule`` its walk order, as in
    :func:`csr_spmm`. On the card each edge's row of g is gathered once for
    both halves (one launch, and the hub rows' second pass when dx is asked
    for). ``t_edge_dst`` is read only by the plain version,
    :func:`sgformer_tpu_torch.ops.spmm.spmm_edge_values_backward`.
    """
    global ev_bwd_launches
    n = t_indptr.shape[0] - 1
    _check_ev_operands(g, x, n)
    if msg_dtype not in _DTYPES:
        raise TypeError(f"msg_dtype must be float32 or bfloat16, got {msg_dtype}")
    if values.dim() != 2 or values.shape[1] != x.shape[1]:
        raise ValueError(f"values must be [E, {x.shape[1]}], got {tuple(values.shape)}")
    _segment_length(t_segments, segment_edges)
    _check_schedule(t_schedule, t_indptr)
    if _check_device(g, x, values, t_indptr, t_edge_src, t_edge_dst, t_perm) == "cpu":
        return spmm_edge_values_backward_plain(g, x, values, t_edge_src, t_edge_dst, t_perm,
                                               msg_dtype, need_dx, need_dv)
    _check_csr(t_indptr, t_edge_src, values=values)
    if (t_perm.dtype != torch.int32 or t_perm.shape != t_edge_src.shape
            or not t_perm.is_contiguous()):
        raise TypeError("t_perm must be a contiguous int32 tensor of one entry per edge")
    g, x = g.contiguous(), x.contiguous()
    heads, d = x.shape[1], x.shape[2]
    dx = torch.empty_like(x) if need_dx else None
    dv = (torch.empty(values.shape, dtype=torch.float32, device=x.device) if need_dv
          else None)
    if n and heads and d and (need_dx or need_dv):
        segments, length = _plan(t_segments, t_indptr, segment_edges)
        n_seg = segments.shape[0]
        part = (torch.empty(n_seg, heads * d, dtype=torch.float32, device=x.device)
                if n_seg and need_dx else None)
        err = _build.library("spmm").sgf_csr_spmm_ev_bwd(
            t_indptr.data_ptr(), t_edge_src.data_ptr(), t_perm.data_ptr(), values.data_ptr(),
            x.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
            dv.data_ptr() if need_dv else None, segments.data_ptr() if n_seg else None, n_seg,
            part.data_ptr() if part is not None else None, length, n, heads, d,
            # the layout as sddmm picks it, from g and x (dx is a fresh
            # allocation), so that both modes give the same dv
            _DTYPES[x.dtype], int(x.dtype == torch.float32 and msg_dtype == torch.bfloat16),
            _aligned(d, g, x), t_schedule.data_ptr() if t_schedule is not None else None,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "csr_spmm_ev_bwd")
        ev_bwd_launches += 1
    elif need_dv and d == 0:
        dv.zero_()
    return dx, dv


class CsrSpmmFunction(torch.autograd.Function):
    """``A @ x`` with ``A^T @ g`` as its gradient, both through
    :func:`csr_spmm`. Only x gets a gradient; the CSR arrays get none. For
    a rectangular A ([rows, num_cols]) the transposed CSR has num_cols rows,
    so the gradient has x's shape."""

    @staticmethod
    def forward(ctx, x, indptr, edge_src, edge_dst, weight, segments,
                t_indptr, t_edge_src, t_edge_dst, t_weight, t_segments, segment_edges,
                schedule, t_schedule):
        ctx.transpose = (t_indptr, t_edge_src, t_edge_dst, t_weight, t_segments, segment_edges,
                         indptr.shape[0] - 1, t_schedule)
        return csr_spmm(x, indptr, edge_src, edge_dst, weight, segments, segment_edges,
                        t_indptr.shape[0] - 1, schedule)

    @staticmethod
    def backward(ctx, g):
        dx = csr_spmm(g.contiguous(), *ctx.transpose)
        return (dx,) + (None,) * 13


def csr_spmm_autograd(x: torch.Tensor, csr: tuple, csr_t: tuple,
                      segments: torch.Tensor | None = None,
                      t_segments: torch.Tensor | None = None,
                      segment_edges: int | None = None,
                      schedule: torch.Tensor | None = None,
                      t_schedule: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`csr_spmm` of ``x`` on ``csr`` = (indptr, edge_src, edge_dst,
    weight), differentiable in x; ``csr_t`` is the CSR of A^T in the same
    form (``csr`` itself when A is symmetric; num_cols rows when A is
    rectangular); ``segments`` and
    ``t_segments`` are their hub plans, both of segments of
    ``segment_edges`` (built from indptr when None), ``schedule`` and
    ``t_schedule`` their walk orders (None: row order). Where autograd does
    not record (``torch.no_grad``, ``torch.inference_mode``, or x needs no
    gradient) it is one :func:`csr_spmm` and saves nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return CsrSpmmFunction.apply(x, *csr, segments, *csr_t, t_segments, segment_edges,
                                     schedule, t_schedule)
    return csr_spmm(x, *csr, segments, segment_edges, csr_t[0].shape[0] - 1, schedule)


class CsrSpmmEdgeValuesFunction(torch.autograd.Function):
    """Per-head ``A_v @ x`` with runtime edge values v, differentiable in x
    and v, as the JAX package's ``_spmm_ev_core`` custom VJP:

    - forward: :func:`csr_spmm_ev` of x rounded to the message type;
    - backward: one :func:`csr_spmm_ev_bwd` on the transposed CSR: dx from g
      in the message type with ``v[t_perm]`` as its values, in x's type,
      and dv from g and the x the forward received (not its rounded copy),
      f32, in the CSR's edge order.
    """

    @staticmethod
    def forward(ctx, x, values, indptr, edge_src, edge_dst, segments,
                t_indptr, t_edge_src, t_edge_dst, t_perm, t_segments, segment_edges,
                msg_dtype, schedule, t_schedule):
        ctx.save_for_backward(x, values)
        ctx.csr_t = (t_indptr, t_edge_src, t_edge_dst, t_perm)
        ctx.t_plan = (t_segments, segment_edges)
        ctx.t_schedule = t_schedule
        ctx.msg_dtype = msg_dtype
        return csr_spmm_ev(x.to(msg_dtype), indptr, edge_src, edge_dst, values, x.dtype,
                           segments, segment_edges, schedule)

    @staticmethod
    def backward(ctx, g):
        x, values = ctx.saved_tensors
        dx, dv = csr_spmm_ev_bwd(g, x, values, *ctx.csr_t, ctx.msg_dtype, *ctx.t_plan,
                                 ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                                 ctx.t_schedule)
        return (dx, dv) + (None,) * 13


def csr_spmm_ev_autograd(x: torch.Tensor, values: torch.Tensor, csr: tuple,
                         csr_t: tuple, msg_dtype: torch.dtype,
                         segments: torch.Tensor | None = None,
                         t_segments: torch.Tensor | None = None,
                         segment_edges: int | None = None,
                         schedule: torch.Tensor | None = None,
                         t_schedule: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`csr_spmm_ev` of x ([N, H, D]) rounded to ``msg_dtype``, with
    ``values`` ([E, H] f32) on ``csr`` = (indptr, edge_src, edge_dst); the
    result has x's type. Differentiable in x and values; ``csr_t`` =
    (t_indptr, t_edge_src, t_edge_dst, t_perm) is the transposed CSR and the
    permutation that takes the values into its order; ``segments`` and
    ``t_segments`` the two CSRs' hub plans, both of segments of
    ``segment_edges`` (built from indptr when None), ``schedule`` and
    ``t_schedule`` their walk orders. Where autograd does not record it is
    one :func:`csr_spmm_ev` and saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or values.requires_grad):
        return CsrSpmmEdgeValuesFunction.apply(x, values, *csr, segments, *csr_t, t_segments,
                                               segment_edges, msg_dtype, schedule, t_schedule)
    return csr_spmm_ev(x.to(msg_dtype), *csr, values, x.dtype, segments, segment_edges,
                       schedule)


class CsrSpmmQ8Function(torch.autograd.Function):
    """The int8 ``A @ x`` with its gradient as the JAX package's
    ``_slab_core`` custom VJP defines it on an int8 plan: the backward
    quantises g with its own absmax, pre-scaled by the same ``rs`` (the
    transposed weights factor the same way), and runs :func:`csr_spmm_q8` on
    the transposed CSR (A's own when A is symmetric) with its hub plan and
    walk order. Only x gets a gradient."""

    @staticmethod
    def forward(ctx, x, indptr, edge_src, edge_dst, weight, segments,
                t_indptr, t_edge_src, t_edge_dst, t_weight, t_segments, rs, segment_edges,
                schedule, t_schedule):
        ctx.transpose = (t_indptr, t_edge_src, t_edge_dst, t_weight, rs, t_segments,
                         segment_edges, t_schedule)
        return csr_spmm_q8(x, indptr, edge_src, edge_dst, weight, rs, segments, segment_edges,
                           schedule)

    @staticmethod
    def backward(ctx, g):
        dx = csr_spmm_q8(g.contiguous(), *ctx.transpose)
        return (dx,) + (None,) * 14


def csr_spmm_q8_autograd(x: torch.Tensor, csr: tuple, csr_t: tuple, rs: torch.Tensor,
                         segments: torch.Tensor | None = None,
                         t_segments: torch.Tensor | None = None,
                         segment_edges: int | None = None,
                         schedule: torch.Tensor | None = None,
                         t_schedule: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`csr_spmm_q8` of ``x`` on ``csr`` = (indptr, edge_src,
    edge_dst, weight) with the separable factor ``rs``, differentiable in x;
    ``csr_t`` is the CSR of A^T in the same form (``csr`` itself when A is
    symmetric); ``segments`` and ``t_segments`` their hub plans, both of
    segments of ``segment_edges`` (built from indptr when None),
    ``schedule`` and ``t_schedule`` their walk orders (None: row order).
    Where autograd does not record it is one :func:`csr_spmm_q8` and saves
    nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return CsrSpmmQ8Function.apply(x, *csr, segments, *csr_t, t_segments, rs,
                                       segment_edges, schedule, t_schedule)
    return csr_spmm_q8(x, *csr, rs, segments, segment_edges, schedule)
