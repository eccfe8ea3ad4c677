"""The benchmark's frozen yardstick: the card's published peaks, the least
time a piece of work allows, the operations and bytes of the SGFormer step,
its SpMM and its linear-attention kernels, and the statistics the metrics
take. Nothing here imports the program: a later change to the program
cannot move the yardstick.

Peaks (NVIDIA H100 SXM data sheet, dense, 700 W): HBM3 at 3.35 TB/s;
bf16 989 TFLOP/s; int8 1,979 TOP/s; f32 at the 3xTF32 rate, three TF32
tensor-core products of 495 TFLOP/s for each f32-accurate one (165
TFLOP/s), above the 67 TFLOP/s of f32 FMAs on the CUDA cores, so that no
f32 kernel can beat its bound.

Counting rule: each input byte is read once and each output byte written
once, whatever a kernel reads again; operations are the algorithm's (two
for a multiply-add), not those of a kernel's split of its operands.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def least_time_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the work takes on the card: the larger of the bytes
    over the HBM rate and the operations over the peak of ``dtype``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# -- the CSR SpMM: out = A @ x ------------------------------------------------


def spmm_bytes(n_rows: int, n_cols: int, nnz: int, width: int, dtype: str) -> int:
    """x's rows read once, the CSR's row pointers, source ids and weights
    read once, the output written once."""
    e = ELEMENT_BYTES[dtype]
    return n_cols * width * e + n_rows * width * e + (n_rows + 1) * 4 + nnz * (4 + 4)


def spmm_flops(nnz: int, width: int) -> int:
    return 2 * nnz * width


def spmm_least_s(n: int, nnz: int, width: int, dtype: str) -> float:
    """One square aggregation (n x n, nnz edges) at ``width`` columns."""
    return least_time_s(spmm_bytes(n, n, nnz, width, dtype), spmm_flops(nnz, width), dtype)


# -- SGFormer's linear attention (one head, n rows, q/k width m, v width d) ----

_SMALL = 4  # the four f32 scalars (|q|^2, |k|^2, inv, n)


def attention_reduce(n: int, m: int, d: int, dtype: str) -> tuple[int, int]:
    """kvs = k^T v, ksum, |q|^2 and |k|^2: reads q, k, v; writes kvs, ksum
    and the scalars (f32)."""
    e = ELEMENT_BYTES[dtype]
    nbytes = n * (2 * m + d) * e + (m * d + m + _SMALL) * 4
    return nbytes, 2 * n * m * d + 3 * n * m


def attention_apply(n: int, m: int, d: int, dtype: str) -> tuple[int, int]:
    """(inv q @ kvs + n v) / (inv q . ksum + n): reads q, v, kvs, ksum;
    writes the output."""
    e = ELEMENT_BYTES[dtype]
    nbytes = n * (m + 2 * d) * e + (m * d + m + _SMALL) * 4
    return nbytes, 2 * n * m * d + 2 * n * m + 4 * n * d


def attention_bwd_reduce(n: int, m: int, d: int, dtype: str) -> tuple[int, int]:
    """The backward's node sums: q @ kvs and q^T (g / den) with their row
    and column sums; reads q, v, g, kvs, ksum; writes P, ds, the scalar
    gradient and two f32 values a row."""
    e = ELEMENT_BYTES[dtype]
    nbytes = n * (m + 2 * d) * e + (2 * m * d + 2 * m + 2 * _SMALL) * 4 + 2 * n * 4
    return nbytes, 4 * n * m * d + 6 * n * d + 2 * n * m


def attention_bwd_apply(n: int, m: int, d: int, dtype: str) -> tuple[int, int]:
    """dq = gd @ kvs^T, dk = v @ P^T, dv = k @ P and their epilogues; reads
    q, k, v, g and two f32 values a row, kvs, P, ksum, ds; writes dq, dk,
    dv."""
    e = ELEMENT_BYTES[dtype]
    nbytes = (n * (2 * m + 2 * d) * e + 2 * n * 4 + (2 * m * d + 2 * m + 2 * _SMALL) * 4
              + n * (2 * m + d) * e)
    return nbytes, 6 * n * m * d + 8 * n * m + 3 * n * d


def attention_least_s(n: int, m: int, d: int, dtype: str, backward: bool) -> float:
    """Least time of one head's forward (reduce + apply), and with
    ``backward`` also of its backward reduce and apply."""
    parts = [attention_reduce, attention_apply]
    if backward:
        parts += [attention_bwd_reduce, attention_bwd_apply]
    return sum(least_time_s(*p(n, m, d, dtype), dtype) for p in parts)


# -- the whole SGFormer step ---------------------------------------------------


def sgformer_forward_flops(model: dict, in_channels: int, n: int, nnz: int) -> int:
    """The forward's operations on n rows and nnz edges: every dense layer
    (2 n in out), the attention's two products (k^T v and q @ kvs, 2 n m d
    each) and each GCN aggregation (2 nnz F). Norms, activations and the
    loss are not counted."""
    h = model["hidden_channels"]
    heads = model.get("trans_num_heads", 1)
    hd = h * heads
    flops = 2 * n * in_channels * h  # attention branch's input layer
    for _ in range(model["trans_num_layers"]):
        flops += 3 * 2 * n * h * hd  # Wq, Wk, Wv
        flops += heads * 2 * (2 * n * h * h)  # k^T v and q @ kvs
    if model.get("gnn", "graphconv") == "graphconv":
        flops += 2 * n * in_channels * h  # GNN branch's input layer
        w_in = 2 * h if model.get("gnn_use_init", False) else h
        for _ in range(model["gnn_num_layers"]):
            flops += spmm_flops(nnz, h) + 2 * n * w_in * h
    fc_in = 2 * h if model.get("aggregate", "add") == "cat" else h
    flops += 2 * n * fc_in * model["out_channels"]
    return flops


def sgformer_train_flops(model: dict, in_channels: int, n: int, nnz: int) -> int:
    """A train step: the forward and a backward counted as twice it."""
    return 3 * sgformer_forward_flops(model, in_channels, n, nnz)


# -- statistics ----------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all of ``values``, interpolated
    linearly between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))

