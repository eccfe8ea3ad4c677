// SGFormer linear attention for Hopper (sm_90a), backward, one head per call.
//
// Forward (linear_attention.cu): a = q @ kvs, b = q . ksum, den = inv*b + n,
// num = inv*a + n*v, out = num / den, with kvs = k^T v, ksum = sum_n k and
// inv = 1 / (||q|| * ||k||). Given g = dL/dout:
//
//   gd = g / den,  gden = -sum_d(g * num) / den^2            (per row)
//   P = q^T gd [M, D],  ds = sum_n q * gden [M],  dinv = sum gd*a + sum gden*b
//   dq = inv * gd @ kvs^T + inv * gden * ksum - dinv * inv / ||q||^2 * q
//   dk = inv * v @ P^T + inv * ds - dinv * inv / ||k||^2 * k
//   dv = n * gd + inv * k @ P
//
// Replaces sgformer_tpu/kernels/attention.py::_bwd_reduce_kernel (bwd reduce)
// and ::_bwd_apply_kernel (bwd apply). The TPU kernels carry P, ds and dinv
// across sequential grid steps in VMEM; Hopper blocks run in parallel and in
// no order, so the reduce is split:
//   1. la_bwd_rows_kernel: one block per 64 rows forms a = q @ kvs tile by
//      tile and reduces it at once to sum_d g*a per row, with b and sum_d g*v;
//      it writes den and gden per row (8 bytes a row) and a per-block f64
//      partial of dinv;
//   2. la_bwd_reduce_kernel: blocks over disjoint node slices write f32
//      partials of P = q^T (g/den) and f64-accumulated partials of ds;
//   3. la_bwd_finish_kernel adds the P and ds partials in slice order and
//      la_bwd_dinv_kernel adds the dinv partials in a fixed f64 tree.
// No atomics anywhere, so repeated calls give bitwise-equal gradients.
// The apply reads den and gden from the reduce instead of recomputing
// a = q @ kvs: three [rows x K] x [K x 64] products per node block instead of
// the Pallas kernel's four.
//
// Differences from the Pallas kernels, on purpose:
// - gd, kvs and P stay f32 into the products; the Pallas backward rounds
//   them to the input type first (kernels/attention.py:234-249).
// - With a node mask (guard = 1) the forward's guard carries over: inv = 0
//   for a zero norm, so the dinv * inv / ||.||^2 terms are 0 (not 0/0), and
//   a zero den is taken as 1 with gden = 0, as autograd of the guarded plain
//   path gives. The Pallas backward has no guard (kernels/attention.py:213).
//
// Bound: memory in bf16. At the arxiv shape (N = 169,343, M = D = 256) the
// reduce must read q, v, g (260 MB, 78 us at 3.35 TB/s) and the apply must
// read q, k, v, g and write dq, dk, dv (607 MB, 181 us); the products are
// 2 and 3 times 2*N*M*D = 22.2 GFLOP. In f32 the bytes double and the
// products bound both passes: at the 3xTF32 rate (three TF32 products at
// 495 TFLOP/s, 165 TFLOP/s of f32 products) ~0.27 and ~0.40 ms. The
// CUDA-core kernels below (la_bwd_rows_kernel, la_bwd_reduce_kernel,
// la_bwd_apply_kernel: 64x64 output tiles, 4x4 per thread, f32 FMAs from
// shared memory, 8 shared loads for 16 FMAs) are bound by the shared-memory
// rate, well under the 67 TFLOP/s FMA peak, and the apply's grid reads each
// row block of q, k, v and g once per 64-column output tile. They remain
// for widths the tensor-core tiles do not fit (above M, D = 256 in f32).
//
// The bf16 backward runs its products on the tensor cores by warpgroup MMAs
// (wgmma m64nNk16 bf16, f32 sums), both operands read through descriptors
// from 128-byte-swizzled shared memory. Each kernel is warp-specialised: a
// producer warp or warpgroup issues every copy by the copy engine (TMA:
// tensor maps of the row-strided inputs, bulk copies of the split operands,
// which their split kernels lay out already swizzled), two consumer
// warpgroups of 64 rows run the MMAs and the epilogues, and mbarriers hand
// each stage of a ring over. (Copies issued by the warps that also ran the
// MMAs stalled them: an SM takes new copies only as fast as device memory
// returns the old ones, and that, not the MMAs, set these kernels' time.)
// - the apply (la_bwd_apply_ws16_kernel; la_bwd_apply_wgmma_kernel for M or
//   D above 256): the A side is the bf16 input rows as they are (g, v, k;
//   the 1/den of gd = g/den moves into the epilogue); the B side, kvs and P,
//   stays f32 in meaning: each is split once per call
//   (la_bwd_split_tiles_kernel) into bf16 hi + lo (hi = bf16(x), lo =
//   bf16(x - hi), ~16 significant bits) and every product is two MMAs, so
//   the error is ~2^-17 of each term against f32 FMAs. Persistent over
//   (256-row block, product) items, each B chunk serving the item's 256
//   rows, the item's A rows in slots that the item before frees, the B
//   chunks and the epilogue operand through one ring; a finished tile is
//   written through shared memory and stored by the copy engine. (The
//   kernel above 256, one block a 128-row block, streams its A rows and B
//   pieces together in 64-deep chunks.) The products, 6 x 22.2 GFLOP at the
//   arxiv shape, are ~0.13 ms at the card's bf16 peak, under the bytes
//   bound;
// - the reduce's rows pass (la_bwd_rows_ws16_kernel) forms a = q @ kvs from
//   the q rows and kvs^T split into three bf16 pieces, hi + mid + lo, by
//   la_bwd_split_rows_kernel (three MMAs a product, each k16 step into fresh
//   sums added in f32 round-to-nearest: dinv's sums cancel, and two pieces
//   left it 1.3e-5 of its size off); each 64-column tile of a is folded at
//   once into sum_d g*a and sum_d g*v per row, so a never leaves the
//   registers, and the pass writes den, gden and the f64 dinv partial as
//   the CUDA-core pass does; persistent, the next row block's q rows
//   landing under this one's last column tile;
// - the P pass (la_bwd_reduce_ws16_kernel) forms P = q^T (g/den) over node
//   slices with both operands node-major (the MMAs read them transposed:
//   MN-major descriptors, which 16-bit operands allow): q as it is, gd = g *
//   (1/den) formed in f32 as each chunk lands and split into bf16 hi + lo,
//   once for all the m rows of a block's tile, two MMAs a product, fresh
//   sums every 32 rows, software-pipelined so that a chunk's MMAs run under
//   the next chunk's split; ds keeps its per-slice f64 sums on the producer
//   warpgroup's spare warps; persistent over (slice, tile) items.
// The first wgmma kernels of both passes (one block a row block or tile,
// nothing of one block's loads under another's work, ds on the consumers of
// a quarter of the blocks) ran at 3.2x and 4.1x their bounds (PERF.md).
// These replaced mma.sync m16n8k16 kernels (ldmatrix fragments, one B
// fragment load and MMA for each 16 x 8 x 16 product), which ran the
// products at 13-19 % of the bf16 peak (PERF.md). a is recomputed from q and
// kvs, as the TPU kernel does, rather than taken from the forward's bf16
// output (num = out * den), which would move gden by ~2^-9. Passes 3
// (finish, dinv) are the CUDA-core design's.
//
// The f32 forms run the same designs on the tensor cores in 3xTF32: each
// f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna),
// and each product is lo*hi' + hi*lo' + hi*hi' (lo*lo' dropped), ~2^-21 of
// each term against the bf16 pieces' 2^-17. What bounds them is the
// products: three TF32 products for each f32-accurate one, at the card's
// 495 TFLOP/s of TF32 (165 TFLOP/s of f32 products; ~0.27 and ~0.40 ms at
// the arxiv shape). On mma.sync m16n8k8 they ran at 20-27 % of that bound:
// MMA issue held them back, three MMAs and two B fragment loads for each
// 16 x 8 x 8 product, and the split of each A fragment reused over a warp
// tile's 32 columns. The rows pass and the apply run them on warpgroup
// MMAs (wgmma m64n64k8 tf32, A from registers): each warp's fragments are
// split into tf32 hi + lo as they load from 128-byte-swizzled f32 atoms
// and feed the MMAs over 64 output columns; the B operand is split once a
// call into tf32 hi + lo atoms that bulk copies stream through a ring, and
// each wgmma reads it through a descriptor (the f32 kernels' dynamic
// shared memory starts 1024-byte aligned: they have no static shared
// memory). Every 16 deep the products go into fresh sums (scale-d = 0)
// added to the running sums in f32 round-to-nearest, so that the tensor
// cores' own accumulation, which may truncate, never chains more than one
// such step. Both are warp-specialised, fed by the copy engine and
// persistent, their A rows streamed into slots that the row block or item
// before frees atom by atom (la_bwd_rows_ws_kernel, la_bwd_apply_ws_kernel,
// below); the kernels they replaced staged A by the MMA warps' own copies
// and overlapped nothing (PERF.md).
// The P pass (la_bwd_reduce_wg_kernel) is
// the f32 forward reduce's design on wgmma m64n128k8 tf32, warp-specialised
// and fed by the copy engine (tensor_core.cuh's rd_produce and
// rd_consume_tf32): q^T from registers, split as its fragments load from
// the node-major atoms, and gd = g * (1/den) formed as each chunk of g is
// split K-major into tf32 hi + lo (tf32 wgmma reads no transposed 32-bit
// operand), ds on the producer warpgroup's spare warps. It replaced an
// mma.sync m16n8k8 kernel whose copies and MMAs ran in turn on the same
// warps (PERF.md). Two tf32 pieces of kvs keep dinv's cancelling sums where
// the bf16 rows pass needs three bf16 pieces.
//
// Inputs are row-strided views (ld* = elements between rows), so the heads
// of an [N, H, *] tensor are read and written in place.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

using tc::split_tf32;
using tc::kPadOf;
using tc::kTcCols;
using tc::kTcRows;

constexpr int kTile = 64;      // output tile (rows x columns)
constexpr int kRows = 32;      // contraction depth per shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid (ceil(N/64)). Block bx owns rows [64*bx, 64*bx+64): it forms
// a = q @ kvs one 64-column tile at a time (q slab stored transposed) and
// folds each tile into sum_d g*a and sum_d g*v per row at once, so a never
// leaves registers. The first 64 threads also form b = q . ksum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
la_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ g,
                   long ldq, long ldv, long ldg, int N, int M, int D,
                   const float* __restrict__ kvs, const float* __restrict__ ksum,
                   const float* __restrict__ scal, const float* __restrict__ n_total, int guard,
                   float* __restrict__ den_out, float* __restrict__ gden_out,
                   double* __restrict__ dinv_part) {
  __shared__ __align__(16) float qt[kRows][kTile + 4];  // [m][row]
  __shared__ __align__(16) float kv[kRows][kTile];      // [m][col]
  __shared__ float b_s[kTile];
  __shared__ float ga_s[kTile];
  __shared__ float gv_s[kTile];
  __shared__ double red[kTile];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long r0 = static_cast<long>(blockIdx.x) * kTile;

  float ga[4] = {0.f, 0.f, 0.f, 0.f};
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
  float b = 0.f;
  for (int d0 = 0; d0 < D; d0 += kTile) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < M; k0 += kRows) {
      for (int i = tid; i < kTile * kRows; i += kThreads) {
        const int r = i / kRows;  // q: consecutive threads walk along m
        const int c = i % kRows;
        const long row = r0 + r;
        qt[c][r] = (row < N && k0 + c < M) ? to_float(q[row * ldq + k0 + c]) : 0.f;
        const int kr = i / kTile;  // kvs: consecutive threads walk along d
        const int kc = i % kTile;
        kv[kr][kc] = (k0 + kr < M && d0 + kc < D)
                         ? kvs[static_cast<size_t>(k0 + kr) * D + d0 + kc]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kRows; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(&qt[c][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&kv[c][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (d0 == 0 && tid < kTile) {
        for (int c = 0; c < kRows && k0 + c < M; ++c) b = fmaf(qt[c][tid], ksum[k0 + c], b);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = r0 + ty * 4 + i;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx * 4 + j;
        if (d < D) {
          const float gf = to_float(g[row * ldg + d]);
          ga[i] = fmaf(gf, acc[i][j], ga[i]);
          gv[i] = fmaf(gf, to_float(v[row * ldv + d]), gv[i]);
        }
      }
    }
  }
  // the 16 threads of one ty hold one row group: lanes 0-15 or 16-31 of a
  // warp, so a fixed xor tree inside each half-warp sums across columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      ga[i] += __shfl_xor_sync(0xffffffffu, ga[i], off);
      gv[i] += __shfl_xor_sync(0xffffffffu, gv[i], off);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ga_s[ty * 4 + i] = ga[i];
      gv_s[ty * 4 + i] = gv[i];
    }
  }
  if (tid < kTile) b_s[tid] = b;
  __syncthreads();

  if (tid < kTile) {
    const long row = r0 + tid;
    double part = 0.0;
    if (row < N) {
      const float inv = scal[2];
      const float n = *n_total;
      const float bb = b_s[tid];
      const float s_ga = ga_s[tid];
      float den = inv * bb + n;
      float gden;
      if (guard && den == 0.f) {
        den = 1.f;
        gden = 0.f;
      } else {
        gden = -(inv * s_ga + n * gv_s[tid]) / (den * den);
      }
      den_out[row] = den;
      gden_out[row] = gden;
      part = static_cast<double>(s_ga / den) + static_cast<double>(gden * bb);
    }
    red[tid] = part;
  }
  __syncthreads();
  for (int stride = kTile / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) dinv_part[blockIdx.x] = red[0];
}

// grid (ceil(M/64), ceil(D/64), slices). Block (mx, dy, s) sums its 64x64
// tile of P = q^T (g/den) over rows [s*rows_per_slice, (s+1)*rows_per_slice).
// Blocks with dy == 0 also sum ds = q . gden per column of their M tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
la_bwd_reduce_kernel(const T* __restrict__ q, const T* __restrict__ g, long ldq, long ldg, int N,
                     int M, int D, int rows_per_slice, const float* __restrict__ den,
                     const float* __restrict__ gden, float* __restrict__ P_part,
                     float* __restrict__ ds_part) {
  __shared__ __align__(16) float qs[kRows][kTile];
  __shared__ __align__(16) float gs[kRows][kTile];
  __shared__ float den_s[kRows];
  __shared__ float gden_s[kRows];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const bool stats = blockIdx.y == 0;
  const long r_begin = static_cast<long>(s) * rows_per_slice;
  const long r_stop = r_begin + rows_per_slice;
  const long r_end = r_stop < N ? r_stop : static_cast<long>(N);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  double ds = 0.0;

  for (long r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (tid < kRows) {
      const long row = r0 + tid;
      den_s[tid] = row < r_end ? den[row] : 1.f;
      gden_s[tid] = row < r_end ? gden[row] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile;
      const int c = i % kTile;
      const long row = r0 + r;
      const bool row_ok = row < r_end;
      qs[r][c] = (row_ok && m0 + c < M) ? to_float(q[row * ldq + m0 + c]) : 0.f;
      gs[r][c] = (row_ok && d0 + c < D) ? to_float(g[row * ldg + d0 + c]) / den_s[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (stats && tid < kTile) {
      for (int r = 0; r < kRows; ++r) {
        ds = fma(static_cast<double>(qs[r][tid]), static_cast<double>(gden_s[r]), ds);
      }
    }
    __syncthreads();
  }

  const size_t MD = static_cast<size_t>(M) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (m < M && d < D) P_part[s * MD + static_cast<size_t>(m) * D + d] = acc[i][j];
    }
  }
  if (stats && tid < kTile && m0 + tid < M) {
    ds_part[static_cast<size_t>(s) * M + m0 + tid] = static_cast<float>(ds);
  }
}

// P and ds are their partials added in slice order.
__global__ void la_bwd_finish_kernel(const float* __restrict__ P_part,
                                     const float* __restrict__ ds_part, int slices, int M, int D,
                                     float* __restrict__ P, float* __restrict__ ds) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t MD = static_cast<size_t>(M) * D;
  if (idx < MD) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += P_part[s * MD + idx];
    P[idx] = t;
  }
  if (idx < static_cast<size_t>(M)) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += ds_part[static_cast<size_t>(s) * M + idx];
    ds[idx] = t;
  }
}

// dinv: the per-block partials in a fixed-order f64 tree, one block.
__global__ void __launch_bounds__(kThreads)
la_bwd_dinv_kernel(const double* __restrict__ part, int count, float* __restrict__ dinv) {
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  double t = 0.0;
  for (int i = tid; i < count; i += kThreads) t += part[i];
  red[tid] = t;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) *dinv = static_cast<float>(red[0]);
}

// grid (ceil(N/64), 2*ceil(M/64) + ceil(D/64)). Block (bx, y) computes rows
// [64*bx, 64*bx+64) of one 64-column tile of dq (y in the first ceil(M/64)),
// dk (the next ceil(M/64)) or dv (the rest):
//   dq: (g/den) @ kvs^T, contraction over D;  dk: v @ P^T, over D;
//   dv: k @ P, over M;
// then the per-row and per-column terms in the epilogue.
template <typename T>
__global__ void __launch_bounds__(kThreads)
la_bwd_apply_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, long ldq, long ldk, long ldv, long ldg,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, long lddq,
                    long lddk, long lddv, int N, int M, int D, const float* __restrict__ kvs,
                    const float* __restrict__ ksum, const float* __restrict__ P,
                    const float* __restrict__ ds, const float* __restrict__ scal,
                    const float* __restrict__ n_total, const float* __restrict__ dinv,
                    const float* __restrict__ den, const float* __restrict__ gden, int guard) {
  __shared__ __align__(16) float at[kRows][kTile + 4];  // [kk][row]
  __shared__ __align__(16) float bs[kRows][kTile + 4];  // [kk][col]
  __shared__ float den_s[kTile];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long r0 = static_cast<long>(blockIdx.x) * kTile;
  const int tiles_m = (M + kTile - 1) / kTile;
  int which = 2;
  int c0 = (static_cast<int>(blockIdx.y) - 2 * tiles_m) * kTile;
  if (static_cast<int>(blockIdx.y) < tiles_m) {
    which = 0;
    c0 = blockIdx.y * kTile;
  } else if (static_cast<int>(blockIdx.y) < 2 * tiles_m) {
    which = 1;
    c0 = (blockIdx.y - tiles_m) * kTile;
  }
  const int K = which == 2 ? M : D;  // contraction depth
  const int C = which == 2 ? D : M;  // output width
  const T* A = which == 0 ? g : (which == 1 ? v : k);
  const long lda = which == 0 ? ldg : (which == 1 ? ldv : ldk);

  if (tid < kTile) den_s[tid] = r0 + tid < N ? den[r0 + tid] : 1.f;
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kRows) {
    for (int i = tid; i < kTile * kRows; i += kThreads) {
      const int r = i / kRows;  // A: consecutive threads walk along kk
      const int c = i % kRows;
      const long row = r0 + r;
      float a = (row < N && k0 + c < K) ? to_float(A[row * lda + k0 + c]) : 0.f;
      if (which == 0) a /= den_s[r];  // gd = g / den, as the plain version
      at[c][r] = a;
      float bval = 0.f;
      if (which == 2) {
        const int kr = i / kTile;  // P [M, D]: consecutive threads walk along d
        const int kc = i % kTile;
        if (k0 + kr < K && c0 + kc < C) bval = P[static_cast<size_t>(k0 + kr) * D + c0 + kc];
        bs[kr][kc] = bval;
      } else {
        // kvs^T or P^T: element (kk, c) is X[c, kk] of the [M, D] matrix;
        // consecutive threads walk along kk, the contiguous dimension of X
        const int kc = i / kRows;
        const int kr = i % kRows;
        const float* X = which == 0 ? kvs : P;
        if (k0 + kr < K && c0 + kc < C) bval = X[static_cast<size_t>(c0 + kc) * D + k0 + kr];
        bs[kr][kc] = bval;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kRows; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&at[c][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[c][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float inv = scal[2];
  const float n = *n_total;
  // the guard: a zero norm gives inv = 0 and no dinv term
  const bool no_norm = guard && inv == 0.f;
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = r0 + ty * 4 + i;
    if (row >= N) continue;
    const float gden_r = which == 0 ? gden[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= C) continue;
      if (which == 0) {
        const float val = inv * acc[i][j] + inv * gden_r * ksum[c] -
                          c_q * to_float(q[row * ldq + c]);
        dq[row * lddq + c] = from_float<T>(val);
      } else if (which == 1) {
        const float val = inv * acc[i][j] + inv * ds[c] - c_k * to_float(k[row * ldk + c]);
        dk[row * lddk + c] = from_float<T>(val);
      } else {
        const float gd = to_float(g[row * ldg + c]) / den_s[ty * 4 + i];
        dv[row * lddv + c] = from_float<T>(n * gd + inv * acc[i][j]);
      }
    }
  }
}

constexpr int kTcK = 64;  // the split operands' k padding
using tc::kSmemPerBlock;

// The f32 (3xTF32) forms take widths up to kWgMaxK (their A rows staged
// whole, 32 f32 deep an atom, beside their B ring and operand tiles).
constexpr int kWgMaxK = 256;
template <typename T>
constexpr bool kIsF32 = std::is_same_v<T, float>;

// The padded extents of the widths: D and M padded to kTcK as depths, D to
// kTcCols as the rows pass's kvs^T columns ([n = D][k = M]).
struct TcDims {
  int Dk, Dn, Mk;
  __host__ __device__ TcDims(int M, int D)
      : Dk((D + kTcK - 1) / kTcK * kTcK), Dn((D + kTcCols - 1) / kTcCols * kTcCols),
        Mk((M + kTcK - 1) / kTcK * kTcK) {}
  __host__ __device__ size_t pt_elems() const { return static_cast<size_t>(Dn) * Mk; }
};

static_assert(kTcCols == tc::kSplitPad && kTcK == tc::kSplitPad,
              "the bf16 rows pass's kvs^T is tensor_core.cuh's split layout");
using tc::split_store;

// The bf16 rows pass splits kvs into three pieces: a = q @ kvs feeds dinv's
// sum sum gd*a, which cancels with sum gden*b to ~1/10 of its terms at the
// arxiv shape, and the ~2^-17 of hi + lo then leaves dinv ~1.3e-5 of its
// size off the f64 plain version (the CUDA-core kernel's f32 sums: 8.5e-7).
// The f32 rows pass splits it into tf32 hi + lo (tc::split_kvs_kernel),
// each product 3xTF32 (~2^-21).
constexpr int kRowsPieces = 3;

// ---------------------------------------------------------------------------
// The f32 rows pass in 3xTF32 on warpgroup MMAs (wgmma m64n64k8 tf32, A from
// registers), warp-specialised, fed by the copy engine (TMA) and
// persistent: grid min(ceil(N / 128), SMs), one block an SM, block b taking
// the 128-row blocks b, b + grid, ... in turn. It replaces, with the P pass,
// sgformer_tpu/kernels/attention.py::_bwd_reduce_kernel for f32 rows: per
// row a = q @ kvs, folded at once into sum_d g*a, with b = q . ksum and
// sum_d g*v, then den, gden and the block's f64 partial of dinv, as
// la_bwd_rows_kernel computes them. Bound by its bytes (q, v and g read
// once: 0.156 ms at the arxiv shape; its three TF32 products 0.135). Two
// consumer warpgroups of 64 rows and a producer warpgroup, which gives its
// registers to the consumers (setmaxnreg). Dynamic shared memory, 1024-byte
// aligned (no static shared memory, so the dynamic block starts the
// block's window), every tile 128-byte swizzled over f32 rows of 32
// (tc::sw128_offset_f32): a row block's q rows as ka = ceil(M / 32) slots of
// one k atom each ([128 rows][32], 16 KB; 128 KB at M = 256); a ring of
// kRwStages chunks of kvs^T, each the tf32 hi and lo [64 n][32 k] atoms of
// one (column tile, k atom) (8 KB each, laid out by tc::split_kvs_kernel, so
// that one 16 KB bulk copy moves a chunk); one g tile [128][64] (two atoms);
// b a row, the dinv tree, mbarriers: 226 KB at M = 256.
//
// The kernel this replaced (one block a row block, q staged by the MMA
// warps' cp.async, kvs^T streamed two chunks deep by the same warps, each
// column tile staged and folded under block barriers) overlapped nothing
// and ran 3.7x its bound. Here the next row block's q rows land under this
// one's last column tile, slot by slot: the consumers' warps load each A
// fragment from its slot and split it into tf32 hi + lo in registers, and
// in a row block's last column tile each warp frees slot j (an empty
// mbarrier of its own, which the two sum warps also arrive on once they have
// read the atom) once its fragments of k atom j are in registers; the
// producer then brings the next row block's atom j into it. The first
// column tile waits for each atom as it reaches it.
//
// The producer warpgroup: warp 0's lane 0 brings the kvs^T chunks by bulk
// copies as the consumers free their stages (full and empty mbarriers);
// warp 1 brings each row block's q atoms and each column tile's g rows by
// tensor maps (the g tile once the consumers have read the last one);
// warps 2 and 3, the sum warps, form b = q . ksum from the staged q rows
// (two f32 FMA chains a row, the even and the odd columns, in column order,
// added) and hand it to the consumers a row block. Where the rows' strides
// or bases do not allow a tensor map (vec_a, vec_io 0) warp 1's lanes copy
// q and g one element a lane at a time. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md): sum_d g*v on the sum warps, v read into their
// registers a row ahead, held the kernel at those loads' latency (0.757 ms
// at arxiv); prefetching the next row block's g and v rows into L2 with its
// q atoms cost 8 %.
//
// The consumers keep the arithmetic of the kernel this replaced, so that
// den, gden and dinv are bitwise its: each product lo*hi' + hi*lo' + hi*hi'
// (the cross terms first), every 16 deep (kWgPeriod) the MMAs start fresh
// sums that are added to the column tile's f32 sums in round-to-nearest, in
// k order, a k atom's two periods double-buffered so that the second's MMAs
// run while the warps add the first's. A finished column tile is folded
// into sum_d g*a and sum_d g*v in that kernel's order: for each row and
// eight-column group an f32 FMA chain in column order from 0 (the
// accumulator fragment holds a group's eight columns in the four lanes of a
// quad, two each, so the chain passes from lane to lane by shuffles, four
// steps of two FMAs), the groups added by the tree ((0 + 4) + (2 + 6)) +
// ((1 + 5) + (3 + 7)), the column tiles in order; g at the fragment's
// columns from the staged tile, which each warp frees once its values are
// in registers, and v at the same columns read from device memory when the
// tile starts, so that its loads run under the tile's MMAs. Then the
// lanes that hold a row's sums form den, gden and the row's dinv term as
// la_bwd_rows_kernel does, and the block's f64 partial is the same pairwise
// tree over its 128 rows, stored under the row block's index.
constexpr int kRwConsumers = 2 * 128;
constexpr int kRwThreads = kRwConsumers + 128;  // and the producer warpgroup
constexpr int kRwStages = 4;
constexpr int kRwAtom = kTcRows * 128;   // a [128 rows][32] f32 atom of q, or half a g tile
constexpr int kRwPiece = tc::kKvsPiece;  // a [64 n][32 k] atom of kvs^T's hi or lo piece
constexpr int kRwStage = 2 * kRwPiece;   // a chunk: its hi and lo atoms
// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers', together the 168 a thread of the launch (2 x 232 + 40 = 3 x 168)
constexpr int kRwProducerRegs = 40;
constexpr int kRwConsumerRegs = 232;
static_assert(2 * kRwConsumerRegs + kRwProducerRegs == 3 * 168, "the launch's registers");
// the q slots are read by the consumer warps and the two sum warps
constexpr int kRwReaders = kRwConsumers / 32 + 2;

// the rows pass's tensor maps: q and g rows in [128][32] f32 boxes
struct RwMaps {
  CUtensorMap q, g;
};

size_t rows_ws_smem(int M) {
  const int ka = tc::cdiv(M, 32);
  return static_cast<size_t>(ka) * kRwAtom + static_cast<size_t>(kRwStages) * kRwStage +
         2 * kRwAtom + kTcRows * (sizeof(double) + sizeof(float)) +
         (2 * static_cast<size_t>(ka) + 2 * kRwStages + 4) * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kRwThreads, 1)
la_bwd_rows_ws_kernel(const float* __restrict__ q, const float* __restrict__ v,
                      const float* __restrict__ g, long ldq, long ldv, long ldg, int N, int M,
                      int D, const float* __restrict__ hl, const float* __restrict__ ksum,
                      const float* __restrict__ scal, const float* __restrict__ n_total,
                      int guard, int vec_a, int vec_io, float* __restrict__ den_out,
                      float* __restrict__ gden_out, double* __restrict__ dinv_part,
                      const __grid_constant__ RwMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const int ka = cdiv(M, 32);
  const int tiles = cdiv(D, kTcCols);
  const int blocks = cdiv(N, kTcRows);
  unsigned char* Qs = smem_raw;                                        // [ka][128][32]
  unsigned char* Bs = Qs + static_cast<size_t>(ka) * kRwAtom;          // [stage][hi, lo]
  unsigned char* Gs = Bs + static_cast<size_t>(kRwStages) * kRwStage;  // [2][128][32]
  double* red = reinterpret_cast<double*>(Gs + 2 * kRwAtom);           // the dinv tree
  float* b_s = reinterpret_cast<float*>(red + kTcRows);                // q . ksum a row
  uint64_t* afull = reinterpret_cast<uint64_t*>(b_s + kTcRows);   // a q atom has landed
  uint64_t* aempty = afull + ka;                                  // a q slot is read
  uint64_t* full = aempty + ka;                                   // a stage has landed
  uint64_t* empty = full + kRwStages;                             // a stage's MMAs are done
  uint64_t* gfull = empty + kRwStages;                            // a g tile has landed
  uint64_t* gempty = gfull + 1;                                   // a g tile is read
  uint64_t* sfull = gempty + 1;                                   // b_s holds a block's b
  uint64_t* sempty = sfull + 1;                                   // b_s and red are read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int j = 0; j < ka; ++j) {
      mbar_init(afull + j, 1);
      mbar_init(aempty + j, kRwReaders);
    }
    for (int s = 0; s < kRwStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRwConsumers / 32);
    }
    mbar_init(gfull, 1);
    mbar_init(gempty, kRwConsumers / 32);
    mbar_init(sfull, 2);
    mbar_init(sempty, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kRwConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<kRwProducerRegs>();
    const int pw = warp - kRwConsumers / 32;
    if (pw == 0) {  // the kvs^T chunks, each into its stage once the consumers have freed it
      if (lane == 0) {
        int ch = 0;
        for (int u = blockIdx.x; u < blocks; u += gridDim.x) {
          for (int t = 0; t < tiles; ++t) {
            for (int kc = 0; kc < ka; ++kc, ++ch) {
              const int st = ch % kRwStages;
              if (ch >= kRwStages) mbar_wait(empty + st, (ch / kRwStages - 1) & 1);
              mbar_arrive_expect_tx(full + st, kRwStage);
              bulk_copy_g2s(Bs + st * kRwStage, hl + static_cast<size_t>(t * ka + kc) *
                                                         (kRwStage / sizeof(float)),
                            kRwStage, full + st);
            }
          }
        }
      }
    } else if (pw == 1) {  // the q atoms and the g tiles
      const CUtensorMap* map_q = &maps.q;
      const CUtensorMap* map_g = &maps.g;
      // row block u's q atoms, slot j once the row block before (the i-th
      // of this block's) has read it
      auto load_q = [&](int u, int i) {
        const long r0 = static_cast<long>(u) * kTcRows;
        for (int j = 0; j < ka; ++j) {
          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);
          unsigned char* dst = Qs + static_cast<size_t>(j) * kRwAtom;
          if (vec_a) {
            if (lane == 0) {
              mbar_arrive_expect_tx(afull + j, kRwAtom);
              tma_load_2d(dst, map_q, 32 * j, static_cast<int>(r0), afull + j);
            }
          } else {
            for (int e = lane; e < kTcRows * 32; e += 32) {
              const int r = e >> 5;
              const int c = 32 * j + (e & 31);
              *reinterpret_cast<float*>(dst + sw128_offset_f32(r, e & 31)) =
                  r0 + r < N && c < M ? q[(r0 + r) * ldq + c] : 0.f;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(afull + j);
          }
        }
      };
      load_q(blockIdx.x, 0);
      int T = 0;  // column tiles brought
      int i = 0;
      for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
        const long r0 = static_cast<long>(u) * kTcRows;
        for (int t = 0; t < tiles; ++t, ++T) {
          if (T > 0) mbar_wait(gempty, (T - 1) & 1);
          if (vec_io) {
            if (lane == 0) {
              mbar_arrive_expect_tx(gfull, 2 * kRwAtom);
              for (int h = 0; h < 2; ++h) {
                tma_load_2d(Gs + h * kRwAtom, map_g, kTcCols * t + 32 * h, static_cast<int>(r0),
                            gfull);
              }
            }
          } else {
            for (int e = lane; e < kTcRows * kTcCols; e += 32) {
              const int r = e / kTcCols;
              const int c = e % kTcCols;
              const int col = kTcCols * t + c;
              *reinterpret_cast<float*>(Gs + (c >> 5) * kRwAtom + sw128_offset_f32(r, c & 31)) =
                  r0 + r < N && col < D ? g[(r0 + r) * ldg + col] : 0.f;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(gfull);
          }
        }
        if (u + static_cast<int>(gridDim.x) < blocks) load_q(u + gridDim.x, i + 1);
      }
    } else {  // warps 2 and 3, the sum warps: b of each row block's rows
      const int L = tid - kRwConsumers - 64;  // 0 .. 63: b of rows L and L + 64
      int i = 0;
      for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
        // b: the even and the odd columns' chains of each row, as the two
        // threads a row of the kernel this replaced formed them
        float be[2] = {0.f, 0.f}, bo[2] = {0.f, 0.f};
        for (int j = 0; j < ka; ++j) {
          mbar_wait(afull + j, i & 1);
          const unsigned char* at = Qs + static_cast<size_t>(j) * kRwAtom;
#pragma unroll 2  // fully unrolled, the loads outgrow the 40 registers
          for (int c4 = 0; c4 < 8; ++c4) {
            const int c = 32 * j + 4 * c4;
            float k4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) k4[e] = c + e < M ? __ldg(ksum + c + e) : 0.f;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float4 x =
                  *reinterpret_cast<const float4*>(at + sw128_offset_f32(L + 64 * rr, 4 * c4));
              be[rr] = fmaf(x.x, k4[0], be[rr]);
              bo[rr] = fmaf(x.y, k4[1], bo[rr]);
              be[rr] = fmaf(x.z, k4[2], be[rr]);
              bo[rr] = fmaf(x.w, k4[3], bo[rr]);
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(aempty + j);
        }
        // handed over once the consumers have read the row block before's
        if (i > 0) mbar_wait(sempty, (i - 1) & 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) b_s[L + 64 * rr] = be[rr] + bo[rr];
        __syncwarp();
        if (lane == 0) mbar_arrive(sfull);
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<kRwConsumerRegs>();
  constexpr int kSteps = kWgPeriod / 8;  // k8 steps a period: two periods a 32-deep atom
  static_assert(kSteps * 2 * 8 == 32, "two periods an atom");
  const float inv = scal[2];
  const float n = *n_total;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  // the lane's fragment rows 16 * warp + g8 (+ 8) at k = t4 (+ 4) of each k8 step
  const int a_off = (16 * warp + g8) * 128 + t4 * 4;
  const int g16 = g8 << 4;  // the swizzle of the rows' 16-byte chunks
  float acc[32], part[2][32];
  unsigned ah[2][kSteps][4], al[2][kSteps][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) part[0][e] = part[1][e] = 0.f;

  // the A fragments of period p of the atom in slot kc, as tf32 hi + lo
  auto load_a = [&](unsigned (&h)[kSteps][4], unsigned (&l)[kSteps][4], int kc, int p) {
    const unsigned char* a = Qs + kc * kRwAtom + a_off;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int s = p * kSteps + ks;  // k8 step of the atom: k from 8 s
      const int lo16 = ((2 * s) << 4) ^ g16;
      const int hi16 = ((2 * s + 1) << 4) ^ g16;
      split_tf32(*reinterpret_cast<const float*>(a + lo16), h[ks][0], l[ks][0]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + lo16), h[ks][1], l[ks][1]);
      split_tf32(*reinterpret_cast<const float*>(a + hi16), h[ks][2], l[ks][2]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + hi16), h[ks][3], l[ks][3]);
    }
  };
  // period p's MMAs into fresh sums d, B the chunk's atoms at Bh (hi; lo
  // one piece on)
  auto issue = [&](float (&d)[32], const unsigned (&h)[kSteps][4],
                   const unsigned (&l)[kSteps][4], const unsigned char* Bh, int p) {
    wgmma_fence_operand(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const unsigned char* b = Bh + (p * kSteps + ks) * 32;
      wgmma_m64n64k8_tf32(d, l[ks], sw128_desc(b), ks);            // lo*hi', fresh first
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b + kRwPiece), 1);  // hi*lo'
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b), 1);             // hi*hi'
    }
    wgmma_commit();
  };
  auto fold = [&](float (&d)[32]) {
    wgmma_fence_operand(d);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
  };

  int ch = 0;  // chunks consumed
  int T = 0;   // column tiles folded
  int i = 0;
  for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
    const long r0 = static_cast<long>(u) * kTcRows;
    // sum_d g*a and sum_d g*v of the lane's rows 16 * warp + g8 (+ 8),
    // whole in the lanes t4 == 3
    float ga[2] = {0.f, 0.f}, gv[2] = {0.f, 0.f};
    for (int t = 0; t < tiles; ++t, ++T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      // v at the fragment's columns (y[j][h]: row 16 * warp + g8 + 8 h,
      // columns 8 j + 2 t4, + 1), read now so that the loads run under the
      // tile's MMAs; zero past N and D
      float2 y[8][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = r0 + 16 * warp + g8 + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = kTcCols * t + 8 * j + 2 * t4;
          const float* p = v + row * ldv + c;
          if (vec_io && row < N && c + 1 < D) {
            y[j][h] = __ldg(reinterpret_cast<const float2*>(p));
          } else {
            y[j][h].x = row < N && c < D ? p[0] : 0.f;
            y[j][h].y = row < N && c + 1 < D ? p[1] : 0.f;
          }
        }
      }
      for (int kc = 0; kc < ka; ++kc, ++ch) {
        const int st = ch % kRwStages;
        mbar_wait(full + st, (ch / kRwStages) & 1);
        if (t == 0) mbar_wait(afull + kc, i & 1);
        const unsigned char* Bh = Bs + st * kRwStage;
        load_a(ah[0], al[0], kc, 0);
        issue(part[0], ah[0], al[0], Bh, 0);
        load_a(ah[1], al[1], kc, 1);
        if (t == tiles - 1) {  // the row block's last reads of slot kc are in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(aempty + kc);
        }
        issue(part[1], ah[1], al[1], Bh, 1);
        wgmma_wait<1>();  // the first period is done
        fold(part[0]);
        wgmma_wait<0>();
        fold(part[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
      }
      // the column tile folded into sum_d g*a and sum_d g*v: g at the
      // fragment's columns (x[j][h], as y)
      mbar_wait(gfull, T & 1);
      float2 x[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[j][h] = *reinterpret_cast<const float2*>(
              Gs + (j >> 2) * kRwAtom + sw128_offset_f32(16 * warp + g8 + 8 * h,
                                                         8 * (j & 3) + 2 * t4));
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(gempty);
      // each (row, group) chain through the quad's lanes in column order:
      // after step s the lane t4 == s holds it up to its two columns
      float pa[8][2], pv[8][2];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float in_a = s == 0 ? 0.f : __shfl_up_sync(0xffffffffu, pa[j][h], 1);
            const float in_v = s == 0 ? 0.f : __shfl_up_sync(0xffffffffu, pv[j][h], 1);
            pa[j][h] = fmaf(x[j][h].y, acc[4 * j + 2 * h + 1],
                            fmaf(x[j][h].x, acc[4 * j + 2 * h], in_a));
            pv[j][h] = fmaf(x[j][h].y, y[j][h].y, fmaf(x[j][h].x, y[j][h].x, in_v));
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ga[h] += ((pa[0][h] + pa[4][h]) + (pa[2][h] + pa[6][h])) +
                 ((pa[1][h] + pa[5][h]) + (pa[3][h] + pa[7][h]));
        gv[h] += ((pv[0][h] + pv[4][h]) + (pv[2][h] + pv[6][h])) +
                 ((pv[1][h] + pv[5][h]) + (pv[3][h] + pv[7][h]));
      }
    }
    // den, gden and the rows' dinv terms, as la_bwd_rows_kernel forms them
    mbar_wait(sfull, i & 1);
    if (t4 == 3) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
        const long row = r0 + r;
        double part_d = 0.0;
        if (row < N) {
          const float bb = b_s[r];
          const float s_ga = ga[h];
          float den = inv * bb + n;
          float gden;
          if (guard && den == 0.f) {
            den = 1.f;
            gden = 0.f;
          } else {
            gden = -(inv * s_ga + n * gv[h]) / (den * den);
          }
          den_out[row] = den;
          gden_out[row] = gden;
          part_d = static_cast<double>(s_ga / den) + static_cast<double>(gden * bb);
        }
        red[r] = part_d;
      }
    }
    rd_consumers_sync();
    if (warp == 0) {  // the pairwise tree over the 128 rows: strides 64, 32, ..., 1
      double x2 = (red[lane] + red[lane + 64]) + (red[lane + 32] + red[lane + 96]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x2 += __shfl_down_sync(0xffffffffu, x2, off);
      if (lane == 0) {
        dinv_part[u] = x2;
        mbar_arrive(sempty);  // b_s and red are read: the next block's may come
      }
    }
  }
}

// The reduce's P pass for f32 inputs in 3xTF32 on warpgroup MMAs (wgmma
// m64n128k8 tf32 -> f32, A from registers), the f32 forward reduce's design
// (la_reduce_wg_kernel) with q for k and gd = g / den for v: grid (slices *
// tiles), tiles = ceil(M/128) * ceil(D/128), slice-major, block b summing
// tile b % tiles of P over its slice's rows, one block an SM. A producer
// warpgroup, its registers given to the consumers, brings each 32-node
// chunk of q and g into swizzled node-major atoms by the copy engine (f32
// tensor maps; where the rows' strides or bases do not allow one, vec == 0,
// its lanes copy them, zero past the slice), and den and gden of the
// chunk's rows with them, through a kBrStages-deep ring of full and empty
// mbarriers (tc::rd_produce). The two consumer warpgroups
// (tc::rd_consume_tf32) split q as its fragments load and form gd = g *
// (1/den) as they split each chunk's g K-major into tf32 hi + lo: the
// correctly rounded 1/den, then a round-to-nearest product, zero past the
// slice, so that gd is bitwise the mma.sync kernel's it replaced. The
// chunk's rows past the slice (which the copy engine reads) are read as
// zeros by both. The blocks of the first column tile also sum ds = q . gden
// per column of their M tile on the producer warpgroup's three other warps
// while the MMAs run, rows w + 3 j of each chunk for warp w, lane l taking
// the columns 4 l .. + 3: f64 FMAs of the values made f64, so that each
// product is exact and ds is exact up to its f64 adds however gden's signs
// make it cancel, the three row groups added in order and rounded to f32
// once a slice. (One f32 chain a chunk made f64 once, as the forward's
// column sums run, costs a tenth as much and loses that where ds cancels;
// an f32 pair a chunk that keeps every rounding error, by an FMA and
// TwoSum, holds it but costs more than the f64 FMAs: PERF.md.) A stage is
// freed when the consumer warps and the three ds warps
// are done with it. Dynamic shared memory: 4 stages of q's and g's four
// atoms (32 KB each), gd's split hi and lo of two chunks (64 KB), den and
// gden of each stage, ds's f64 sums and the mbarriers, 196 KB.
constexpr int kBrStages = 4;
constexpr int kBrStage = 8 * tc::kRfAtom;  // q's four atoms, g's four
constexpr int kBrSums = 4 * tc::kRfSumWarps * 32;  // ds's f64 sums: [column % 4][row group][lane]
constexpr size_t kBrSmem = kBrStages * kBrStage + 4 * tc::kRfPiece +
                           kBrStages * 2 * tc::kRfRows * sizeof(float) + kBrSums * sizeof(double) +
                           (2 * kBrStages + 4) * sizeof(uint64_t);

__global__ void __launch_bounds__(tc::kRdThreads, 1)
la_bwd_reduce_wg_kernel(const float* __restrict__ q, const float* __restrict__ g, long ldq,
                        long ldg, int N, int M, int D, int rows_per_slice, int vec,
                        const float* __restrict__ den, const float* __restrict__ gden,
                        float* __restrict__ P_part, float* __restrict__ ds_part,
                        const __grid_constant__ tc::RdMaps maps) {  // a: q, b: g
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem_raw;  // [stage][q atoms 0-3; g atoms 0-3]
  unsigned char* gsplit = ring + kBrStages * kBrStage;  // [buffer][hi, lo][128 d][32 nodes]
  float* rows_s = reinterpret_cast<float*>(gsplit + 4 * kRfPiece);  // [stage][den, gden][32]
  double* colsum = reinterpret_cast<double*>(rows_s + kBrStages * 2 * kRfRows);
  uint64_t* full = reinterpret_cast<uint64_t*>(colsum + kBrSums);  // a stage has landed
  uint64_t* empty = full + kBrStages;                               // a stage is read
  uint64_t* sfull = empty + kBrStages;  // a split buffer is written
  uint64_t* sempty = sfull + 2;         // a split buffer's MMAs are done

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const RdBlock<kRfRows> blk(N, M, D, rows_per_slice);

  if (tid == 0) {
    for (int i = 0; i < kBrStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kRdConsumers / 32 + kRfSumWarps);  // consumer and ds warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(sfull + b, kRdConsumers / 32);
      mbar_init(sempty + b, kRdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kRdConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    const int pw = warp - kRdConsumers / 32;
    if (pw == 0) {
      rd_produce<float, kRfRows, kBrStages, 4, 2>(
          ring, full, empty, q, g, q, ldq, ldg, ldq, M, D, blk, 2, vec, lane, maps,
          [&](int st, long r0) {
            // den and gden of the chunk's rows, lane r's row r, zero past the slice
            const bool ok = r0 + lane < blk.r_end;
            rows_s[st * 2 * kRfRows + lane] = ok ? den[r0 + lane] : 0.f;
            rows_s[(st * 2 + 1) * kRfRows + lane] = ok ? gden[r0 + lane] : 0.f;
            __syncwarp();
          });
      return;
    }
    // warps 1-3: ds of row group pw - 1 of every chunk, f64 FMAs of the
    // values made f64
    double ds[4] = {0.0, 0.0, 0.0, 0.0};
    for (int c = 0; c < blk.chunks; ++c) {
      const int st = c % kBrStages;
      mbar_wait(full + st, (c / kBrStages) & 1);
      if (blk.k_stats) {
        const unsigned char* qs = ring + st * kBrStage;
        const float* gden_s = rows_s + (st * 2 + 1) * kRfRows;
        const int valid = blk.valid(c);
        for (int r = pw - 1; r < valid; r += kRfSumWarps) {
          float x[4];
          rd_load4(reinterpret_cast<const float*>(qs + (lane >> 3) * kRfAtom +
                                                  sw128_offset_f32(r, (4 * lane) & 31)),
                   true, x);
          const double gr = static_cast<double>(gden_s[r]);
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[e] = fma(static_cast<double>(x[e]), gr, ds[e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (blk.k_stats) {  // uniform over the block
#pragma unroll
      for (int e = 0; e < 4; ++e) colsum[(e * kRfSumWarps + pw - 1) * 32 + lane] = ds[e];
      rd_sum_warps_sync();
      for (int col = (pw - 1) * 32 + lane; col < kRdTile; col += kRfSumWarps * 32) {
        if (blk.m0 + col >= M) continue;
        const double* p = colsum + (col & 3) * kRfSumWarps * 32 + (col >> 2);
        double sum = 0.0;
#pragma unroll
        for (int rg = 0; rg < kRfSumWarps; ++rg) sum += p[32 * rg];
        ds_part[static_cast<size_t>(blk.s) * M + blk.m0 + col] = static_cast<float>(sum);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // gd = g * (1/den) of each node row as the split reads it
  rd_consume_tf32<kBrStages, kBrStage>(
      ring, gsplit, full, empty, sfull, sempty, blk, M, D, P_part, tid,
      [&](int st, int valid, int r, float (&x)[4]) {
        const float rd = r < valid ? __frcp_rn(rows_s[st * 2 * kRfRows + r]) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __fmul_rn(x[e], rd);
      });
}

// ---------------------------------------------------------------------------
// The bf16 backward on warpgroup MMAs (wgmma m64nNk16 bf16, f32 sums), the
// three kernels of the main path's step: both operands of every product
// are read by the MMAs from 128-byte-swizzled shared memory through
// descriptors (tensor_core.cuh), a block is two consumer warpgroups of 64
// rows and a producer warp (a warpgroup in the P pass), one
// block an SM, and every kernel's dynamic shared memory starts 1024-byte
// aligned (no static shared memory). Shared tiles: kWgAtom16 bytes hold a
// swizzled [64 rows][64 bf16] atom; a [128][64] tile is two of them.
using bf16 = __nv_bfloat16;
using tc::sw128_desc;
using tc::sw128_desc_mn;
using tc::sw128_offset;
constexpr int kWgAtom16 = 64 * 128;       // bytes of a swizzled [64][64] bf16 atom
constexpr int kWgTile16 = 2 * kWgAtom16;  // a [128][64] tile

// A tensor map of rows [N][width] of bf16, ld elements apart, read in
// [box_rows][64 columns] boxes into the 128-byte swizzle, zero past N and
// width (tc::encode_rows_map).
cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int N, int width, long ld,
                            int box_rows = 128) {
  return tc::encode_rows_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), N, width,
                             ld, 64, box_rows);
}

// kvs^T as the rows pass reads it: three bf16 pieces (hi, mid, lo, as
// tc::split_store<3> splits each element) of each [64 n = d][64 k = m]
// chunk, swizzled as the pass's shared memory holds it (8 KB, zero past
// the widths), column tile by column tile and k chunk by k chunk, so that
// one bulk copy moves a piece's chunk: piece p of chunk (ct, kc) starts at
// element ((ct * kt + kc) * 3 + p) * 4096, kt = split_pad(M) / 64.
__global__ void __launch_bounds__(kThreads)
la_bwd_split_rows_kernel(const float* __restrict__ kvs, int M, int D, bf16* __restrict__ hl) {
  const int Mk = tc::split_pad(M);
  const int kt = Mk / 64;
  const size_t count = tc::split_t_elems(M, D);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i / Mk);
    const int kk = static_cast<int>(i % Mk);
    const size_t off = static_cast<size_t>(((n / 64) * kt + kk / 64) * 3) * 4096 +
                       sw128_offset(n % 64, kk % 64) / 2;
    tc::split_store<3>(n < D && kk < M ? kvs[static_cast<size_t>(kk) * D + n] : 0.f, hl + off,
                       4096);
  }
}

// The bf16 reduce's rows pass on warpgroup MMAs (wgmma m64n64k16 bf16, f32
// sums; A from registers, B through descriptors), warp-specialised, fed by
// the copy engine and persistent, the f32 rows pass's design
// (la_bwd_rows_ws_kernel) on bf16 rows: grid min(ceil(N / 128), SMs), one
// block an SM, block b taking the 128-row blocks b, b + grid, ... in turn.
// It replaces, with the P pass, sgformer_tpu/kernels/attention.py::
// _bwd_reduce_kernel for bf16 rows: per row a = q @ kvs, folded at once into
// sum_d g*a, with b = q . ksum and sum_d g*v, then den, gden and the row
// block's f64 partial of dinv. Bound by its bytes (q, v and g read once:
// 0.078 ms at the arxiv shape; its three bf16 products 0.067). Two consumer
// warpgroups of 64 rows and a producer warpgroup, which gives its registers
// to the consumers (setmaxnreg). Dynamic shared memory, 1024-byte aligned
// (no static shared memory), every tile 128-byte swizzled over rows of 64
// bf16 (sw128_offset): a row block's q rows as kt = ceil(M / 64) slots of
// one k-tile each ([128 rows][64], 16 KB; 64 KB at M = 256); a ring of
// `stages` chunks of kvs^T, each the three bf16 pieces (hi, mid, lo) of one
// (column tile, k-tile) as la_bwd_split_rows_kernel lays them out ([64
// n][64 k], 8 KB each), moved by three bulk copies; where the copy engine
// may read g and v (vec_io) and they fit, one g tile and one v tile
// [128][64] (gv_tile); b a row, the dinv tree and the mbarriers: 194 KB at
// M = 256 (4 stages), 226 KB at M = 704 (2 stages, no g and v tiles).
//
// The kernel this replaced (one block a row block, its whole q tile awaited
// before the first MMA, each column tile's g and v requested only once
// every consumer had read the last ones) overlapped nothing. Here the next
// row block's q rows land under this one's last column tile, slot by slot:
// in a row block's last column tile each consumer warp frees slot j (an
// empty mbarrier of its own, on which the two sum warps also arrive once
// they have read the k-tile) once the MMAs that read k-tile j are done; the
// producer then brings the next row block's k-tile j into it. The first
// column tile waits for each k-tile as it reaches it.
//
// The producer warpgroup: warp 0's lane 0 brings the kvs^T chunks by bulk
// copies as the consumers free their stages (full and empty mbarriers);
// warp 1 brings each row block's q k-tiles and each column tile's g and v
// rows by tensor maps (the tiles once the consumers have read the last
// ones); warps 2 and 3, the sum warps, form b = q . ksum from the staged q
// rows (two f32 FMA chains a row, the even and the odd columns, in column
// order, added, as two threads a row of the kernel this replaced formed
// them) and hand it to the consumers a row block. Where the rows' strides
// or bases do not allow a tensor map (vec_a 0) warp 1's lanes copy q one
// element a lane at a time; without the g and v tiles the consumers read g
// and v into their registers when a column tile starts, so that the loads
// run under its MMAs.
//
// The consumers keep the arithmetic of the kernel this replaced, so that
// den, gden and dinv are bitwise its: each k16 step's three MMAs (A = the
// warpgroup's 64 q rows, loaded into registers by ldmatrix once for the
// three; B = hi, mid, lo) into fresh sums (scale-d = 0 on hi), added to the
// column tile's f32 sums in round-to-nearest in k order, a step's sums and
// A fragments double-buffered so that its MMAs run while the warps add the
// last step's; a finished column tile folded into the lane's sum_d g*a and
// sum_d g*v, one f32 FMA chain each over the lane's two columns of each
// eight-column group in column order, the column tiles in order, g and v at
// the fragment's columns (each warp frees the staged tiles once its values
// are in registers); the four lanes of a fragment row added by a fixed xor
// tree. Then the lanes that hold a row's sums form den, gden and the row's
// dinv term as la_bwd_rows_kernel does, and the row block's f64 partial is
// the same pairwise tree over its 128 rows, stored under the row block's
// index. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): neither
// the q, g and v loads nor the ring's L2 traffic bound this pass (each
// removed, it ran within 3 %); its MMAs take 0.056 ms of 0.18 at the arxiv
// shape, and the rest is the consumers' issue of the fresh sums' adds and
// the handshakes. (Forming b on the consumers, as the kernel this replaced
// did, ran 25 % slower; the steps pipelined across chunks, 30 % slower; two
// g and v buffers, or the next row block's rows prefetched into L2, gained
// nothing.)
constexpr int kRowsPiece16 = 64 * 128;  // bytes of one piece's [64][64] chunk
constexpr int kRowsConsumers = 2 * 128;
constexpr int kRsThreads = kRowsConsumers + 128;  // and the producer warpgroup
constexpr int kRsStage = 3 * kRowsPiece16;        // a chunk: its hi, mid and lo pieces
// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers', together the 168 a thread of the launch (under 56 the
// producer's counts and pointers spilled)
constexpr int kRsProducerRegs = 56;
constexpr int kRsConsumerRegs = 224;
static_assert(2 * kRsConsumerRegs + kRsProducerRegs == 3 * 168, "the launch's registers");
// the q slots are read by the consumer warps and the two sum warps
constexpr int kRsReaders = kRowsConsumers / 32 + 2;


size_t rows_ws16_smem(int M, int stages, int gv_tile) {
  const int kt = tc::split_pad(M) / 64;
  return static_cast<size_t>(kt + 2 * gv_tile) * kWgTile16 +
         static_cast<size_t>(stages) * kRsStage +
         kTcRows * (sizeof(double) + sizeof(float)) +
         (2 * static_cast<size_t>(kt) + 2 * stages + 4) * sizeof(uint64_t);
}

// The pass's layout at this width: the g and v tiles where the copy engine
// may read them (gv_ok) and they fit, then the ring's depth, 4 down to 2;
// stages 0 where the q slots and two stages do not fit one block's shared
// memory (M above 704: the CUDA-core pass runs).
void rows_ws16_layout(int M, int gv_ok, int& stages, int& gv_tile) {
  for (gv_tile = gv_ok; gv_tile >= 0; --gv_tile) {
    for (stages = 4; stages >= 2; --stages) {
      if (rows_ws16_smem(M, stages, gv_tile) <= kSmemPerBlock) return;
    }
  }
  stages = gv_tile = 0;
}
int rows_ws16_stages(int M) {
  int stages, gv_tile;
  rows_ws16_layout(M, 0, stages, gv_tile);
  return stages;
}

// the consumers' own barrier (the producer has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRowsConsumers) : "memory");
}

// d[64 x 64] = A[64 x 16] B[16 x 64] + (scale_d ? d : 0), bf16 in, f32
// sums, A from registers (each warp's 16 rows of the warpgroup's 64 as the
// m16 x k16 fragment ldmatrix_x4 loads), B K-major through its descriptor;
// d laid out as tc::wgmma_m64n64k16's
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// the m16 x k16 bf16 fragment of rows r0 .. r0 + 15, k0 .. k0 + 15 of a
// swizzled tile of 64-wide rows (tc::sw128_offset), as mma.m16n8k16's A:
// a[0] rows r0 + g, k0 + 2t (+1); a[1] rows + 8; a[2] k + 8; a[3] both
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const unsigned char* tile, int r0,
                                            int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k = k0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(tc::smem_addr(tile + tc::sw128_offset(r, k))));
}

// the rows pass's tensor maps: q, g and v rows in [128][64] bf16 boxes
struct RsMaps {
  CUtensorMap q, g, v;
};

__global__ void __launch_bounds__(kRsThreads, 1)
la_bwd_rows_ws16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                        const bf16* __restrict__ g, long ldq, long ldv, long ldg, int N, int M,
                        int D, const bf16* __restrict__ hl, const float* __restrict__ ksum,
                        const float* __restrict__ scal, const float* __restrict__ n_total,
                        int guard, int vec_a, int vec_io, int stages, int gv_tile,
                        float* __restrict__ den_out, float* __restrict__ gden_out,
                        double* __restrict__ dinv_part, const __grid_constant__ RsMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  // (the widths' counts are formed again in each role: a value live across
  // setmaxnreg is spilled)
  const int kt = split_pad(M) / 64;  // q's k-tiles, chunks a column tile
  unsigned char* Qs = smem_raw;                                        // [kt][128][64]
  unsigned char* Gs = Qs + static_cast<size_t>(kt) * kWgTile16;  // g, v [128][64] (gv_tile)
  unsigned char* Bs = Gs + static_cast<size_t>(2 * gv_tile) * kWgTile16;  // [stage][hi, mid, lo]
  double* red = reinterpret_cast<double*>(Bs + static_cast<size_t>(stages) * kRsStage);
  float* b_s = reinterpret_cast<float*>(red + kTcRows);           // q . ksum a row
  uint64_t* afull = reinterpret_cast<uint64_t*>(b_s + kTcRows);   // a q k-tile has landed
  uint64_t* aempty = afull + kt;                                  // a q slot is read
  uint64_t* full = aempty + kt;                                   // a stage has landed
  uint64_t* empty = full + stages;                                // a stage's MMAs are done
  uint64_t* gfull = empty + stages;                               // a g, v tile has landed
  uint64_t* gempty = gfull + 1;                                   // a g, v tile is read
  uint64_t* sfull = gempty + 1;                                   // b_s holds a block's b
  uint64_t* sempty = sfull + 1;                                   // b_s and red are read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int j = 0; j < kt; ++j) {
      mbar_init(afull + j, 1);
      mbar_init(aempty + j, kRsReaders);
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kRowsConsumers / 32);
    }
    mbar_init(gfull, 1);
    mbar_init(gempty, kRowsConsumers / 32);
    mbar_init(sfull, 2);
    mbar_init(sempty, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kRowsConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<kRsProducerRegs>();
    const int pw = warp - kRowsConsumers / 32;
    const int tiles = cdiv(D, kTcCols);
    const int blocks = cdiv(N, kTcRows);
    if (pw == 0) {  // the kvs^T chunks, each into its stage once the consumers have freed it
      if (lane == 0) {
        int ch = 0;
        for (int u = blockIdx.x; u < blocks; u += gridDim.x) {
          for (int t = 0; t < tiles; ++t) {
            for (int kc = 0; kc < kt; ++kc, ++ch) {
              const int st = ch % stages;
              if (ch >= stages) mbar_wait(empty + st, (ch / stages - 1) & 1);
              mbar_arrive_expect_tx(full + st, kRsStage);
              const bf16* src = hl + static_cast<size_t>(t * kt + kc) * 3 * 4096;
              unsigned char* dst = Bs + static_cast<size_t>(st) * kRsStage;
              for (int p = 0; p < 3; ++p) {
                bulk_copy_g2s(dst + p * kRowsPiece16, src + p * 4096, kRowsPiece16, full + st);
              }
            }
          }
        }
      }
    } else if (pw == 1) {  // the q k-tiles and the g and v tiles
      const CUtensorMap* map_q = &maps.q;
      // row block u's q k-tiles, slot j once the row block before (the
      // i-th of this block's) has read it
      auto load_q = [&](int u, int i) {
        const long r0 = static_cast<long>(u) * kTcRows;
        for (int j = 0; j < kt; ++j) {
          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);
          unsigned char* dst = Qs + static_cast<size_t>(j) * kWgTile16;
          if (vec_a) {
            if (lane == 0) {
              mbar_arrive_expect_tx(afull + j, kWgTile16);
              tma_load_2d(dst, map_q, 64 * j, static_cast<int>(r0), afull + j);
            }
          } else {
            for (int e = lane; e < kTcRows * 64; e += 32) {
              const int r = e >> 6;
              const int c = 64 * j + (e & 63);
              *reinterpret_cast<bf16*>(dst + sw128_offset(r, e & 63)) =
                  r0 + r < N && c < M ? q[(r0 + r) * ldq + c] : __float2bfloat16_rn(0.f);
            }
            fence_proxy_async();  // the lanes' stores, for the MMAs
            __syncwarp();
            if (lane == 0) mbar_arrive(afull + j);
          }
        }
      };
      load_q(blockIdx.x, 0);
      int T = 0;  // column tiles brought
      int i = 0;
      for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
        const long r0 = static_cast<long>(u) * kTcRows;
        if (gv_tile && lane == 0) {
          for (int t = 0; t < tiles; ++t, ++T) {
            if (T > 0) mbar_wait(gempty, (T - 1) & 1);
            mbar_arrive_expect_tx(gfull, 2 * kWgTile16);
            tma_load_2d(Gs, &maps.g, kTcCols * t, static_cast<int>(r0), gfull);
            tma_load_2d(Gs + kWgTile16, &maps.v, kTcCols * t, static_cast<int>(r0), gfull);
          }
        }
        if (u + static_cast<int>(gridDim.x) < blocks) load_q(u + gridDim.x, i + 1);
      }
    } else {  // warps 2 and 3, the sum warps: b of each row block's rows
      const int L = tid - kRowsConsumers - 64;  // 0 .. 63: b of rows L and L + 64
      int i = 0;
      for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
        float be[2] = {0.f, 0.f}, bo[2] = {0.f, 0.f};
        for (int j = 0; j < kt; ++j) {
          mbar_wait(afull + j, i & 1);
          const unsigned char* at = Qs + static_cast<size_t>(j) * kWgTile16;
#pragma unroll 1  // unrolled, the loads outgrow the 40 registers
          for (int c8 = 0; c8 < 8; ++c8) {
            const int c = 64 * j + 8 * c8;
            if (c >= M) break;
            float k8[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) k8[e] = c + e < M ? __ldg(ksum + c + e) : 0.f;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const uint4 raw =
                  *reinterpret_cast<const uint4*>(at + sw128_offset(L + 64 * rr, 8 * c8));
              const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 x = __bfloat1622float2(x2[e]);
                if (c + 2 * e < M) be[rr] = fmaf(x.x, k8[2 * e], be[rr]);
                if (c + 2 * e + 1 < M) bo[rr] = fmaf(x.y, k8[2 * e + 1], bo[rr]);
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(aempty + j);
        }
        // handed over once the consumers have read the row block before's
        if (i > 0) mbar_wait(sempty, (i - 1) & 1);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) b_s[L + 64 * rr] = be[rr] + bo[rr];
        __syncwarp();
        if (lane == 0) mbar_arrive(sfull);
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<kRsConsumerRegs>();
  const int tiles = cdiv(D, kTcCols);
  const int blocks = cdiv(N, kTcRows);
  const float inv = scal[2];
  const float n = *n_total;
  const int wg = warp >> 2;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  float acc[32], part[2][32];
  unsigned af[2][4];  // the A fragments of two steps
#pragma unroll
  for (int e = 0; e < 32; ++e) part[0][e] = part[1][e] = 0.f;
  auto fold = [&](float (&d)[32]) {
    wgmma_fence_operand(d);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
  };
  // a [128][64] tile's values at the lane's fragment (x[h][j]: row
  // 16 * warp + g8 + 8 h, columns 8 j + 2 t4, + 1) of column tile t read
  // from device memory, zero past N and D (the last column of an odd width
  // alone: a word's other half is the next row's or head's)
  auto load_rows = [&](__nv_bfloat162 (&x)[2][8], const bf16* X, long ld, long r0, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = r0 + 16 * warp + g8 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kTcCols * t + 8 * j + 2 * t4;
        const bf16* p = X + row * ld + c;
        if (vec_io && row < N && c + 1 < D) {
          x[h][j] = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
        } else {
          const bf16 zero = __float2bfloat16_rn(0.f);
          x[h][j] = __halves2bfloat162(row < N && c < D ? p[0] : zero,
                                       row < N && c + 1 < D ? p[1] : zero);
        }
      }
    }
  };

  int ch = 0;  // chunks consumed
  int T = 0;   // column tiles folded
  int i = 0;
  for (int u = blockIdx.x; u < blocks; u += gridDim.x, ++i) {
    const long r0 = static_cast<long>(u) * kTcRows;
    // sum_d g*a and sum_d g*v of the lane's rows 16 * warp + g8 (+ 8)
    float ga[2] = {0.f, 0.f}, gv[2] = {0.f, 0.f};
    for (int t = 0; t < tiles; ++t, ++T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      // g and v without their tiles now, so that the loads run under the
      // tile's MMAs
      __nv_bfloat162 x[2][8], y[2][8];
      if (!gv_tile) {
        load_rows(x, g, ldg, r0, t);
        load_rows(y, v, ldv, r0, t);
      }
      for (int kc = 0; kc < kt; ++kc, ++ch) {
        const int st = ch % stages;
        mbar_wait(full + st, (ch / stages) & 1);
        if (t == 0) mbar_wait(afull + kc, i & 1);
        const unsigned char* a_tile = Qs + static_cast<size_t>(kc) * kWgTile16 + wg * kWgAtom16;
        const unsigned char* b_st = Bs + static_cast<size_t>(st) * kRsStage;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float (&d)[32] = part[ks & 1];
          // the step's A fragment into registers once for its three MMAs
          // (its buffer's last MMAs, two steps back, are done)
          ldmatrix_x4(af[ks & 1], a_tile, 16 * (warp & 3), 16 * ks, lane);
          wgmma_fence_operand(d);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            wgmma_m64n64k16_rs(d, af[ks & 1], sw128_desc(b_st + p * kRowsPiece16 + ks * 32), p);
          }
          wgmma_commit();
          if (ks > 0) {
            wgmma_wait<1>();  // step ks - 1's MMAs are done
            fold(part[(ks - 1) & 1]);
          }
        }
        wgmma_wait<0>();
        fold(part[1]);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty + st);
          // the row block's last MMAs on slot kc are done
          if (t == tiles - 1) mbar_arrive(aempty + kc);
        }
      }
      if (gv_tile) {  // g and v at the lane's fragment from the staged tiles
        mbar_wait(gfull, T & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int off = sw128_offset(16 * warp + g8 + 8 * h, 8 * j + 2 * t4);
            x[h][j] = *reinterpret_cast<const __nv_bfloat162*>(Gs + off);
            y[h][j] = *reinterpret_cast<const __nv_bfloat162*>(Gs + kWgTile16 + off);
          }
        __syncwarp();
        if (lane == 0) mbar_arrive(gempty);
      }
      // the column tile's a, folded into the lane's rows
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 xf = __bfloat1622float2(x[h][j]);
          const float2 yf = __bfloat1622float2(y[h][j]);
          ga[h] = fmaf(xf.x, acc[4 * j + 2 * h], ga[h]);
          gv[h] = fmaf(xf.x, yf.x, gv[h]);
          ga[h] = fmaf(xf.y, acc[4 * j + 2 * h + 1], ga[h]);
          gv[h] = fmaf(xf.y, yf.y, gv[h]);
        }
    }
    // the four lanes of a fragment row, a fixed xor tree
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ga[h] += __shfl_xor_sync(0xffffffffu, ga[h], off);
        gv[h] += __shfl_xor_sync(0xffffffffu, gv[h], off);
      }
    }
    // den, gden and the rows' dinv terms, as la_bwd_rows_kernel forms them
    mbar_wait(sfull, i & 1);
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
        const long row = r0 + r;
        double part_d = 0.0;
        if (row < N) {
          const float bb = b_s[r];
          const float s_ga = ga[h];
          float den = inv * bb + n;
          float gden;
          if (guard && den == 0.f) {
            den = 1.f;
            gden = 0.f;
          } else {
            gden = -(inv * s_ga + n * gv[h]) / (den * den);
          }
          den_out[row] = den;
          gden_out[row] = gden;
          part_d = static_cast<double>(s_ga / den) + static_cast<double>(gden * bb);
        }
        red[r] = part_d;
      }
    }
    consumers_sync();
    if (warp == 0) {  // the pairwise tree over the 128 rows: strides 64, 32, ..., 1
      double x2 = (red[lane] + red[lane + 64]) + (red[lane + 32] + red[lane + 96]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x2 += __shfl_down_sync(0xffffffffu, x2, off);
      if (lane == 0) {
        dinv_part[u] = x2;
        mbar_arrive(sempty);  // b_s and red are read: the next block's may come
      }
    }
  }
}

// The reduce's P pass for bf16 rows: P = q^T (g/den) over node slices on
// warpgroup MMAs (wgmma m64n64k16 bf16, f32 sums), both operands read
// node-major (MN-major descriptors: the MMA's k is the node axis),
// warp-specialised, fed by the copy engine and persistent: grid min(items,
// SMs), one block an SM, block b taking the items b, b + grid, ... in
// turn. It replaces, with the rows pass, sgformer_tpu/kernels/attention.py::
// _bwd_reduce_kernel for bf16 rows. Bound by its bytes (q, g, den and gden
// read once: 0.052 ms at the arxiv shape; its two products, q^T gd's hi and
// lo, 0.045). An item is (slice, m tile, d tile of 64 columns),
// slice-major; an m tile is as many 64-row m atoms as there are d tiles,
// up to four (256 m rows at D >= 256), consumer warpgroup w its m atoms 2 w
// and 2 w + 1 (two m64 MMA tiles) by the item's 64 d columns, so that each
// chunk's gd = g * (1/den) is formed and split once for every m row of the
// tile (the kernel this replaced, 128 m by 128 d a block, formed each gd
// twice, once in each m tile's block), and ds's f64 sums of the m tile's
// columns are spread over its d tiles' items, one m atom an item (there
// only the first d tile's blocks summed ds, and took longest).
//
// The producer warpgroup (its registers given to the consumers by
// setmaxnreg, one of its warps working) brings each 64-row chunk of q (the
// m tile's atoms, [64 nodes][64] each) and of g (the d tile's atom) into a
// kPsStages-deep ring by tensor maps of 64-row boxes (or its lanes' copies
// where the rows' strides do not allow one, vec 0), with 1/den (correctly
// rounded), gden and gden made f64 of the chunk's rows (read a chunk
// ahead, so that those loads run while it waits for a stage) and the
// chunk's rows inside the slice, through full and empty mbarriers. The
// consumers keep the kernel this replaced's arithmetic, so that P and ds
// are bitwise its: the rows of a chunk past the slice (which the copy
// engine reads) zeroed, gd = g * (1/den) in f32, zero past the slice, split
// into bf16 hi + lo atoms; each 32-node half of the chunk's products (two
// k16 steps, hi then lo) into fresh sums added to the item's f32 sums with
// round-to-nearest adds (the 32-row period), a software pipeline: chunk c's
// MMAs issued before the warps sum its ds and split chunk c + 1's gd into
// the other of two gd buffers, one consumer barrier a chunk. ds in the
// kernel this replaced's eight f64 chains a column (rows r % 8 = par + 2 i,
// i < 4, par 0 and 1; each value made f64, so each product is exact), a
// chain of two columns a thread, added in its order at the item's end: ((i
// 0 + 1) + (i 2 + 3)) for each par, par 0's + par 1's, rounded to f32 once.
// (ds on two of the producer's spare warps, a column a lane, held the pass
// at twice the consumers' time: PERF.md.) Dynamic shared memory: the ring
// (40 KB a stage), the gd atoms of two chunks (32 KB), 1/den, gden and gden
// in f64 of each stage, ds's chains and the mbarriers: 200 KB.
constexpr int kPRows = 64;  // node rows a staged chunk
constexpr int kPsStages = 4;
constexpr int kPsAtoms = 4;  // m atoms an m tile at most
constexpr int kPsStage = (kPsAtoms + 1) * kWgAtom16;  // q's m atoms, g's atom
constexpr int kPsThreads = kRowsConsumers + 128;
constexpr int kPsReaders = kRowsConsumers / 32;  // a stage's readers: the consumer warps
constexpr size_t kPsSmem = kPsStages * kPsStage + 4 * kWgAtom16 +
                           kPsStages * kPRows * (2 * sizeof(float) + sizeof(double)) +
                           8 * 64 * sizeof(double) + 2 * kPsStages * sizeof(uint64_t) +
                           kPsStages * sizeof(int);

// the P pass's items: (slice, m tile, d tile), slice-major
struct PsItems {
  int atoms, mtiles, dtiles, count;
  __host__ __device__ PsItems(int M, int D, int slices)
      : atoms(tc::cdiv(D, 64) < kPsAtoms ? tc::cdiv(D, 64) : kPsAtoms),
        mtiles(tc::cdiv(M, 64 * atoms)), dtiles(tc::cdiv(D, 64)),
        count(slices * mtiles * dtiles) {}
  // item it's slice, first m row and first d column
  __device__ void at(int it, int& s, int& m0, int& d0) const {
    s = it / (mtiles * dtiles);
    const int rest = it % (mtiles * dtiles);
    m0 = rest / dtiles * 64 * atoms;
    d0 = rest % dtiles * 64;
  }
};

// slice s's 64-row chunks
__device__ __forceinline__ int ps_chunks(int s, int N, int rows_per_slice) {
  const long r_begin = static_cast<long>(s) * rows_per_slice;
  const long rows = N - r_begin < rows_per_slice ? N - r_begin : rows_per_slice;
  return static_cast<int>((rows + kPRows - 1) / kPRows);
}

__global__ void __launch_bounds__(kPsThreads, 1)
la_bwd_reduce_ws16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g, long ldq,
                          long ldg, int N, int M, int D, int slices, int rows_per_slice, int vec,
                          const float* __restrict__ den, const float* __restrict__ gden,
                          float* __restrict__ P_part, float* __restrict__ ds_part,
                          const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (tc::smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem_raw;                   // [stage][q's m atoms; g's atom]
  unsigned char* gd = ring + kPsStages * kPsStage;  // [buffer][hi atom, lo atom]
  float* rows_s = reinterpret_cast<float*>(gd + 4 * kWgAtom16);  // [stage][1/den, gden][kPRows]
  double* gden_d = reinterpret_cast<double*>(rows_s + kPsStages * 2 * kPRows);  // [stage][kPRows]
  double* red = gden_d + kPsStages * kPRows;  // ds's chains [column][row % 8]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * 64);  // a stage has landed
  uint64_t* empty = full + kPsStages;                                  // a stage is read
  int* valid_s = reinterpret_cast<int*>(empty + kPsStages);  // a stage's rows inside the slice

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int i = 0; i < kPsStages; ++i) {
      tc::mbar_init(full + i, 1);
      tc::mbar_init(empty + i, kPsReaders);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kRowsConsumers / 32) {  // the producer warpgroup
    tc::setmaxnreg_dec<40>();
    if (warp > kRowsConsumers / 32) return;
    const PsItems items(M, D, slices);
    // the chunks, each into its stage once the consumers are done with it
    int ch = 0;
    for (int it = blockIdx.x; it < items.count; it += gridDim.x) {
      int s, m0, d0;
      items.at(it, s, m0, d0);
      const long r_begin = static_cast<long>(s) * rows_per_slice;
      const long r_end = r_begin + rows_per_slice < N ? r_begin + rows_per_slice
                                                      : static_cast<long>(N);
      const int chunks = static_cast<int>((r_end - r_begin + kPRows - 1) / kPRows);
      const int qa = min(items.atoms, tc::cdiv(M - m0, 64));  // the m atoms inside M
      // den and gden of chunk c's rows lane and lane + 32, read a chunk
      // ahead, so that the loads run while the producer waits for a stage
      float dn[2], gn[2];
      auto read_rows = [&](int c) {
        const long r0 = r_begin + static_cast<long>(c) * kPRows;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = c < chunks && r0 + lane + 32 * h < r_end;
          dn[h] = ok ? den[r0 + lane + 32 * h] : 0.f;
          gn[h] = ok ? gden[r0 + lane + 32 * h] : 0.f;
        }
      };
      read_rows(0);
      for (int c = 0; c < chunks; ++c, ++ch) {
        const int st = ch % kPsStages;
        if (ch >= kPsStages) tc::mbar_wait(empty + st, (ch / kPsStages - 1) & 1);
        unsigned char* qs = ring + st * kPsStage;
        const long r0 = r_begin + static_cast<long>(c) * kPRows;
        if (lane == 0) valid_s[st] = static_cast<int>(r_end - r0 < kPRows ? r_end - r0 : kPRows);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // 1/den and gden of the chunk's rows, zero past the slice
          const int r = lane + 32 * h;
          const bool ok = r0 + r < r_end;
          rows_s[st * 2 * kPRows + r] = ok ? __frcp_rn(dn[h]) : 0.f;
          rows_s[st * 2 * kPRows + kPRows + r] = gn[h];
          gden_d[st * kPRows + r] = static_cast<double>(gn[h]);
        }
        if (!vec) {  // q and g one element a lane at a time, zero past N and the widths
          for (int i = lane; i < kPRows * 64 * (qa + 1); i += 32) {
            const int a = i / (kPRows * 64);  // q's m atoms 0 .. qa - 1, then g's
            const int r = (i >> 6) % kPRows;
            const int c64 = i & 63;
            const bool is_g = a == qa;
            const bf16* X = is_g ? g : q;
            const long ld = is_g ? ldg : ldq;
            const int col = is_g ? d0 + c64 : m0 + 64 * a + c64;
            const bool ok = r0 + r < N && col < (is_g ? D : M);
            *reinterpret_cast<bf16*>(qs + (is_g ? kPsAtoms : a) * kWgAtom16 +
                                     sw128_offset(r, c64)) =
                ok ? X[(r0 + r) * ld + col] : __float2bfloat16_rn(0.f);
          }
          tc::fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) {
          if (vec) {
            tc::mbar_arrive_expect_tx(full + st, (qa + 1) * kWgAtom16);
            for (int a = 0; a < qa; ++a) {
              tc::tma_load_2d(qs + a * kWgAtom16, &map_q, m0 + 64 * a, static_cast<int>(r0),
                              full + st);
            }
            tc::tma_load_2d(qs + kPsAtoms * kWgAtom16, &map_g, d0, static_cast<int>(r0),
                            full + st);
          } else {
            tc::mbar_arrive(full + st);
          }
        }
        read_rows(c + 1);
      }
    }
    return;
  }

  tc::setmaxnreg_inc<232>();
  const PsItems items(M, D, slices);
  const int wg = warp >> 2;
  // ds: the thread's chain (rows r % 8 = ci, chain ci / 2 of the rows of
  // parity ci % 2) of the item's ds columns 2 cp and 2 cp + 1; a warp's
  // lanes read one row's 64 columns at a time
  const int cp = tid & 31;
  const int ci = tid >> 5;
  // acc[b]: the item's sums of the warpgroup's m64 tile b by the d tile;
  // part[half][b]: a chunk half's fresh sums (both tiles' MMAs run where
  // the m tile has fewer atoms or M ends inside it, on rows never stored:
  // MMAs under a condition are serialised by ptxas)
  float acc[2][32], part[2][2][32];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) part[0][b][i] = part[1][b][i] = 0.f;
  int ch = 0;  // chunks consumed
  for (int it = blockIdx.x; it < items.count; it += gridDim.x) {
    int s, m0, d0;
    items.at(it, s, m0, d0);
    const int chunks = ps_chunks(s, N, rows_per_slice);
    const int atom = d0 / 64;  // the m tile's atom whose ds this item sums
    const bool stats = atom < items.atoms && m0 + 64 * atom < M;  // uniform over the block
    double dsc[2] = {0.0, 0.0};
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;

    // the block's cc-th chunk into gd buffer cc % 2, once its stage has
    // landed: its rows past the slice (which the copy engine read) as
    // zeros, gd = g * (1/den) as bf16 hi + lo, 8 columns of one row a
    // thread step
    auto split = [&](int cc) {
      const int st = cc % kPsStages;
      tc::mbar_wait(full + st, (cc / kPsStages) & 1);
      unsigned char* qs = ring + st * kPsStage;
      const unsigned char* gs = qs + kPsAtoms * kWgAtom16;
      const float* rd_s = rows_s + st * 2 * kPRows;
      unsigned char* gdb = gd + (cc & 1) * 2 * kWgAtom16;
      const int valid = valid_s[st];
      for (int i = tid; i < (kPRows - valid) * 8 * kPsAtoms; i += kRowsConsumers) {
        const int r = valid + i / (8 * kPsAtoms);
        const int cs = (i % (8 * kPsAtoms)) * 8;
        *reinterpret_cast<uint4*>(qs + (cs >> 6) * kWgAtom16 + sw128_offset(r, cs & 63)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kPRows * 8 / kRowsConsumers; ++k) {
        const int i = tid + k * kRowsConsumers;
        const int r = i >> 3;
        const int off = sw128_offset(r, (i & 7) * 8);
        const bool ok = r < valid;
        const float rd = ok ? rd_s[r] : 0.f;
        const uint4 raw = *reinterpret_cast<const uint4*>(gs + off);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint4 hi_raw, lo_raw;
        __nv_bfloat162* hi2 = reinterpret_cast<__nv_bfloat162*>(&hi_raw);
        __nv_bfloat162* lo2 = reinterpret_cast<__nv_bfloat162*>(&lo_raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          const float x = ok ? __fmul_rn(f.x, rd) : 0.f;
          const float y = ok ? __fmul_rn(f.y, rd) : 0.f;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          hi2[e] = hi;
          lo2[e] = __floats2bfloat162_rn(x - hf.x, y - hf.y);
        }
        *reinterpret_cast<uint4*>(gdb + off) = hi_raw;
        *reinterpret_cast<uint4*>(gdb + kWgAtom16 + off) = lo_raw;
      }
      tc::fence_proxy_async();  // gd's stores and the zeroed rows, for the MMAs
    };

    // a software pipeline: chunk c's MMAs run while the warps split chunk
    // c + 1's gd into the other buffer; one barrier a chunk
    if (chunks > 0) split(ch);
    consumers_sync();
    for (int c = 0; c < chunks; ++c, ++ch) {
      const int st = ch % kPsStages;
      const unsigned char* qs = ring + st * kPsStage;
      const unsigned char* gdb = gd + (ch & 1) * 2 * kWgAtom16;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int b = 0; b < 2; ++b) tc::wgmma_fence_operand(part[half][b]);
        tc::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k = 2 * half + ks;  // node rows 16k .. 16k + 15 of the chunk
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint64_t db = sw128_desc_mn(gdb + p * kWgAtom16 + k * 2048);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              tc::wgmma_m64n64k16<1>(part[half][b],
                                     sw128_desc_mn(qs + (2 * wg + b) * kWgAtom16 + k * 2048), db,
                                     ks | p);
            }
          }
        }
        tc::wgmma_commit();
      }
      if (stats) {  // ds of the chunk's rows (zero past the slice) while its MMAs run
        const unsigned char* qc = qs + atom * kWgAtom16;
        const double* gden_c = gden_d + st * kPRows;
#pragma unroll
        for (int r = ci; r < kPRows; r += 8) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qc + sw128_offset(r, 2 * cp)));
          dsc[0] = fma(static_cast<double>(x.x), gden_c[r], dsc[0]);
          dsc[1] = fma(static_cast<double>(x.y), gden_c[r], dsc[1]);
        }
      }
      if (c + 1 < chunks) split(ch + 1);
      // each half's sums, in order, into the item's
      tc::wgmma_wait<1>();
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        tc::wgmma_fence_operand(part[0][b]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = __fadd_rn(acc[b][i], part[0][b][i]);
      }
      tc::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        tc::wgmma_fence_operand(part[1][b]);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = __fadd_rn(acc[b][i], part[1][b][i]);
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(empty + st);
      consumers_sync();  // chunk c's gd is free, chunk c + 1's is in place
    }

    float* Pp = P_part + static_cast<size_t>(s) * M * D;
    const bool pairs = (D & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (2 * wg + b >= items.atoms) continue;  // the next m tile's rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 128 * wg + 64 * b + 16 * (warp & 3) + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        float* prow = Pp + static_cast<size_t>(m) * D;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d0 + 8 * j + 2 * (lane & 3);
          const float x = acc[b][4 * j + 2 * h];
          const float y = acc[b][4 * j + 2 * h + 1];
          if (pairs && d + 1 < D) {
            *reinterpret_cast<float2*>(prow + d) = make_float2(x, y);
          } else {
            if (d < D) prow[d] = x;
            if (d + 1 < D) prow[d + 1] = y;
          }
        }
      }
    }
    if (stats) {  // ds in the kernel this replaced's order, rounded to f32 once
      red[(2 * cp) * 8 + ci] = dsc[0];
      red[(2 * cp + 1) * 8 + ci] = dsc[1];
      consumers_sync();
      const int col = m0 + 64 * atom + tid;
      if (tid < 64 && col < M) {
        // chain i of parity par at red[8 tid + par + 2 i]
        const double* p = red + tid * 8;
        const double ds0 = (p[0] + p[2]) + (p[4] + p[6]);
        const double ds1 = (p[1] + p[3]) + (p[5] + p[7]);
        ds_part[static_cast<size_t>(s) * M + col] = static_cast<float>(ds0 + ds1);
      }
      consumers_sync();  // red is read
    }
  }
}

// The bf16 apply's B operands as la_bwd_split_tiles_kernel lays them out:
// for each product w (dq: kvs, dk: P, as [n = M][k = D]; dv: P^T, as [n =
// D][k = M]) its [128 n][64 k] chunks, hi then lo, each swizzled as the
// apply's shared memory holds it (16 KB, zero past the widths), column tile
// by column tile and k chunk by k chunk, so that one bulk copy moves a
// piece's chunk.
struct ApTiles {
  int M, D;
  __host__ __device__ ApTiles(int M_, int D_) : M(M_), D(D_) {}
  __host__ __device__ int kch(int w) const { return tc::cdiv(w == 2 ? M : D, 64); }
  __host__ __device__ int tiles(int w) const { return tc::cdiv(w == 2 ? D : M, 128); }
  __host__ __device__ size_t elems(int w) const {
    return static_cast<size_t>(tiles(w)) * kch(w) * 2 * 8192;
  }
  __host__ __device__ size_t total() const { return elems(0) + elems(1) + elems(2); }
  // the first element of piece p of product w's chunk (column tile ct, k chunk kc)
  __host__ __device__ size_t chunk(int w, int ct, int kc, int p) const {
    const size_t base = w == 0 ? 0 : (w == 1 ? elems(0) : elems(0) + elems(1));
    return base + (static_cast<size_t>(ct * kch(w) + kc) * 2 + p) * 8192;
  }
};

// hl = kvs, P and P^T as bf16 hi + lo in ApTiles' layout (each element x
// as hi = bf16(x), lo = bf16(x - hi)).
__global__ void __launch_bounds__(kThreads)
la_bwd_split_tiles_kernel(const float* __restrict__ kvs, const float* __restrict__ P, int M,
                          int D, bf16* __restrict__ hl) {
  const ApTiles a(M, D);
  const size_t count = a.total() / 2;  // elements of one piece, over the three products
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t j = i;
    int w = 0;
    for (; w < 2; ++w) {
      const size_t per = a.elems(w) / 2;
      if (j < per) break;
      j -= per;
    }
    const int kp = a.kch(w) * 64;
    const int n = static_cast<int>(j / kp);
    const int kk = static_cast<int>(j % kp);
    float x = 0.f;
    if (w == 2) {
      if (n < D && kk < M) x = P[static_cast<size_t>(kk) * D + n];
    } else if (n < M && kk < D) {
      x = (w == 0 ? kvs : P)[static_cast<size_t>(n) * D + kk];
    }
    const bf16 hi = __float2bfloat16_rn(x);
    const size_t off = a.chunk(w, n / 128, kk / 64, 0) + sw128_offset(n % 128, kk % 64) / 2;
    hl[off] = hi;
    hl[off + 8192] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

// The bf16 apply for M or D above 256 (up to kWgMaxK16; the persistent
// la_bwd_apply_ws16_kernel below takes the widths up to 256, whose A slots
// fit its shared memory). grid (ceil(N / 128)), 128 rows a block. Its
// three products (dq: g @ kvs^T over D; dk: v @ P^T over D; dv: k @ P over
// M), each over 128-column tiles of its output, run as one stream of 64-deep
// chunks: a chunk is the A rows' [128][64] tile of the product (g, v or k)
// and the B operand's hi and lo [128 n][64 k] tiles (kvs, P or P^T, laid
// out swizzled by la_bwd_split_tiles_kernel), through a kApStages-deep ring.
// Blocks start at different products (rot), so that the SMs do not all
// read one tensor at once.
//
// The warps specialise: a producer warp issues every copy, by the copy
// engine (TMA): each chunk (the A rows by a tensor map, the B tiles by
// bulk copies of 16 KB) as the consumers free its stage, and each column
// tile's operand for the epilogue (q, k or g; two [128][64] boxes by a
// tensor map) into one of two buffers once the tile two back has left it;
// full and empty mbarriers hand stages and buffers over. Two consumer
// warpgroups of 64 rows run each chunk's four k16 steps of wgmma
// m64n128k16, hi then lo into one accumulator (the parent's sums: no fresh
// sums, the products do not cancel), and finish each column tile warp by
// warp: each warp reads its 16 rows of the operand at its fragment and
// writes the output there in place as bf16, with the parent's epilogue
// terms in their order (den and gden of its rows loaded once a block, ksum
// and ds staged once a block, each division by den through the row's
// reciprocal, div_by); one thread then stores the tile by the copy engine,
// which clips it to the output. (Copies and stores issued by the warps
// that also ran the MMAs and epilogues stalled them: the SM takes new
// copies only as fast as device memory returns the old ones.) Where the
// views' strides or bases do not allow a tensor map (vec_a, vec_io 0) the
// producer's lanes copy the A rows and operands one element at a time and
// the consumers store their rows. Dynamic shared memory: the ring (48 KB a
// stage), the two operand buffers (64 KB), ksum and ds, the mbarriers: 210
// KB at M = 256.
constexpr int kApStages = 3;
constexpr int kApConsumers = 2 * 128;          // two warpgroups
constexpr int kApThreads = kApConsumers + 32;  // and the producer warp
constexpr int kApStage = 3 * kWgTile16;        // A, B hi, B lo: [128][64] each
// the widest rows it takes (M and D padded to 64): any width fits its
// shared memory, but above 704 the CUDA-core kernel runs, where the
// mma.sync kernel's A tile stopped fitting
constexpr int kWgMaxK16 = 704;

size_t apply_wgmma_smem(int M) {
  return static_cast<size_t>(kApStages) * kApStage + 4 * kWgTile16 +
         2 * static_cast<size_t>(tc::cdiv(M, 4) * 4) * sizeof(float) +
         (2 * kApStages + 4) * sizeof(uint64_t);
}

// the apply's tensor maps: its A rows (g, v, k), its epilogue operands (q,
// k, g) and its outputs (dq, dk, dv)
struct ApMaps {
  CUtensorMap g, v, k, q, dq, dk, dv;
};

__global__ void __launch_bounds__(kApThreads, 1)
la_bwd_apply_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g, long ldq,
                          long ldk, long ldv, long ldg, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, long lddq, long lddk,
                          long lddv, int N, int M, int D, const bf16* __restrict__ hl,
                          const float* __restrict__ ksum, const float* __restrict__ ds,
                          const float* __restrict__ scal, const float* __restrict__ n_total,
                          const float* __restrict__ dinv, const float* __restrict__ den,
                          const float* __restrict__ gden, int guard, int vec_a, int vec_io,
                          const __grid_constant__ ApMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (tc::smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem_raw;                          // [stage][A, B hi, B lo]
  unsigned char* Xs = ring + kApStages * kApStage;         // [buffer][2][128][64]
  float* col_s = reinterpret_cast<float*>(Xs + 4 * kWgTile16);  // ksum, then ds
  const int Mc = tc::cdiv(M, 4) * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(col_s + 2 * Mc);  // a stage has landed
  uint64_t* empty = full + kApStages;                            // a stage's MMAs are done
  uint64_t* xfull = empty + kApStages;                           // an operand has landed
  uint64_t* xempty = xfull + 2;                                  // a tile has left its buffer
  const TcDims t(M, D);
  const ApTiles at(M, D);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;
  const int rot = static_cast<int>(blockIdx.x);

  // column tiles of product which, and its k chunks
  auto tiles_of = [&](int which) { return tc::cdiv(which == 2 ? D : M, 128); };
  auto kch_of = [&](int which) { return (which == 2 ? t.Mk : t.Dk) / 64; };
  const int tiles = 2 * tiles_of(0) + tiles_of(2);
  const int chunks = 2 * tiles_of(0) * kch_of(0) + tiles_of(2) * kch_of(2);
  // tile tt as (product, first column); products in the block's order
  auto tile_at = [&](int tt, int& which, int& c0) {
    for (int w = 0; w < 3; ++w) {
      which = (w + rot) % 3;
      if (tt < tiles_of(which) || w == 2) break;
      tt -= tiles_of(which);
    }
    c0 = tt * 128;
  };
  // chunk ch as (product, first column, k chunk)
  auto locate = [&](int ch, int& which, int& c0, int& kc) {
    for (int w = 0; w < 3; ++w) {
      which = (w + rot) % 3;
      const int per = tiles_of(which) * kch_of(which);
      if (ch < per || w == 2) break;
      ch -= per;
    }
    c0 = ch / kch_of(which) * 128;
    kc = ch % kch_of(which);
  };

  if (tid == 0) {
    for (int i = 0; i < kApStages; ++i) {
      tc::mbar_init(full + i, 1);  // the producer's, with its copies' bytes
      tc::mbar_init(empty + i, kApConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      tc::mbar_init(xfull + i, 1);
      tc::mbar_init(xempty + i, 1);
    }
    tc::mbar_init_fence();
  }
  for (int i = tid; i < 2 * Mc; i += kApThreads) {
    const int c = i < Mc ? i : i - Mc;
    col_s[i] = c < M ? (i < Mc ? ksum[c] : ds[c]) : 0.f;
  }
  __syncthreads();

  if (warp == kApConsumers / 32) {  // the producer
    // tile tt's operand into buffer tt % 2, once tile tt - 2 has left it
    auto load_x = [&](int tt) {
      const int b = tt & 1;
      if (tt >= 2) tc::mbar_wait(xempty + b, ((tt - 2) >> 1) & 1);
      int which, c0;
      tile_at(tt, which, c0);
      unsigned char* Xb = Xs + b * 2 * kWgTile16;
      if (!vec_io) {
        const bf16* X = which == 0 ? q : (which == 1 ? k : g);
        const long ldx = which == 0 ? ldq : (which == 1 ? ldk : ldg);
        const int C = which == 2 ? D : M;
        for (int i = lane; i < 128 * 128; i += 32) {
          const int r = i >> 7;
          const int c = i & 127;
          const bool ok = r0 + r < N && c0 + c < C;
          *reinterpret_cast<bf16*>(Xb + (c >> 6) * kWgTile16 + sw128_offset(r, c & 63)) =
              ok ? X[(r0 + r) * ldx + c0 + c] : __float2bfloat16_rn(0.f);
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(xfull + b);
      } else if (lane == 0) {
        const CUtensorMap* map = which == 0 ? &maps.q : (which == 1 ? &maps.k : &maps.g);
        tc::mbar_arrive_expect_tx(xfull + b, 2 * kWgTile16);
        for (int h = 0; h < 2; ++h) {
          tc::tma_load_2d(Xb + h * kWgTile16, map, c0 + 64 * h, static_cast<int>(r0), xfull + b);
        }
      }
    };
    load_x(0);
    int tt = 0;  // the tile of chunk ch
    for (int ch = 0; ch < chunks; ++ch) {
      const int st = ch % kApStages;
      if (ch >= kApStages) tc::mbar_wait(empty + st, (ch / kApStages - 1) & 1);
      int which, c0, kc;
      locate(ch, which, c0, kc);
      unsigned char* dst = ring + st * kApStage;
      if (!vec_a) {  // the A rows [128][64] one element a lane at a time
        const bf16* A = which == 0 ? g : (which == 1 ? v : k);
        const long lda = which == 0 ? ldg : (which == 1 ? ldv : ldk);
        const int K = which == 2 ? M : D;
        for (int i = lane; i < 128 * 64; i += 32) {
          const int r = i >> 6;
          const int c = i & 63;
          const bool ok = r0 + r < N && kc * 64 + c < K;
          *reinterpret_cast<bf16*>(dst + sw128_offset(r, c)) =
              ok ? A[(r0 + r) * lda + kc * 64 + c] : __float2bfloat16_rn(0.f);
        }
        tc::fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {  // B's hi and lo chunks, and the A rows
        tc::mbar_arrive_expect_tx(full + st, (vec_a ? 3 : 2) * kWgTile16);
        const bf16* src = hl + at.chunk(which, c0 / 128, kc, 0);
        tc::bulk_copy_g2s(dst + kWgTile16, src, kWgTile16, full + st);
        tc::bulk_copy_g2s(dst + 2 * kWgTile16, src + 8192, kWgTile16, full + st);
        if (vec_a) {
          const CUtensorMap* map = which == 0 ? &maps.g : (which == 1 ? &maps.v : &maps.k);
          tc::tma_load_2d(dst, map, kc * 64, static_cast<int>(r0), full + st);
        }
      }
      if (kc == kch_of(which) - 1) {  // the next tile's operand, a tile ahead
        ++tt;
        if (tt < tiles) load_x(tt);
      }
    }
    return;
  }

  // the consumers
  const float inv = scal[2];
  const float n = *n_total;
  const bool no_norm = guard && inv == 0.f;  // the guard: no dinv term
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
  // den, its reciprocal and gden of the lane's two fragment rows, loaded once
  float den_r[2], rden_r[2], gden_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long row = r0 + 16 * warp + (lane >> 2) + 8 * h;
    den_r[h] = row < N ? den[row] : 1.f;
    rden_r[h] = __frcp_rn(den_r[h]);
    gden_r[h] = row < N ? gden[row] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int tt = 0;  // the tile of chunk ch
  for (int ch = 0; ch < chunks; ++ch) {
    int which, c0, kc;
    locate(ch, which, c0, kc);
    const int kch = kch_of(which);
    const int st = ch % kApStages;
    tc::mbar_wait(full + st, (ch / kApStages) & 1);
    const unsigned char* stage = ring + st * kApStage;
    const unsigned char* a_tile = stage + (warp >> 2) * kWgAtom16;
    tc::wgmma_fence_operand(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sw128_desc(a_tile + ks * 32);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        tc::wgmma_m64n128k16(acc, da, sw128_desc(stage + (1 + p) * kWgTile16 + ks * 32),
                             kc > 0 || ks > 0 || p > 0);
      }
    }
    tc::wgmma_commit();
    if (vec_io && kc == 0 && tt > 0 && tid == 0) {  // the last tile has left its buffer
      tc::bulk_store_wait_read();
      tc::mbar_arrive(xempty + ((tt - 1) & 1));
    }
    tc::wgmma_wait<0>();
    tc::wgmma_fence_operand(acc);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(empty + st);
    if (kc == kch - 1) {  // the column tile's epilogue, warp by warp, into its buffer
      const int b = tt & 1;
      tc::mbar_wait(xfull + b, (tt >> 1) & 1);
      unsigned char* Xb = Xs + b * 2 * kWgTile16;
      // the product's epilogue, its terms in the parent's order, one loop a
      // product (compiled apart, so that no element tests the product)
      auto finish = [&](auto product) {
        constexpr int kWhich = decltype(product)::value;
        const float* cs_col = col_s + (kWhich == 0 ? 0 : Mc);  // ksum (dq) or ds (dk)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int cl = 8 * j + 2 * (lane & 3);
          float col[2] = {0.f, 0.f};
          if constexpr (kWhich < 2) {
#pragma unroll
            for (int e = 0; e < 2; ++e) col[e] = c0 + cl + e < M ? cs_col[c0 + cl + e] : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                Xb + (cl >> 6) * kWgTile16 +
                sw128_offset(16 * warp + (lane >> 2) + 8 * h, cl & 63));
            const float2 x2 = __bfloat1622float2(*p);
            const float x[2] = {x2.x, x2.y};
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = acc[4 * j + 2 * h + e];
              if constexpr (kWhich == 0) {
                o[e] = inv * tc::div_by(a, den_r[h], rden_r[h]) + inv * gden_r[h] * col[e] - c_q * x[e];
              } else if constexpr (kWhich == 1) {
                o[e] = inv * a + inv * col[e] - c_k * x[e];
              } else {
                o[e] = n * tc::div_by(x[e], den_r[h], rden_r[h]) + inv * a;
              }
            }
            *p = __floats2bfloat162_rn(o[0], o[1]);
          }
        }
      };
      if (which == 0) {
        finish(std::integral_constant<int, 0>{});
      } else if (which == 1) {
        finish(std::integral_constant<int, 1>{});
      } else {
        finish(std::integral_constant<int, 2>{});
      }
      if (vec_io) {  // the tile out by the copy engine, clipped to the output
        tc::fence_proxy_async();
        consumers_sync();
        if (tid == 0) {
          const CUtensorMap* map = which == 0 ? &maps.dq : (which == 1 ? &maps.dk : &maps.dv);
          for (int h = 0; h < 2; ++h) {
            tc::tma_store_2d(map, c0 + 64 * h, static_cast<int>(r0), Xb + h * kWgTile16);
          }
          tc::bulk_store_commit();
        }
      } else {  // the warp's rows, 16 bytes a lane where they allow
        __syncwarp();
        bf16* out = which == 0 ? dq : (which == 1 ? dk : dv);
        const long ldo = which == 0 ? lddq : (which == 1 ? lddk : lddv);
        const int C = which == 2 ? D : M;
        for (int i = lane; i < 16 * 16; i += 32) {
          const int r = 16 * warp + (i >> 4);
          const int cs = (i & 15) * 8;
          const long row = r0 + r;
          if (row >= N || c0 + cs >= C) continue;
          const bf16* s8 = reinterpret_cast<const bf16*>(Xb + (cs >> 6) * kWgTile16 +
                                                         sw128_offset(r, cs & 63));
          for (int e = 0; e < 8 && c0 + cs + e < C; ++e) out[row * ldo + c0 + cs + e] = s8[e];
        }
        consumers_sync();
        if (tid == 0) tc::mbar_arrive(xempty + b);
      }
      ++tt;
    }
  }
  if (vec_io && tid == 0) tc::bulk_store_wait_read();
}

// The bf16 apply, persistent: the f32 apply's design below
// (la_bwd_apply_ws_kernel) on la_bwd_apply_wgmma_kernel's products, for
// widths up to 256 (M and D padded to 64: at most kAsMaxSlots k chunks).
// grid min(3 ceil(N / 256), SMs), one block an SM, block b taking the items
// b, b + grid, ... in turn, item u product u % 3 (dq: g @ kvs^T over D; dk:
// v @ P^T over D; dv: k @ P over M) of the 256-row block u / 3. It replaces
// sgformer_tpu/kernels/attention.py::_bwd_apply_kernel for bf16 rows; bound
// by its bytes (q, k, v, g read and dq, dk, dv written once: 0.182 ms at
// the arxiv shape; its six split products 0.135). Two consumer warpgroups of
// 128 rows each, two m64n128 sums a warpgroup over the same B descriptors,
// so that each B chunk serves 256 rows before it leaves shared memory (the
// kernel before read B again for every 128 rows), and a producer warpgroup,
// which gives its registers to the consumers (setmaxnreg). Dynamic shared
// memory, 1024-byte aligned (no static shared memory), every tile 128-byte
// swizzled over rows of 64 bf16 (sw128_offset): an item's A rows (g, v or k)
// as up to four slots of one k chunk each ([256 rows][64], 32 KB; 128 KB at
// a depth of 256), each A row read from device memory once an item; a ring
// of kAsStages 32 KB stages that carries, column tile by column tile, the
// tile's B chunks (kvs, P or P^T as bf16 hi and lo [128 n][64 k], laid out
// swizzled by la_bwd_split_tiles_kernel: two 16 KB bulk copies a chunk) and
// then its epilogue operand (q, k or g) in halves of [256 rows][64 columns];
// ksum and ds; mbarriers: 226 KB at M = D = 256. (The A slots, B stages and
// a whole [256][128] operand tile do not fit one block's 227 KB, so the
// operand halves pass through the B ring.)
//
// The next item's A rows arrive under this item's last column tile, slot by
// slot: there each consumer warp frees slot j (an empty mbarrier of its own)
// once the MMAs that read k chunk j are done, and the producer brings the
// next item's k chunk j into it; the first column tile waits for each slot
// as it reaches it. Slots past an item's depth (M != D) are handed over
// empty, so that every slot's barriers complete once an item.
//
// The producer warpgroup: warp 0 fills the ring in its order, lane 0 by the
// copy engine (the B chunks by bulk copies, the operand halves by a tensor
// map, two [128][64] boxes each) as the consumers free its stages; warp 1
// brings the A slots by a tensor map. Where the views' strides or bases do
// not allow a tensor map (vec_a, vec_io 0) warps 0 and 1 copy the operand
// halves and A rows one element a lane at a time and each consumer warp
// stores its own rows. The consumers keep la_bwd_apply_wgmma_kernel's
// arithmetic, so that the outputs are bitwise its: each chunk's four k16
// steps of wgmma m64n128k16, hi then lo into one sum a tile (the products do
// not cancel), k chunks in order, the two sums' steps interleaved; each
// chunk's MMAs are drained before its stage is freed, so that two stages are
// free for the copies of the chunks after it (queueing the next chunk's MMAs
// first, wgmma.wait_group 1, held a stage a chunk longer, and every chunk
// waited for its copy: 0.32 against 0.29 ms at the arxiv shape, PERF.md).
// The tile's last chunk issues sum 0's steps and sum 1's as two groups, and
// sum 0's epilogue runs under sum 1's MMAs. The epilogue at each lane's
// fragment, in the operand's halves in place (read and written by ldmatrix
// and stmatrix, all of a call's reads before its writes), the terms of that
// kernel in their order and fused as it fused them (den and gden of the
// lane's rows loaded once an item, ksum and ds staged once a block, each
// division correctly rounded through the row's reciprocal, tc::div_by):
// sum 0's and sum 1's rows of the first half, stored by the copy engine
// (one store a warpgroup and half, clipped to the output), then the second
// half's, its first sum's rows before the first half's stage is freed (its
// store has read it by then), the second half's stage freed once the next
// chunk's MMAs are issued.
constexpr int kAsRows = 2 * kTcRows;            // rows an item: 128 a consumer warpgroup
constexpr int kAsConsumers = 2 * 128;
constexpr int kAsThreads = kAsConsumers + 128;  // and the producer warpgroup
constexpr int kAsStages = 3;
constexpr int kAsSlot = 2 * kWgTile16;   // an item's A rows of one k chunk, [256][64]
constexpr int kAsStage = 2 * kWgTile16;  // B's hi and lo [128 n][64 k], or an operand half [256][64]
constexpr int kAsMaxSlots = 4;           // k chunks an item at most: widths up to 256
// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers', together the 168 a thread of the launch (under 56 the
// producer's loops spilled)
constexpr int kAsProducerRegs = 56;
constexpr int kAsConsumerRegs = 224;
static_assert(2 * kAsConsumerRegs + kAsProducerRegs == 3 * 168, "the launch's registers");

int apply_ws16_slots(int M, int D) { return std::max(tc::cdiv(M, 64), tc::cdiv(D, 64)); }

size_t apply_ws16_smem(int M, int D) {
  const int slots = apply_ws16_slots(M, D);
  return static_cast<size_t>(slots) * kAsSlot + static_cast<size_t>(kAsStages) * kAsStage +
         2 * static_cast<size_t>(tc::cdiv(M, 128) * 128) * sizeof(float) +
         2 * static_cast<size_t>(slots + kAsStages) * sizeof(uint64_t);
}

// whether the persistent kernel takes these widths (else
// la_bwd_apply_wgmma_kernel, up to kWgMaxK16)
bool apply_ws16_fits(int M, int D) {
  return apply_ws16_slots(M, D) <= kAsMaxSlots && apply_ws16_smem(M, D) <= kSmemPerBlock;
}

// an mbarrier arrival counted `count` times (a warpgroup's four warps)
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

// four 8 x 8 b16 blocks of shared memory into (ldmatrix_rows) or from
// (stmatrix_rows) the accumulator's fragment layout: lane l addresses row l %
// 8 of block l / 8 and holds the column pair 2 (l % 4) of row l / 4 of each
// block
__device__ __forceinline__ void ldmatrix_rows(unsigned (&r)[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_addr(p)));
}
__device__ __forceinline__ void stmatrix_rows(unsigned char* p, const unsigned (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   tc::smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// consumer warpgroup wg's own barrier
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__global__ void __launch_bounds__(kAsThreads, 1)
la_bwd_apply_ws16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g, long ldq,
                         long ldk, long ldv, long ldg, bf16* __restrict__ dq,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, long lddq, long lddk,
                         long lddv, int N, int M, int D, const bf16* __restrict__ hl,
                         const float* __restrict__ ksum, const float* __restrict__ ds,
                         const float* __restrict__ scal, const float* __restrict__ n_total,
                         const float* __restrict__ dinv, const float* __restrict__ den,
                         const float* __restrict__ gden, int guard, int vec_a, int vec_io,
                         const __grid_constant__ ApMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const ApTiles at(M, D);
  const int slots = max(at.kch(0), at.kch(2));
  const int items = 3 * cdiv(N, kAsRows);
  const int Mp = cdiv(M, 128) * 128;
  unsigned char* As = smem_raw;                                          // [slot][256][64]
  unsigned char* Rs = As + static_cast<size_t>(slots) * kAsSlot;         // [stage]
  float* col_s = reinterpret_cast<float*>(Rs + kAsStages * kAsStage);    // ksum, then ds
  uint64_t* afull = reinterpret_cast<uint64_t*>(col_s + 2 * Mp);  // an A slot has landed
  uint64_t* aempty = afull + slots;                               // an A slot is read
  uint64_t* full = aempty + slots;                                // a stage has landed
  uint64_t* empty = full + kAsStages;                             // a stage is read
  // the 64-column halves of product w's column tile t that reach its output
  auto halves = [&](int w, int t) { return min(2, cdiv((w == 2 ? D : M) - 128 * t, 64)); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int j = 0; j < slots; ++j) {
      mbar_init(afull + j, 1);
      mbar_init(aempty + j, kAsConsumers / 32);
    }
    for (int s = 0; s < kAsStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kAsConsumers / 32);
    }
    mbar_init_fence();
  }
  for (int i = tid; i < 2 * Mp; i += kAsThreads) {  // ksum, then ds
    const int c = i < Mp ? i : i - Mp;
    col_s[i] = c < M ? (i < Mp ? ksum[c] : ds[c]) : 0.f;
  }
  __syncthreads();

  if (warp >= kAsConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<kAsProducerRegs>();
    const int pw = warp - kAsConsumers / 32;
    if (pw == 0) {  // the ring: each column tile's B chunks, then its operand's halves
      int e = 0;    // entries issued
      for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int w = u % 3;
        const long r0 = static_cast<long>(u / 3) * kAsRows;
        const int boxes = N - r0 > kTcRows ? 2 : 1;  // [128]-row boxes holding rows below N
        for (int t = 0; t < at.tiles(w); ++t) {
          const int kch = at.kch(w);
          for (int c = 0; c < kch + halves(w, t); ++c, ++e) {
            const int st = e % kAsStages;
            if (e >= kAsStages) mbar_wait(empty + st, (e / kAsStages - 1) & 1);
            unsigned char* dst = Rs + st * kAsStage;
            if (c < kch) {  // B's hi and lo of k chunk c
              if (lane == 0) {
                mbar_arrive_expect_tx(full + st, kAsStage);
                const bf16* src = hl + at.chunk(w, t, c, 0);
                bulk_copy_g2s(dst, src, kWgTile16, full + st);
                bulk_copy_g2s(dst + kWgTile16, src + 8192, kWgTile16, full + st);
              }
              continue;
            }
            const int c0 = 128 * t + 64 * (c - kch);  // the operand's half
            if (vec_io) {
              if (lane == 0) {
                const CUtensorMap* map = w == 0 ? &maps.q : (w == 1 ? &maps.k : &maps.g);
                mbar_arrive_expect_tx(full + st, boxes * kWgTile16);
                for (int b = 0; b < boxes; ++b) {
                  tma_load_2d(dst + b * kWgTile16, map, c0, static_cast<int>(r0) + kTcRows * b,
                              full + st);
                }
              }
            } else {
              const bf16* X = w == 0 ? q : (w == 1 ? k : g);
              const long ldx = w == 0 ? ldq : (w == 1 ? ldk : ldg);
              const int C = w == 2 ? D : M;
#pragma unroll 1  // rolled: the producer's 56 registers
              for (int i = lane; i < kAsRows * 64; i += 32) {
                const int r = i >> 6;
                const int cc = i & 63;
                *reinterpret_cast<bf16*>(dst + sw128_offset(r, cc)) =
                    r0 + r < N && c0 + cc < C ? X[(r0 + r) * ldx + c0 + cc]
                                              : __float2bfloat16_rn(0.f);
              }
              __syncwarp();
              if (lane == 0) mbar_arrive(full + st);
            }
          }
        }
      }
    } else if (pw == 1) {  // each item's A slots, slot j once the last item has read it
      int i = 0;
      for (int u = blockIdx.x; u < items; u += gridDim.x, ++i) {
        const int w = u % 3;
        const long r0 = static_cast<long>(u / 3) * kAsRows;
        const int boxes = N - r0 > kTcRows ? 2 : 1;
        for (int j = 0; j < slots; ++j) {
          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);
          unsigned char* dst = As + static_cast<size_t>(j) * kAsSlot;
          if (j >= at.kch(w)) {  // past the item's depth: handed over empty
            if (lane == 0) mbar_arrive(afull + j);
          } else if (vec_a) {
            if (lane == 0) {
              const CUtensorMap* map = w == 0 ? &maps.g : (w == 1 ? &maps.v : &maps.k);
              mbar_arrive_expect_tx(afull + j, boxes * kWgTile16);
              for (int b = 0; b < boxes; ++b) {
                tma_load_2d(dst + b * kWgTile16, map, 64 * j, static_cast<int>(r0) + kTcRows * b,
                            afull + j);
              }
            }
          } else {
            const bf16* A = w == 0 ? g : (w == 1 ? v : k);
            const long lda = w == 0 ? ldg : (w == 1 ? ldv : ldk);
            const int K = w == 2 ? M : D;
#pragma unroll 1  // rolled: the producer's 56 registers
            for (int e = lane; e < kAsRows * 64; e += 32) {
              const int r = e >> 6;
              const int c = 64 * j + (e & 63);
              *reinterpret_cast<bf16*>(dst + sw128_offset(r, e & 63)) =
                  r0 + r < N && c < K ? A[(r0 + r) * lda + c] : __float2bfloat16_rn(0.f);
            }
            fence_proxy_async();  // read by the MMAs
            __syncwarp();
            if (lane == 0) mbar_arrive(afull + j);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 128 wg .. 128 wg + 127 of each
  // item, as two m64n128 sums (rows 64 b on)
  setmaxnreg_inc<kAsConsumerRegs>();
  const int wg = warp >> 2;
  const int g8 = lane >> 2;
  const int frag_row = 128 * wg + 16 * (warp & 3) + g8;  // + 64 b + 8 h: the lane's rows
  const bool leader = (tid & 127) == 0;                   // stores the warpgroup's rows
  const float inv = scal[2];
  const float n = *n_total;
  const bool no_norm = guard && inv == 0.f;  // the guard: no dinv term
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
  float acc[2][64];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[b][x] = 0.f;
  }
  int pend = -1;  // the stage of the warpgroup's last stored half, until its store has read it
  // the store of the last half has read its stage: free it
  auto release = [&]() {
    if (leader) {
      bulk_store_wait_read();
      mbar_arrive_n(empty + pend, 4);
    }
    pend = -1;
  };

  int e = 0;  // ring entries consumed
  int i = 0;
  for (int u = blockIdx.x; u < items; u += gridDim.x, ++i) {
    const int w = u % 3;
    const long r0 = static_cast<long>(u / 3) * kAsRows;
    const int kch = at.kch(w);
    const int tiles = at.tiles(w);
    // the slots it leaves unread, each handed back once it has been handed
    // over (so that the consumers never run a phase ahead of the producer on
    // a slot)
    __syncwarp();
    if (lane == 0) {
      for (int j = kch; j < slots; ++j) {
        mbar_wait(afull + j, i & 1);
        mbar_arrive(aempty + j);
      }
    }
    // den and gden of the lane's four fragment rows (their loads land under
    // the MMAs: den's reciprocal is taken where the epilogue needs it)
    float den_r[2][2], gden_r[2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = r0 + frag_row + 64 * b + 8 * h;
        den_r[b][h] = row < N ? den[row] : 1.f;
        gden_r[b][h] = row < N ? gden[row] : 0.f;
      }
    }
    for (int t = 0; t < tiles; ++t) {
      // chunk kc's MMAs (in stage st): the steps of the two sums interleaved
      // in one group, or (split, the tile's last chunk) sum 0's steps in a
      // group of their own before sum 1's, so that sum 0 is done first and its
      // epilogue runs under sum 1's MMAs
      auto issue = [&](int kc, int st, auto split) {
        const unsigned char* a_rows = As + static_cast<size_t>(kc) * kAsSlot + 2 * wg * kWgAtom16;
        const unsigned char* b_tile = Rs + st * kAsStage;
        wgmma_fence_operand(acc[0]);
        wgmma_fence_operand(acc[1]);
        wgmma_fence();
        if constexpr (decltype(split)::value) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              const uint64_t da = sw128_desc(a_rows + b * kWgAtom16 + ks * 32);
#pragma unroll
              for (int p = 0; p < 2; ++p) {
                wgmma_m64n128k16(acc[b], da, sw128_desc(b_tile + p * kWgTile16 + ks * 32),
                                 kc > 0 || ks > 0 || p > 0);
              }
            }
            wgmma_commit();
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const uint64_t db = sw128_desc(b_tile + p * kWgTile16 + ks * 32);
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                wgmma_m64n128k16(acc[b], sw128_desc(a_rows + b * kWgAtom16 + ks * 32), db,
                                 kc > 0 || ks > 0 || p > 0);
              }
            }
          }
          wgmma_commit();
        }
      };
      // each chunk's MMAs drained before its stage is freed (and, in the
      // item's last tile, its A slot), so that two stages of the ring are free
      // for the next chunks' copies: with the next chunk's MMAs queued first
      // (wgmma.wait_group 1), a stage was held a chunk longer and every chunk
      // waited for its copy (PERF.md)
      for (int kc = 0; kc < kch; ++kc, ++e) {
        const int st = e % kAsStages;
        mbar_wait(full + st, (e / kAsStages) & 1);
        if (t == 0) mbar_wait(afull + kc, i & 1);
        if (kc < kch - 1) {
          issue(kc, st, std::false_type{});
          if (pend >= 0) release();
          wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(empty + st);
            if (t == tiles - 1) mbar_arrive(aempty + kc);
          }
        } else {
          issue(kc, st, std::true_type{});
          if (pend >= 0) release();
        }
      }

      // the column tile's epilogue at each lane's fragment, in the operand's
      // halves in place: the product's terms in the replaced kernel's order,
      // one loop a product, half and sum (compiled apart, so that no element
      // tests them)
      auto finish = [&](auto product, auto part, auto sum, unsigned char* Xh) {
        constexpr int kWhich = decltype(product)::value;
        constexpr int kHalf = decltype(part)::value;
        constexpr int b = decltype(sum)::value;
        const float* cs_col = col_s + (kWhich == 0 ? 0 : Mp);  // ksum (dq) or ds (dk), 0 past M
        float rden_r[2];  // the rows' 1/den, correctly rounded
#pragma unroll
        for (int h = 0; h < 2; ++h) rden_r[h] = kWhich == 1 ? 0.f : __frcp_rn(den_r[b][h]);
        // the operand's values at the lane's fragment, all loaded before any
        // is overwritten (the stores may alias the loads, so loads and
        // stores interleaved would each wait for the last): ldmatrix hands
        // each lane its (row, column pair) of four 8 x 8 blocks, the
        // accumulator's fragment layout; lane l reads a row of block l / 8:
        // rows 8 h of column group j for blocks (h, j) = (0, j0), (1, j0),
        // (0, j0 + 1), (1, j0 + 1)
        unsigned char* xrow = Xh + (frag_row - g8 + 64 * b + 8 * ((lane >> 3) & 1) + (lane & 7)) * 128;
        unsigned xs[8][2];
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 2) {
          unsigned r[4];
          ldmatrix_rows(r, xrow + ((((j0 + (lane >> 4)) ^ lane) & 7) << 4));
          xs[j0][0] = r[0];
          xs[j0][1] = r[1];
          xs[j0 + 1][0] = r[2];
          xs[j0 + 1][1] = r[3];
        }
        unsigned os[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * (lane & 3);
          float col[2] = {0.f, 0.f};
          if constexpr (kWhich < 2) {
            const float2 c2 = *reinterpret_cast<const float2*>(cs_col + 128 * t + 64 * kHalf + cl);
            col[0] = c2.x;
            col[1] = c2.y;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // bf16 to f32 exactly: the bf16 bits as an f32's high half
            const unsigned xu = xs[j][h];
            const float x[2] = {__uint_as_float(xu << 16), __uint_as_float(xu & 0xffff0000u)};
            float o[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              // the terms fused as in the kernel this replaced, so that the
              // outputs are bitwise its: inv * (a / den) + inv * gden * ksum -
              // c_q * q; inv * a + inv * ds - c_k * k; n * (g / den) + inv *
              // a; each division correctly rounded by the row's reciprocal
              const float a = acc[b][4 * (8 * kHalf + j) + 2 * h + c];
              if constexpr (kWhich == 0) {
                o[c] = __fmaf_rn(-c_q, x[c],
                                 __fmaf_rn(inv, div_by(a, den_r[b][h], rden_r[h]),
                                           __fmul_rn(__fmul_rn(inv, gden_r[b][h]), col[c])));
              } else if constexpr (kWhich == 1) {
                o[c] = __fmaf_rn(-c_k, x[c], __fmaf_rn(inv, a, __fmul_rn(inv, col[c])));
              } else {
                o[c] = __fmaf_rn(n, div_by(x[c], den_r[b][h], rden_r[h]), __fmul_rn(inv, a));
              }
            }
            const __nv_bfloat162 o2 = __floats2bfloat162_rn(o[0], o[1]);
            os[j][h] = *reinterpret_cast<const unsigned*>(&o2);
          }
        }
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 2) {
          const unsigned r[4] = {os[j0][0], os[j0][1], os[j0 + 1][0], os[j0 + 1][1]};
          stmatrix_rows(xrow + ((((j0 + (lane >> 4)) ^ lane) & 7) << 4), r);
        }
      };
      auto fin = [&](auto part, auto sum, unsigned char* Xh) {
        if (w == 0) {
          finish(std::integral_constant<int, 0>{}, part, sum, Xh);
        } else if (w == 1) {
          finish(std::integral_constant<int, 1>{}, part, sum, Xh);
        } else {
          finish(std::integral_constant<int, 2>{}, part, sum, Xh);
        }
      };
      // half h's stage out: by the copy engine (the warpgroup's rows, clipped
      // to the output; the stage freed once the store has read it), or by
      // each warp's own stores of its 32 rows
      auto store = [&](int h, int st, unsigned char* Xh) {
        const int c0 = 128 * t + 64 * h;
        const long rw = r0 + 128 * wg;  // the warpgroup's first row
        if (vec_io) {
          fence_proxy_async();
          warpgroup_sync(wg);
          if (pend >= 0) release();  // the first half's store has read its stage
          if (leader && rw < N) {
            const CUtensorMap* map = w == 0 ? &maps.dq : (w == 1 ? &maps.dk : &maps.dv);
            tma_store_2d(map, c0, static_cast<int>(rw), Xh + wg * kWgTile16);
            bulk_store_commit();
          }
          pend = st;
        } else {
          __syncwarp();
          bf16* out = w == 0 ? dq : (w == 1 ? dk : dv);
          const long ldo = w == 0 ? lddq : (w == 1 ? lddk : lddv);
          const int C = w == 2 ? D : M;
          for (int x = lane; x < 32 * 64; x += 32) {
            const int r = frag_row - g8 + (x >> 10) * 64 + ((x >> 6) & 15);
            const int c = x & 63;
            const long row = r0 + r;
            if (row < N && c0 + c < C) {
              out[row * ldo + c0 + c] = *reinterpret_cast<const bf16*>(Xh + sw128_offset(r, c));
            }
          }
          fence_proxy_async();  // the stage's next bulk copy after these reads and writes
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + st);
        }
      };
      using H0 = std::integral_constant<int, 0>;
      using H1 = std::integral_constant<int, 1>;
      const bool two = halves(w, t) > 1;
      const int st0 = e % kAsStages;
      const int st1 = (e + 1) % kAsStages;
      unsigned char* X0 = Rs + st0 * kAsStage;
      unsigned char* X1 = Rs + st1 * kAsStage;
      mbar_wait(full + st0, (e / kAsStages) & 1);
      wgmma_wait<1>();  // sum 0 is done
      wgmma_fence_operand(acc[0]);
      fin(H0{}, H0{}, X0);
      wgmma_wait<0>();  // sum 1 is done: free the last chunk's stage (and A slot)
      wgmma_fence_operand(acc[1]);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + (e - 1) % kAsStages);
        if (t == tiles - 1) mbar_arrive(aempty + kch - 1);
      }
      fin(H0{}, H1{}, X0);
      store(0, st0, X0);
      if (two) {
        mbar_wait(full + st1, ((e + 1) / kAsStages) & 1);
        fin(H1{}, H0{}, X1);
        // the first half's store has read its stage by now: free it for the
        // next tile's chunk, a half's arithmetic earlier than the second
        // half's store would
        if (pend >= 0) release();
        fin(H1{}, H1{}, X1);
        store(1, st1, X1);
      }
      e += two ? 2 : 1;
    }
  }
  if (vec_io && leader) bulk_store_wait_read();
}

// ---------------------------------------------------------------------------
// The f32 apply in 3xTF32 on warpgroup MMAs (wgmma m64n64k8 tf32, A from
// registers), warp-specialised, fed by the copy engine (TMA) and
// persistent: grid min(3 ceil(N / 128), SMs), one block an SM, block b
// taking the items b, b + grid, ... in turn, item u product u % 3 (dq: g @
// kvs^T over D; dk: v @ P^T over D; dv: k @ P over M) of the 128-row block
// u / 3. It replaces sgformer_tpu/kernels/attention.py::_bwd_apply_kernel
// for f32 rows; bound by its products (three TF32 products for each f32
// one: 0.41 ms at the arxiv shape, the bytes 0.36). Two consumer
// warpgroups of 64 rows and a producer warpgroup, which gives its
// registers to the consumers (setmaxnreg). Dynamic shared memory,
// 1024-byte aligned (no static shared memory, so the dynamic block starts
// the block's window), every tile 128-byte swizzled over f32 rows of 32
// (tc::sw128_offset_f32): the A rows of an item as up to 8 slots of one k
// atom each ([128 rows][32], 16 KB; 128 KB at a depth of 256); a ring of
// kBaStages chunks of the B operand (kvs, P or P^T), each the tf32 hi and
// lo [64 n][32 k] atoms of one (column tile, k atom) (8 KB each; laid out
// swizzled by la_bwd_split_atoms_kernel, so that one 16 KB bulk copy moves
// a chunk); xbufs epilogue tiles [128][64] (two atoms; one at M = D = 256);
// ksum and ds; mbarriers: 226 KB at M = D = 256.
//
// Three A tiles of 128 KB, a B ring and an operand tile do not fit one
// block's 227 KB at once, so the next item's A rows arrive under the
// current item's MMAs slot by slot: the consumers' warps load each A
// fragment from its slot and split it into tf32 hi + lo in registers, so a
// slot is read by their loads, not by the MMAs, and in an item's last
// column tile each warp frees slot j (an empty mbarrier of its own) once
// its fragments of k atom j are in registers; the producer then brings the
// next item's atom j into it (a full mbarrier of its own). The item's first
// column tile waits for each atom as it reaches it, so the next product's
// rows stream in behind the last column tile's MMAs, a slot at a time, and
// each A row is read from device memory once. (Restaging A whole after a
// product, as the kernel this replaced did, left it idle for the 128 KB
// copy three times a row block; streaming A through the ring with B would
// read it again from L2 for every column tile.) Slots past an item's depth
// (M != D) are handed over empty, so that every slot's barriers complete
// once an item.
//
// The producer warpgroup: warp 0's lane 0 brings the B chunks by bulk
// copies as the consumers free their stages (full and empty mbarriers);
// warp 1 brings each column tile's epilogue operand (q, k or g) by a tensor
// map into the next epilogue tile once its last output has left it; warp 2
// brings the A atoms by a tensor map. Where the views' strides or bases do
// not allow a tensor map (vec_a, vec_io 0) warps 1 and 2 copy the operands
// and A rows one element a lane at a time and the consumers store their
// rows. The consumers keep the arithmetic of the f32 row kernels, so that
// the outputs are bitwise the kernel's it replaced: each product lo*hi' +
// hi*lo' + hi*hi' (the cross terms first), every 16 deep (kWgPeriod) the
// MMAs start fresh sums that are added to the tile's f32 sums in
// round-to-nearest, in k order, a k atom's two periods double-buffered so
// that the second's MMAs run while the warps fold the first's (issuing the
// two periods' MMAs interleaved measured 3 % slower, PERF.md). Then each
// 64-column tile's epilogue at each lane's fragment, the terms of the
// kernel it replaced in their order and fused as they were (den and gden
// of the lane's rows loaded once an item, ksum and ds staged once a block,
// each division correctly rounded through the row's reciprocal, tc::div_by,
// where an IEEE division an element cost ~10 instructions and a branch),
// written in place into the epilogue tile and stored by the copy engine,
// which clips it to the output.
constexpr int kBaConsumers = 2 * 128;
constexpr int kBaThreads = kBaConsumers + 128;  // and the producer warpgroup
constexpr int kBaStages = 4;
constexpr int kBaAtom = kTcRows * 128;          // a [128 rows][32] f32 atom: A, or half a tile
constexpr int kBaPiece = kTcCols * 128;         // a [64 n][32 k] atom of a split B
constexpr int kBaStage = 2 * kBaPiece;          // its hi and lo

// The f32 apply's B operands as la_bwd_split_atoms_kernel lays them out:
// for each product w (dq: kvs, dk: P, as [n = M][k = D]; dv: P^T, as [n =
// D][k = M]) the tf32 hi and lo atoms of each (column tile, k atom) chunk,
// column tile by column tile.
struct BaAtoms {
  int M, D;
  __host__ __device__ BaAtoms(int M_, int D_) : M(M_), D(D_) {}
  __host__ __device__ int ka(int w) const { return tc::cdiv(w == 2 ? M : D, 32); }
  __host__ __device__ int tiles(int w) const { return tc::cdiv(w == 2 ? D : M, kTcCols); }
  __host__ __device__ size_t elems(int w) const {
    return static_cast<size_t>(tiles(w)) * ka(w) * 2 * (kBaPiece / 4);
  }
  __host__ __device__ size_t total() const { return elems(0) + elems(1) + elems(2); }
  // the first element of product w's chunk (column tile ct, k atom kc): hi, then lo
  __host__ __device__ size_t chunk(int w, int ct, int kc) const {
    const size_t base = w == 0 ? 0 : (w == 1 ? elems(0) : elems(0) + elems(1));
    return base + static_cast<size_t>(ct * ka(w) + kc) * 2 * (kBaPiece / 4);
  }
};

// hl = kvs, P and P^T as tf32 hi + lo (tc::split_store<2, float>) in
// BaAtoms' layout, zero past the widths.
__global__ void __launch_bounds__(kThreads)
la_bwd_split_atoms_kernel(const float* __restrict__ kvs, const float* __restrict__ P, int M,
                          int D, float* __restrict__ hl) {
  constexpr int kPiece = kBaPiece / 4;
  const BaAtoms a(M, D);
  const size_t count = a.total() / 2;  // elements of one piece, over the three products
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t j = i;
    int w = 0;
    for (; w < 2; ++w) {
      const size_t per = a.elems(w) / 2;
      if (j < per) break;
      j -= per;
    }
    const int chunk = static_cast<int>(j / kPiece);
    const int n = chunk / a.ka(w) * kTcCols + static_cast<int>(j % kPiece) / 32;
    const int kk = chunk % a.ka(w) * 32 + static_cast<int>(j % 32);
    float x = 0.f;
    if (w == 2) {
      if (n < D && kk < M) x = P[static_cast<size_t>(kk) * D + n];
    } else if (n < M && kk < D) {
      x = (w == 0 ? kvs : P)[static_cast<size_t>(n) * D + kk];
    }
    const size_t off = a.chunk(w, chunk / a.ka(w), chunk % a.ka(w)) +
                       tc::sw128_offset_f32(static_cast<int>(j % kPiece) / 32, kk % 32) / 4;
    split_store<2>(x, hl + off, kPiece);
  }
}

size_t bwd_apply_ws_smem(int M, int D, int xbufs) {
  const int slots = std::max(tc::cdiv(M, 32), tc::cdiv(D, 32));
  return static_cast<size_t>(slots) * kBaAtom + static_cast<size_t>(kBaStages) * kBaStage +
         static_cast<size_t>(xbufs) * 2 * kBaAtom + 2 * static_cast<size_t>(tc::cdiv(M, 4) * 4) *
         sizeof(float) + 2 * (slots + kBaStages + xbufs) * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kBaThreads, 1)
la_bwd_apply_ws_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g, long ldq,
                       long ldk, long ldv, long ldg, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, long lddq, long lddk,
                       long lddv, int N, int M, int D, const float* __restrict__ hl,
                       const float* __restrict__ ksum, const float* __restrict__ ds,
                       const float* __restrict__ scal, const float* __restrict__ n_total,
                       const float* __restrict__ dinv, const float* __restrict__ den,
                       const float* __restrict__ gden, int guard, int vec_a, int vec_io,
                       int xbufs, const __grid_constant__ ApMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const BaAtoms at(M, D);
  const int slots = max(at.ka(0), at.ka(2));
  const int items = 3 * cdiv(N, kTcRows);
  const int Mc = cdiv(M, 4) * 4;
  unsigned char* As = smem_raw;                                             // [slot][128][32]
  unsigned char* Bs = As + static_cast<size_t>(slots) * kBaAtom;            // [stage][hi, lo]
  unsigned char* Xs = Bs + static_cast<size_t>(kBaStages) * kBaStage;       // [xbufs][2][128][32]
  float* col_s = reinterpret_cast<float*>(Xs + static_cast<size_t>(xbufs) * 2 * kBaAtom);
  uint64_t* afull = reinterpret_cast<uint64_t*>(col_s + 2 * Mc);  // an A atom has landed
  uint64_t* aempty = afull + slots;                               // an A slot is read
  uint64_t* full = aempty + slots;                                // a stage has landed
  uint64_t* empty = full + kBaStages;                             // a stage's MMAs are done
  uint64_t* xfull = empty + kBaStages;                            // an operand tile has landed
  uint64_t* xempty = xfull + xbufs;                               // a tile has left its buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int j = 0; j < slots; ++j) {
      mbar_init(afull + j, 1);
      mbar_init(aempty + j, kBaConsumers / 32);
    }
    for (int s = 0; s < kBaStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kBaConsumers / 32);
    }
    for (int b = 0; b < xbufs; ++b) {
      mbar_init(xfull + b, 1);
      mbar_init(xempty + b, 1);
    }
    mbar_init_fence();
  }
  for (int i = tid; i < 2 * Mc; i += kBaThreads) {  // ksum, then ds
    const int c = i < Mc ? i : i - Mc;
    col_s[i] = c < M ? (i < Mc ? ksum[c] : ds[c]) : 0.f;
  }
  __syncthreads();

  if (warp >= kBaConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    const int pw = warp - kBaConsumers / 32;
    if (pw == 0) {  // the B chunks, each into its stage once the consumers have freed it
      if (lane == 0) {
        int ch = 0;
        for (int u = blockIdx.x; u < items; u += gridDim.x) {
          const int w = u % 3;
          for (int t = 0; t < at.tiles(w); ++t) {
            for (int kc = 0; kc < at.ka(w); ++kc, ++ch) {
              const int st = ch % kBaStages;
              if (ch >= kBaStages) mbar_wait(empty + st, (ch / kBaStages - 1) & 1);
              mbar_arrive_expect_tx(full + st, kBaStage);
              bulk_copy_g2s(Bs + st * kBaStage, hl + at.chunk(w, t, kc), kBaStage, full + st);
            }
          }
        }
      }
    } else if (pw == 1) {  // each column tile's operand, once the tile's last output has left
      int T = 0;
      for (int u = blockIdx.x; u < items; u += gridDim.x) {
        const int w = u % 3;
        const long r0 = static_cast<long>(u / 3) * kTcRows;
        const float* X = w == 0 ? q : (w == 1 ? k : g);
        const long ldx = w == 0 ? ldq : (w == 1 ? ldk : ldg);
        const int C = w == 2 ? D : M;
        const CUtensorMap* map = w == 0 ? &maps.q : (w == 1 ? &maps.k : &maps.g);
        for (int t = 0; t < at.tiles(w); ++t, ++T) {
          const int b = T % xbufs;
          if (T >= xbufs) mbar_wait(xempty + b, (T / xbufs - 1) & 1);
          unsigned char* dst = Xs + static_cast<size_t>(b) * 2 * kBaAtom;
          const int c0 = kTcCols * t;
          if (vec_io) {
            if (lane == 0) {
              mbar_arrive_expect_tx(xfull + b, 2 * kBaAtom);
              for (int h = 0; h < 2; ++h) {
                tma_load_2d(dst + h * kBaAtom, map, c0 + 32 * h, static_cast<int>(r0), xfull + b);
              }
            }
          } else {
            for (int i = lane; i < kTcRows * kTcCols; i += 32) {
              const int r = i / kTcCols;
              const int c = i % kTcCols;
              *reinterpret_cast<float*>(dst + (c >> 5) * kBaAtom + sw128_offset_f32(r, c & 31)) =
                  r0 + r < N && c0 + c < C ? X[(r0 + r) * ldx + c0 + c] : 0.f;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(xfull + b);
          }
        }
      }
    } else if (pw == 2) {  // each item's A atoms, slot j once the last item has read it
      int i = 0;
      for (int u = blockIdx.x; u < items; u += gridDim.x, ++i) {
        const int w = u % 3;
        const long r0 = static_cast<long>(u / 3) * kTcRows;
        const float* A = w == 0 ? g : (w == 1 ? v : k);
        const long lda = w == 0 ? ldg : (w == 1 ? ldv : ldk);
        const int K = w == 2 ? M : D;
        const CUtensorMap* map = w == 0 ? &maps.g : (w == 1 ? &maps.v : &maps.k);
        for (int j = 0; j < slots; ++j) {
          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);
          unsigned char* dst = As + static_cast<size_t>(j) * kBaAtom;
          if (j >= at.ka(w)) {  // past the item's depth: handed over empty
            if (lane == 0) mbar_arrive(afull + j);
          } else if (vec_a) {
            if (lane == 0) {
              mbar_arrive_expect_tx(afull + j, kBaAtom);
              tma_load_2d(dst, map, 32 * j, static_cast<int>(r0), afull + j);
            }
          } else {
            for (int e = lane; e < kTcRows * 32; e += 32) {
              const int r = e >> 5;
              const int c = 32 * j + (e & 31);
              *reinterpret_cast<float*>(dst + sw128_offset_f32(r, e & 31)) =
                  r0 + r < N && c < K ? A[(r0 + r) * lda + c] : 0.f;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(afull + j);
          }
        }
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<232>();
  constexpr int kSteps = kWgPeriod / 8;  // k8 steps a period: two periods a 32-deep atom
  static_assert(kSteps * 2 * 8 == 32, "two periods an atom");
  const float inv = scal[2];
  const float n = *n_total;
  const bool no_norm = guard && inv == 0.f;  // the guard: no dinv term
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
  const int g8 = lane >> 2;
  // the lane's fragment rows 16 * warp + g8 (+ 8) at k = lane % 4 (+ 4) of each k8 step
  const int a_off = (16 * warp + g8) * 128 + (lane & 3) * 4;
  const int g16 = g8 << 4;  // the swizzle of the rows' 16-byte chunks
  float acc[32], part[2][32];
  unsigned ah[2][kSteps][4], al[2][kSteps][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.f;

  // the A fragments of period p of the atom in slot kc, as tf32 hi + lo
  auto load_a = [&](unsigned (&h)[kSteps][4], unsigned (&l)[kSteps][4], int kc, int p) {
    const unsigned char* a = As + kc * kBaAtom + a_off;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int s = p * kSteps + ks;  // k8 step of the atom: k from 8 s
      const int lo16 = ((2 * s) << 4) ^ g16;
      const int hi16 = ((2 * s + 1) << 4) ^ g16;
      split_tf32(*reinterpret_cast<const float*>(a + lo16), h[ks][0], l[ks][0]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + lo16), h[ks][1], l[ks][1]);
      split_tf32(*reinterpret_cast<const float*>(a + hi16), h[ks][2], l[ks][2]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + hi16), h[ks][3], l[ks][3]);
    }
  };
  // period p's MMAs into fresh sums d, B the chunk's atoms at Bh (hi; lo
  // one piece on)
  auto issue = [&](float (&d)[32], const unsigned (&h)[kSteps][4],
                   const unsigned (&l)[kSteps][4], const unsigned char* Bh, int p) {
    wgmma_fence_operand(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const unsigned char* b = Bh + (p * kSteps + ks) * 32;
      wgmma_m64n64k8_tf32(d, l[ks], sw128_desc(b), ks);            // lo*hi', fresh first
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b + kBaPiece), 1);  // hi*lo'
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b), 1);             // hi*hi'
    }
    wgmma_commit();
  };
  auto fold = [&](float (&d)[32]) {
    wgmma_fence_operand(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
  };
  int stored = -1;  // the epilogue tile whose store has yet to read it
  // the store of the last tile has read its buffer: free it
  auto release = [&]() {
    if (tid == 0) {
      bulk_store_wait_read();
      mbar_arrive(xempty + stored);
    }
    stored = -1;
  };

  int ch = 0;  // chunks consumed
  int T = 0;   // column tiles finished
  int i = 0;
  for (int u = blockIdx.x; u < items; u += gridDim.x, ++i) {
    const int w = u % 3;
    const long r0 = static_cast<long>(u / 3) * kTcRows;
    const int ka = at.ka(w);
    const int tiles = at.tiles(w);
    // the slots it leaves unread, each handed back once it has been handed
    // over (so that the consumers never run a phase ahead of the producer on
    // a slot: a wait a phase behind would then block for the next item's)
    __syncwarp();
    if (lane == 0) {
      for (int j = ka; j < slots; ++j) {
        mbar_wait(afull + j, i & 1);
        mbar_arrive(aempty + j);
      }
    }
    // den, its reciprocal and gden of the lane's two fragment rows
    float den_r[2], rden_r[2], gden_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = r0 + 16 * warp + g8 + 8 * h;
      den_r[h] = row < N ? den[row] : 1.f;
      rden_r[h] = __frcp_rn(den_r[h]);
      gden_r[h] = row < N ? gden[row] : 0.f;
    }
    for (int t = 0; t < tiles; ++t, ++T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int kc = 0; kc < ka; ++kc, ++ch) {
        const int st = ch % kBaStages;
        mbar_wait(full + st, (ch / kBaStages) & 1);
        if (t == 0) mbar_wait(afull + kc, i & 1);
        const unsigned char* Bh = Bs + st * kBaStage;
        load_a(ah[0], al[0], kc, 0);
        issue(part[0], ah[0], al[0], Bh, 0);
        if (stored >= 0) release();
        load_a(ah[1], al[1], kc, 1);
        if (t == tiles - 1) {  // the item's last reads of slot kc are in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(aempty + kc);
        }
        issue(part[1], ah[1], al[1], Bh, 1);
        wgmma_wait<1>();  // the first period is done
        fold(part[0]);
        wgmma_wait<0>();
        fold(part[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
      }
      // the column tile's epilogue at each lane's fragment, in its tile in place
      const int xb = T % xbufs;
      unsigned char* Xb = Xs + static_cast<size_t>(xb) * 2 * kBaAtom;
      mbar_wait(xfull + xb, (T / xbufs) & 1);
      const int c0 = kTcCols * t;
      // the product's terms in the replaced kernel's order, one loop a product
      // (compiled apart, so that no element tests the product)
      auto finish = [&](auto product) {
        constexpr int kWhich = decltype(product)::value;
        const float* cs_col = col_s + (kWhich == 0 ? 0 : Mc);  // ksum (dq) or ds (dk)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * (lane & 3);
          float col[2] = {0.f, 0.f};
          if constexpr (kWhich < 2) {
#pragma unroll
            for (int e = 0; e < 2; ++e) col[e] = c0 + cl + e < M ? cs_col[c0 + cl + e] : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* p = reinterpret_cast<float2*>(
                Xb + (j >> 2) * kBaAtom + sw128_offset_f32(16 * warp + g8 + 8 * h, cl & 31));
            const float2 x2 = *p;
            const float x[2] = {x2.x, x2.y};
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // the terms fused as in the kernel this replaced, so that the
              // outputs are bitwise its: inv * (a / den) + inv * gden * ksum
              // - c_q * q; inv * a + inv * ds - c_k * k; n * (g / den) + inv *
              // a; each division correctly rounded by the row's reciprocal
              const float a = acc[4 * j + 2 * h + e];
              if constexpr (kWhich == 0) {
                o[e] = __fmaf_rn(-c_q, x[e],
                                 __fmaf_rn(__fmul_rn(inv, gden_r[h]), col[e],
                                           __fmul_rn(inv, div_by(a, den_r[h], rden_r[h]))));
              } else if constexpr (kWhich == 1) {
                o[e] = __fmaf_rn(-c_k, x[e], __fmaf_rn(inv, col[e], __fmul_rn(inv, a)));
              } else {
                o[e] = __fmaf_rn(n, div_by(x[e], den_r[h], rden_r[h]), __fmul_rn(inv, a));
              }
            }
            *p = make_float2(o[0], o[1]);
          }
        }
      };
      if (w == 0) {
        finish(std::integral_constant<int, 0>{});
      } else if (w == 1) {
        finish(std::integral_constant<int, 1>{});
      } else {
        finish(std::integral_constant<int, 2>{});
      }
      if (vec_io) {  // the tile out by the copy engine, clipped to the output
        fence_proxy_async();
        consumers_sync();
        if (tid == 0) {
          const CUtensorMap* map = w == 0 ? &maps.dq : (w == 1 ? &maps.dk : &maps.dv);
          for (int h = 0; h < 2; ++h) {
            tma_store_2d(map, c0 + 32 * h, static_cast<int>(r0), Xb + h * kBaAtom);
          }
          bulk_store_commit();
        }
        stored = xb;
      } else {  // the warp's own 16 rows
        __syncwarp();
        float* out = w == 0 ? dq : (w == 1 ? dk : dv);
        const long ldo = w == 0 ? lddq : (w == 1 ? lddk : lddv);
        const int C = w == 2 ? D : M;
        for (int e = lane; e < 16 * kTcCols; e += 32) {
          const int r = 16 * warp + e / kTcCols;
          const int c = e % kTcCols;
          const long row = r0 + r;
          if (row < N && c0 + c < C) {
            out[row * ldo + c0 + c] = *reinterpret_cast<const float*>(
                Xb + (c >> 5) * kBaAtom + sw128_offset_f32(r, c & 31));
          }
        }
        consumers_sync();
        if (tid == 0) mbar_arrive(xempty + xb);
      }
    }
  }
  if (vec_io && tid == 0) bulk_store_wait_read();
}

template <typename T>
cudaError_t launch_bwd_reduce(const void* q, const void* v, const void* g, long ldq, long ldv,
                              long ldg, int N, int M, int D, int slices, int rows_per_slice,
                              const float* kvs, const float* ksum, const float* scal,
                              const float* n_total, int guard, float* den, float* gden,
                              double* dinv_part, float* P_part, float* ds_part,
                              cudaStream_t st) {
  const unsigned row_blocks = static_cast<unsigned>((N + kTile - 1) / kTile);
  la_bwd_rows_kernel<T><<<row_blocks, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), static_cast<const T*>(g), ldq, ldv,
      ldg, N, M, D, kvs, ksum, scal, n_total, guard, den, gden, dinv_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTile - 1) / kTile, (D + kTile - 1) / kTile, slices);
  la_bwd_reduce_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), ldq, ldg, N, M, D, rows_per_slice, den,
      gden, P_part, ds_part);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The tensor-core reduce: kvs^T split into hl, the rows pass, the P pass;
// T = bf16, or float for the 3xTF32 form (hl: tf32 pieces in f32).
template <typename T>
cudaError_t launch_bwd_reduce_tc(const T* q, const T* v, const T* g, long ldq, long ldv, long ldg,
                                 int N, int M, int D, int slices, int rows_per_slice,
                                 const float* kvs, const float* ksum, const float* scal,
                                 const float* n_total, int guard, float* den, float* gden,
                                 double* dinv_part, float* P_part, float* ds_part, T* hl,
                                 cudaStream_t st) {
  constexpr int kPer = kPadOf<T>;  // elements of a 16-byte copy
  cudaError_t err;
  if constexpr (kIsF32<T>) {
    err = tc::launch_split_kvs(kvs, M, D, hl, st);
  } else {
    const size_t count = tc::split_t_elems(M, D);
    const unsigned blocks =
        static_cast<unsigned>(std::min<size_t>((count + kThreads - 1) / kThreads, 1024));
    la_bwd_split_rows_kernel<<<blocks, kThreads, 0, st>>>(kvs, M, D, hl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int vec_io = ldg % kPer == 0 && ldv % kPer == 0 && aligned16(g) && aligned16(v);
  const unsigned row_blocks = (N + kTcRows - 1) / kTcRows;
  if constexpr (kIsF32<T>) {
    // tensor maps where the copy engine can read the rows (16-byte aligned
    // bases and row strides; it clips the widths), else warp 1's lanes copy
    // them: q (vec_a), g (vec_io, which also has v read 8 bytes at a time)
    const int vec_a = ldq % kPer == 0 && aligned16(q);
    RwMaps maps = {};
    struct Rows { CUtensorMap* map; const float* base; int width; long ld; int want; };
    const Rows rows[2] = {{&maps.q, q, M, ldq, vec_a}, {&maps.g, g, D, ldg, vec_io}};
    for (const Rows& r : rows) {
      if (!r.want) continue;
      err = tc::encode_rows_map(r.map, r.base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), N,
                                r.width, r.ld, 32, kTcRows);
      if (err != cudaSuccess) return err;
    }
    const size_t smem = rows_ws_smem(M);
    err = cudaFuncSetAttribute(la_bwd_rows_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(static_cast<int>(row_blocks), sms);
    la_bwd_rows_ws_kernel<<<blocks, kRwThreads, smem, st>>>(
        q, v, g, ldq, ldv, ldg, N, M, D, hl, ksum, scal, n_total, guard, vec_a, vec_io, den, gden,
        dinv_part, maps);
  } else {
    // tensor maps where the copy engine can read the rows: q (vec_a), g and
    // v (the g and v tiles, where vec_io and they fit), else the producer's
    // lanes copy q and the consumers read g and v
    const int vec_a = M % kPer == 0 && ldq % kPer == 0 && aligned16(q);
    int stages, gv_tile;
    rows_ws16_layout(M, vec_io, stages, gv_tile);
    RsMaps maps = {};
    struct Rows { CUtensorMap* map; const bf16* base; int width; long ld; int want; };
    const Rows rows[3] = {{&maps.q, q, M, ldq, vec_a}, {&maps.g, g, D, ldg, gv_tile},
                          {&maps.v, v, D, ldv, gv_tile}};
    for (const Rows& r : rows) {
      if (!r.want) continue;
      err = encode_rows_map(r.map, r.base, N, r.width, r.ld);
      if (err != cudaSuccess) return err;
    }
    const size_t smem = rows_ws16_smem(M, stages, gv_tile);
    err = cudaFuncSetAttribute(la_bwd_rows_ws16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(static_cast<int>(row_blocks), sms);
    la_bwd_rows_ws16_kernel<<<blocks, kRsThreads, smem, st>>>(
        q, v, g, ldq, ldv, ldg, N, M, D, hl, ksum, scal, n_total, guard, vec_a, vec_io, stages,
        gv_tile, den, gden, dinv_part, maps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kIsF32<T>) {
    const int tiles = tc::cdiv(M, tc::kNodeTile) * tc::cdiv(D, tc::kNodeTile);
    // tensor maps where the copy engine can read the rows (16-byte aligned
    // bases and row strides; it clips the widths), else the producer's
    // lanes copy them
    const int vec = ldq % kPer == 0 && ldg % kPer == 0 && aligned16(q) && aligned16(g);
    tc::RdMaps maps = {};
    if (vec) {
      err = tc::encode_rows_map(&maps.a, q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), N, M,
                                ldq, 32, tc::kRfRows);
      if (err == cudaSuccess) {
        err = tc::encode_rows_map(&maps.b, g, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), N,
                                  D, ldg, 32, tc::kRfRows);
      }
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(la_bwd_reduce_wg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBrSmem));
    if (err != cudaSuccess) return err;
    la_bwd_reduce_wg_kernel<<<slices * tiles, tc::kRdThreads, kBrSmem, st>>>(
        q, g, ldq, ldg, N, M, D, rows_per_slice, vec, den, gden, P_part, ds_part, maps);
  } else {
    const int vec = M % kPer == 0 && D % kPer == 0 && ldq % kPer == 0 && ldg % kPer == 0 &&
                    aligned16(q) && aligned16(g);
    CUtensorMap map_q = {}, map_g = {};
    if (vec) {
      err = encode_rows_map(&map_q, q, N, M, ldq, kPRows);
      if (err == cudaSuccess) err = encode_rows_map(&map_g, g, N, D, ldg, kPRows);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(la_bwd_reduce_ws16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kPsSmem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(PsItems(M, D, slices).count, sms);
    la_bwd_reduce_ws16_kernel<<<blocks, kPsThreads, kPsSmem, st>>>(
        q, g, ldq, ldg, N, M, D, slices, rows_per_slice, vec, den, gden, P_part, ds_part, map_q,
        map_g);
  }
  return cudaGetLastError();
}

// Elements of the tensor-core reduce's scratch (kvs^T in pieces of the
// input type: bf16, or tf32 in f32), or 0 where the reduce runs on the CUDA
// cores: an M whose q tile does not fit one block's shared memory beside
// the B stages (above 704 in bf16, 256 in f32).
int bwd_reduce_scratch(int dtype, int M, int D) {
  const TcDims t(M, D);
  if (dtype == 1) {
    if (rows_ws16_stages(M) == 0) return 0;
    return static_cast<int>(kRowsPieces * t.pt_elems());
  }
  if (dtype == 0) {
    if (t.Mk > kWgMaxK || rows_ws_smem(M) > kSmemPerBlock) return 0;
    return static_cast<int>(tc::split_kvs_elems<float>(M, D));
  }
  return 0;
}

template <typename T>
void launch_bwd_apply(const void* q, const void* k, const void* v, const void* g, long ldq,
                      long ldk, long ldv, long ldg, void* dq, void* dk, void* dv, long lddq,
                      long lddk, long lddv, int N, int M, int D, const float* kvs,
                      const float* ksum, const float* P, const float* ds, const float* scal,
                      const float* n_total, const float* dinv, const float* den,
                      const float* gden, int guard, cudaStream_t st) {
  const int tiles_m = (M + kTile - 1) / kTile;
  const int tiles_d = (D + kTile - 1) / kTile;
  const dim3 grid((N + kTile - 1) / kTile, 2 * tiles_m + tiles_d);
  la_bwd_apply_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), ldq, ldk, ldv, ldg, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), lddq, lddk, lddv, N, M, D, kvs, ksum, P, ds, scal, n_total, dinv,
      den, gden, guard);
}

// The tensor-core apply: kvs, P and P^T split into hl (bf16 pieces by
// la_bwd_split_tiles_kernel, or tf32 pieces in f32 by
// la_bwd_split_atoms_kernel for T = float), then la_bwd_apply_ws16_kernel
// (bf16 up to M, D = 256), la_bwd_apply_wgmma_kernel (bf16 above, up to
// 704) or la_bwd_apply_ws_kernel (f32).
template <typename T>
cudaError_t launch_bwd_apply_tc(const T* q, const T* k, const T* v, const T* g, long ldq,
                                long ldk, long ldv, long ldg, T* dq, T* dk, T* dv, long lddq,
                                long lddk, long lddv, int N, int M, int D, const float* kvs,
                                const float* ksum, const float* P, const float* ds,
                                const float* scal, const float* n_total, const float* dinv,
                                const float* den, const float* gden, int guard, int vec_a,
                                int vec_io, T* hl, cudaStream_t st) {
  const size_t total = kIsF32<T> ? BaAtoms(M, D).total() / 2 : ApTiles(M, D).total() / 2;
  const unsigned split_blocks =
      static_cast<unsigned>(std::min<size_t>((total + kThreads - 1) / kThreads, 1024));
  if constexpr (kIsF32<T>) {
    la_bwd_split_atoms_kernel<<<split_blocks, kThreads, 0, st>>>(kvs, P, M, D, hl);
  } else {
    la_bwd_split_tiles_kernel<<<split_blocks, kThreads, 0, st>>>(kvs, P, M, D, hl);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return err;
  const unsigned row_blocks = (N + kTcRows - 1) / kTcRows;
  // the tensor maps where the copy engine can read the rows (vec_a: the A
  // rows g, v, k; vec_io: the epilogue's operands q, k, g and the outputs:
  // 16-byte aligned bases and row strides), else left empty; [128 rows][128
  // bytes] boxes
  ApMaps maps = {};
  struct Rows { CUtensorMap* map; const void* base; int width; long ld; bool want; };
  const Rows rows[7] = {{&maps.g, g, D, ldg, vec_a || vec_io}, {&maps.v, v, D, ldv, !!vec_a},
                        {&maps.k, k, M, ldk, vec_a || vec_io}, {&maps.q, q, M, ldq, !!vec_io},
                        {&maps.dq, dq, M, lddq, !!vec_io}, {&maps.dk, dk, M, lddk, !!vec_io},
                        {&maps.dv, dv, D, lddv, !!vec_io}};
  for (const Rows& r : rows) {
    if (!r.want) continue;
    err = kIsF32<T> ? tc::encode_rows_map(r.map, r.base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                          sizeof(float), N, r.width, r.ld, 32, kTcRows)
                    : encode_rows_map(r.map, r.base, N, r.width, r.ld);
    if (err != cudaSuccess) return err;
  }
  if constexpr (kIsF32<T>) {
    const int xbufs = bwd_apply_ws_smem(M, D, 2) <= kSmemPerBlock ? 2 : 1;
    const size_t smem = bwd_apply_ws_smem(M, D, xbufs);
    err = cudaFuncSetAttribute(la_bwd_apply_ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(3 * static_cast<int>(row_blocks), sms);
    la_bwd_apply_ws_kernel<<<blocks, kBaThreads, smem, st>>>(
        q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M, D, hl, ksum, ds, scal,
        n_total, dinv, den, gden, guard, vec_a, vec_io, xbufs, maps);
  } else if (apply_ws16_fits(M, D)) {
    const size_t smem = apply_ws16_smem(M, D);
    err = cudaFuncSetAttribute(la_bwd_apply_ws16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(3 * tc::cdiv(N, kAsRows), sms);
    la_bwd_apply_ws16_kernel<<<blocks, kAsThreads, smem, st>>>(
        q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M, D, hl, ksum, ds, scal,
        n_total, dinv, den, gden, guard, vec_a, vec_io, maps);
  } else {  // widths above the persistent kernel's slots
    const size_t smem = apply_wgmma_smem(M);
    err = cudaFuncSetAttribute(la_bwd_apply_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    la_bwd_apply_wgmma_kernel<<<row_blocks, kApThreads, smem, st>>>(
        q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M, D, hl, ksum, ds, scal,
        n_total, dinv, den, gden, guard, vec_a, vec_io, maps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, v, g: [N, M], [N, D], [N, D] rows of
// the input type; kvs [M, D], ksum [M], scal [4] = (qsq, ksq, inv, 0) and
// n_total from the forward (f32, device). Outputs: rows [2, N] = (den, gden)
// per row, P [M, D], ds [M], dinv (one f32). Scratch: dinv_part
// [ceil(N/64)] f64, P_part [slices, M, D], ds_part [slices, M], and hl, the
// sgf_la_bwd_reduce_scratch(dtype, M, D) elements of the input type of the
// tensor-core design where that is not 0 (else unused). Returns the first
// cudaError_t of the launches, each checked as it is made.
extern "C" int sgf_la_bwd_reduce(const void* q, const void* v, const void* g, long ldq, long ldv,
                                 long ldg, int N, int M, int D, int dtype, int slices,
                                 int rows_per_slice, int guard, const float* kvs,
                                 const float* ksum, const float* scal, const float* n_total,
                                 float* rows, double* dinv_part, float* P_part, float* ds_part,
                                 float* P, float* ds, float* dinv, void* hl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* den = rows;
  float* gden = rows + N;
  cudaError_t err;
  int row_blocks = (N + kTile - 1) / kTile;
  if (bwd_reduce_scratch(dtype, M, D) > 0) {
    using bf16 = __nv_bfloat16;
    if (dtype == 1) {
      err = launch_bwd_reduce_tc(static_cast<const bf16*>(q), static_cast<const bf16*>(v),
                                 static_cast<const bf16*>(g), ldq, ldv, ldg, N, M, D, slices,
                                 rows_per_slice, kvs, ksum, scal, n_total, guard, den, gden,
                                 dinv_part, P_part, ds_part, static_cast<bf16*>(hl), st);
    } else {
      err = launch_bwd_reduce_tc(static_cast<const float*>(q), static_cast<const float*>(v),
                                 static_cast<const float*>(g), ldq, ldv, ldg, N, M, D, slices,
                                 rows_per_slice, kvs, ksum, scal, n_total, guard, den, gden,
                                 dinv_part, P_part, ds_part, static_cast<float*>(hl), st);
    }
    row_blocks = (N + kTcRows - 1) / kTcRows;
  } else if (dtype == 0) {
    err = launch_bwd_reduce<float>(q, v, g, ldq, ldv, ldg, N, M, D, slices, rows_per_slice, kvs,
                                   ksum, scal, n_total, guard, den, gden, dinv_part, P_part,
                                   ds_part, st);
  } else if (dtype == 1) {
    err = launch_bwd_reduce<__nv_bfloat16>(q, v, g, ldq, ldv, ldg, N, M, D, slices,
                                           rows_per_slice, kvs, ksum, scal, n_total, guard, den,
                                           gden, dinv_part, P_part, ds_part, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t MD = static_cast<size_t>(M) * D;
  const unsigned fin_blocks = static_cast<unsigned>((MD + kThreads - 1) / kThreads);
  la_bwd_finish_kernel<<<fin_blocks, kThreads, 0, st>>>(P_part, ds_part, slices, M, D, P, ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  la_bwd_dinv_kernel<<<1, kThreads, 0, st>>>(dinv_part, row_blocks, dinv);
  return static_cast<int>(cudaGetLastError());
}

// The scratch (elements of the input type) of the tensor-core reduce for
// these widths, or 0 where the reduce runs on the CUDA cores (M above 704
// in bf16, above 256 in f32).
extern "C" int sgf_la_bwd_reduce_scratch(int dtype, int M, int D) {
  return bwd_reduce_scratch(dtype, M, D);
}

// The scratch (elements of the input type) of the tensor-core apply for
// these widths, or 0 where the apply runs on the CUDA cores: M or D above
// 704 in bf16 (kWgMaxK16), and in f32 widths whose A tile does not fit one
// block's shared memory (above 256).
extern "C" int sgf_la_bwd_apply_scratch(int dtype, int M, int D) {
  size_t smem;
  if (dtype == 1) {
    const TcDims t(M, D);
    if (t.Mk > kWgMaxK16 || t.Dk > kWgMaxK16) return 0;
    smem = apply_wgmma_smem(M);
  } else if (dtype == 0) {
    const TcDims t(M, D);
    if (t.Mk > kWgMaxK || t.Dk > kWgMaxK) return 0;
    smem = bwd_apply_ws_smem(M, D, 1);
  } else {
    return 0;
  }
  if (smem > kSmemPerBlock) return 0;
  return static_cast<int>(dtype == 1 ? ApTiles(M, D).total() : BaAtoms(M, D).total());
}

// 1 where the tensor-core apply for these widths is a persistent kernel
// (la_bwd_apply_ws_kernel in f32; la_bwd_apply_ws16_kernel in bf16 up to M,
// D = 256), 0 where it is la_bwd_apply_wgmma_kernel (bf16 above 256) or the
// apply runs on the CUDA cores.
extern "C" int sgf_la_bwd_apply_persistent(int dtype, int M, int D) {
  if (sgf_la_bwd_apply_scratch(dtype, M, D) == 0) return 0;
  return dtype == 0 || apply_ws16_fits(M, D);
}

// dq, dk [N, M] and dv [N, D] in the input type, each a row-strided view
// (ld*); dinv is the sum over all heads; rows = (den, gden) from the reduce.
// hl: the scratch of sgf_la_bwd_apply_scratch elements of the input type
// where that is not 0 (the tensor-core designs: la_bwd_split_tiles_kernel,
// then la_bwd_apply_ws16_kernel, or la_bwd_apply_wgmma_kernel above M, D =
// 256; la_bwd_split_atoms_kernel, then la_bwd_apply_ws_kernel in 3xTF32 for
// f32),
// else unused (la_bwd_apply_kernel). vec_a: 1 when the A rows (g, v, k)
// may be read 16 bytes at a time (M and D multiples of 8, row strides too,
// bases 16-byte aligned); vec_io: the epilogue moves 8 columns of q, k, g,
// dq, dk, dv with 16-byte accesses (row strides multiples of 8, bases
// 16-byte aligned).
extern "C" int sgf_la_bwd_apply(const void* q, const void* k, const void* v, const void* g,
                                long ldq, long ldk, long ldv, long ldg, void* dq, void* dk,
                                void* dv, long lddq, long lddk, long lddv, int N, int M, int D,
                                int dtype, const float* kvs, const float* ksum, const float* P,
                                const float* ds, const float* scal, const float* n_total,
                                const float* dinv, const float* rows, int guard, int vec_a,
                                int vec_io, void* hl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* den = rows;
  const float* gden = rows + N;
  if (sgf_la_bwd_apply_scratch(dtype, M, D) > 0) {
    using bf16 = __nv_bfloat16;
    if (dtype == 1) {
      return static_cast<int>(launch_bwd_apply_tc(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(g), ldq, ldk, ldv, ldg, static_cast<bf16*>(dq),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), lddq, lddk, lddv, N, M, D, kvs, ksum,
          P, ds, scal, n_total, dinv, den, gden, guard, vec_a, vec_io, static_cast<bf16*>(hl),
          st));
    }
    return static_cast<int>(launch_bwd_apply_tc(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(g), ldq, ldk, ldv, ldg, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), lddq, lddk, lddv, N, M, D, kvs, ksum,
        P, ds, scal, n_total, dinv, den, gden, guard, vec_a, vec_io, static_cast<float*>(hl),
        st));
  }
  if (dtype == 0) {
    launch_bwd_apply<float>(q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M,
                            D, kvs, ksum, P, ds, scal, n_total, dinv, den, gden, guard, st);
  } else if (dtype == 1) {
    launch_bwd_apply<__nv_bfloat16>(q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk,
                                    lddv, N, M, D, kvs, ksum, P, ds, scal, n_total, dinv, den,
                                    gden, guard, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
