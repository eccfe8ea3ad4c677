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
// The bf16 apply (la_bwd_apply_tc_kernel) runs its three products on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 sums). The A side is the
// bf16 input rows as they are (g, v, k; the 1/den of gd = g/den moves into
// the epilogue); the B side, kvs and P, stays f32 in meaning: each is split
// once per call (la_bwd_split_kernel) into bf16 hi + lo (hi = bf16(x), lo =
// bf16(x - hi), ~16 significant bits) and every product is two MMAs, so the
// error is ~2^-17 of each term against the CUDA-core kernel's f32 FMAs. One
// block owns 128 rows and produces all three outputs at full width, so q, k,
// v and g are read from device memory once (the CUDA-core grid reads each
// row block once per 64-column output tile). The MMA work, 6 x 22.2 GFLOP
// at the arxiv shape, is ~0.13 ms at the card's bf16 peak, under the bytes
// bound.
//
// The bf16 reduce runs both its products on the tensor cores too:
//   1. la_bwd_rows_tc_kernel forms a = q @ kvs with the apply's core (the
//      q rows staged once by cp.async, kvs^T split into three bf16 pieces,
//      hi + mid + lo, by tc::split_t_kernel and streamed in
//      double-buffered 64-deep chunks; three MMAs a product, since dinv's
//      sums cancel and two pieces left it 1.3e-5 of its size off); its
//      epilogue folds each 64-column tile of a into sum_d g*a
//      and sum_d g*v per row at once, so a never leaves the block, and
//      writes den, gden and the f64 dinv partial as the CUDA-core pass does;
//   2. la_bwd_reduce_tc_kernel forms P = q^T (g/den) with the node-axis
//      contraction of the forward reduce (tensor_core.cuh): q is the A
//      operand as it is, gd = g * (1/den) is formed in f32 while each chunk
//      is staged and split into bf16 hi + lo, two MMAs a product; ds keeps
//      its per-slice f64 sum on the CUDA cores.
// a is recomputed from q and kvs, as the TPU kernel does, rather than taken
// from the forward's bf16 output (num = out * den), which would move gden by
// ~2^-9. Passes 3 (finish, dinv) are the CUDA-core design's.
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
// tile's 32 columns. The apply and the rows pass now run them on warpgroup
// MMAs (tc::wg_column_tile, wgmma m64n64k8 tf32): the A rows (g, v, k; q)
// stay f32 in shared memory (a 128 x 256 tile is 130 KB, one block an SM)
// and each warp's fragments are split as they load and feed the MMAs from
// registers, each one over 64 output columns; B (kvs, P, P^T; kvs^T) is
// split once per call into tf32 hi + lo and streamed in 64-deep chunks,
// 128-byte swizzled (two stages of hi and lo, 64 KB, at the start of the
// dynamic block, which must be 1024-byte aligned: the f32 kernels have no
// static shared memory), and each wgmma reads it through a descriptor, a
// 64 x 64 x 8 product a warpgroup. Every 16 deep the products go into fresh
// sums (scale-d = 0) added to the running sums in f32 round-to-nearest, so
// that the tensor cores' own accumulation, which may truncate, never chains
// more than one such step. That took the apply at the arxiv shape from 2.08
// to 1.58 ms and the rows pass from 0.75 to 0.57 (NVIDIA H100, 700 W):
// still ~4x the bound, since the MMA loop alone runs at ~45 % of the TF32
// peak and one block an SM does not overlap the A staging, the B stream and
// the epilogue with it (PERF.md). The P pass (la_bwd_reduce_tf32_kernel) stays on
// mma.sync: the node-axis contraction with q split as its fragments load and
// gd = g * (1/den) split once a chunk into shared tf32 hi + lo tiles (both
// operands node-major, which tf32 wgmma, transposing no 32-bit operand,
// does not read). Two tf32 pieces of kvs keep dinv's cancelling sums where
// the bf16 rows pass needs three bf16 pieces.
//
// Inputs are row-strided views (ld* = elements between rows), so the heads
// of an [N, H, *] tensor are read and written in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::mma_bf16;
using tc::split_tf32;
using tc::kCsStride;
using tc::kPadOf;
using tc::kTcCols;
using tc::kTcRows;
using tc::kTcThreads;
using tc::kTfK;
using tc::kWgBBytes;
using tc::load8;
using tc::node_mma_chunk_tf32;
using tc::store8;
using tc::tc_stage_rows;
using tc::tc_tile_to_smem;
using tc::tile8;

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

// ---------------------------------------------------------------------------
// The bf16 apply on the tensor cores.
//
// Block tile: kTcRows rows x kTcCols output columns, 8 warps in a 4 x 2
// grid of 32 x 32 warp tiles (2 m16 x 4 n8 MMA tiles each). For each of the
// three products the block stages its rows of the A operand ([kTcRows, K]
// bf16, K padded with zeros to a multiple of kTcK) into shared memory once
// (cp.async, every copy in flight at once), then walks the output columns
// kTcCols at a time, streaming the B operand in kTcK-deep chunks (hi and lo,
// double-buffered with cp.async) and finishing each column tile in an
// epilogue that stages the tile in shared memory, so that its reads of q, k,
// g and its writes of dq, dk, dv are 16-byte and coalesced (straight from
// the registers' fragment layout they are 4-byte and scattered, and they,
// not the MMAs, set the kernel's time on the H100). B is stored n-major
// ([n][k],
// contiguous in k), so ldmatrix without transpose yields mma's "col"
// fragments. Each k-step issues the 8 hi MMAs, then the 8 lo MMAs, so no
// MMA waits on the one before it.

constexpr int kTcK = 64;
constexpr int kTcPad = 8;  // bf16 per shared row past its end: ldmatrix without bank conflicts
constexpr int kTcBStride = kTcK + kTcPad;
constexpr int kTcBStage = kTcCols * kTcBStride;  // bf16 of one piece's chunk
constexpr size_t kTcBStageBytes = kTcBStage * sizeof(__nv_bfloat16);
using tc::kSmemPerBlock;

// The f32 (3xTF32) forms pad a shared A row by 16 bytes as a bf16 one
// (kTcPad) and stream B in kTfK-deep f32 chunks through the warpgroup core
// (tc::wg_column_tile: two stages of hi and lo, kWgBBytes, first in the
// dynamic block), up to widths of kWgMaxK.
static_assert(kTcK % kTfK == 0, "whole tf32 chunks in the padded depth");
constexpr int kWgMaxK = 256;
template <typename T>
constexpr bool kIsF32 = std::is_same_v<T, float>;

// The padded extents of the split operands: kvs and P as [n = M][k = D]
// (dq and dk), P^T as [n = D][k = M] (dv); n padded to kTcCols, k to kTcK.
struct TcDims {
  int Mn, Dk, Dn, Mk;
  __host__ __device__ TcDims(int M, int D)
      : Mn((M + kTcCols - 1) / kTcCols * kTcCols), Dk((D + kTcK - 1) / kTcK * kTcK),
        Dn((D + kTcCols - 1) / kTcCols * kTcCols), Mk((M + kTcK - 1) / kTcK * kTcK) {}
  __host__ __device__ size_t kvs_elems() const { return static_cast<size_t>(Mn) * Dk; }
  __host__ __device__ size_t pt_elems() const { return static_cast<size_t>(Dn) * Mk; }
  // hl holds kvs hi, kvs lo, P hi, P lo, P^T hi, P^T lo, in this order
  __host__ __device__ size_t total() const { return 4 * kvs_elems() + 2 * pt_elems(); }
};

static_assert(kTcCols == tc::kSplitPad && kTcK == tc::kSplitPad,
              "P^T and the rows pass's kvs^T share tensor_core.cuh's split layout");
using tc::split_store;

// The rows pass splits kvs into three pieces: a = q @ kvs feeds dinv's sum
// sum gd*a, which cancels with sum gden*b to ~1/10 of its terms at the arxiv
// shape, and the ~2^-17 of hi + lo then leaves dinv ~1.3e-5 of its size off
// the f64 plain version (the CUDA-core kernel's f32 sums: 8.5e-7). The f32
// rows pass splits it into tf32 hi + lo, each product 3xTF32 (~2^-21).
template <typename T>
constexpr int kRowsPieces = 3;
template <>
constexpr int kRowsPieces<float> = 2;

// hl[...] = the hi and lo halves of kvs, P and P^T, zero in the pads: bf16
// pieces, or tf32 pieces held in f32 (Piece = float).
template <typename Piece>
__global__ void __launch_bounds__(kThreads)
la_bwd_split_kernel(const float* __restrict__ kvs, const float* __restrict__ P, int M, int D,
                    Piece* __restrict__ hl) {
  const TcDims t(M, D);
  const size_t nk = t.kvs_elems();
  const size_t count = 2 * nk + t.pt_elems();
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float x = 0.f;
    Piece* hi;
    size_t lo_off;
    if (i < 2 * nk) {  // kvs (i < nk) or P, [m][d]
      const size_t j = i < nk ? i : i - nk;
      const int m = static_cast<int>(j / t.Dk);
      const int d = static_cast<int>(j % t.Dk);
      const float* X = i < nk ? kvs : P;
      if (m < M && d < D) x = X[static_cast<size_t>(m) * D + d];
      hi = hl + (i < nk ? 0 : 2 * nk) + j;
      lo_off = nk;
    } else {  // P^T, [d][m]
      const size_t j = i - 2 * nk;
      const int d = static_cast<int>(j / t.Mk);
      const int m = static_cast<int>(j % t.Mk);
      if (m < M && d < D) x = P[static_cast<size_t>(m) * D + d];
      hi = hl + 4 * nk + j;
      lo_off = t.pt_elems();
    }
    split_store<2>(x, hi, lo_off);
  }
}

// The f32 output tile of the epilogue (tc::kCsStride) lies over the B
// stages once a column tile's products are done.
static_assert(kTcRows * kCsStride * 4 <= 4 * kTcBStageBytes &&
                  kTcRows * kCsStride * 4 <= kWgBBytes,
              "C tile must fit the B stages");
static_assert(kTcRows * (kTcCols / 8) % kTcThreads == 0, "whole epilogue steps a thread");

// The rows kernels' core, shared by the apply and the reduce's rows pass
// (tensor_core.cuh: tc_stage_rows stages the A rows).
//
// acc = As [kTcRows][Kp] @ B^T for the output columns [c0, c0 + kTcCols),
// with B the split operand [n][Kp] in kPieces bf16 pieces (hi at B_hi, the
// next at B_hi + piece_off, ...), streamed in kTcK-deep chunks,
// double-buffered by cp.async in Bs ([stage][piece][n][k]). B is n-major
// (contiguous in k), so ldmatrix without transpose yields mma's "col"
// fragments. Each k-step issues the 8 hi MMAs, then the next piece's 8, so
// no MMA waits on the one before it. kStepSums: each k-step's products go
// into fresh sums, added to acc with f32 round-to-nearest adds, so that the
// tensor cores' own accumulation, which may truncate, only ever chains one
// k-step's pieces: a bias of its rounding toward zero would otherwise grow
// with K and, in the reduce's rows pass, move dinv's cancelling sums by
// ~1e-5 of dinv (measured on the H100). Ends with a barrier, after which Bs
// is free.
template <int kPieces, bool kStepSums>
__device__ __forceinline__ void tc_column_tile(float (&acc)[2][4][4], const __nv_bfloat16* As,
                                               int a_stride, __nv_bfloat16* Bs,
                                               const __nv_bfloat16* __restrict__ B_hi,
                                               size_t piece_off, int Kp, int c0, int tid,
                                               int lane, int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one chunk: [kTcCols][kTcK] of each piece, 16 bytes a copy
  auto load_b = [&](int kc, int stage) {
    constexpr int kSegs = kTcK / 8;
    constexpr int kCopies = kPieces * kTcCols * kSegs;
    static_assert(kCopies % kTcThreads == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < kCopies / kTcThreads; ++it) {
      const int i = tid + it * kTcThreads;
      const int piece = i / (kTcCols * kSegs);
      const int row = (i / kSegs) % kTcCols;
      const int seg = (i % kSegs) * 8;
      const __nv_bfloat16* src =
          B_hi + piece * piece_off + static_cast<size_t>(c0 + row) * Kp + kc * kTcK + seg;
      cp_async16(Bs + (stage * kPieces + piece) * kTcBStage + row * kTcBStride + seg, src);
    }
    cp_async_commit();
  };

  const int chunks = Kp / kTcK;
  load_b(0, 0);
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 < chunks) {
      load_b(kc + 1, (kc + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Bh = Bs + (kc & 1) * kPieces * kTcBStage;
#pragma unroll
    for (int ks = 0; ks < kTcK; ks += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm + mt * 16 + (lane & 15);
        const int col = kc * kTcK + ks + (lane >> 4) * 8;
        ldmatrix_x4(a[mt], As + static_cast<size_t>(row) * a_stride + col);
      }
      // the hi piece's fragments, its 8 MMAs, then the next piece's in the
      // same registers
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      float (&sums)[2][4][4] = kStepSums ? part : acc;
#pragma unroll
      for (int piece = 0; piece < kPieces; ++piece) {
        const __nv_bfloat16* Bp = Bh + piece * kTcBStage;
        unsigned b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int nrow = wn + np * 16 + (lane & 7) + (lane >> 4) * 8;
          const int kcol = ks + ((lane >> 3) & 1) * 8;
          unsigned r[4];
          ldmatrix_x4(r, Bp + nrow * kTcBStride + kcol);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(sums[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
      if (kStepSums) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
      }
    }
    __syncthreads();  // this stage is refilled two chunks on
  }
}

// grid (ceil(N / kTcRows)); dynamic shared memory: the A tile
// [kTcRows][max(Dk, Mk) + kTcPad] and two stages of B chunks (hi and lo,
// [kTcCols][kTcK + kTcPad] each). vec_a: 1 when the A rows (g, v, k) may be
// read 16 bytes at a time (M and D multiples of 8, row strides too, bases
// 16-byte aligned). vec_io: the epilogue moves 8 columns of q, k, g, dq,
// dk, dv with 16-byte accesses (row strides multiples of 8, bases 16-byte
// aligned). Each column tile is finished in an epilogue that stages it in
// shared memory, so that its reads of q, k, g and its writes of dq, dk, dv
// are 16-byte and coalesced (straight from the registers' fragment layout
// they are 4-byte and scattered, and they, not the MMAs, set the kernel's
// time on the H100). bf16 only: the f32 form is la_bwd_apply_wg_kernel.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
la_bwd_apply_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ g, long ldq, long ldk, long ldv, long ldg,
                       T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, long lddq,
                       long lddk, long lddv, int N, int M, int D, const T* __restrict__ hl,
                       const float* __restrict__ ksum, const float* __restrict__ ds,
                       const float* __restrict__ scal, const float* __restrict__ n_total,
                       const float* __restrict__ dinv, const float* __restrict__ den,
                       const float* __restrict__ gden, int guard, int vec_a, int vec_io) {
  static_assert(!kIsF32<T>, "the f32 form is la_bwd_apply_wg_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcDims t(M, D);
  const int a_stride = max(t.Dk, t.Mk) + kPadOf<T>;
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + static_cast<size_t>(kTcRows) * a_stride;  // [stage][hi, lo][n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 32;   // warp's first row in the tile
  const int wn = (warp >> 2) * 32;  // warp's first column in the column tile
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;

  const float inv = scal[2];
  const float n = *n_total;
  const bool no_norm = guard && inv == 0.f;  // the guard: no dinv term
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
  const size_t nk = t.kvs_elems();

  for (int which = 0; which < 3; ++which) {
    // dq: g @ kvs^T over D; dk: v @ P^T over D; dv: k @ P over M
    const T* A = which == 0 ? g : (which == 1 ? v : k);
    const long lda = which == 0 ? ldg : (which == 1 ? ldv : ldk);
    const int K = which == 2 ? M : D;
    const int Kp = which == 2 ? t.Mk : t.Dk;
    const int C = which == 2 ? D : M;
    const T* B_hi = hl + (which == 0 ? 0 : (which == 1 ? 2 * nk : 4 * nk));
    const size_t lo_off = which == 2 ? t.pt_elems() : nk;

    __syncthreads();  // the previous product is done with As
    tc_stage_rows(As, a_stride, A, lda, r0, N, K, Kp, vec_a, tid);
    __syncthreads();

    const int tiles = (C + kTcCols - 1) / kTcCols;
    for (int ti = 0; ti < tiles; ++ti) {
      const int c0 = ti * kTcCols;
      float acc[2][4][4];
      tc_column_tile<2, false>(acc, As, a_stride, Bs, B_hi, lo_off, Kp, c0, tid, lane, wm, wn);
      // epilogue: the tile through shared memory, then 8 columns a thread
      // step with 16-byte loads and stores
      float* Cs = reinterpret_cast<float*>(Bs);
      tc_tile_to_smem(Cs, acc, lane, wm, wn);
      // a fixed trip count, unrolled, so that each thread's reads of q, k or
      // g are in flight together
#pragma unroll
      for (int it = 0; it < kTcRows * (kTcCols / 8) / kTcThreads; ++it) {
        const int i = tid + it * kTcThreads;
        const int r = i / (kTcCols / 8);
        const int cs = (i % (kTcCols / 8)) * 8;
        const long row = r0 + r;
        const int c = c0 + cs;
        if (row >= N || c >= C) continue;
        const int cols = min(8, C - c);
        const bool vec = vec_io && cols == 8;
        float a[8], o[8], x[8];
        tile8(Cs, r, cs, a);
        const float den_r = den[row];
        if (which == 0) {
          const float gden_r = gden[row];
          load8(q + row * ldq + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ks = e < cols ? ksum[c + e] : 0.f;
            o[e] = inv * (a[e] / den_r) + inv * gden_r * ks - c_q * x[e];
          }
          store8(dq + row * lddq + c, vec, cols, o);
        } else if (which == 1) {
          load8(k + row * ldk + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dsv = e < cols ? ds[c + e] : 0.f;
            o[e] = inv * a[e] + inv * dsv - c_k * x[e];
          }
          store8(dk + row * lddk + c, vec, cols, o);
        } else {
          load8(g + row * ldg + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = n * (x[e] / den_r) + inv * a[e];
          store8(dv + row * lddv + c, vec, cols, o);
        }
      }
      __syncthreads();  // Cs is the next column tile's B stages
    }
  }
}

template <typename T>
size_t tc_smem_bytes(int M, int D) {
  const TcDims t(M, D);
  const int a_stride = (t.Dk > t.Mk ? t.Dk : t.Mk) + kPadOf<T>;
  return static_cast<size_t>(kTcRows) * a_stride * sizeof(T) + 4 * kTcBStageBytes;
}

// The reduce's rows pass on the tensor cores. grid (ceil(N / kTcRows));
// dynamic shared memory: the q tile [kTcRows][Mk + kPadOf<T>] and the B
// stages of kvs^T (its kRowsPieces<T> pieces, hl as tc::split_t_kernel
// writes it): ~123 KB at M = 256, one block an SM (bf16 only: the f32 form
// is la_bwd_rows_wg_kernel). Block bx owns
// rows [128*bx, 128*bx + 128): b = q . ksum from the staged q rows, then
// a = q @ kvs one 64-column tile at a time, each tile folded at once into
// sum_d g*a and sum_d g*v per row (eight threads a row, 8 columns each, a
// fixed xor tree across them), then den, gden and the block's f64 dinv
// partial, as la_bwd_rows_kernel computes them. vec_a: q rows by 16-byte
// copies; vec_io: g and v read 16 bytes at a time.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
la_bwd_rows_tc_kernel(const T* __restrict__ q, const T* __restrict__ v, const T* __restrict__ g,
                      long ldq, long ldv, long ldg, int N, int M, int D, const T* __restrict__ hl,
                      const float* __restrict__ ksum, const float* __restrict__ scal,
                      const float* __restrict__ n_total, int guard, int vec_a, int vec_io,
                      float* __restrict__ den_out, float* __restrict__ gden_out,
                      double* __restrict__ dinv_part) {
  static_assert(!kIsF32<T>, "the f32 form is la_bwd_rows_wg_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float b_s[kTcRows];
  __shared__ float ga_s[kTcRows];
  __shared__ float gv_s[kTcRows];
  __shared__ double red[kTcRows];
  const TcDims t(M, D);
  const int a_stride = t.Mk + kPadOf<T>;
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + static_cast<size_t>(kTcRows) * a_stride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;

  tc_stage_rows(As, a_stride, q, ldq, r0, N, M, t.Mk, vec_a, tid);
  __syncthreads();
  {  // b = q . ksum, two threads a row (adjacent lanes), f32
    const int r = tid >> 1;
    float b = 0.f;
    for (int c = tid & 1; c < M; c += 2) {
      b = fmaf(to_float(As[static_cast<size_t>(r) * a_stride + c]), ksum[c], b);
    }
    b += __shfl_xor_sync(0xffffffffu, b, 1);
    if ((tid & 1) == 0) b_s[r] = b;
  }

  // thread tid folds columns (tid % 8) * 8 .. + 8 of rows tid / 8 + 32 * it
  constexpr int kSteps = kTcRows * (kTcCols / 8) / kTcThreads;
  float ga[kSteps], gv[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) ga[it] = gv[it] = 0.f;
  float* Cs = reinterpret_cast<float*>(Bs);
  for (int c0 = 0; c0 < D; c0 += kTcCols) {
    float acc[2][4][4];
    tc_column_tile<kRowsPieces<T>, true>(acc, As, a_stride, Bs, hl, t.pt_elems(), t.Mk, c0, tid,
                                         lane, wm, wn);
    tc_tile_to_smem(Cs, acc, lane, wm, wn);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int i = tid + it * kTcThreads;
      const int r = i / (kTcCols / 8);
      const int cs = (i % (kTcCols / 8)) * 8;
      const long row = r0 + r;
      const int c = c0 + cs;
      float pga = 0.f, pgv = 0.f;
      if (row < N && c < D) {
        const int cols = min(8, D - c);
        const bool vec = vec_io && cols == 8;
        float a[8], x[8], y[8];
        tile8(Cs, r, cs, a);
        load8(g + row * ldg + c, vec, cols, x);
        load8(v + row * ldv + c, vec, cols, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          pga = fmaf(x[e], a[e], pga);
          pgv = fmaf(x[e], y[e], pgv);
        }
      }
      // the eight threads of a row are lanes 8j .. 8j + 7 of one warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        pga += __shfl_xor_sync(0xffffffffu, pga, off);
        pgv += __shfl_xor_sync(0xffffffffu, pgv, off);
      }
      ga[it] += pga;
      gv[it] += pgv;
    }
    __syncthreads();  // Cs is the next column tile's B stages
  }
  if ((tid & 7) == 0) {
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int r = (tid + it * kTcThreads) / (kTcCols / 8);
      ga_s[r] = ga[it];
      gv_s[r] = gv[it];
    }
  }
  __syncthreads();

  if (tid < kTcRows) {
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
  for (int stride = kTcRows / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) dinv_part[blockIdx.x] = red[0];
}

template <typename T>
size_t rows_tc_smem_bytes(int M, int D) {
  const TcDims t(M, D);
  return static_cast<size_t>(kTcRows) * (t.Mk + kPadOf<T>) * sizeof(T) +
         2 * kRowsPieces<T> * kTcBStageBytes;
}

// ---------------------------------------------------------------------------
// The f32 apply and rows pass on warpgroup MMAs in 3xTF32 (tc::wg_column_tile).
// grid (ceil(N / kTcRows)), 128 rows a block, two warpgroups of 64 rows,
// one block an SM. Dynamic shared memory, 1024-byte aligned (no static
// shared memory, so the dynamic block starts the block's window): the two
// B stages (kWgBBytes, 64 KB; the staged output tile lies over them) and the
// f32 A tile [kTcRows][Kp + 4] (130 KB at a width of 256): ~194 KB.

// the dynamic block of the f32 kernels for an A tile K (padded) wide
size_t wg_smem_bytes(int K) {
  return kWgBBytes + static_cast<size_t>(kTcRows) * (K + kPadOf<float>) * sizeof(float);
}

// The apply: for each product (dq: g @ kvs^T over D; dk: v @ P^T over D;
// dv: k @ P over M) the block stages its A rows once, then forms its column
// tiles, each finished in la_bwd_apply_tc_kernel's epilogue. Blocks start
// at different products and column tiles (rot), so that the SMs do not all
// stage A rows at once. vec_a, vec_io as la_bwd_apply_tc_kernel takes them.
__global__ void __launch_bounds__(kTcThreads, 1)
la_bwd_apply_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g, long ldq, long ldk,
                       long ldv, long ldg, float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, long lddq, long lddk, long lddv, int N, int M, int D,
                       const float* __restrict__ hl, const float* __restrict__ ksum,
                       const float* __restrict__ ds, const float* __restrict__ scal,
                       const float* __restrict__ n_total, const float* __restrict__ dinv,
                       const float* __restrict__ den, const float* __restrict__ gden, int guard,
                       int vec_a, int vec_io) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (tc::smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const TcDims t(M, D);
  const int a_stride = max(t.Dk, t.Mk) + kPadOf<float>;
  unsigned char* Bs = smem_raw;
  float* Cs = reinterpret_cast<float*>(Bs);
  float* As = reinterpret_cast<float*>(smem_raw + kWgBBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;

  const float inv = scal[2];
  const float n = *n_total;
  const bool no_norm = guard && inv == 0.f;  // the guard: no dinv term
  const float c_q = no_norm ? 0.f : *dinv * inv / scal[0];
  const float c_k = no_norm ? 0.f : *dinv * inv / scal[1];
  const size_t nk = t.kvs_elems();

  const int rot = static_cast<int>(blockIdx.x);
  for (int w = 0; w < 3; ++w) {
    const int which = (w + rot) % 3;
    const float* A = which == 0 ? g : (which == 1 ? v : k);
    const long lda = which == 0 ? ldg : (which == 1 ? ldv : ldk);
    const int K = which == 2 ? M : D;
    const int Kp = which == 2 ? t.Mk : t.Dk;
    const int C = which == 2 ? D : M;
    const float* B_hi = hl + (which == 0 ? 0 : (which == 1 ? 2 * nk : 4 * nk));
    const size_t lo_off = which == 2 ? t.pt_elems() : nk;

    __syncthreads();  // the previous product is done with As
    tc_stage_rows(As, a_stride, A, lda, r0, N, K, Kp, vec_a, tid);
    __syncthreads();

    const int tiles = (C + kTcCols - 1) / kTcCols;
    for (int ti = 0; ti < tiles; ++ti) {
      const int c0 = (ti + rot) % tiles * kTcCols;
      float acc[32];
      tc::wg_column_tile(acc, As, a_stride, Bs, B_hi, lo_off, Kp, c0, tid, lane, warp);
      tc::wg_tile_to_smem(Cs, acc, lane, warp);
#pragma unroll
      for (int it = 0; it < kTcRows * (kTcCols / 8) / kTcThreads; ++it) {
        const int i = tid + it * kTcThreads;
        const int r = i / (kTcCols / 8);
        const int cs = (i % (kTcCols / 8)) * 8;
        const long row = r0 + r;
        const int c = c0 + cs;
        if (row >= N || c >= C) continue;
        const int cols = min(8, C - c);
        const bool vec = vec_io && cols == 8;
        float a[8], o[8], x[8];
        tile8(Cs, r, cs, a);
        const float den_r = den[row];
        if (which == 0) {
          const float gden_r = gden[row];
          load8(q + row * ldq + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ks = e < cols ? ksum[c + e] : 0.f;
            o[e] = inv * (a[e] / den_r) + inv * gden_r * ks - c_q * x[e];
          }
          store8(dq + row * lddq + c, vec, cols, o);
        } else if (which == 1) {
          load8(k + row * ldk + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dsv = e < cols ? ds[c + e] : 0.f;
            o[e] = inv * a[e] + inv * dsv - c_k * x[e];
          }
          store8(dk + row * lddk + c, vec, cols, o);
        } else {
          load8(g + row * ldg + c, vec, cols, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = n * (x[e] / den_r) + inv * a[e];
          store8(dv + row * lddv + c, vec, cols, o);
        }
      }
      __syncthreads();  // Cs is the next column tile's B stages
    }
  }
}

// The rows pass: la_bwd_rows_tc_kernel's with the f32 core. b = q . ksum
// from the staged q rows,
// then a = q @ kvs one column tile at a time (kvs^T as tf32 hi + lo, hl as
// tc::split_t_kernel writes it), each tile folded at once into sum_d g*a
// and sum_d g*v per row (eight threads a row, 8 columns each, a fixed xor
// tree across them), then den, gden and the block's f64 dinv partial, as
// la_bwd_rows_kernel computes them, the per-row sums over the B stages.
__global__ void __launch_bounds__(kTcThreads, 1)
la_bwd_rows_wg_kernel(const float* __restrict__ q, const float* __restrict__ v,
                      const float* __restrict__ g, long ldq, long ldv, long ldg, int N, int M,
                      int D, const float* __restrict__ hl, const float* __restrict__ ksum,
                      const float* __restrict__ scal, const float* __restrict__ n_total,
                      int guard, int vec_a, int vec_io, float* __restrict__ den_out,
                      float* __restrict__ gden_out, double* __restrict__ dinv_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (tc::smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const TcDims t(M, D);
  const int a_stride = t.Mk + kPadOf<float>;
  unsigned char* Bs = smem_raw;
  float* Cs = reinterpret_cast<float*>(Bs);
  float* As = reinterpret_cast<float*>(smem_raw + kWgBBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;

  tc_stage_rows(As, a_stride, q, ldq, r0, N, M, t.Mk, vec_a, tid);
  __syncthreads();
  float b = 0.f;  // q . ksum of row tid / 2, two threads a row (adjacent lanes), f32
  {
    const float* qr = As + static_cast<size_t>(tid >> 1) * a_stride;
    for (int c = tid & 1; c < M; c += 2) b = fmaf(qr[c], ksum[c], b);
    b += __shfl_xor_sync(0xffffffffu, b, 1);
  }

  // thread tid folds columns (tid % 8) * 8 .. + 8 of rows tid / 8 + 32 * it
  constexpr int kSteps = kTcRows * (kTcCols / 8) / kTcThreads;
  float ga[kSteps], gv[kSteps];
#pragma unroll
  for (int it = 0; it < kSteps; ++it) ga[it] = gv[it] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kTcCols) {
    float acc[32];
    tc::wg_column_tile(acc, As, a_stride, Bs, hl, t.pt_elems(), t.Mk, c0, tid, lane, warp);
    tc::wg_tile_to_smem(Cs, acc, lane, warp);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int i = tid + it * kTcThreads;
      const int r = i / (kTcCols / 8);
      const int cs = (i % (kTcCols / 8)) * 8;
      const long row = r0 + r;
      const int c = c0 + cs;
      float pga = 0.f, pgv = 0.f;
      if (row < N && c < D) {
        const int cols = min(8, D - c);
        const bool vec = vec_io && cols == 8;
        float a[8], x[8], y[8];
        tile8(Cs, r, cs, a);
        load8(g + row * ldg + c, vec, cols, x);
        load8(v + row * ldv + c, vec, cols, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          pga = fmaf(x[e], a[e], pga);
          pgv = fmaf(x[e], y[e], pgv);
        }
      }
      // the eight threads of a row are lanes 8j .. 8j + 7 of one warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        pga += __shfl_xor_sync(0xffffffffu, pga, off);
        pgv += __shfl_xor_sync(0xffffffffu, pgv, off);
      }
      ga[it] += pga;
      gv[it] += pgv;
    }
    __syncthreads();  // Cs is the next column tile's B stages
  }
  float* b_s = Cs;
  float* ga_s = b_s + kTcRows;
  float* gv_s = ga_s + kTcRows;
  double* red = reinterpret_cast<double*>(gv_s + kTcRows);
  if ((tid & 1) == 0) b_s[tid >> 1] = b;
  if ((tid & 7) == 0) {
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const int r = (tid + it * kTcThreads) / (kTcCols / 8);
      ga_s[r] = ga[it];
      gv_s[r] = gv[it];
    }
  }
  __syncthreads();

  if (tid < kTcRows) {
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
  for (int stride = kTcRows / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) dinv_part[blockIdx.x] = red[0];
}

// The reduce's P pass on the tensor cores: the node-axis contraction of the
// forward reduce (tensor_core.cuh) with A = q and B = gd = g / den. grid
// (slices * tiles), tiles = ceil(M/128) * ceil(D/128), slice-major: block b
// sums tile b % tiles of P over rows [s*rows_per_slice, (s+1)*rows_per_slice),
// s = b / tiles. Each 32-row chunk of q and g (and den, gden) comes through
// a kReduceStages-deep cp.async ring; once it has landed the block forms gd
// in f32 (g times the correctly rounded 1/den: within 2^-23 of g / den,
// against the 2^-17 of the split), splits it into bf16 hi + lo tiles and
// runs both through the MMAs. The blocks of the first column tile also sum
// ds = q . gden per column of their M tile in f64 from the staged q rows.
constexpr int kReduceStages = 4;
constexpr int kReduceStage = 2 * tc::kNodeChunk;  // bf16 of a stage's q and g chunks
constexpr size_t kReduceSmem =
    kReduceStages * (kReduceStage * sizeof(__nv_bfloat16) + 2 * tc::kNodeRows * sizeof(float)) +
    2 * tc::kNodeChunk * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(tc::kNodeThreads, 2)
la_bwd_reduce_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
                        long ldq, long ldg, int N, int M, int D, int rows_per_slice, int vec,
                        const float* __restrict__ den, const float* __restrict__ gden,
                        float* __restrict__ P_part, float* __restrict__ ds_part) {
  using tc::kNodeRows;
  using tc::kNodeStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][q, g]
  __nv_bfloat16* gd_hi = ring + kReduceStages * kReduceStage;
  __nv_bfloat16* gd_lo = gd_hi + tc::kNodeChunk;
  float* rows_s = reinterpret_cast<float*>(gd_lo + tc::kNodeChunk);  // [stage][den, gden]
  __shared__ double red[tc::kNodeTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 64;
  const int tiles_m = tc::cdiv(M, tc::kNodeTile);
  const int tiles = tiles_m * tc::cdiv(D, tc::kNodeTile);
  const int s = blockIdx.x / tiles;
  const int dy = (blockIdx.x % tiles) / tiles_m;
  const int m0 = (blockIdx.x % tiles % tiles_m) * tc::kNodeTile;
  const int d0 = dy * tc::kNodeTile;
  const bool stats = dy == 0;
  const long r_begin = static_cast<long>(s) * rows_per_slice;
  const long r_stop = r_begin + rows_per_slice;
  const long r_end = r_stop < N ? r_stop : static_cast<long>(N);
  const int chunks = static_cast<int>((r_end - r_begin + kNodeRows - 1) / kNodeRows);

  auto stage = [&](int c) {
    const int st = c % kReduceStages;
    __nv_bfloat16* qs = ring + st * kReduceStage;
    const long r0 = r_begin + static_cast<long>(c) * kNodeRows;
    tc::stage_node_rows(qs, q, ldq, r0, r_end, m0, M, vec, tid);
    tc::stage_node_rows(qs + tc::kNodeChunk, g, ldg, r0, r_end, d0, D, vec, tid);
    if (tid < 2 * kNodeRows) {  // den, then gden, of the chunk's rows
      const int r = tid % kNodeRows;
      const float* src = tid < kNodeRows ? den : gden;
      const bool ok = r0 + r < r_end;
      tc::cp_async4(rows_s + st * 2 * kNodeRows + tid, ok ? src + r0 + r : src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int col = tid & (tc::kNodeTile - 1);
  const int par = tid / tc::kNodeTile;
  double ds = 0.0;

  for (int c = 0; c < kReduceStages - 1; ++c) {
    if (c < chunks) stage(c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<kReduceStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + kReduceStages - 1 < chunks) stage(c + kReduceStages - 1);
    tc::cp_async_commit();
    const int st = c % kReduceStages;
    const __nv_bfloat16* qs = ring + st * kReduceStage;
    const __nv_bfloat16* gs = qs + tc::kNodeChunk;
    const float* den_s = rows_s + st * 2 * kNodeRows;
    const long r0 = r_begin + static_cast<long>(c) * kNodeRows;
    // gd = g * (1/den) as bf16 hi + lo, 8 columns of one row a thread step;
    // rows past the slice are zeros
#pragma unroll
    for (int it = 0; it < kNodeRows * tc::kNodeTile / 8 / tc::kNodeThreads; ++it) {
      const int i = tid + it * tc::kNodeThreads;
      const int r = i / (tc::kNodeTile / 8);
      const int cs = (i % (tc::kNodeTile / 8)) * 8;
      const float rd = r0 + r < r_end ? __frcp_rn(den_s[r]) : 0.f;
      const uint4 raw = *reinterpret_cast<const uint4*>(gs + r * kNodeStride + cs);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 hi_raw, lo_raw;
      __nv_bfloat162* hi2 = reinterpret_cast<__nv_bfloat162*>(&hi_raw);
      __nv_bfloat162* lo2 = reinterpret_cast<__nv_bfloat162*>(&lo_raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float x = __fmul_rn(f.x, rd);
        const float y = __fmul_rn(f.y, rd);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        hi2[e] = hi;
        lo2[e] = __floats2bfloat162_rn(x - hf.x, y - hf.y);
      }
      *reinterpret_cast<uint4*>(gd_hi + r * kNodeStride + cs) = hi_raw;
      *reinterpret_cast<uint4*>(gd_lo + r * kNodeStride + cs) = lo_raw;
    }
    __syncthreads();
    const __nv_bfloat16* const gd[2] = {gd_hi, gd_lo};
    tc::node_mma_chunk<2>(acc, qs, gd, wm, wn, lane);
    if (stats) {
      const float* gden_s = den_s + kNodeRows;
#pragma unroll 4
      for (int r = par; r < kNodeRows; r += 2) {
        ds = fma(static_cast<double>(__bfloat162float(qs[r * kNodeStride + col])),
                 static_cast<double>(gden_s[r]), ds);
      }
    }
  }
  tc::cp_async_wait<0>();

  tc::store_node_tile(P_part + static_cast<size_t>(s) * M * D, acc, m0, d0, M, D, wm, wn, lane);
  if (stats) {  // uniform over the block
    if (par == 1) red[col] = ds;
    __syncthreads();
    if (par == 0 && m0 + col < M) {
      ds_part[static_cast<size_t>(s) * M + m0 + col] = static_cast<float>(ds + red[col]);
    }
  }
}

// The reduce's P pass for f32 inputs, 3xTF32: la_bwd_reduce_tc_kernel's
// grid, slices and f64 ds, one block an SM (the A fragments of a whole
// chunk stay in registers). Each 32-row chunk of q and g (and den, gden)
// comes through a kTfReduceStages-deep cp.async ring as f32; once it has
// landed
// the block forms gd = g * (1/den) (the correctly rounded 1/den: within
// 2^-23 of g / den) and splits it into tf32 hi + lo tiles; q is split as
// its fragments load.
constexpr int kTfReduceStages = 3;
constexpr int kTfReduceStage = 2 * tc::kNodeChunk;  // f32 of a stage's q and g chunks
constexpr size_t kTfReduceSmem =
    (kTfReduceStages * (kTfReduceStage + 2 * tc::kNodeRows) + 2 * tc::kNodeChunk) *
    sizeof(float);

__global__ void __launch_bounds__(tc::kNodeThreads, 1)
la_bwd_reduce_tf32_kernel(const float* __restrict__ q, const float* __restrict__ g, long ldq,
                          long ldg, int N, int M, int D, int rows_per_slice, int vec,
                          const float* __restrict__ den, const float* __restrict__ gden,
                          float* __restrict__ P_part, float* __restrict__ ds_part) {
  using tc::kNodeRows;
  using tc::kNodeStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stage][q, g]
  float* gd_hi = ring + kTfReduceStages * kTfReduceStage;
  float* gd_lo = gd_hi + tc::kNodeChunk;
  float* rows_s = gd_lo + tc::kNodeChunk;  // [stage][den, gden]
  __shared__ double red[tc::kNodeTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 64;
  const int tiles_m = tc::cdiv(M, tc::kNodeTile);
  const int tiles = tiles_m * tc::cdiv(D, tc::kNodeTile);
  const int s = blockIdx.x / tiles;
  const int dy = (blockIdx.x % tiles) / tiles_m;
  const int m0 = (blockIdx.x % tiles % tiles_m) * tc::kNodeTile;
  const int d0 = dy * tc::kNodeTile;
  const bool stats = dy == 0;
  const long r_begin = static_cast<long>(s) * rows_per_slice;
  const long r_stop = r_begin + rows_per_slice;
  const long r_end = r_stop < N ? r_stop : static_cast<long>(N);
  const int chunks = static_cast<int>((r_end - r_begin + kNodeRows - 1) / kNodeRows);

  auto stage = [&](int c) {
    const int st = c % kTfReduceStages;
    float* qs = ring + st * kTfReduceStage;
    const long r0 = r_begin + static_cast<long>(c) * kNodeRows;
    tc::stage_node_rows(qs, q, ldq, r0, r_end, m0, M, vec, tid);
    tc::stage_node_rows(qs + tc::kNodeChunk, g, ldg, r0, r_end, d0, D, vec, tid);
    if (tid < 2 * kNodeRows) {  // den, then gden, of the chunk's rows
      const int r = tid % kNodeRows;
      const float* src = tid < kNodeRows ? den : gden;
      const bool ok = r0 + r < r_end;
      tc::cp_async4(rows_s + st * 2 * kNodeRows + tid, ok ? src + r0 + r : src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int col = tid & (tc::kNodeTile - 1);
  const int par = tid / tc::kNodeTile;
  double ds = 0.0;

  for (int c = 0; c < kTfReduceStages - 1; ++c) {
    if (c < chunks) stage(c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<kTfReduceStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1 and gd
    if (c + kTfReduceStages - 1 < chunks) stage(c + kTfReduceStages - 1);
    tc::cp_async_commit();
    const int st = c % kTfReduceStages;
    const float* qs = ring + st * kTfReduceStage;
    const float* gs = qs + tc::kNodeChunk;
    const float* den_s = rows_s + st * 2 * kNodeRows;
    const long r0 = r_begin + static_cast<long>(c) * kNodeRows;
    // gd = g * (1/den) as tf32 hi + lo, 4 columns of one row a thread step;
    // rows past the slice are zeros
#pragma unroll
    for (int it = 0; it < kNodeRows * tc::kNodeTile / 4 / tc::kNodeThreads; ++it) {
      const int i = tid + it * tc::kNodeThreads;
      const int r = i / (tc::kNodeTile / 4);
      const int cs = (i % (tc::kNodeTile / 4)) * 4;
      const float rd = r0 + r < r_end ? __frcp_rn(den_s[r]) : 0.f;
      const float4 x = *reinterpret_cast<const float4*>(gs + r * kNodeStride + cs);
      const float xs[4] = {__fmul_rn(x.x, rd), __fmul_rn(x.y, rd), __fmul_rn(x.z, rd),
                           __fmul_rn(x.w, rd)};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(xs[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(gd_hi + r * kNodeStride + cs) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(gd_lo + r * kNodeStride + cs) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    node_mma_chunk_tf32(acc, qs, gd_hi, gd_lo, wm, wn, lane);
    if (stats) {
      const float* gden_s = den_s + kNodeRows;
#pragma unroll 4
      for (int r = par; r < kNodeRows; r += 2) {
        ds = fma(static_cast<double>(qs[r * kNodeStride + col]), static_cast<double>(gden_s[r]),
                 ds);
      }
    }
  }
  tc::cp_async_wait<0>();

  tc::store_node_tile(P_part + static_cast<size_t>(s) * M * D, acc, m0, d0, M, D, wm, wn, lane);
  if (stats) {  // uniform over the block
    if (par == 1) red[col] = ds;
    __syncthreads();
    if (par == 0 && m0 + col < M) {
      ds_part[static_cast<size_t>(s) * M + m0 + col] = static_cast<float>(ds + red[col]);
    }
  }
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
  cudaError_t err = tc::launch_split_t<kRowsPieces<T>>(kvs, M, D, hl, st);
  if (err != cudaSuccess) return err;
  const int vec_a = M % kPer == 0 && ldq % kPer == 0 && aligned16(q);
  const int vec_io = ldg % kPer == 0 && ldv % kPer == 0 && aligned16(g) && aligned16(v);
  const unsigned row_blocks = (N + kTcRows - 1) / kTcRows;
  if constexpr (kIsF32<T>) {
    const size_t smem = wg_smem_bytes(TcDims(M, D).Mk);
    err = cudaFuncSetAttribute(la_bwd_rows_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    la_bwd_rows_wg_kernel<<<row_blocks, kTcThreads, smem, st>>>(
        q, v, g, ldq, ldv, ldg, N, M, D, hl, ksum, scal, n_total, guard, vec_a, vec_io, den, gden,
        dinv_part);
  } else {
    const size_t smem = rows_tc_smem_bytes<T>(M, D);
    err = cudaFuncSetAttribute(la_bwd_rows_tc_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    la_bwd_rows_tc_kernel<T><<<row_blocks, kTcThreads, smem, st>>>(
        q, v, g, ldq, ldv, ldg, N, M, D, hl, ksum, scal, n_total, guard, vec_a, vec_io, den, gden,
        dinv_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = M % kPer == 0 && D % kPer == 0 && ldq % kPer == 0 && ldg % kPer == 0 &&
                  aligned16(q) && aligned16(g);
  const int tiles = tc::cdiv(M, tc::kNodeTile) * tc::cdiv(D, tc::kNodeTile);
  if constexpr (kIsF32<T>) {
    err = cudaFuncSetAttribute(la_bwd_reduce_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kTfReduceSmem));
    if (err != cudaSuccess) return err;
    la_bwd_reduce_tf32_kernel<<<slices * tiles, tc::kNodeThreads, kTfReduceSmem, st>>>(
        q, g, ldq, ldg, N, M, D, rows_per_slice, vec, den, gden, P_part, ds_part);
  } else {
    err = cudaFuncSetAttribute(la_bwd_reduce_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kReduceSmem));
    if (err != cudaSuccess) return err;
    la_bwd_reduce_tc_kernel<<<slices * tiles, tc::kNodeThreads, kReduceSmem, st>>>(
        q, g, ldq, ldg, N, M, D, rows_per_slice, vec, den, gden, P_part, ds_part);
  }
  return cudaGetLastError();
}

// Elements of the tensor-core reduce's scratch (kvs^T in pieces of the
// input type: bf16, or tf32 in f32), or 0 where the reduce runs on the CUDA
// cores: an M whose q tile does not fit one block's shared memory beside
// the B stages (above 640 in bf16, 256 in f32).
int bwd_reduce_scratch(int dtype, int M, int D) {
  constexpr size_t kStatic = 4096;  // la_bwd_rows_tc_kernel's static shared memory, rounded up
  const TcDims t(M, D);
  if (dtype == 1) {
    if (rows_tc_smem_bytes<__nv_bfloat16>(M, D) + kStatic > kSmemPerBlock) return 0;
    return static_cast<int>(kRowsPieces<__nv_bfloat16> * t.pt_elems());
  }
  if (dtype == 0) {
    if (t.Mk > kWgMaxK || wg_smem_bytes(t.Mk) > kSmemPerBlock) return 0;
    return static_cast<int>(kRowsPieces<float> * t.pt_elems());
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

// The tensor-core apply: kvs, P and P^T split into hl (bf16 pieces, or
// tf32 pieces in f32 for T = float), then la_bwd_apply_tc_kernel<T> (bf16)
// or la_bwd_apply_wg_kernel (f32).
template <typename T>
cudaError_t launch_bwd_apply_tc(const T* q, const T* k, const T* v, const T* g, long ldq,
                                long ldk, long ldv, long ldg, T* dq, T* dk, T* dv, long lddq,
                                long lddk, long lddv, int N, int M, int D, const float* kvs,
                                const float* ksum, const float* P, const float* ds,
                                const float* scal, const float* n_total, const float* dinv,
                                const float* den, const float* gden, int guard, int vec_a,
                                int vec_io, T* hl, cudaStream_t st) {
  const size_t total = TcDims(M, D).total();
  const unsigned split_blocks =
      static_cast<unsigned>(std::min<size_t>((total + kThreads - 1) / kThreads, 1024));
  la_bwd_split_kernel<T><<<split_blocks, kThreads, 0, st>>>(kvs, P, M, D, hl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return err;
  const unsigned row_blocks = (N + kTcRows - 1) / kTcRows;
  if constexpr (kIsF32<T>) {
    const TcDims t(M, D);
    const size_t smem = wg_smem_bytes(max(t.Dk, t.Mk));
    err = cudaFuncSetAttribute(la_bwd_apply_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    la_bwd_apply_wg_kernel<<<row_blocks, kTcThreads, smem, st>>>(
        q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M, D, hl, ksum, ds, scal,
        n_total, dinv, den, gden, guard, vec_a, vec_io);
  } else {
    const size_t smem = tc_smem_bytes<T>(M, D);
    err = cudaFuncSetAttribute(la_bwd_apply_tc_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    la_bwd_apply_tc_kernel<T><<<row_blocks, kTcThreads, smem, st>>>(
        q, k, v, g, ldq, ldk, ldv, ldg, dq, dk, dv, lddq, lddk, lddv, N, M, D, hl, ksum, ds, scal,
        n_total, dinv, den, gden, guard, vec_a, vec_io);
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
// these widths, or 0 where the reduce runs on the CUDA cores (M above 640
// in bf16, above 256 in f32).
extern "C" int sgf_la_bwd_reduce_scratch(int dtype, int M, int D) {
  return bwd_reduce_scratch(dtype, M, D);
}

// The scratch (elements of the input type) of the tensor-core apply for
// these widths, or 0 where the apply runs on the CUDA cores: widths whose A
// tile does not fit one block's shared memory (above ~700 in bf16, 256 in
// f32).
extern "C" int sgf_la_bwd_apply_scratch(int dtype, int M, int D) {
  size_t smem;
  if (dtype == 1) {
    smem = tc_smem_bytes<__nv_bfloat16>(M, D);
  } else if (dtype == 0) {
    const TcDims t(M, D);
    if (t.Mk > kWgMaxK || t.Dk > kWgMaxK) return 0;
    smem = wg_smem_bytes(max(t.Dk, t.Mk));
  } else {
    return 0;
  }
  if (smem > kSmemPerBlock) return 0;
  return static_cast<int>(TcDims(M, D).total());
}

// dq, dk [N, M] and dv [N, D] in the input type, each a row-strided view
// (ld*); dinv is the sum over all heads; rows = (den, gden) from the reduce.
// hl: the scratch of sgf_la_bwd_apply_scratch elements of the input type
// where that is not 0 (the tensor-core design: la_bwd_split_kernel, then
// la_bwd_apply_tc_kernel, in 3xTF32 for f32), else unused
// (la_bwd_apply_kernel); vec_a and vec_io as la_bwd_apply_tc_kernel takes
// them.
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
