// SGFormer linear attention for Hopper (sm_90a), forward, one head per call:
//
//   reduce:  kvs = k^T v [M, D], ksum = sum_n k [M], qsq = ||q||^2, ksq = ||k||^2
//   apply:   out = (inv * q @ kvs + n * v) / (inv * q . ksum + n),
//            inv = 1 / (sqrt(qsq) * sqrt(ksq))
//
// Replaces sgformer_tpu/kernels/attention.py::_reduce_kernel and
// ::_apply_kernel. The TPU kernels carry the sums from one grid step to the
// next in VMEM; blocks on Hopper run in parallel and in no order, so the
// reduce here is two passes: blocks over disjoint node ranges write f32
// partials to scratch, and a second small kernel adds them in a fixed order.
// There are no atomics, so repeated calls give bitwise-equal results. Tail
// rows are masked inside the kernels; nothing is padded on the host.
//
// Differences from the Pallas kernels, both on purpose:
// - apply keeps kvs in f32, as the plain path does (ops/attention.py:100);
//   the Pallas apply rounds kvs to q's type before its matmul
//   (kernels/attention.py:83).
// - inv follows the guarded plain path (ops/attention.py:89-97): with a node
//   mask, a zero norm gives inv = 0 and a zero denominator becomes 1. The
//   Pallas apply takes rsqrt of the norms without a guard
//   (kernels/attention.py:79), which is inf for an all-masked group.
//
// Bound: memory. At the arxiv shape (N = 169,343, M = D = 256, bf16) reduce
// must read q, k, v once (260 MB, 78 us at 3.35 TB/s) and apply must read
// q, v and write out (260 MB); each does 2*N*M*D = 22.2 GFLOP, 22 us at the
// bf16 tensor-core peak. This first version multiplies on the CUDA cores in
// f32 (64x64 tiles in shared memory, a 4x4 register tile per thread, 67
// TFLOP/s peak), so its floor is ~0.33 ms per kernel: operations, not bytes,
// bound it until the products move to wgmma.
//
// Inputs are row-strided views (ld* = elements between rows), so the heads of
// an [N, H, M] tensor are read in place; the last dimension is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;      // M and D tile
constexpr int kRows = 32;      // node rows per reduce step, M depth per apply step
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

// grid (ceil(M/64), ceil(D/64), slices). Block (mx, dy, s) sums its 64x64
// tile of k^T v over rows [s*rows_per_slice, (s+1)*rows_per_slice). Blocks
// with dy == 0 also sum k, k*k and q*q per column of their M tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
la_reduce_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 long ldq, long ldk, long ldv, int N, int M, int D, int rows_per_slice,
                 float* __restrict__ kvs_part, float* __restrict__ ksum_part,
                 float* __restrict__ qsq_part, float* __restrict__ ksq_part) {
  __shared__ __align__(16) float ks[kRows][kTile];
  __shared__ __align__(16) float vs[kRows][kTile];
  __shared__ float qs[kRows][kTile];
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
  // the per-column sums run over a whole slice (thousands of rows): keep
  // them in f64 so the norms are exact to f32 rounding
  double ksum = 0.0, ksq = 0.0, qsq = 0.0;

  for (long r0 = r_begin; r0 < r_end; r0 += kRows) {
    for (int i = tid; i < kRows * kTile; i += kThreads) {
      const int r = i / kTile;
      const int c = i % kTile;
      const long row = r0 + r;
      const bool row_ok = row < r_end;
      const bool m_ok = row_ok && m0 + c < M;
      ks[r][c] = m_ok ? to_float(k[row * ldk + m0 + c]) : 0.f;
      vs[r][c] = (row_ok && d0 + c < D) ? to_float(v[row * ldv + d0 + c]) : 0.f;
      if (stats) qs[r][c] = m_ok ? to_float(q[row * ldq + m0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&ks[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&vs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (stats && tid < kTile) {
      for (int r = 0; r < kRows; ++r) {
        const double kv = ks[r][tid];
        const double qv = qs[r][tid];
        ksum += kv;
        ksq = fma(kv, kv, ksq);
        qsq = fma(qv, qv, qsq);
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
      if (m < M && d < D) kvs_part[s * MD + static_cast<size_t>(m) * D + d] = acc[i][j];
    }
  }
  if (stats && tid < kTile && m0 + tid < M) {
    const size_t o = static_cast<size_t>(s) * M + m0 + tid;
    ksum_part[o] = static_cast<float>(ksum);
    ksq_part[o] = static_cast<float>(ksq);
    qsq_part[o] = static_cast<float>(qsq);
  }
}

// Second pass: kvs and ksum are the partials added in slice order.
__global__ void la_finish_kernel(const float* __restrict__ kvs_part,
                                 const float* __restrict__ ksum_part, int slices, int M,
                                 int D, float* __restrict__ kvs, float* __restrict__ ksum) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t MD = static_cast<size_t>(M) * D;
  if (idx < MD) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += kvs_part[s * MD + idx];
    kvs[idx] = t;
  }
  if (idx < static_cast<size_t>(M)) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += ksum_part[static_cast<size_t>(s) * M + idx];
    ksum[idx] = t;
  }
}

// Second pass for the norms, one block, fixed-order f64 tree. scal = [qsq, ksq, inv, 0].
__global__ void __launch_bounds__(kThreads)
la_scalars_kernel(const float* __restrict__ qsq_part, const float* __restrict__ ksq_part,
                  int count, int guard, float* __restrict__ scal) {
  __shared__ double sq[kThreads];
  __shared__ double sk[kThreads];
  const int tid = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = tid; i < count; i += kThreads) {
    a += qsq_part[i];
    b += ksq_part[i];
  }
  sq[tid] = a;
  sk[tid] = b;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      sq[tid] += sq[tid + stride];
      sk[tid] += sk[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float qsq = static_cast<float>(sq[0]);
    const float ksq = static_cast<float>(sk[0]);
    float inv;
    if (guard) {
      inv = (qsq > 0.f && ksq > 0.f) ? 1.f / (sqrtf(qsq) * sqrtf(ksq)) : 0.f;
    } else {
      inv = 1.f / (sqrtf(qsq) * sqrtf(ksq));
    }
    scal[0] = qsq;
    scal[1] = ksq;
    scal[2] = inv;
    scal[3] = 0.f;
  }
}

// grid (ceil(N/64), ceil(D/64)). Block (bx, dy) computes rows
// [64*bx, 64*bx+64) x columns [64*dy, 64*dy+64) of out, stepping over M in
// 32-deep slabs of q (stored transposed) and kvs. The first 64 threads also
// form each row's q . ksum for the denominator.
template <typename T>
__global__ void __launch_bounds__(kThreads)
la_apply_kernel(const T* __restrict__ q, const T* __restrict__ v, long ldq, long ldv,
                T* __restrict__ out, long ldo, int N, int M, int D,
                const float* __restrict__ kvs, const float* __restrict__ ksum,
                const float* __restrict__ scal, const float* __restrict__ n_total, int guard) {
  __shared__ __align__(16) float qt[kRows][kTile + 4];  // [m][row]
  __shared__ __align__(16) float kv[kRows][kTile];      // [m][col]
  __shared__ float den_s[kTile];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long r0 = static_cast<long>(blockIdx.x) * kTile;
  const int d0 = blockIdx.y * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float b = 0.f;

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
    if (tid < kTile) {
      for (int c = 0; c < kRows && k0 + c < M; ++c) b = fmaf(qt[c][tid], ksum[k0 + c], b);
    }
    __syncthreads();
  }
  if (tid < kTile) den_s[tid] = b;
  __syncthreads();

  const float inv = scal[2];
  const float n = *n_total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = r0 + ty * 4 + i;
    if (row >= N) continue;
    float den = inv * den_s[ty * 4 + i] + n;
    if (guard && den == 0.f) den = 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < D) {
        const float num = inv * acc[i][j] + n * to_float(v[row * ldv + d]);
        out[row * ldo + d] = from_float<T>(num / den);
      }
    }
  }
}

template <typename T>
void launch_reduce(const void* q, const void* k, const void* v, long ldq, long ldk, long ldv,
                   int N, int M, int D, int slices, int rows_per_slice, float* kvs_part,
                   float* ksum_part, float* qsq_part, float* ksq_part, cudaStream_t st) {
  const dim3 grid((M + kTile - 1) / kTile, (D + kTile - 1) / kTile, slices);
  la_reduce_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ldq, ldk,
      ldv, N, M, D, rows_per_slice, kvs_part, ksum_part, qsq_part, ksq_part);
}

template <typename T>
void launch_apply(const void* q, const void* v, long ldq, long ldv, void* out, long ldo, int N,
                  int M, int D, const float* kvs, const float* ksum, const float* scal,
                  const float* n_total, int guard, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  la_apply_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(v), ldq, ldv, static_cast<T*>(out), ldo,
      N, M, D, kvs, ksum, scal, n_total, guard);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Scratch: kvs_part [slices, M, D],
// ksum_part, qsq_part, ksq_part [slices, M]. Outputs: kvs [M, D], ksum [M],
// scal [4] = (qsq, ksq, inv, 0). Returns the cudaError_t of the launches.
extern "C" int sgf_la_reduce(const void* q, const void* k, const void* v, long ldq, long ldk,
                             long ldv, int N, int M, int D, int dtype, int slices,
                             int rows_per_slice, int guard, float* kvs_part, float* ksum_part,
                             float* qsq_part, float* ksq_part, float* kvs, float* ksum,
                             float* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_reduce<float>(q, k, v, ldq, ldk, ldv, N, M, D, slices, rows_per_slice, kvs_part,
                         ksum_part, qsq_part, ksq_part, st);
  } else if (dtype == 1) {
    launch_reduce<__nv_bfloat16>(q, k, v, ldq, ldk, ldv, N, M, D, slices, rows_per_slice,
                                 kvs_part, ksum_part, qsq_part, ksq_part, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t MD = static_cast<size_t>(M) * D;
  const unsigned fin_blocks = static_cast<unsigned>((MD + kThreads - 1) / kThreads);
  la_finish_kernel<<<fin_blocks, kThreads, 0, st>>>(kvs_part, ksum_part, slices, M, D, kvs,
                                                    ksum);
  la_scalars_kernel<<<1, kThreads, 0, st>>>(qsq_part, ksq_part, slices * M, guard, scal);
  return static_cast<int>(cudaGetLastError());
}

// out may be a row-strided view (ldo); n_total is a device float scalar.
extern "C" int sgf_la_apply(const void* q, const void* v, long ldq, long ldv, void* out,
                            long ldo, int N, int M, int D, int dtype, const float* kvs,
                            const float* ksum, const float* scal, const float* n_total,
                            int guard, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_apply<float>(q, v, ldq, ldv, out, ldo, N, M, D, kvs, ksum, scal, n_total, guard, st);
  } else if (dtype == 1) {
    launch_apply<__nv_bfloat16>(q, v, ldq, ldv, out, ldo, N, M, D, kvs, ksum, scal, n_total,
                                guard, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
