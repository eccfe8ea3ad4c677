// CSR SpMM for Hopper (sm_90a): the GCN aggregation A_norm @ X.
//
//   out[i, :] = sum_{e in [indptr[i], indptr[i+1])} w[e] * x[src[e], :]
//
// Replaces two TPU kernels of sgformer_tpu, which split this one sum only to
// fit the TPU's VMEM: kernels/slab_spmm.py::_ssel_kernel (edges inside a
// slab, prebuilt selector matmuls) and kernels/spmm.py::_spmm_kernel (the
// window-chunked sum of the cross-slab messages), plus the w_self * x
// self-loop term of kernels/slab_spmm.py. Here the edges are the dst-sorted
// CSR that preprocess_graph builds, so one kernel computes the whole sum in
// the caller's node order: no reorder, no plan.
//
// Bound: memory. At the arxiv shape (N = 169,343, E = 2,499,039, F = 256,
// bf16) the least traffic per call is x read once (86.7 MB), out written
// once (86.7 MB) and src + w (20 MB), about 194 MB or 58 us at 3.35 TB/s.
// The work is 2*E*F = 1.3 GFLOP, nothing for the card. What this simple
// kernel really pays is the per-edge gather of a source row: E rows of
// 512 bytes, about 1.28 GB if L2 kept nothing.
//
// Design: one warp per destination row (in-degree is at most 33 here, mean
// 14.8). Each lane owns 8 columns and loads them with one 16-byte load (bf16)
// or two (f32), so a warp reads a whole 256-wide row in one coalesced pass.
// The row's edge ids and weights are read 32 at a time, one per lane, and
// broadcast with shuffles. The sum is kept in f32 registers and rounded once
// to x's type on the store. Each row is summed in edge order by one warp, so
// the result is deterministic (no atomics).
//
// There is no backward here. Training reuses this kernel on A^T, which is A
// for the symmetrised graphs that preprocess_graph builds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

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

// Eight consecutive elements of a row, moved with 16-byte accesses. The
// pointer must be 16-byte aligned (the wrapper checks x and out).
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// F % 8 == 0 and 16-byte aligned rows: each lane owns 8 columns per pass of
// 256 columns (one pass at F <= 256). Every lane runs every loop trip, even
// past F, because the shuffles need the whole warp.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_vec8(const int* __restrict__ indptr, const int* __restrict__ src,
              const float* __restrict__ w, const T* __restrict__ x,
              T* __restrict__ out, int n_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = 0; c0 < F; c0 += 256) {
    const int c = c0 + lane * 8;
    const bool active = c < F;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e0 = start; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0;
      float we = 0.f;
      if (e < end) {
        s = __ldg(src + e);
        we = __ldg(w + e);
      }
      const int cnt = min(32, end - e0);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int sj = __shfl_sync(kFull, s, j);
        const float wj = __shfl_sync(kFull, we, j);
        if (active) {
          float v[8];
          Vec8<T>::load(x + static_cast<size_t>(sj) * F + c, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
        }
      }
    }
    if (active) Vec8<T>::store(out + static_cast<size_t>(row) * F + c, acc);
  }
}

// Any F and alignment: each lane owns one column per pass of 32 columns.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_scalar(const int* __restrict__ indptr, const int* __restrict__ src,
                const float* __restrict__ w, const T* __restrict__ x,
                T* __restrict__ out, int n_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = 0; c0 < F; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < F;
    float acc = 0.f;
    for (int e0 = start; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0;
      float we = 0.f;
      if (e < end) {
        s = __ldg(src + e);
        we = __ldg(w + e);
      }
      const int cnt = min(32, end - e0);
      for (int j = 0; j < cnt; ++j) {
        const int sj = __shfl_sync(kFull, s, j);
        const float wj = __shfl_sync(kFull, we, j);
        if (active) acc = fmaf(wj, to_float(x[static_cast<size_t>(sj) * F + c]), acc);
      }
    }
    if (active) out[static_cast<size_t>(row) * F + c] = from_float<T>(acc);
  }
}

template <typename T>
void launch(const int* indptr, const int* src, const float* w, const void* x, void* out,
            int n_rows, int F, int vec8, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec8) {
    csr_spmm_vec8<T><<<grid, block, 0, stream>>>(indptr, src, w, xt, ot, n_rows, F);
  } else {
    csr_spmm_scalar<T><<<grid, block, 0, stream>>>(indptr, src, w, xt, ot, n_rows, F);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec8: 1 when F % 8 == 0 and x, out are
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int sgf_csr_spmm(const void* indptr, const void* src, const void* w,
                            const void* x, void* out, int n_rows, int F, int dtype,
                            int vec8, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(ip, sp, wp, x, out, n_rows, F, vec8, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(ip, sp, wp, x, out, n_rows, F, vec8, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
