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
// bf16 tensor-core peak. The f32 kernels multiply on the CUDA cores in f32
// (64x64 tiles in shared memory, a 4x4 register tile per thread, 67 TFLOP/s
// peak), so their floor is ~0.33 ms per kernel: operations, not bytes, bound
// them. They are the exact-parity path.
//
// The bf16 reduce (la_reduce_tc_kernel) runs k^T v on the tensor cores
// (tensor_core.cuh: mma.sync m16n8k16, bf16 in, f32 sums). k and v are bf16,
// so every product is exact in f32 and only the order of the sums differs
// from the CUDA-core kernel; it stays fixed. A block owns a 128 x 128 tile of
// kvs over one slice of N; the blocks of a slice have neighbouring indices,
// so they run together and the second read of the slice's k or v rows (each
// feeds two tiles at M = D = 256) is served by the 50 MB L2, not by device
// memory. Node rows stream through a 4-stage cp.async ring of 32-row chunks
// (k, v and, in the blocks that sum it, q); ksum, ||k||^2 and ||q||^2 are
// summed per column in f64 on the CUDA cores from the chunks already in
// shared memory, between the MMAs. Partials go to scratch and are added in
// slice order by la_finish_kernel, as for the f32 kernel.
//
// The bf16 apply (la_apply_tc_kernel) runs a = q @ kvs on the tensor cores
// by warpgroup MMAs (wgmma m64n64k16, bf16 in, f32 sums, both operands read
// from 128-byte-swizzled shared memory through descriptors). kvs stays f32
// in meaning: kvs^T is split once a call into bf16 hi + lo (~16 significant
// bits, 2^-17 of each term; tc::split_t_kernel) and each product is two
// MMAs into one accumulator. A block owns 128 rows: it stages its q rows
// once, streams the kvs^T chunks of every 64-column output tile, double-
// buffered by cp.async, and finishes each tile warp by warp: v is read and
// out written through shared memory, 16 bytes a lane, coalesced. b = q .
// ksum is an f32 dot on the CUDA cores, run while the first MMAs do. The
// output is rounded to bf16 once, from f32; no atomics, so repeated calls
// are bitwise equal. At the arxiv shape the MMA work, 2 x 22.2 GFLOP, is
// ~0.045 ms at the bf16 peak, under the bytes bound; the design measured
// against it, an mma.sync version of the backward's row core, is in PERF.md.
//
// Inputs are row-strided views (ld* = elements between rows), so the heads of
// an [N, H, M] tensor are read in place; the last dimension is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 64;      // M and D tile
constexpr int kRows = 32;      // node rows per reduce step, M depth per apply step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kApplyRows = 128;     // rows of a tensor-core apply block: two warpgroups
constexpr int kApplyThreads = 256;
constexpr int kWgTile = 64 * 64 * 2;   // bytes of one swizzled [64][64] bf16 tile
constexpr int kWgKTile = 2 * kWgTile;  // one [128][64] k-tile of q rows, or the v tile

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

// The bf16 reduce on the tensor cores. grid (slices * tiles), tiles =
// ceil(M/128) * ceil(D/128), slice-major: block b sums tile b % tiles of
// k^T v over rows [s*rows_per_slice, (s+1)*rows_per_slice), s = b / tiles.
// The blocks of the first column tile (n0 == 0) also sum k and k*k per column
// of their M tile, those of the second (or the first, when D fits one tile)
// q*q, so that the f64 work and the extra q traffic fall on different blocks.
// Dynamic shared memory: kReduceStages chunks of k, v and q rows.
constexpr int kReduceStages = 4;
constexpr int kReduceStage = 3 * tc::kNodeChunk;  // bf16 of one stage: k, v, q

__global__ void __launch_bounds__(tc::kNodeThreads, 2)
la_reduce_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, long ldq, long ldk, long ldv, int N,
                    int M, int D, int rows_per_slice, int vec, float* __restrict__ kvs_part,
                    float* __restrict__ ksum_part, float* __restrict__ qsq_part,
                    float* __restrict__ ksq_part) {
  using tc::kNodeRows;
  using tc::kNodeStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ double red[3][tc::kNodeTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 64;
  const int tiles_m = tc::cdiv(M, tc::kNodeTile);
  const int tiles_d = tc::cdiv(D, tc::kNodeTile);
  const int tiles = tiles_m * tiles_d;
  const int s = blockIdx.x / tiles;
  const int dy = (blockIdx.x % tiles) / tiles_m;
  const int m0 = (blockIdx.x % tiles % tiles_m) * tc::kNodeTile;
  const int d0 = dy * tc::kNodeTile;
  const bool k_stats = dy == 0;
  const bool q_stats = dy == (tiles_d > 1 ? 1 : 0);
  const long r_begin = static_cast<long>(s) * rows_per_slice;
  const long r_stop = r_begin + rows_per_slice;
  const long r_end = r_stop < N ? r_stop : static_cast<long>(N);
  const int chunks = static_cast<int>((r_end - r_begin + kNodeRows - 1) / kNodeRows);

  auto stage = [&](int c) {
    __nv_bfloat16* ks = ring + (c % kReduceStages) * kReduceStage;
    const long r0 = r_begin + static_cast<long>(c) * kNodeRows;
    tc::stage_node_rows(ks, k, ldk, r0, r_end, m0, M, vec, tid);
    tc::stage_node_rows(ks + tc::kNodeChunk, v, ldv, r0, r_end, d0, D, vec, tid);
    if (q_stats) tc::stage_node_rows(ks + 2 * tc::kNodeChunk, q, ldq, r0, r_end, m0, M, vec, tid);
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // per column: thread t sums column t % 128 over the chunk rows of parity
  // t / 128, in f64 (a slice holds thousands of rows)
  const int col = tid & (tc::kNodeTile - 1);
  const int par = tid / tc::kNodeTile;
  double ksum = 0.0, ksq = 0.0, qsq = 0.0;

  for (int c = 0; c < kReduceStages - 1; ++c) {
    if (c < chunks) stage(c);
    tc::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<kReduceStages - 2>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + kReduceStages - 1 < chunks) stage(c + kReduceStages - 1);
    tc::cp_async_commit();
    const __nv_bfloat16* ks = ring + (c % kReduceStages) * kReduceStage;
    const __nv_bfloat16* const vs[1] = {ks + tc::kNodeChunk};
    tc::node_mma_chunk<1>(acc, ks, vs, wm, wn, lane);
    if (k_stats) {
#pragma unroll 4
      for (int r = par; r < kNodeRows; r += 2) {
        const double x = __bfloat162float(ks[r * kNodeStride + col]);
        ksum += x;
        ksq = fma(x, x, ksq);
      }
    }
    if (q_stats) {
      const __nv_bfloat16* qs = ks + 2 * tc::kNodeChunk;
#pragma unroll 4
      for (int r = par; r < kNodeRows; r += 2) {
        const double x = __bfloat162float(qs[r * kNodeStride + col]);
        qsq = fma(x, x, qsq);
      }
    }
  }
  tc::cp_async_wait<0>();

  tc::store_node_tile(kvs_part + static_cast<size_t>(s) * M * D, acc, m0, d0, M, D, wm, wn,
                      lane);
  if (k_stats || q_stats) {  // uniform over the block
    if (par == 1) {
      red[0][col] = ksum;
      red[1][col] = ksq;
      red[2][col] = qsq;
    }
    __syncthreads();
    if (par == 0 && m0 + col < M) {
      const size_t o = static_cast<size_t>(s) * M + m0 + col;
      if (k_stats) {
        ksum_part[o] = static_cast<float>(ksum + red[0][col]);
        ksq_part[o] = static_cast<float>(ksq + red[1][col]);
      }
      if (q_stats) qsq_part[o] = static_cast<float>(qsq + red[2][col]);
    }
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

// The bf16 apply on the tensor cores by warpgroup MMAs (wgmma). grid
// (ceil(N / 128)), 128 rows a block: two warpgroups of 64 rows, each warp
// owning 16 of them from the MMAs' fragments to the stores. Dynamic shared
// memory, 1024-byte aligned (no static shared memory, so the dynamic block
// starts the block's window): the q tile as Mk/64 swizzled [128][64]
// k-tiles, two stages of kvs^T chunks (hi and lo, swizzled [64 n][64 k]
// each), the v/out tile [128][64] (swizzled the same way, so the fragment
// accesses are free of bank conflicts) and den per row: 112.5 KB at M =
// 256, two blocks an SM.
//
// The block stages its q rows once, then runs the chunks of all column
// tiles as one stream, chunk ch + 1 in flight by cp.async while chunk ch's
// 8 wgmma (4 k16 steps, hi then lo into one accumulator) run; a barrier a
// chunk hands the B stages over. The rest is warp-local: each warp forms
// den for its 16 rows while the first chunk's MMAs run, loads its rows of
// each v tile a column tile ahead, and in the epilogue reads v at its
// fragment, writes out there in place as bf16 and stores its rows 16 bytes
// a lane, with no block barrier (the epilogue's traffic and waits, not the
// MMAs, set such a kernel's time). cp.async groups, in order:
// (q, chunk 0), v tile 0, then each chunk ch's iteration commits chunk ch +
// 1 and a v group (the next v tile after a column tile's epilogue, else
// empty), so that at a chunk's start every group but the last v group has
// landed.
__global__ void __launch_bounds__(kApplyThreads, 2)
la_apply_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v,
                   long ldq, long ldv, __nv_bfloat16* __restrict__ out, long ldo, int N, int M,
                   int D, const __nv_bfloat16* __restrict__ hl, const float* __restrict__ ksum,
                   const float* __restrict__ scal, const float* __restrict__ n_total, int guard,
                   int vec_a, int vec_io) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const int Mk = split_pad(M);  // q's k-tiles and kvs^T's k extent
  const int kchunks = Mk / 64;
  const int chunks = kchunks * (split_pad(D) / 64);
  unsigned char* As = smem_raw;                         // [Mk/64][128][64]
  unsigned char* Bs = As + kchunks * kWgKTile;          // [stage][hi, lo][64][64]
  unsigned char* Vs = Bs + 4 * kWgTile;                 // [128][64]
  float* den_s = reinterpret_cast<float*>(Vs + kWgKTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows 16 * warp .. + 16; warpgroup warp / 4
  const long r0 = static_cast<long>(blockIdx.x) * kApplyRows;
  const float inv = scal[2];
  const float n = *n_total;
  const size_t piece = split_t_elems(M, D);

  // q rows, zero past N and from M up to Mk
  if (vec_a) {
    const int segs = Mk / 8;
    for (int i = tid; i < kApplyRows * segs; i += kApplyThreads) {
      const int r = i / segs;
      const int c = (i % segs) * 8;
      const bool ok = r0 + r < N && c < M;
      cp_async16(As + (c >> 6) * kWgKTile + sw128_offset(r, c & 63),
                 ok ? q + (r0 + r) * ldq + c : q, ok);
    }
  } else {
    for (int i = tid; i < kApplyRows * Mk; i += kApplyThreads) {
      const int r = i / Mk;
      const int c = i % Mk;
      *reinterpret_cast<__nv_bfloat16*>(As + (c >> 6) * kWgKTile + sw128_offset(r, c & 63)) =
          (r0 + r < N && c < M) ? q[(r0 + r) * ldq + c] : __float2bfloat16_rn(0.f);
    }
  }
  // chunk ch of kvs^T, hi and lo, [64 n][64 k] each
  auto load_b = [&](int ch) {
    const int c0 = ch / kchunks * 64;
    const int k0 = ch % kchunks * 64;
    unsigned char* dst = Bs + (ch & 1) * 2 * kWgTile;
#pragma unroll
    for (int it = 0; it < 2 * 64 * 8 / kApplyThreads; ++it) {
      const int i = tid + it * kApplyThreads;
      const int p = i >> 9;
      const int nr = (i >> 3) & 63;
      const int c = (i & 7) * 8;
      cp_async16(dst + p * kWgTile + sw128_offset(nr, c),
                 hl + p * piece + static_cast<size_t>(c0 + nr) * Mk + k0 + c);
    }
  };
  // the warp's 16 rows of v at columns [c0, c0 + 64), zero past N and D
  auto load_v = [&](int c0) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = warp * 16 + it * 4 + (lane >> 3);
      const int c = (lane & 7) * 8;
      const long row = r0 + r;
      unsigned char* dst = Vs + sw128_offset(r, c);
      if (vec_io && c0 + c + 8 <= D) {
        const bool ok = row < N;
        cp_async16(dst, ok ? v + row * ldv + c0 + c : v, ok);
      } else {
        __nv_bfloat16* d8 = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d8[e] = (row < N && c0 + c + e < D) ? v[row * ldv + c0 + c + e]
                                              : __float2bfloat16_rn(0.f);
        }
      }
    }
  };

  load_b(0);
  cp_async_commit();
  load_v(0);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();  // q and chunk 0 have landed

  // den = inv * (q . ksum) + n for the warp's rows, 8 columns a lane (16-byte
  // reads), four rows at once, f32 sums added by a fixed xor tree
  auto warp_den = [&]() {
    for (int i0 = 0; i0 < 16; i0 += 4) {
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = lane * 8; c < Mk; c += 256) {
        float ks[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) ks[e] = c + e < M ? __ldg(ksum + c + e) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              As + (c >> 6) * kWgKTile + sw128_offset(warp * 16 + i0 + j, c & 63));
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(h[e]);
            b[j] = fmaf(x.x, ks[2 * e], b[j]);
            b[j] = fmaf(x.y, ks[2 * e + 1], b[j]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] += __shfl_xor_sync(0xffffffffu, b[j], off);
      if (lane < 4) {  // lane j writes row i0 + j
        const float bj = lane == 0 ? b[0] : lane == 1 ? b[1] : lane == 2 ? b[2] : b[3];
        const float den = inv * bj + n;
        den_s[warp * 16 + i0 + lane] = guard && den == 0.f ? 1.f : den;
      }
    }
  };

  float acc[32];
  float den_r[2];  // den of the lane's two fragment rows
  for (int ch = 0; ch < chunks; ++ch) {
    const int kc = ch % kchunks;
    const int c0 = ch / kchunks * 64;
    if (ch > 0) {
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();  // chunk ch has landed; every warp is done with chunk ch - 1
    }
    if (ch + 1 < chunks) load_b(ch + 1);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    wgmma_fence_operand(acc);
    wgmma_fence();
    const unsigned char* a_tile = As + kc * kWgKTile + (warp >> 2) * kWgTile;
    const unsigned char* b_tile = Bs + (ch & 1) * 2 * kWgTile;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = sw128_desc(a_tile + ks * 32);
      wgmma_m64n64k16(acc, da, sw128_desc(b_tile + ks * 32));
      wgmma_m64n64k16(acc, da, sw128_desc(b_tile + kWgTile + ks * 32));
    }
    wgmma_commit();
    if (ch == 0) {  // while the first MMAs run
      warp_den();
      __syncwarp();
      den_r[0] = den_s[warp * 16 + (lane >> 2)];
      den_r[1] = den_s[warp * 16 + (lane >> 2) + 8];
    }
    wgmma_wait_all();
    wgmma_fence_operand(acc);
    if (kc == kchunks - 1) {  // the column tile's epilogue, warp by warp
      cp_async_wait<1>();  // every group but chunk ch + 1: the v tile has landed
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162* p =
              reinterpret_cast<__nv_bfloat162*>(Vs + sw128_offset(r, 8 * j + 2 * (lane & 3)));
          const float2 x = __bfloat1622float2(*p);
          *p = __floats2bfloat162_rn((inv * acc[4 * j + 2 * h] + n * x.x) / den_r[h],
                                     (inv * acc[4 * j + 2 * h + 1] + n * x.y) / den_r[h]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int r = warp * 16 + it * 4 + (lane >> 3);
        const int c = (lane & 7) * 8;
        const long row = r0 + r;
        if (row >= N || c0 + c >= D) continue;
        const unsigned char* src = Vs + sw128_offset(r, c);
        if (vec_io && c0 + c + 8 <= D) {
          *reinterpret_cast<uint4*>(out + row * ldo + c0 + c) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          const __nv_bfloat16* s8 = reinterpret_cast<const __nv_bfloat16*>(src);
          for (int e = 0; e < 8 && c0 + c + e < D; ++e) out[row * ldo + c0 + c + e] = s8[e];
        }
      }
      __syncwarp();
      if (c0 + 64 < D) load_v(c0 + 64);
    }
    cp_async_commit();  // the v group of this iteration, empty but after an epilogue
  }
  cp_async_wait<0>();
}

size_t apply_tc_smem_bytes(int M, int D) {
  return tc::split_pad(M) / 64 * kWgKTile + 6 * kWgTile + kApplyRows * 4;
}

// bf16 elements of the tensor-core apply's scratch (kvs^T as hi + lo), or 0
// where the apply runs on the CUDA cores: f32 inputs, or an M whose q tile
// does not fit one block's shared memory beside the B stages.
int apply_scratch(int dtype, int M, int D) {
  if (dtype != 1 || apply_tc_smem_bytes(M, D) > tc::kSmemPerBlock) return 0;
  return static_cast<int>(2 * tc::split_t_elems(M, D));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
    using bf16 = __nv_bfloat16;
    // 16-byte copies where widths, strides and bases allow
    const bool vec = M % 8 == 0 && D % 8 == 0 && ldq % 8 == 0 && ldk % 8 == 0 &&
                     ldv % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    const int smem = kReduceStages * kReduceStage * static_cast<int>(sizeof(bf16));
    cudaError_t err = cudaFuncSetAttribute(la_reduce_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = tc::cdiv(M, tc::kNodeTile) * tc::cdiv(D, tc::kNodeTile);
    la_reduce_tc_kernel<<<slices * tiles, tc::kNodeThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        ldq, ldk, ldv, N, M, D, rows_per_slice, static_cast<int>(vec), kvs_part, ksum_part,
        qsq_part, ksq_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
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

// The bf16 scratch (elements) of the tensor-core apply for these widths,
// or 0 where the apply runs on the CUDA cores (f32 inputs, or M above 704).
extern "C" int sgf_la_apply_scratch(int dtype, int M, int D) {
  return apply_scratch(dtype, M, D);
}

// out may be a row-strided view (ldo); n_total is a device float scalar.
// hl: the bf16 scratch of sgf_la_apply_scratch elements where that is not 0
// (the tensor-core design: tc::split_t_kernel<2>, then la_apply_tc_kernel),
// else unused (la_apply_kernel).
extern "C" int sgf_la_apply(const void* q, const void* v, long ldq, long ldv, void* out,
                            long ldo, int N, int M, int D, int dtype, const float* kvs,
                            const float* ksum, const float* scal, const float* n_total,
                            int guard, void* hl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (apply_scratch(dtype, M, D) > 0) {
    using bf16 = __nv_bfloat16;
    bf16* h = static_cast<bf16*>(hl);
    cudaError_t err = tc::launch_split_t<2>(kvs, M, D, h, st);
    if (err != cudaSuccess || N == 0) return static_cast<int>(err);
    const int vec_a = M % 8 == 0 && ldq % 8 == 0 && aligned16(q);
    const int vec_io = ldv % 8 == 0 && ldo % 8 == 0 && aligned16(v) && aligned16(out);
    const size_t smem = apply_tc_smem_bytes(M, D);
    err = cudaFuncSetAttribute(la_apply_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    la_apply_tc_kernel<<<(N + kApplyRows - 1) / kApplyRows, kApplyThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(v), ldq, ldv,
        static_cast<bf16*>(out), ldo, N, M, D, h, ksum, scal, n_total, guard, vec_a, vec_io);
    return static_cast<int>(cudaGetLastError());
  }
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
