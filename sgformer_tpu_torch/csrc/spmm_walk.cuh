// The CSR row walk of the whole warp (sm_90a): one warp per destination
// row, the sum over its edges of v[e, h] * x[src[e], h, :]. csr_spmm_kernel
// (spmm.cu) walks every head wider than 128 columns, or off the 16-byte
// path, with it; the slab_variant probe (microbench.cu) runs it in its
// three modes, so that the probe splits the walk csr_spmm runs and not a
// copy of it. Also the row pieces both walks and the rest of spmm.cu share:
// the 16-byte loads and stores of eight elements (Vec8) and a lane's
// columns of a pass (Cols).
//
// Design: one warp per destination row (in-degree is at most 33 on the
// arxiv graph, mean 14.8), a loop over the heads inside it. The row's edge
// ids and values are read 32 at a time, one per lane, and broadcast with
// shuffles. The sum is kept in f32 registers and rounded once on the store;
// the messages may be bf16 with an f32 result (GAT's bf16 messages). Each
// lane owns 8 columns and loads them with one 16-byte load (bf16) or two
// (f32), so a warp reads 256 columns of a source row in one coalesced pass,
// edge after edge; off the 16-byte path one column a lane, 32 columns a
// pass. What bounds the walk is the gathered rows (one row of a head per
// edge and head) at the card's gather rate, not the read-once bytes: the
// gather_rows probe measured 4.0 TB/s of random 512-byte rows over its own
// x on the H100, 5.25 TB/s with x in L2 and 2.81 TB/s from HBM. At F = 256
// on the arxiv graph the walk reads 1.28 GB of rows, in 0.3432 ms (3.7
// TB/s) in node order and in 0.2024 ms (6.3 TB/s, L2 serving most rows) in
// the walk order (Graph.schedule), which keeps one cluster's rows in the
// warps in flight. Each head's pass walks the row's edges again, its ids
// and values then in L1: a warp that read them once and kept both of GAT's
// 256-column heads in registers took 1.04 ms against this walk's 0.90 at
// GAT's first layer on the H100 (fewer warps in flight), so the walk per
// pass stays. It is held to 32 registers with bf16 rows (8 blocks of 8
// warps an SM, kWholeWarpBlocks), so that an SM holds its full 64 warps:
// the gather's latency bounds it; f32 rows would spill there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace rw {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// The whole warp's walk: the least blocks an SM holds (its launch bounds'
// minimum) with rows of TIn.
template <typename TIn>
constexpr int kWholeWarpBlocks = sizeof(TIn) == 2 ? 8 : 1;

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
// pointer must be 16-byte aligned (the wrappers check the rows' base and
// width). load is load_raw then unpack; split, a gather in flight holds
// its raw bytes (4 registers in bf16, 8 in f32).
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(load_raw(p), v);
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
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return {__ldg(q), __ldg(q + 1)};
  }
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&v)[8]) {
    v[0] = raw.a.x; v[1] = raw.a.y; v[2] = raw.a.z; v[3] = raw.a.w;
    v[4] = raw.b.x; v[5] = raw.b.y; v[6] = raw.b.z; v[7] = raw.b.w;
  }
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    unpack(load_raw(p), v);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// One lane's share of a pass over a head's columns: 8 columns with 16-byte
// accesses (D % 8 == 0, aligned rows, 256 columns a pass) or one column (any
// D, 32 columns a pass).
template <bool kVec8>
struct Cols {
  static constexpr int kPerLane = kVec8 ? 8 : 1;
  static constexpr int kPass = 32 * kPerLane;

  template <typename T>
  static __device__ __forceinline__ void load(const T* p, float (&v)[kPerLane]) {
    if constexpr (kVec8) {
      Vec8<T>::load(p, v);
    } else {
      v[0] = to_float(p[0]);
    }
  }
  template <typename T>
  static __device__ __forceinline__ void store(T* p, const float (&v)[kPerLane]) {
    if constexpr (kVec8) {
      Vec8<T>::store(p, v);
    } else {
      p[0] = from_float<T>(v[0]);
    }
  }
};

// The row an edge of the walk reads, and its weight. kGather: x[src[e]]
// times v[e, h], the sum itself (csr_spmm, the probe's prod). The probe's
// other two modes split its time: kStaticSub reads x[src[e] % kStaticRows]
// (kStaticRows, the TPU plan's block_rows: a gather of rows that stay
// cached; wrong results, timing only); kOwnRow reads the destination's own
// row, loaded once a pass and held in registers, times 1.0001 * v[e, h]:
// no gather, the walk alone, its edge ids still read.
enum class Source { kGather, kStaticSub, kOwnRow };
constexpr int kStaticRows = 128;

// The sum over edges [begin, end) of weight(e) * row(e) (Source) for every
// head, written to the F = H*D columns at dst (row: the destination's
// index, read by kOwnRow alone): one pass of Cols' width at a time within
// a head, each element an fmaf chain in edge order from 0. Every lane runs
// every loop trip, even past D, because the shuffles need the whole warp.
template <Source kSrc, typename TIn, typename TDst, bool kVec8>
__device__ __forceinline__ void spmm_edges(const int* __restrict__ src,
                                           const float* __restrict__ v,
                                           const TIn* __restrict__ x, TDst* __restrict__ dst,
                                           int begin, int end, int H, int D, int row = 0) {
  using C = Cols<kVec8>;
  const int lane = threadIdx.x & 31;
  const size_t F = static_cast<size_t>(H) * D;
  for (int h = 0; h < H; ++h) {
    for (int c0 = 0; c0 < D; c0 += C::kPass) {
      const int c = h * D + c0 + lane * C::kPerLane;
      const bool active = c0 + lane * C::kPerLane < D;
      float acc[C::kPerLane] = {};
      [[maybe_unused]] float own[C::kPerLane];
      if constexpr (kSrc == Source::kOwnRow) {
        if (active) C::load(x + static_cast<size_t>(row) * F + c, own);
      }
      for (int e0 = begin; e0 < end; e0 += 32) {
        const int e = e0 + lane;
        int s = 0;
        float we = 0.f;
        if (e < end) {
          s = __ldg(src + e);
          we = __ldg(v + static_cast<size_t>(e) * H + h);
        }
        const int cnt = min(32, end - e0);
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const int sj = __shfl_sync(kFull, s, j);
          const float wj = __shfl_sync(kFull, we, j);
          if (active) {
            if constexpr (kSrc == Source::kOwnRow) {
              // the id's test keeps its read: the walk is what this row times
              const float wm = __fmul_rn(1.0001f, sj < 0 ? 0.f : wj);
#pragma unroll
              for (int i = 0; i < C::kPerLane; ++i) acc[i] = fmaf(wm, own[i], acc[i]);
            } else {
              const int r = kSrc == Source::kStaticSub ? sj & (kStaticRows - 1) : sj;
              float xv[C::kPerLane];
              C::load(x + static_cast<size_t>(r) * F + c, xv);
#pragma unroll
              for (int i = 0; i < C::kPerLane; ++i) acc[i] = fmaf(wj, xv[i], acc[i]);
            }
          }
        }
      }
      if (active) C::store(dst + c, acc);
    }
  }
}

// Warp w's position of the whole warp's walk, p = w - n_seg (csr_spmm's
// first n_seg warps walk its hub segments): row schedule[p] in the walk
// order (kOrdered; without it the row is p, which the compiler recomputes
// instead of holding: one register fewer at the cap, which held node
// order's bf16 walk at its time), written in place. Nothing at or past
// n_rows, and a row of more than max_edges edges is left to its hub
// segments; the whole warp leaves together. Each row is summed edge for
// edge as in any order, so the result does not depend on the order.
template <Source kSrc, typename TIn, typename TOut, bool kVec8, bool kOrdered>
__device__ __forceinline__ void walk_position(int w, int n_seg, int n_rows,
                                              const int* __restrict__ indptr,
                                              const int* __restrict__ schedule,
                                              const int* __restrict__ src,
                                              const float* __restrict__ v,
                                              const TIn* __restrict__ x,
                                              TOut* __restrict__ out, int max_edges, int H,
                                              int D) {
  const size_t F = static_cast<size_t>(H) * D;
  if (w - n_seg >= n_rows) return;
  const int row = kOrdered ? __ldg(schedule + w - n_seg) : w - n_seg;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  if (end - start > max_edges) return;
  spmm_edges<kSrc, TIn, TOut, kVec8>(src, v, x, out + static_cast<size_t>(row) * F, start,
                                     end, H, D, row);
}

}  // namespace rw
