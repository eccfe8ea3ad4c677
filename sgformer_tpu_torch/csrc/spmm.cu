// CSR SpMM and its gradients for Hopper (sm_90a): the GCN aggregation
// A_norm @ X and GAT's per-head aggregation with runtime edge values.
//
//   csr_spmm:        out[i, h, :] = sum_{e in [indptr[i], indptr[i+1])} v[e, h] * x[src[e], h, :]
//   csr_spmm_ev_bwd: dx[s, h, :]  = sum_{e out of s} v[e, h] * msg(g[dst[e], h, :])
//                    dv[e, h]     = sum_d g[dst[e], h, d] * x[src[e], h, d]
//   sddmm:           dv alone, on the dst-sorted CSR
//
// x, out and g are [N, H*D] rows (the [N, H, D] view of a per-head tensor);
// v and dv are [E, H] f32 in dst-sorted edge order. With H = 1 and v the
// fixed GCN weights, csr_spmm is the GCN aggregation.
//
// csr_spmm replaces three TPU kernels of sgformer_tpu, which split this one
// sum only to fit the TPU's VMEM: kernels/slab_spmm.py::_ssel_kernel (edges
// inside a slab, prebuilt selector matmuls), kernels/slab_spmm.py::
// _slab_kernel (the same with selectors built in-kernel from a packed
// stream, the fallback on power-law graphs), and kernels/spmm.py::
// _spmm_kernel (the window-chunked sum of cross-slab messages with fixed
// weights, and with runtime per-edge values in chunked_spmm_edge_values,
// one call per head), plus the w_self * x self-loop term of
// kernels/slab_spmm.py. Here the edges are the dst-sorted CSR that
// preprocess_graph builds, so one kernel computes the whole sum in the
// caller's node order, all heads in one launch: no reorder, and no plan but
// the hub segments below (with a second, small pass for them). The
// gradient of the fixed-weight sum in x is this kernel on the transposed
// order (the caller passes the transposed CSR and its weights).
//
// csr_spmm_ev_bwd is the whole gradient of the per-edge-value form,
// kernels/spmm.py::_spmm_ev_bwd: its dx, which the JAX package runs through
// _spmm_kernel on the backward (transposed) plan, and its dv, a gather-dot
// that it leaves to XLA outside any Pallas kernel (two [E, H*D] f32
// gathers materialised). sddmm is that dv alone, on the dst-sorted CSR.
//
// Bound: memory. At the arxiv shape (N = 169,343, E = 2,499,039) with F =
// H*D = 256 bf16 the least traffic per csr_spmm call is x read once (86.7
// MB), out written once (86.7 MB) and src + v (20 MB), about 194 MB or 58 us
// at 3.35 TB/s; the work, 2*E*F = 1.3 GFLOP, is nothing for the card. What
// these simple kernels really pay is the per-edge gather of a source row: E
// rows of F elements, which L2 serves only in part.
//
// Design: one warp per destination row. A head wider than 128 columns, or
// off the 16-byte path (D % 8 != 0, unaligned rows), takes the whole warp,
// edge after edge (spmm_walk.cuh: its design and rates).
//
// A narrower head left most of that warp idle: at D = 40 (GAT's output
// layer) 5 of 32 lanes worked while the warp walked the row's edges one
// after another, 400 MB of f32 rows at 1.6 TB/s (0.2456 ms on the arxiv
// graph on the H100, slower than PyTorch's sparse product at 0.2252). So a
// head of at most 128 columns on the 16-byte path is taken by groups of the
// fewest lanes (4, 8 or 16) whose 8 columns cover it (lane_groups, shared
// with the backward walk): group q takes slot i = edge i * kGroups + q of
// each 32-edge batch, each lane stages the raw bytes of 4 gathers before it
// uses any, each column is an fmaf chain in edge order within its group,
// and the groups' chains are added in group order at the end of the range
// (add_groups) and rounded once on the store. At D = 40 on the arxiv graph
// one warp a row took ~0.17 ms in f32 (2.3 TB/s of rows): what bounded it
// was each row's chain of dependent loads (its row pointers, its edge ids,
// then its gathers) over the warps an SM holds. So the lane groups' walk
// takes persistent walkers that read the row pointers of 32 rows at once
// and prefetch each next row's edge ids and values into L1
// (csr_spmm_kernel): 0.127 ms there, and 0.167 on the power-law graph,
// where the hub segments are walked by the same walkers. The backward
// walk's dx is the same sum in the same order, so it is this walk on the
// transposed CSR bit for bit at every width. Without the 16-byte path (D %
// 8 != 0, unaligned rows) one column a lane over the whole warp, 32
// columns a pass.
//
// The walk order. The rows are walked in the graph's walk order
// (Graph.schedule: the clustering reorder's permutation of the rows, built
// once per graph) and each is written in place, so that the warps in
// flight walk one cluster's rows and gather from rows that L2 holds: the
// JAX package kept a slab of x in VMEM for a cluster's window of rows
// (kernels/slab_spmm.py), the H100's 50 MB L2 keeps it here. The result is
// the same bit for bit in any order. The per-edge-value backward walk
// takes its transposed CSR's order too.
//
// Hub rows. One warp walks its row's edges one after another, about 0.37 us
// an edge from device memory, so on a power-law graph (the JAX package's
// bench graph: in-degree up to 7,391, 487 rows above 256 holding 21 % of the
// edges) one warp on the largest row set the whole kernel's time while the
// other SMs sat idle. The JAX package met the same skew with a hub tail kept
// in VMEM (kernels/slabs.py); here the work is balanced instead. A row of
// more than max_edges in-edges is cut, once per graph on the host, into
// segments of at most max_edges consecutive edges (the plan: (row, begin,
// end) per segment, in row order); the first pass gives each segment a warp
// of its own, placed first in the grid so that the long walks start at
// once, and it writes the segment's f32 partial row into scratch; the
// second pass (csr_spmm_hub_kernel) adds each hub row's partials in segment
// order and rounds once. Rows of at most max_edges edges take the one-warp
// path unchanged (the lane groups' walkers take the segments as items of
// their walk, interleaved, so that the long ones start at once). No atomics
// touch values, so the result is the same on every call.
//
// The per-edge-value backward walk. Both halves of the gradient read the
// same edges: on the transposed CSR, row s is a source node and each edge
// e' goes to a destination d, so one gather of g[d] gives dx[s] += v *
// msg(g[d]) and dv[t_perm[e']] = g[d] . x[s] with x[s] held by the warp.
// The parent design ran dx as csr_spmm on the transposed CSR (after a plain
// cast of g to the message type and a plain index_select of v) and dv as a
// second walk of the dst-sorted CSR gathering x, so it gathered twice. One
// templated walk now does both (csr_spmm_ev_bwd: a = x held, b = g
// gathered, p = t_perm) or dv alone (sddmm: a = g held, b = x gathered, p =
// the edge itself). Bounds, at GAT's first layer on the arxiv graph (H = 2,
// D = 256, f32 x and g, bf16 messages): read once, x and g (347 MB each),
// dx written (347 MB), v read and dv written (20 MB each) and the edge ids
// (21 MB), 1.10 GB or 0.33 ms at 3.35 TB/s; gathered, one 1 KB row of g per edge
// and head, 5.1 GB, which at the gather_rows probe's random-row rates on
// the H100 (5.25 TB/s with x in L2, 2.81 TB/s from HBM) takes 0.97-1.8 ms:
// that rate, not the read-once bytes, is what it pays.
// The design spends nothing else around the gathers: each lane issues
// kInFlight gathers before it uses any, keeps a partial dot per edge of a
// 32-edge batch and folds them once per batch (transpose_fold: 31
// shuffle-adds for 32 dots, where a butterfly per edge took 160); a head
// narrower than a warp's pass is taken by groups of 4-16 lanes, each on its
// own edges (at D = 40 f32, 5 of 32 lanes would otherwise work); hub rows
// are split by the CSR's own plan as in csr_spmm (each segment's dv is
// final, its dx partial goes through csr_spmm_hub_kernel); a destination
// hub only makes g[hub] a row that many warps gather, which L2 serves. No
// atomics: dv and dx are the same on every call. dv is the same bit for
// bit in both modes (products commute; one column order, one fold); dx is
// the forward walk's (the same lane groups, edge slots, chains and group
// order), so it is csr_spmm_ev of msg(g) on the transposed CSR bit for bit
// at every width.
//
// csr_spmm_q8 is the int8 branch of kernels/slab_spmm.py::_ssel_kernel
// (int8 x int8 -> int32 dots of 0/1 selectors with absmax-quantised rows),
// with the epilogue of _apply_side fused in:
//
//   out[i, :] = ((acc[i, :] * (s / 127)) * rs[i]) + w_self[i] * xb[i, :]
//   acc[i, :] = sum_{e in row i, src[e] != i} q[src[e], :]       (exact int32)
//   w_self[i] = sum_{e in row i, src[e] == i} v[e]
//
// q is x * rs quantised to int8 (quantize_absmax below), xb the bf16 x, s
// the absmax, read from device memory so the host never waits for it. The
// GCN weights factor as rs[src] * rs[dst]: q carries rs[src] and the
// epilogue rs[dst], so no per-edge value is read except at the self edge,
// which is pulled out unquantised as the JAX plan does. Bound: memory, with
// a quarter of bf16's gathered bytes (one int8 row of F bytes per edge).
// What it pays is the gather: E random rows, from L2 at the arxiv shape
// (its 43 MB table nearly fits) and partly from device memory at
// large-400K (102 MB).
//
// Design: csr_spmm's row walk, one warp per row in the graph's walk order
// (Graph.schedule, as csr_spmm walks), edge ids read 32 at a time and
// shuffled; each lane loads 8 int8 (8 bytes, 256 columns a warp pass; one
// byte for F % 8 != 0 or unaligned rows) and keeps int32 sums. The order
// took the walk at large-400K (a 102 MB table, twice L2) from 10.4 to 15.0
// G rows/s on the H100; a half-warp an edge with 16-byte gathers, the bytes
// summed in 16-bit halves of words (fewer instructions, 48 registers
// against 32) and csr_spmm's persistent prefetching walkers were each
// slower in that order (PERF.md §6).
// Hub rows are split as in csr_spmm, but by a launch of their own: a warp a
// segment writes int32 partials (127 * HUB_EDGES fits with room to spare)
// and the segment's self weight, the row walk leaves those rows out (its
// registers stay the unsplit walk's, with no spills), and a third launch
// adds the partials and runs the epilogue. In node order neither a
// half-warp an edge with 16-byte gathers and four loads in flight a lane,
// nor column slices sized for L2, was worth its code (PERF.md §6, row 5b):
// the random gathers set the time. Integer sums make the result bitwise the
// same for any edge order, walk order or split; the epilogue uses
// round-to-nearest products and add without contraction, in the plain
// version's order. Any F (the TPU's padding of F to 128 is a Mosaic
// constraint).
//
// quantize_absmax is the absmax quantiser of _apply_side (slab_spmm.py:
// 380-394), which the JAX package leaves to XLA outside the pallas_call:
// xs = bf16(bf16(x) * bf16(rs)), s = max(max |xs|, 1e-30) and q =
// int8(clamp(rint(xs * (127 / s)), -127, 127)), bit for bit the plain
// version. A global maximum over [N, F] needs every element before the
// first q, and [N, F] does not fit on chip, so it is two launches: each
// block of the first writes the maximum of its grid-stride share into a
// scratch of partial maxima; each block of the second reduces those (a few
// hundred values from L2, exact in any order), block 0 stores s, and every
// block quantises its share, walking from the end, where the first pass
// ended, so that its first reads hit L2. |xs| is compared as its bits,
// where a NaN is above every number, so a NaN in x gives a NaN s, as amax
// does. Bound: memory, x read twice, rs read, q written: 0.153 ms at
// large-400K in bf16. 16-byte loads of 8 elements a thread (F % 8 == 0,
// aligned rows), else one element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "spmm_walk.cuh"

namespace {

using namespace rw;

// The lane groups' row walk (csr_spmm_kernel) takes persistent walkers. A
// walker's shared memory holds the rows and edge ranges of its next
// kHeader items; before it walks one item it prefetches into L1 the lines
// of the next item's first kPrefetch edge ids and their values.
constexpr int kHeader = 32;
constexpr int kPrefetch = 64;

extern __shared__ int walk_smem[];

// Prefetch into L1 the lines of edges [b, min(e, b + kPrefetch)): their
// ids and their values (v is [E, H]), one line a lane.
__device__ __forceinline__ void prefetch_edges(const int* __restrict__ src,
                                               const float* __restrict__ v, int H, int b,
                                               int e) {
  const int count = min(e - b, kPrefetch);
  if (count <= 0) return;
  const int lane = threadIdx.x & 31;
  const auto line = [](const void* p) {
    return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t{127});
  };
  const char* s0 = line(src + b);
  const int s_lines = static_cast<int>((line(src + b + count - 1) - s0) / 128) + 1;
  const char* v0 = line(v + static_cast<size_t>(b) * H);
  const int v_lines =
      static_cast<int>((line(v + static_cast<size_t>(b + count) * H - 1) - v0) / 128) + 1;
  const char* p = lane < s_lines ? s0 + lane * 128
                  : lane < s_lines + v_lines ? v0 + (lane - s_lines) * 128
                                             : nullptr;
  if (p != nullptr) asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// The end of a range of a walk in lane groups: each of this lane's kPer
// columns becomes the sum of the groups' chains of that column in group
// order (group 0's + group 1's + ...), f32, in every lane; group 0's lanes
// store it.
template <int kLanes, int kPer>
__device__ __forceinline__ void add_groups(float (&acc)[kPer], int k) {
  constexpr int kGroups = 32 / kLanes;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    float s = acc[t];
#pragma unroll
    for (int g2 = 1; g2 < kGroups; ++g2) {
      s = __fadd_rn(s, __shfl_sync(kFull, acc[t], k + g2 * kLanes));
    }
    acc[t] = s;
  }
}

// spmm_edges for a head of at most kLanes * 8 columns on the 16-byte path,
// in kGroups = 32 / kLanes groups of kLanes lanes (see the design note):
// lane k of group q owns columns [8k, 8k + 8) of each head and takes slot i
// = edge i * kGroups + q of each 32-edge batch, in rounds of kInFlight
// slots whose gathers it starts, as raw bytes, before it uses any; each
// column is an fmaf chain in edge order within the group, and the groups'
// chains are added in group order. ev_bwd_edges' dx is the same sum in the
// same order. Every lane runs every loop trip, even past D, because the
// shuffles need the whole warp.
template <typename TIn, typename TDst, int kLanes>
__device__ __forceinline__ void spmm_edges_grouped(const int* __restrict__ src,
                                                   const float* __restrict__ v,
                                                   const TIn* __restrict__ x,
                                                   TDst* __restrict__ dst, int begin, int end,
                                                   int H, int D) {
  using V = Vec8<TIn>;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kInFlight = 4;
  const int lane = threadIdx.x & 31;
  const int q = lane / kLanes;
  const int k = lane % kLanes;
  const size_t F = static_cast<size_t>(H) * D;
  const bool active = k * 8 < D;
  for (int h = 0; h < H; ++h) {
    const int c = h * D + k * 8;
    const TIn* xc = x + c;
    float acc[8] = {};
    for (int e0 = begin; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int s = 0;
      float we = 0.f;
      if (e < end) {
        s = __ldg(src + e);
        we = __ldg(v + static_cast<size_t>(e) * H + h);
      }
      const int cnt = min(32, end - e0);
      const int slots = (cnt + kGroups - 1) / kGroups;  // the same in every lane
#pragma unroll 1
      for (int i0 = 0; i0 < slots; i0 += kInFlight) {
        typename V::Raw raw[kInFlight];
        float w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int j = (i0 + u) * kGroups + q;  // below 32: kLanes is a multiple of kInFlight
          const int sj = __shfl_sync(kFull, s, j);
          w[u] = __shfl_sync(kFull, we, j);
          if (active && j < cnt) raw[u] = V::load_raw(xc + static_cast<size_t>(sj) * F);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (active && (i0 + u) * kGroups + q < cnt) {
            float xv[8];
            V::unpack(raw[u], xv);
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[t] = fmaf(w[u], xv[t], acc[t]);
          }
        }
      }
    }
    add_groups<kLanes>(acc, k);
    if (q == 0 && active) Vec8<TDst>::store(dst + c, acc);
  }
}

// The walk of one edge range: the whole warp (kLanes = 32) or lane groups.
template <typename TIn, typename TDst, bool kVec8, int kLanes>
__device__ __forceinline__ void spmm_range(const int* __restrict__ src,
                                           const float* __restrict__ v,
                                           const TIn* __restrict__ x, TDst* __restrict__ dst,
                                           int begin, int end, int H, int D) {
  if constexpr (kLanes == 32) {
    spmm_edges<Source::kGather, TIn, TDst, kVec8>(src, v, x, dst, begin, end, H, D);
  } else {
    static_assert(kVec8, "lane groups take 8 columns a lane");
    spmm_edges_grouped<TIn, TDst, kLanes>(src, v, x, dst, begin, end, H, D);
  }
}

// The row walk, in the walk order: position p is row schedule[p] (row p
// when schedule is null), written in place; each row summed edge for edge
// as in any order, so the result does not depend on it. A row of more than
// max_edges edges is left to its hub segments (seg[s] = (row, begin, end)),
// whose f32 partial rows go to part[s]. The order keeps a cluster's rows
// together, so the warps in flight gather from rows that L2 holds.
//
// The whole warp's walk (kLanes = 32: heads wider than 128 columns, or off
// the 16-byte path; spmm_walk.cuh, which the slab_variant probe runs too)
// takes a warp a hub segment, then warp n_seg + p takes position p
// (walk_position): the gathers of 1 KB rows keep it busy, and the
// hardware's block scheduler keeps the warps in flight on one window of the
// order. It is held to kWholeWarpBlocks (32 registers with bf16 rows).
//
// The lane groups' walk (kLanes < 32) is bound instead by each row's chain
// of dependent loads (its position's row, its row pointers, its edge ids,
// then its gathers), so it takes `walkers` persistent warps, as many as the
// card holds at once: walker w takes items w, w + walkers, ... of the hub
// segments and then of the positions (items are interleaved over the
// walkers, so the long segments start at once and do not trail). It reads
// the rows and edge ranges of its next kHeader items at once into its
// shared memory, and before it walks one item it prefetches into L1 the
// lines of the next item's edge ids and values (prefetch_edges); so an
// item's chain is paid for kHeader items at once or ahead of it, and it
// waits for its gathers. The walk stages 4 gathers a lane and is held to
// 64 registers with bf16 rows (4 blocks an SM) and 80 with f32 rows (3):
// on the H100 at D = 32-128 that timed best of 40-115 registers and of 2,
// 4 or 8 gathers in flight (chip_compare.py narrow on copies with one
// change, one warp a row), where a tighter cap spills the staged rows.
template <typename TIn, typename TOut, bool kVec8, int kLanes, bool kOrdered>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  kLanes == 32 ? kWholeWarpBlocks<TIn>
                                               : (sizeof(TIn) == 2 ? 4 : 3))
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                const float* __restrict__ v, const TIn* __restrict__ x,
                TOut* __restrict__ out, const int* __restrict__ seg, int n_seg,
                float* __restrict__ part, int max_edges, int n_rows, int H, int D,
                const int* __restrict__ schedule, int walkers) {
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const size_t F = static_cast<size_t>(H) * D;
  if constexpr (kLanes == 32) {
    if (w < n_seg) {
      spmm_range<TIn, float, kVec8, kLanes>(src, v, x, part + static_cast<size_t>(w) * F,
                                            __ldg(seg + 3 * w + 1), __ldg(seg + 3 * w + 2), H,
                                            D);
      return;
    }
    walk_position<Source::kGather, TIn, TOut, kVec8, kOrdered>(
        w, n_seg, n_rows, indptr, schedule, src, v, x, out, max_edges, H, D);
  } else {
    if (w >= walkers) return;
    const int lane = threadIdx.x & 31;
    // this walker's header: the output rows (-1 - s for hub segment s),
    // begins and ends of its next kHeader items
    const int rows = (threadIdx.x >> 5) * 3 * kHeader;
    const int begins = rows + kHeader;
    const int ends = rows + 2 * kHeader;
    const unsigned items = static_cast<unsigned>(n_seg) + static_cast<unsigned>(n_rows);
    const unsigned stride = static_cast<unsigned>(kHeader) * walkers;
    for (unsigned first = w;; first += stride) {
      const unsigned long long i = first + static_cast<unsigned long long>(lane) * walkers;
      if (i < items) {
        int row, b, e;
        if (i < static_cast<unsigned>(n_seg)) {
          row = -1 - static_cast<int>(i);
          b = __ldg(seg + 3 * i + 1);
          e = __ldg(seg + 3 * i + 2);
        } else {
          const int p = static_cast<int>(i - n_seg);
          row = schedule != nullptr ? __ldg(schedule + p) : p;
          b = __ldg(indptr + row);
          e = __ldg(indptr + row + 1);
        }
        walk_smem[rows + lane] = row;
        walk_smem[begins + lane] = b;
        walk_smem[ends + lane] = e;
      }
      __syncwarp();
      const int count = static_cast<int>(min(static_cast<unsigned>(kHeader),
                                             (items - first + walkers - 1) / walkers));
      for (int t = 0; t < count; ++t) {
        if (t + 1 < count) {
          prefetch_edges(src, v, H, walk_smem[begins + t + 1], walk_smem[ends + t + 1]);
        }
        const int row = walk_smem[rows + t];
        const int b = walk_smem[begins + t];
        const int e = walk_smem[ends + t];
        if (row < 0) {
          spmm_range<TIn, float, kVec8, kLanes>(
              src, v, x, part + static_cast<size_t>(-1 - row) * F, b, e, H, D);
        } else if (e - b <= max_edges) {
          spmm_range<TIn, TOut, kVec8, kLanes>(src, v, x, out + static_cast<size_t>(row) * F,
                                               b, e, H, D);
        }
      }
      __syncwarp();  // every lane done with the header before it is rewritten
      if (items - first <= stride) break;
    }
  }
}

// Second pass over the hub rows: the warp of a row's first segment adds the
// row's partials in segment order (first + second + ...) and rounds once.
template <typename TOut, bool kVec8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_hub_kernel(const int* __restrict__ seg, int n_seg, const float* __restrict__ part,
                    TOut* __restrict__ out, int F) {
  using C = Cols<kVec8>;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;
  const int row = __ldg(seg + 3 * w);
  if (w > 0 && __ldg(seg + 3 * (w - 1)) == row) return;  // not the row's first segment
  int last = w + 1;
  while (last < n_seg && __ldg(seg + 3 * last) == row) ++last;
  for (int c0 = 0; c0 < F; c0 += C::kPass) {
    const int c = c0 + lane * C::kPerLane;
    if (c >= F) break;  // no shuffles here
    float acc[C::kPerLane];
    C::load(part + static_cast<size_t>(w) * F + c, acc);
    for (int s = w + 1; s < last; ++s) {
      float t[C::kPerLane];
      C::load(part + static_cast<size_t>(s) * F + c, t);
#pragma unroll
      for (int i = 0; i < C::kPerLane; ++i) acc[i] = __fadd_rn(acc[i], t[i]);
    }
    C::store(out + static_cast<size_t>(row) * F + c, acc);
  }
}

// ---------------------------------------------------------------------------
// The per-edge-value backward walk (csr_spmm_ev_bwd, sddmm).

// The fixed-order transposing reduction over a group of kO * 2 lanes, each
// holding kO * 2 partial dots (slot i: the group's i-th edge of the batch):
// at offset o a lane keeps the half of its slots whose bit o is its own lane
// bit o, adds the partner's partials of those slots, and sends the other
// half. After the steps o = kO, kO/2, ..., 1 (kO*2 - 1 shuffle-adds in all)
// slot 0 of the group's lane k holds the whole dot of slot k.
template <int kO, int kSlots>
__device__ __forceinline__ void transpose_fold(float (&part)[kSlots], int k) {
  const bool upper = (k & kO) != 0;
#pragma unroll
  for (int i = 0; i < kO; ++i) {
    const float send = upper ? part[i] : part[i + kO];
    const float keep = upper ? part[i + kO] : part[i];
    part[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kO));
  }
  if constexpr (kO > 1) transpose_fold<kO / 2, kSlots>(part, k);
}

// The message a dx product reads: g rounded to the message type (kRound:
// bf16 messages of an f32 g, as g.to(msg_dtype)), else g as it is.
template <bool kRound>
__device__ __forceinline__ float msg_value(float v) {
  if constexpr (kRound) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// One row r's edges [begin, end) of the walk. a_row: the row's vector a[r]
// ([H*D]); b: the rows gathered per edge (b[col[e]]). For every edge e and
// head h (need_dv) dv[p(e), h] = a[r, h] . b[col[e], h], with p(e) =
// perm[e] (e when perm is null); when dx_row is not null also dx_row[h, :]
// = sum_e val[p(e), h] * msg(b[col[e], h, :]).
//
// The warp is kGroups groups of kLanes lanes; each lane owns Cols' columns
// of a pass of kLanes * kPerLane columns within a head, and each group
// takes every kGroups-th edge of a batch of 32 (slot i of group q is edge
// i * kGroups + q). A batch's edge ids (and p(e), val) are read one per
// lane and shuffled; each lane issues kInFlight gathers before it uses any
// (4 edges, 8 loads of 16 bytes, in one group of 32 lanes; 2 in lane groups,
// where 4 took 0.40 ms against 0.28 at D = 40 on the H100, and a register
// cap for 3 blocks an SM 0.31); it keeps its partial dot of every edge of
// its slots, and
// transpose_fold then leaves each edge's dot in the lane that writes it.
// The dot is an fmaf chain over the lane's columns in column order (a times
// b: the same products in either mode), then the fold: so both modes give
// the same dv bit for bit. Over several passes (a head wider than a pass,
// kLanes = 32 only) each pass's dot is added to the one stored, in pass
// order. dx: each column an fmaf chain in edge order from 0 within its
// group, the groups' chains added in group order at the end of the range
// (add_groups): csr_spmm_ev's walk on the same edges with the same lane
// groups (spmm_edges with one group, spmm_edges_grouped with several), bit
// for bit.
template <typename T, bool kRound, bool kVec8, int kLanes, typename TDst>
__device__ __forceinline__ void ev_bwd_edges(const int* __restrict__ col,
                                             const int* __restrict__ perm,
                                             const float* __restrict__ val,
                                             const T* __restrict__ a_row,
                                             const T* __restrict__ b, float* __restrict__ dv,
                                             TDst* __restrict__ dx_row, int begin, int end,
                                             int H, int D, bool need_dv) {
  using C = Cols<kVec8>;
  constexpr int kPer = C::kPerLane;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kWidth = kLanes * kPer;
  constexpr int kInFlight = kLanes == 32 ? 4 : 2;
  const int lane = threadIdx.x & 31;
  const int q = lane / kLanes;
  const int k = lane % kLanes;
  const size_t F = static_cast<size_t>(H) * D;
  const bool need_dx = dx_row != nullptr;
  for (int h = 0; h < H; ++h) {
    for (int c0 = 0; c0 < D; c0 += kWidth) {
      const int c = h * D + c0 + k * kPer;
      const bool active = c0 + k * kPer < D;
      float av[kPer] = {};
      if (active) C::load(a_row + c, av);
      float acc[kPer] = {};
      for (int e0 = begin; e0 < end; e0 += 32) {
        const int e = e0 + lane;
        int my_col = 0;
        int my_p = e;
        float my_val = 0.f;
        if (e < end) {
          my_col = __ldg(col + e);
          if (perm != nullptr) my_p = __ldg(perm + e);
          if (need_dx) my_val = __ldg(val + static_cast<size_t>(my_p) * H + h);
        }
        const int cnt = min(32, end - e0);
        const int slots = (cnt + kGroups - 1) / kGroups;  // the same in every lane
        float part[kLanes];
#pragma unroll
        for (int i0 = 0; i0 < kLanes; i0 += kInFlight) {
          if (i0 < slots) {
            float bv[kInFlight][kPer];
            float w[kInFlight];
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
              const int j = (i0 + u) * kGroups + q;
              const int cj = __shfl_sync(kFull, my_col, j);
              w[u] = __shfl_sync(kFull, my_val, j);
              if (active && j < cnt) {
                C::load(b + static_cast<size_t>(cj) * F + c, bv[u]);
              } else {
#pragma unroll
                for (int t = 0; t < kPer; ++t) bv[u][t] = 0.f;
              }
            }
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
              float p = 0.f;
#pragma unroll
              for (int t = 0; t < kPer; ++t) p = fmaf(av[t], bv[u][t], p);
              part[i0 + u] = p;
              if (need_dx && active && (i0 + u) * kGroups + q < cnt) {
#pragma unroll
                for (int t = 0; t < kPer; ++t) {
                  acc[t] = fmaf(w[u], msg_value<kRound>(bv[u][t]), acc[t]);
                }
              }
            }
          } else {
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) part[i0 + u] = 0.f;
          }
        }
        if (need_dv) {
          if constexpr (kLanes > 1) transpose_fold<kLanes / 2, kLanes>(part, k);
          const int je = k * kGroups + q;  // the batch edge whose dot this lane holds
          const int pe = __shfl_sync(kFull, my_p, je);
          if (je < cnt) {
            float* o = dv + static_cast<size_t>(pe) * H + h;
            *o = c0 == 0 ? part[0] : __fadd_rn(*o, part[0]);
          }
        }
      }
      if (need_dx) {
        if constexpr (kGroups > 1) add_groups<kLanes>(acc, k);
        if (q == 0 && active) C::store(dx_row + c, acc);
      }
    }
  }
}

// Warps [0, n_seg) take one hub segment each (seg[w] = (row, begin, end)):
// its dv is final per edge, and its dx partial row goes to part[w]; warp
// n_seg + i takes row schedule[i] (row i when schedule is null) unless the
// row has more than max_edges edges (its segments cover it). dx null: dv
// only.
template <typename T, bool kRound, bool kVec8, int kLanes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ev_bwd_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
              const int* __restrict__ perm, const float* __restrict__ val,
              const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ dv,
              T* __restrict__ dx, const int* __restrict__ seg, int n_seg,
              float* __restrict__ part, int max_edges, int n_rows, int H, int D, int need_dv,
              const int* __restrict__ schedule) {
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const size_t F = static_cast<size_t>(H) * D;
  if (w < n_seg) {
    const int row = __ldg(seg + 3 * w);
    ev_bwd_edges<T, kRound, kVec8, kLanes, float>(
        col, perm, val, a + static_cast<size_t>(row) * F, b, dv,
        dx != nullptr ? part + static_cast<size_t>(w) * F : nullptr, __ldg(seg + 3 * w + 1),
        __ldg(seg + 3 * w + 2), H, D, need_dv != 0);
    return;
  }
  if (w - n_seg >= n_rows) return;  // the whole warp leaves together
  const int row = schedule != nullptr ? __ldg(schedule + w - n_seg) : w - n_seg;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  if (end - start > max_edges) return;
  ev_bwd_edges<T, kRound, kVec8, kLanes, T>(
      col, perm, val, a + static_cast<size_t>(row) * F, b, dv,
      dx != nullptr ? dx + static_cast<size_t>(row) * F : nullptr, start, end, H, D,
      need_dv != 0);
}

dim3 grid_for(int n_rows) { return dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// ---------------------------------------------------------------------------
// The int8 aggregation (csr_spmm_q8) and its absmax quantiser.

// The walk of one edge range [begin, end) into row at this lane's kPer
// columns from c (8 with 8-byte loads, F % 8 == 0 and aligned rows, else
// one): acc gets the exact int32 sums of q[src[e]] over the non-self
// edges, and the sum of the self edges' v[e] in edge order is returned (the
// same in every lane). Edge ids are read 32 at a time and shuffled. Every
// lane runs every loop trip, even past F, because the shuffles need the
// whole warp.
template <bool kVec8>
__device__ __forceinline__ float q8_edges(const int* __restrict__ src,
                                          const float* __restrict__ v,
                                          const int8_t* __restrict__ q, size_t F, int row,
                                          int begin, int end, int c, bool active,
                                          int (&acc)[kVec8 ? 8 : 1]) {
  constexpr int kPer = kVec8 ? 8 : 1;
  const int lane = threadIdx.x & 31;
  float w_self = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0;
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    int s = -1;
    float ws = 0.f;
    if (e < end) {
      s = __ldg(src + e);
      if (s == row) ws = __ldg(v + e);
    }
    const int cnt = min(32, end - e0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int sj = __shfl_sync(kFull, s, j);
      const float wj = __shfl_sync(kFull, ws, j);
      if (sj == row) {
        w_self += wj;
      } else if (active) {
        const int8_t* p = q + static_cast<size_t>(sj) * F + c;
        if constexpr (kVec8) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            // byte i % 4 of word i / 4, sign-extended
            const unsigned word = i < 4 ? raw.x : raw.y;
            acc[i] += static_cast<int>(word << (24 - 8 * (i % 4))) >> 24;
          }
        } else {
          acc[0] += __ldg(p);
        }
      }
    }
  }
  return w_self;
}

// out = ((acc * dq) * r) + w_self * xb at kPer columns from off, each
// operation rounded to nearest (no contraction), in the plain version's
// order.
template <typename TOut, bool kVec8>
__device__ __forceinline__ void q8_epilogue(const int (&acc)[kVec8 ? 8 : 1], float dq, float r,
                                            float w_self, const __nv_bfloat16* __restrict__ xb,
                                            TOut* __restrict__ out, size_t off) {
  constexpr int kPer = kVec8 ? 8 : 1;
  float xv[kPer];
  float o[kPer];
  if constexpr (kVec8) {
    Vec8<__nv_bfloat16>::load(xb + off, xv);
  } else {
    xv[0] = __bfloat162float(xb[off]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float t = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), dq), r);
    o[i] = __fadd_rn(t, __fmul_rn(w_self, xv[i]));
  }
  if constexpr (kVec8) {
    Vec8<TOut>::store(out + off, o);
  } else {
    out[off] = from_float<TOut>(o[0]);
  }
}

// Hub segments: warp w sums segment w (seg[w] = (row, begin, end)) into
// int32 partials part[w] and its self-edge weight wpart[w].
template <bool kVec8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_q8_seg_kernel(const int* __restrict__ src, const float* __restrict__ v,
                       const int8_t* __restrict__ q, const int* __restrict__ seg, int n_seg,
                       int* __restrict__ part, float* __restrict__ wpart, int F) {
  constexpr int kPer = kVec8 ? 8 : 1;
  constexpr int kPass = 32 * kPer;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;
  const int row = __ldg(seg + 3 * w);
  const int begin = __ldg(seg + 3 * w + 1);
  const int end = __ldg(seg + 3 * w + 2);
  for (int c0 = 0; c0 < F; c0 += kPass) {
    const int c = c0 + lane * kPer;
    const bool active = c < F;
    int acc[kPer];
    const float w_self = q8_edges<kVec8>(src, v, q, F, row, begin, end, c, active, acc);
    if (active) {
      int* p = part + static_cast<size_t>(w) * F + c;
#pragma unroll
      for (int i = 0; i < kPer; ++i) p[i] = acc[i];
    }
    if (c0 == 0 && lane == 0) wpart[w] = w_self;
  }
}

// The row walk, in the walk order: warp p takes row schedule[p] (row p
// when schedule is null), written in place; 256 columns a pass with 8-byte
// loads, else 32. A row of more than max_edges edges is left to its hub
// segments. The order keeps a cluster's rows together, so the warps in
// flight gather from rows that L2 holds.
template <typename TOut, bool kVec8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_q8_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                   const float* __restrict__ v, const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ xb, const float* __restrict__ rs,
                   const float* __restrict__ absmax, TOut* __restrict__ out, int max_edges,
                   int n_rows, int F, const int* __restrict__ schedule) {
  constexpr int kPer = kVec8 ? 8 : 1;
  constexpr int kPass = 32 * kPer;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_rows) return;  // the whole warp leaves together
  const int row = schedule != nullptr ? __ldg(schedule + w) : w;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  if (end - start > max_edges) return;
  const float dq = __fdiv_rn(__ldg(absmax), 127.0f);
  const float r = __ldg(rs + row);
  for (int c0 = 0; c0 < F; c0 += kPass) {
    const int c = c0 + lane * kPer;
    const bool active = c < F;
    int acc[kPer];
    const float w_self = q8_edges<kVec8>(src, v, q, F, row, start, end, c, active, acc);
    if (active) {
      q8_epilogue<TOut, kVec8>(acc, dq, r, w_self, xb, out, static_cast<size_t>(row) * F + c);
    }
  }
}

// Second pass over the hub rows: the warp of a row's first segment adds the
// row's integer partials (exact in any order) and its segments' self-edge
// weights in segment order, then runs the epilogue.
template <typename TOut>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_q8_hub_kernel(const int* __restrict__ seg, int n_seg, const int* __restrict__ part,
                       const float* __restrict__ wpart, const __nv_bfloat16* __restrict__ xb,
                       const float* __restrict__ rs, const float* __restrict__ absmax,
                       TOut* __restrict__ out, int F) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_seg) return;
  const int row = __ldg(seg + 3 * w);
  if (w > 0 && __ldg(seg + 3 * (w - 1)) == row) return;  // not the row's first segment
  int last = w + 1;
  while (last < n_seg && __ldg(seg + 3 * last) == row) ++last;
  float w_self = wpart[w];
  for (int s = w + 1; s < last; ++s) w_self = __fadd_rn(w_self, wpart[s]);
  const float dq = __fdiv_rn(__ldg(absmax), 127.0f);
  const float r = __ldg(rs + row);
  for (int c = lane; c < F; c += 32) {
    int acc[1] = {part[static_cast<size_t>(w) * F + c]};
    for (int s = w + 1; s < last; ++s) acc[0] += part[static_cast<size_t>(s) * F + c];
    q8_epilogue<TOut, false>(acc, dq, r, w_self, xb, out, static_cast<size_t>(row) * F + c);
  }
}

template <typename TOut, bool kVec8>
cudaError_t launch_q8(const int* indptr, const int* src, const float* v, const int8_t* q,
                      const __nv_bfloat16* xb, const float* rs, const float* absmax, void* out,
                      const int* seg, int n_seg, int* part, float* wpart, int max_edges,
                      int n_rows, int F, const int* schedule, cudaStream_t st) {
  TOut* o = static_cast<TOut*>(out);
  const dim3 block(kWarpsPerBlock * 32);
  if (n_seg > 0) {
    csr_spmm_q8_seg_kernel<kVec8><<<grid_for(n_seg), block, 0, st>>>(src, v, q, seg, n_seg, part,
                                                                      wpart, F);
  }
  csr_spmm_q8_kernel<TOut, kVec8><<<grid_for(n_rows), block, 0, st>>>(
      indptr, src, v, q, xb, rs, absmax, o, max_edges, n_rows, F, schedule);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 0) return err;
  csr_spmm_q8_hub_kernel<TOut><<<grid_for(n_seg), block, 0, st>>>(seg, n_seg, part, wpart, xb,
                                                                   rs, absmax, o, F);
  return cudaGetLastError();
}

// The quantiser. Both passes walk x in items of 8 elements (16-byte loads
// of bf16, two of f32; F % 8 == 0 and aligned rows) or of one element.
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// xs of item i's kPer elements: bf16(bf16(x) * bf16(rs[row])); the product
// of two bf16 values is exact in f32 and rounded once.
template <typename T, bool kVec8>
__device__ __forceinline__ void prescaled(const T* __restrict__ x, const float* __restrict__ rs,
                                          unsigned i, unsigned per_row,
                                          float (&xs)[kVec8 ? 8 : 1]) {
  const float r = round_bf16(__ldg(rs + i / per_row));
  if constexpr (kVec8) {
    Vec8<T>::load(x + static_cast<size_t>(i) * 8, xs);
  } else {
    xs[0] = to_float(x[i]);
  }
#pragma unroll
  for (int k = 0; k < (kVec8 ? 8 : 1); ++k) xs[k] = round_bf16(__fmul_rn(round_bf16(xs[k]), r));
}

// The largest of m over the block, in every thread. |v| compares as its
// bits (unsigned), where a NaN is larger than any number: a NaN anywhere
// gives a NaN maximum, as amax does, in any order.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned red[kQuantThreads / 32];
  m = __reduce_max_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kQuantThreads / 32; ++i) m = max(m, red[i]);
  return m;
}

// Pass 1: each block's max |xs| (as bits) into part[blockIdx.x].
template <typename T, bool kVec8>
__global__ void __launch_bounds__(kQuantThreads)
absmax_partial_kernel(const T* __restrict__ x, const float* __restrict__ rs,
                      unsigned* __restrict__ part, unsigned n_items, unsigned per_row) {
  unsigned m = 0;
  for (unsigned i = blockIdx.x * kQuantThreads + threadIdx.x; i < n_items;
       i += gridDim.x * kQuantThreads) {
    float xs[kVec8 ? 8 : 1];
    prescaled<T, kVec8>(x, rs, i, per_row, xs);
#pragma unroll
    for (int k = 0; k < (kVec8 ? 8 : 1); ++k) m = max(m, __float_as_uint(fabsf(xs[k])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// Pass 2: every block reduces the partial maxima (exact in any order),
// s = max(absmax, 1e-30) (block 0 stores it), and quantises its items:
// q = int8(clamp(rint(xs * (127 / s)), -127, 127)), rint rounding half to
// even. It walks the items from the end, where pass 1 ended, so that its
// first reads hit what L2 still holds.
template <typename T, bool kVec8>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ rs,
                const unsigned* __restrict__ part, int n_parts, float* __restrict__ absmax,
                int8_t* __restrict__ q, unsigned n_items, unsigned per_row) {
  unsigned m = 0;
  for (int i = threadIdx.x; i < n_parts; i += kQuantThreads) m = max(m, part[i]);
  m = block_max(m);
  const float s = __uint_as_float(max(m, __float_as_uint(1e-30f)));
  if (blockIdx.x == 0 && threadIdx.x == 0) *absmax = s;
  const float scale = __fdiv_rn(127.0f, s);
  for (unsigned t = blockIdx.x * kQuantThreads + threadIdx.x; t < n_items;
       t += gridDim.x * kQuantThreads) {
    const unsigned i = n_items - 1 - t;
    float xs[kVec8 ? 8 : 1];
    prescaled<T, kVec8>(x, rs, i, per_row, xs);
    unsigned packed[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < (kVec8 ? 8 : 1); ++k) {
      const float r = fminf(fmaxf(rintf(__fmul_rn(xs[k], scale)), -127.0f), 127.0f);
      packed[k / 4] |= (static_cast<unsigned>(__float2int_rn(r)) & 0xffu) << (8 * (k % 4));
    }
    if constexpr (kVec8) {
      *reinterpret_cast<uint2*>(q + static_cast<size_t>(i) * 8) = make_uint2(packed[0], packed[1]);
    } else {
      q[i] = static_cast<int8_t>(static_cast<int>(packed[0] << 24) >> 24);
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, const float* rs, unsigned* part, int n_parts,
                            float* absmax, int8_t* q, unsigned n_items, unsigned per_row,
                            int vec8, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (vec8) {
    absmax_partial_kernel<T, true><<<n_parts, kQuantThreads, 0, st>>>(xt, rs, part, n_items,
                                                                       per_row);
  } else {
    absmax_partial_kernel<T, false><<<n_parts, kQuantThreads, 0, st>>>(xt, rs, part, n_items,
                                                                        per_row);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (vec8) {
    quantize_kernel<T, true><<<n_parts, kQuantThreads, 0, st>>>(
        xt, rs, part, n_parts, absmax, q, n_items, per_row);
  } else {
    quantize_kernel<T, false><<<n_parts, kQuantThreads, 0, st>>>(
        xt, rs, part, n_parts, absmax, q, n_items, per_row);
  }
  return cudaGetLastError();
}


// The lane groups of the row walks, forward and backward alike, for a head
// of D columns: on the 16-byte path (vec8) groups of the fewest lanes (4,
// 8, 16 or 32) whose 8 columns each cover a head, else one group of 32
// lanes of one column each, in passes. Calls launch(vec8, lanes) with both
// as std::integral_constant.
template <typename Launch>
cudaError_t lane_groups(int D, int vec8, Launch&& launch) {
  if (!vec8) return launch(std::false_type{}, std::integral_constant<int, 32>{});
  const int lanes = (D + 7) / 8;
  if (lanes <= 4) return launch(std::true_type{}, std::integral_constant<int, 4>{});
  if (lanes <= 8) return launch(std::true_type{}, std::integral_constant<int, 8>{});
  if (lanes <= 16) return launch(std::true_type{}, std::integral_constant<int, 16>{});
  return launch(std::true_type{}, std::integral_constant<int, 32>{});
}

// The row walk's walkers: as many warps as the card holds at once, at
// most one an item.
template <typename Kernel>
cudaError_t resident_warps(Kernel kernel, size_t smem, int n_items, int* walkers) {
  int device = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWarpsPerBlock * 32,
                                                        smem);
  }
  *walkers = min(n_items, max(1, blocks * sms) * kWarpsPerBlock);
  return err;
}

template <typename TIn, typename TOut, bool kVec8, int kLanes>
cudaError_t launch_spmm_cols(const int* indptr, const int* src, const float* v, const TIn* x,
                             TOut* out, const int* seg, int n_seg, float* part, int max_edges,
                             int n_rows, int H, int D, const int* schedule,
                             cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  // the whole warp's walk in node order takes its own instance (see
  // csr_spmm_kernel); the walkers, one instance, read either from their
  // header
  const auto kernel = schedule == nullptr
                          ? csr_spmm_kernel<TIn, TOut, kVec8, kLanes, kLanes != 32>
                          : csr_spmm_kernel<TIn, TOut, kVec8, kLanes, true>;
  // the whole warp's walk: a warp a hub segment, then a warp a row; the
  // lane groups': as many walkers as the card holds, at most one an item,
  // each with its header in shared memory
  int warps = n_seg + n_rows, walkers = 0;
  size_t smem = 0;
  if (kLanes < 32) {
    smem = static_cast<size_t>(kWarpsPerBlock) * 3 * kHeader * sizeof(int);
    const long long items = static_cast<long long>(n_seg) + n_rows;
    cudaError_t err = resident_warps(kernel, smem, static_cast<int>(min(items, 1LL << 30)),
                                     &walkers);
    if (err != cudaSuccess) return err;
    warps = walkers;
  }
  kernel<<<grid_for(warps), block, smem, stream>>>(
      indptr, src, v, x, out, seg, n_seg, part, max_edges, n_rows, H, D, schedule, walkers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 0) return err;
  csr_spmm_hub_kernel<TOut, kVec8><<<grid_for(n_seg), block, 0, stream>>>(seg, n_seg, part, out,
                                                                         H * D);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_spmm(const int* indptr, const int* src, const float* v, const void* x,
                        void* out, const int* seg, int n_seg, float* part, int max_edges,
                        int n_rows, int H, int D, int vec8, const int* schedule,
                        cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  TOut* ot = static_cast<TOut*>(out);
  return lane_groups(D, vec8, [&](auto vec, auto lanes) {
    return launch_spmm_cols<TIn, TOut, decltype(vec)::value, decltype(lanes)::value>(
        indptr, src, v, xt, ot, seg, n_seg, part, max_edges, n_rows, H, D, schedule, stream);
  });
}

template <typename T, bool kRound, bool kVec8, int kLanes>
cudaError_t launch_ev_bwd_lanes(const int* indptr, const int* col, const int* perm,
                                const float* val, const T* a, const T* b, float* dv, T* dx,
                                const int* seg, int n_seg, float* part, int max_edges,
                                int n_rows, int H, int D, const int* schedule, cudaStream_t st) {
  const dim3 block(kWarpsPerBlock * 32);
  ev_bwd_kernel<T, kRound, kVec8, kLanes><<<grid_for(n_seg + n_rows), block, 0, st>>>(
      indptr, col, perm, val, a, b, dv, dx, seg, n_seg, part, max_edges, n_rows, H, D,
      dv != nullptr, schedule);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_seg == 0 || dx == nullptr) return err;
  csr_spmm_hub_kernel<T, kVec8><<<grid_for(n_seg), block, 0, st>>>(seg, n_seg, part, dx, H * D);
  return cudaGetLastError();
}

template <typename T, bool kRound>
cudaError_t launch_ev_bwd(const int* indptr, const int* col, const int* perm, const float* val,
                          const void* a, const void* b, float* dv, void* dx, const int* seg,
                          int n_seg, float* part, int max_edges, int n_rows, int H, int D,
                          int vec8, const int* schedule, cudaStream_t st) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* xt = static_cast<T*>(dx);
  return lane_groups(D, vec8, [&](auto vec, auto lanes) {
    return launch_ev_bwd_lanes<T, kRound, decltype(vec)::value, decltype(lanes)::value>(
        indptr, col, perm, val, at, bt, dv, xt, seg, n_seg, part, max_edges, n_rows, H, D,
        schedule, st);
  });
}

}  // namespace

// Types: 0 = float32, 1 = bfloat16. vec8: 1 when D % 8 == 0 and the row
// arrays are 16-byte aligned. Each returns the cudaError_t of its launch (0
// on success).

// x (the messages) in in_dtype, out in out_dtype, any pairing: GAT sends
// bf16 messages of an f32 tensor and keeps the f32 result. seg: the hub
// plan, [n_seg, 3] int32 (row, begin, end) in row order, covering exactly
// the rows of more than max_edges edges; part: f32 scratch [n_seg, H*D]
// (unused when n_seg is 0). schedule: the walk order, [n_rows] int32, a
// permutation of the rows (null: row order); the result does not depend on
// it. Launches csr_spmm_kernel, then csr_spmm_hub_kernel when there are hub
// rows.
extern "C" int sgf_csr_spmm(const void* indptr, const void* src, const void* v,
                            const void* x, void* out, const void* seg, int n_seg, void* part,
                            int max_edges, int n_rows, int H, int D, int in_dtype,
                            int out_dtype, int vec8, const void* schedule, void* stream) {
  const int* so = static_cast<const int*>(schedule);
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* vp = static_cast<const float*>(v);
  const int* sg = static_cast<const int*>(seg);
  float* pp = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0) {
    err = launch_spmm<float, float>(ip, sp, vp, x, out, sg, n_seg, pp, max_edges, n_rows, H, D,
                                    vec8, so, st);
  } else if (in_dtype == 1 && out_dtype == 1) {
    err = launch_spmm<__nv_bfloat16, __nv_bfloat16>(ip, sp, vp, x, out, sg, n_seg, pp,
                                                    max_edges, n_rows, H, D, vec8, so, st);
  } else if (in_dtype == 1 && out_dtype == 0) {
    err = launch_spmm<__nv_bfloat16, float>(ip, sp, vp, x, out, sg, n_seg, pp, max_edges,
                                            n_rows, H, D, vec8, so, st);
  } else if (in_dtype == 0 && out_dtype == 1) {
    err = launch_spmm<float, __nv_bfloat16>(ip, sp, vp, x, out, sg, n_seg, pp, max_edges,
                                            n_rows, H, D, vec8, so, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// q int8 and xb bf16, [N, F]; v, rs and the absmax f32; out in out_dtype.
// vec8: F % 8 == 0 and 16-byte aligned rows. seg, n_seg and max_edges:
// the hub plan, as in sgf_csr_spmm; part: int32 scratch [n_seg, F] and
// wpart f32 [n_seg] (unused when n_seg is 0). schedule: the walk order, as
// in sgf_csr_spmm (null: row order); the result does not depend on it.
// Launches csr_spmm_q8_kernel, and when there are hub rows
// csr_spmm_q8_seg_kernel before it and csr_spmm_q8_hub_kernel after it.
extern "C" int sgf_csr_spmm_q8(const void* indptr, const void* src, const void* v,
                               const void* q, const void* xb, const void* rs,
                               const void* absmax, void* out, const void* seg, int n_seg,
                               void* part, void* wpart, int max_edges, int n_rows, int F,
                               int out_dtype, int vec8, const void* schedule, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* vp = static_cast<const float*>(v);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(xb);
  const float* rp = static_cast<const float*>(rs);
  const float* ap = static_cast<const float*>(absmax);
  const int* sg = static_cast<const int*>(seg);
  int* pp = static_cast<int*>(part);
  float* wp = static_cast<float*>(wpart);
  const int* so = static_cast<const int*>(schedule);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 0 && vec8) {
    err = launch_q8<float, true>(ip, sp, vp, qp, xp, rp, ap, out, sg, n_seg, pp, wp, max_edges,
                                 n_rows, F, so, st);
  } else if (out_dtype == 0) {
    err = launch_q8<float, false>(ip, sp, vp, qp, xp, rp, ap, out, sg, n_seg, pp, wp, max_edges,
                                  n_rows, F, so, st);
  } else if (out_dtype == 1 && vec8) {
    err = launch_q8<__nv_bfloat16, true>(ip, sp, vp, qp, xp, rp, ap, out, sg, n_seg, pp, wp,
                                         max_edges, n_rows, F, so, st);
  } else if (out_dtype == 1) {
    err = launch_q8<__nv_bfloat16, false>(ip, sp, vp, qp, xp, rp, ap, out, sg, n_seg, pp, wp,
                                          max_edges, n_rows, F, so, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// x [N, F] in dtype (0 = float32, 1 = bfloat16), rs [N] f32; writes q [N,
// F] int8 and the absmax (one f32) on the device. n_items: N * F / 8 with
// vec8 (F % 8 == 0 and x 16-byte aligned), else N * F; per_row: items a
// row; part: n_parts uint32 of scratch, one per block of each pass. Two
// launches.
extern "C" int sgf_quantize_absmax(const void* x, const void* rs, void* part, int n_parts,
                                   void* absmax, void* q, int n_items, int per_row, int dtype,
                                   int vec8, void* stream) {
  const float* rp = static_cast<const float*>(rs);
  unsigned* pp = static_cast<unsigned*>(part);
  float* ap = static_cast<float*>(absmax);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_parts < 1 || n_items < 1 || per_row < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned items = static_cast<unsigned>(n_items);
  const unsigned row = static_cast<unsigned>(per_row);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_quantize<float>(x, rp, pp, n_parts, ap, qp, items, row, vec8, st);
  } else if (dtype == 1) {
    err = launch_quantize<__nv_bfloat16>(x, rp, pp, n_parts, ap, qp, items, row, vec8, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The per-edge-value backward on the transposed CSR (t_indptr, t_col =
// t_edge_src, the original destinations; t_perm, the dst-sorted id of each
// edge): dx = sum over row s's edges e' of val[t_perm[e'], h] * msg(g[d])
// (dx null: not computed) and dv[t_perm[e'], h] = x[s, h] . g[d, h] (dv
// null: not computed). x, g and dx in dtype; round_msg: g's messages are
// bf16 (dtype f32 only). val and dv f32 [E, H]. seg, n_seg, max_edges: the
// transposed CSR's hub plan, as in sgf_csr_spmm; part: f32 scratch [n_seg,
// H*D] for dx (unused when n_seg is 0 or dx is null). t_schedule: the
// transposed CSR's walk order, as in sgf_csr_spmm (null: row order).
// Launches ev_bwd_kernel, then csr_spmm_hub_kernel when there are hub rows
// and dx.
extern "C" int sgf_csr_spmm_ev_bwd(const void* t_indptr, const void* t_col, const void* t_perm,
                                   const void* val, const void* x, const void* g, void* dx,
                                   void* dv, const void* seg, int n_seg, void* part,
                                   int max_edges, int n_rows, int H, int D, int dtype,
                                   int round_msg, int vec8, const void* t_schedule,
                                   void* stream) {
  const int* so = static_cast<const int*>(t_schedule);
  const int* ip = static_cast<const int*>(t_indptr);
  const int* cp = static_cast<const int*>(t_col);
  const int* pp = static_cast<const int*>(t_perm);
  const float* vp = static_cast<const float*>(val);
  float* dp = static_cast<float*>(dv);
  const int* sg = static_cast<const int*>(seg);
  float* sp = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && round_msg) {
    err = launch_ev_bwd<float, true>(ip, cp, pp, vp, x, g, dp, dx, sg, n_seg, sp, max_edges,
                                     n_rows, H, D, vec8, so, st);
  } else if (dtype == 0) {
    err = launch_ev_bwd<float, false>(ip, cp, pp, vp, x, g, dp, dx, sg, n_seg, sp, max_edges,
                                      n_rows, H, D, vec8, so, st);
  } else if (dtype == 1) {
    err = launch_ev_bwd<__nv_bfloat16, false>(ip, cp, pp, vp, x, g, dp, dx, sg, n_seg, sp,
                                              max_edges, n_rows, H, D, vec8, so, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dv only, on the dst-sorted CSR: dv[e, h] = g[i, h] . x[src[e], h] for
// row i's edges, the same walk with g held and x gathered. g and x in one
// type (dtype); dv f32. seg, n_seg, max_edges: the CSR's hub plan (each
// segment's dots are final; no second pass).
extern "C" int sgf_sddmm(const void* indptr, const void* src, const void* g, const void* x,
                         void* dv, const void* seg, int n_seg, int max_edges, int n_rows, int H,
                         int D, int dtype, int vec8, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  float* dp = static_cast<float*>(dv);
  const int* sg = static_cast<const int*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_ev_bwd<float, false>(ip, sp, nullptr, nullptr, g, x, dp, nullptr, sg, n_seg,
                                      nullptr, max_edges, n_rows, H, D, vec8, nullptr, st);
  } else if (dtype == 1) {
    err = launch_ev_bwd<__nv_bfloat16, false>(ip, sp, nullptr, nullptr, g, x, dp, nullptr, sg,
                                              n_seg, nullptr, max_edges, n_rows, H, D, vec8,
                                              nullptr, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
