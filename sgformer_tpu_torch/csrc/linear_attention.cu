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
// bf16 tensor-core peak. In f32 the bytes double (156 us) and the products
// run in 3xTF32 (below): three TF32 products of 22.2 GFLOP at 495 TFLOP/s,
// 135 us, so the bytes bound the f32 kernels too.
//
// Both reduces run k^T v on warpgroup MMAs (wgmma), warp-specialised: a
// block owns a 128 x 128 tile of kvs over one slice of N; its producer
// warpgroup brings the slice's node rows of k, v and (in the blocks that
// sum it) q by the copy engine (TMA) through a ring of full and empty
// mbarriers, and two consumer warpgroups run the MMAs on the staged atoms
// while ksum, ||k||^2 and ||q||^2 are summed per column on the CUDA cores
// (f32 chains made f64 once a chunk). The blocks of a slice have
// neighbouring indices, so they run together and the second read of the
// slice's k or v rows (each feeds two tiles at M = D = 256) is served by
// the 50 MB L2. Partials go to scratch and are added in slice order by
// la_finish_kernel. The products of each 32 node rows go into fresh sums
// added to the block's with round-to-nearest f32 adds, so that the tensor
// cores' own accumulation never chains a slice. Where the copies came from
// the MMA warps (cp.async) they stalled them: the copies alone held the
// bf16 mma.sync kernel this replaced at 1.6x its bound (PERF.md).
// - bf16 (la_reduce_wgmma_kernel): both operands read node-major through
//   MN-major descriptors (wgmma m64n64k16), k and v as they are: bf16
//   products are exact in f32, so only the order of the sums differs from
//   the plain version, and it stays fixed.
//
// The bf16 apply (la_apply_wgmma_kernel) runs a = q @ kvs on warpgroup MMAs
// (wgmma m64n64k16, bf16 in, f32 sums, both operands read from
// 128-byte-swizzled shared memory through descriptors). kvs stays f32 in
// meaning: kvs^T is split once a call into bf16 hi + lo (~16 significant
// bits, 2^-17 of each term; tc::split_kvs_kernel<bf16>) and each product
// is two MMAs into one accumulator. It is warp-specialised, fed by the copy
// engine (TMA) and persistent, one block an SM: a producer warpgroup brings
// each 128-row block's q rows (double-buffered up to M = 256, so that the
// next row block's land under this one's MMAs), the kvs^T chunks through a
// ring of stages and each column tile's v rows; two consumer warpgroups run
// the MMAs, form den = inv * (q . ksum) + n from the staged q rows while a
// row block's first MMAs run, and finish each 64-column tile in place for
// the copy engine to store. The output is rounded to bf16 once, from f32;
// no atomics, so repeated calls are bitwise equal. At the arxiv shape the
// MMA work, 2 x 22.2 GFLOP, is ~0.045 ms at the bf16 peak, under the bytes
// bound (0.078 ms).
//
// The f32 kernels run in 3xTF32 (f32 sums), as the f32 backward does
// (linear_attention_bwd.cu): each f32 operand x is split into hi = tf32(x)
// and lo = tf32(x - hi) (cvt.rna), and each product is lo*hi' + hi*lo' +
// hi*hi' (lo*lo' dropped), ~2^-21 of each term.
// - The f32 reduce (la_reduce_wg_kernel) is the bf16 reduce's grid,
//   slices, tiles, producer, column sums and second passes on wgmma
//   m64n128k8 tf32, which reads no transposed 32-bit operand: k^T comes
//   from registers, split as its fragments load from the node-major atoms,
//   and v is split once a chunk into tf32 hi + lo atoms written K-major
//   (d rows, nodes contiguous). Its tile streams the node rows, so it takes
//   any M and D.
// - The f32 apply (la_apply_wg_kernel) runs a = q @ kvs on warpgroup MMAs
//   (wgmma m64n64k8 tf32, A from registers), warp-specialised: a producer
//   warpgroup brings the q rows (staged once in f32, 128 KB at M = 256, one
//   block an SM), kvs^T's tf32 hi and lo pieces (split once a call by
//   tc::split_kvs_kernel, already swizzled) and each column tile's v rows
//   by the copy engine (TMA), and forms den; two consumer warpgroups split
//   q as its fragments load, run the MMAs and finish each tile in place for
//   the copy engine to store. Its q tile fits one block's shared memory up
//   to M = 256.
// Wider q rows (above M = 256 in f32, 704 in bf16) run la_apply_kernel on
// the CUDA cores (64 x 64 output tiles, f32 FMAs from shared memory).
//
// Inputs are row-strided views (ld* = elements between rows), so the heads of
// an [N, H, M] tensor are read in place; the last dimension is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 64;      // M and D tile
constexpr int kRows = 32;      // M depth per CUDA-core apply step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kApplyRows = 128;     // rows of a tensor-core apply block: two warpgroups
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

// The forward reduce on warpgroup MMAs, warp-specialised: grid (slices *
// tiles), tiles = ceil(M/128) * ceil(D/128), slice-major: block b sums tile
// b % tiles of k^T v over the rows [s*rows_per_slice, (s+1)*rows_per_slice),
// s = b / tiles, warpgroup w its 64 m rows by all 128 d columns. The blocks
// of the first column tile (dy == 0) also sum k and k*k per column of their
// M tile, those of the second (or the first, when D fits one tile) q*q, so
// that the column sums and the extra q traffic fall on different blocks.
// Three warpgroups a block, one block an SM: two consumer warpgroups run
// the MMAs, and a producer warpgroup, whose registers go to them
// (setmaxnreg), feeds them: one warp of it brings each chunk of k, v and,
// in the blocks that sum it, q into 128-byte-swizzled node-major atoms by
// the copy engine (tensor maps of the rows; where their strides or bases
// do not allow one, vec == 0, its lanes copy them one element at a time,
// zero past the slice), through a ring of full and empty mbarriers. A
// chunk's rows past the slice (the copy engine reads on to N, and
// zero-fills past it) are zeroed before the MMAs read them, and the column
// sums stop at the slice's end. The block's slice arithmetic (RdBlock), the
// producer (rd_produce) and the f32 form's K-major split (rd_split_tf32)
// are tensor_core.cuh's, shared with the f32 backward P pass.
//
// The column sums run on the CUDA cores from the staged atoms while the
// chunk's MMAs run, by row groups: in bf16 the eight consumer warps (rows
// w + 8 j of a chunk for warp w), in f32 the producer warpgroup's three
// other warps (rows w + 3 j), where they took a quarter of the MMA warps'
// time. Lane l takes the four columns 4 l .. + 3, loaded four at a time,
// one f32 chain a column and quantity over its group's rows of the chunk
// (the squares of bf16 inputs exact in f32, each square added by an FMA);
// each chain's sum is made an f64 once a chunk and added to its group's
// f64 sum (converting every element to f64 ran at a sixteenth of the FMA
// rate), and at the end each column's groups are added in order in f64 and
// rounded to f32 once a slice. (A single warp summing all the rows held
// the bf16 kernel to a third of its speed.)
using tc::kRdConsumers;
using tc::kRdThreads;
using tc::kRdTile;
using tc::kRfAtom;
using tc::kRfPiece;
using tc::kRfRows;
using tc::kRfSumWarps;
using tc::RdBlock;
using tc::RdMaps;  // a: k, b: v, c: q
using tc::rd_load4;
constexpr int kRdSums = 3 * 4 * kRdConsumers;  // bf16's f64 column sums: 12 a consumer thread

// A staged chunk's f32 chains for a thread's columns 4 l .. + 3 (l its
// lane) over the chunk's rows rg + kGroups j below valid (its row group):
// s and k2 the sums and sums of squares of k (k_stats), q2 those of q
// (q_stats), each square added by an FMA. at(r, c) is the byte offset of
// element (r, c) in a chunk's k (or q) atoms.
template <typename T, int kRowsPerChunk, int kGroups, typename At>
__device__ __forceinline__ void rd_chunk_sums(const unsigned char* ks, const unsigned char* qs,
                                              int rg, int lane, int valid, bool k_stats,
                                              bool q_stats, At at, float (&s)[4],
                                              float (&k2)[4], float (&q2)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = k2[e] = q2[e] = 0.f;
#pragma unroll
  for (int j = 0; j < (kRowsPerChunk + kGroups - 1) / kGroups; ++j) {
    const int r = rg + kGroups * j;
    const int off = at(r, 4 * lane);
    if (k_stats) {
      float x[4];
      rd_load4(reinterpret_cast<const T*>(ks + off), r < valid, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] += x[e];
        k2[e] = fmaf(x[e], x[e], k2[e]);
      }
    }
    if (q_stats) {
      float y[4];
      rd_load4(reinterpret_cast<const T*>(qs + off), r < valid, y);
#pragma unroll
      for (int e = 0; e < 4; ++e) q2[e] = fmaf(y[e], y[e], q2[e]);
    }
  }
}

// Column col's slice sum of a quantity (0: k, 1: k*k, 2: q*q) from the f64
// sums of its kGroups row groups, laid out in shared memory as
// colsum[((quantity * 4 + e) * kGroups + rg) * 32 + l] for column 4 l + e,
// added in order and rounded to f32 once.
template <int kGroups>
__device__ __forceinline__ float rd_total(const double* colsum, int quantity, int col) {
  const double* p = colsum + (quantity * 4 + (col & 3)) * kGroups * 32 + (col >> 2);
  double sum = 0.0;
#pragma unroll
  for (int rg = 0; rg < kGroups; ++rg) sum += p[32 * rg];
  return static_cast<float>(sum);
}

// Column col's slice sums out (col < kRdTile): k's and k*k's where k_stats,
// q*q's where q_stats.
template <int kGroups>
__device__ __forceinline__ void rd_store_col(const double* colsum, int col, int m0, int M, int s,
                                             bool k_stats, bool q_stats,
                                             float* __restrict__ ksum_part,
                                             float* __restrict__ qsq_part,
                                             float* __restrict__ ksq_part) {
  if (m0 + col >= M) return;
  const size_t o = static_cast<size_t>(s) * M + m0 + col;
  if (k_stats) {
    ksum_part[o] = rd_total<kGroups>(colsum, 0, col);
    ksq_part[o] = rd_total<kGroups>(colsum, 1, col);
  }
  if (q_stats) qsq_part[o] = rd_total<kGroups>(colsum, 2, col);
}

// The bf16 reduce (wgmma m64n64k16 bf16 -> f32, both operands MN-major:
// the MMA's k is the node axis, so k and v are read as the copy engine
// staged them, [64 nodes][64] atoms). bf16 products are exact in f32, so
// k and v go in as they are. Each 32-node half of a chunk (two k16 steps on
// each of v's two 64-column atoms) goes into fresh sums added to the
// block's f32 sums with round-to-nearest adds, so that the tensor cores'
// own accumulation, which may truncate, never chains more than 32 rows; the
// two halves' sums are double-buffered, the second's MMAs running while
// the first's are added. No block barrier a chunk: each warpgroup reads
// only its own k atom, and a stage is freed when the eight consumer warps
// are done with it. Dynamic shared memory: 4 stages of k's, v's and q's
// two atoms (48 KB each), each consumer thread's twelve f64 column sums
// (24 KB: its registers hold the MMAs' sums) and the mbarriers, 216 KB.
constexpr int kRwRows = 64;                // node rows a staged chunk
constexpr int kRwStages = 4;
constexpr int kRwAtom = 64 * 128;          // bytes of a swizzled [64 nodes][64] bf16 atom
constexpr int kRwStage = 6 * kRwAtom;      // k's two atoms, v's two, q's two
constexpr size_t kRwSmem = kRwStages * kRwStage + kRdSums * sizeof(double) +
                           2 * kRwStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kRdThreads, 1)
la_reduce_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, long ldq, long ldk, long ldv, int N,
                       int M, int D, int rows_per_slice, int vec, float* __restrict__ kvs_part,
                       float* __restrict__ ksum_part, float* __restrict__ qsq_part,
                       float* __restrict__ ksq_part, const __grid_constant__ RdMaps maps) {
  using namespace tc;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem_raw;  // [stage][k atoms 0, 1; v atoms 0, 1; q atoms 0, 1]
  double* colsum = reinterpret_cast<double*>(ring + kRwStages * kRwStage);  // see rd_total
  uint64_t* full = reinterpret_cast<uint64_t*>(colsum + kRdSums);  // a stage has landed
  uint64_t* empty = full + kRwStages;                               // a stage is read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const RdBlock<kRwRows> blk(N, M, D, rows_per_slice);
  const int m0 = blk.m0;
  const bool k_stats = blk.k_stats, q_stats = blk.q_stats;

  if (tid == 0) {
    for (int i = 0; i < kRwStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kRdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kRdConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (warp == kRdConsumers / 32) {
      rd_produce<bf16, kRwRows, kRwStages, 2, 3>(ring, full, empty, k, v, q, ldk, ldv, ldq, M, D,
                                                 blk, q_stats ? 3 : 2, vec, lane, maps,
                                                 [](int, long) {});
    }
    return;
  }

  setmaxnreg_inc<232>();
  // acc[atom]: the block's sums of the warpgroup's 64 m rows by each
  // 64-column atom of d; part[half][atom]: a chunk half's fresh sums
  float acc[2][32], part[2][2][32];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = part[0][a][i] = part[1][a][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) colsum[i * kRdConsumers + tid] = 0.0;
  const auto at = [](int r, int c) { return (c >> 6) * kRwAtom + sw128_offset(r, c & 63); };

  for (int c = 0; c < blk.chunks; ++c) {
    const int st = c % kRwStages;
    mbar_wait(full + st, (c / kRwStages) & 1);
    unsigned char* stage = ring + st * kRwStage;
    unsigned char* k_atom = stage + wg * kRwAtom;  // the warpgroup's 64 m columns of k
    const int valid = blk.valid(c);
    if (valid < kRwRows) {  // the slice's last chunk: its k rows past the slice as zeros
      for (int i = tid & 127; i < (kRwRows - valid) * 8; i += 128) {
        *reinterpret_cast<uint4*>(k_atom + sw128_offset(valid + i / 8, (i % 8) * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      rd_warpgroup_sync(wg);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int a = 0; a < 2; ++a) wgmma_fence_operand(part[half][a]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = 2 * half + ks;  // node rows 16 kk .. 16 kk + 15 of the chunk
        const uint64_t da = sw128_desc_mn(k_atom + kk * 2048);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          wgmma_m64n64k16<1>(part[half][a], da,
                             sw128_desc_mn(stage + (2 + a) * kRwAtom + kk * 2048), ks);
        }
      }
      wgmma_commit();
    }
    // the chunk's column sums while its MMAs run
    if (k_stats || q_stats) {
      float cs[3][4];
      rd_chunk_sums<bf16, kRwRows, 8>(stage, stage + 4 * kRwAtom, warp, lane, valid, k_stats,
                                      q_stats, at, cs[0], cs[1], cs[2]);
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        if (i < 8 ? k_stats : q_stats) {
          colsum[i * kRdConsumers + tid] += static_cast<double>(cs[i / 4][i % 4]);
        }
      }
    }
    // each half's sums, in order, into the block's
    wgmma_wait<1>();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      wgmma_fence_operand(part[0][a]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = __fadd_rn(acc[a][i], part[0][a][i]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      wgmma_fence_operand(part[1][a]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = __fadd_rn(acc[a][i], part[1][a][i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  float* kp = kvs_part + static_cast<size_t>(blk.s) * M * D;
  const bool pairs = (D & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    float* row = kp + static_cast<size_t>(m) * D;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = blk.d0 + 64 * a + 8 * j + 2 * (lane & 3);
        const float x = acc[a][4 * j + 2 * h];
        const float y = acc[a][4 * j + 2 * h + 1];
        if (pairs && d + 1 < D) {
          *reinterpret_cast<float2*>(row + d) = make_float2(x, y);
        } else {
          if (d < D) row[d] = x;
          if (d + 1 < D) row[d + 1] = y;
        }
      }
  }
  rd_consumers_sync();
  if (tid < kRdTile) {  // k's sums by threads 0-127, q's by 128-255
    rd_store_col<8>(colsum, tid, m0, M, blk.s, k_stats, false, ksum_part, qsq_part, ksq_part);
  } else {
    rd_store_col<8>(colsum, tid - kRdTile, m0, M, blk.s, false, q_stats, ksum_part, qsq_part,
                    ksq_part);
  }
}

// The f32 reduce in 3xTF32 (wgmma m64n128k8 tf32 -> f32, A from registers):
// the bf16 reduce's grid, tiles, producer and column sums over 32-node
// chunks of f32 atoms ([32 nodes][32], the swizzle over f32 rows), its
// consumers tc::rd_consume_tf32 with A = k^T (split as its fragments load)
// and B = v as it is (split once a chunk into K-major tf32 hi + lo atoms).
// A stage is freed when the consumer warps and the three column-sum warps
// are done with it. Dynamic shared memory: 3 stages of k's, v's and q's
// four atoms (48 KB each), v's split hi and lo of two chunks (64 KB), the
// column-sum warps' f64 sums and the mbarriers, 217 KB.
constexpr int kRfStages = 3;
constexpr int kRfStage = 12 * kRfAtom;      // k's four atoms, v's four, q's four
constexpr int kRfSums = 3 * 4 * kRfSumWarps * 32;  // their f64 column sums (see rd_total)
constexpr size_t kRfSmem = kRfStages * kRfStage + 4 * kRfPiece + kRfSums * sizeof(double) +
                           (2 * kRfStages + 4) * sizeof(uint64_t);

__global__ void __launch_bounds__(kRdThreads, 1)
la_reduce_wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, long ldq, long ldk, long ldv, int N, int M,
                    int D, int rows_per_slice, int vec, float* __restrict__ kvs_part,
                    float* __restrict__ ksum_part, float* __restrict__ qsq_part,
                    float* __restrict__ ksq_part, const __grid_constant__ RdMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem_raw;  // [stage][k atoms 0-3; v atoms 0-3; q atoms 0-3]
  unsigned char* vsplit = ring + kRfStages * kRfStage;  // [buffer][hi, lo][128 d][32 nodes]
  double* colsum = reinterpret_cast<double*>(vsplit + 4 * kRfPiece);    // see rd_total
  uint64_t* full = reinterpret_cast<uint64_t*>(colsum + kRfSums);      // a stage has landed
  uint64_t* empty = full + kRfStages;                                   // a stage is read
  uint64_t* sfull = empty + kRfStages;  // a split buffer is written
  uint64_t* sempty = sfull + 2;         // a split buffer's MMAs are done

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const RdBlock<kRfRows> blk(N, M, D, rows_per_slice);
  const int m0 = blk.m0;
  const bool k_stats = blk.k_stats, q_stats = blk.q_stats;

  if (tid == 0) {
    for (int i = 0; i < kRfStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kRdConsumers / 32 + kRfSumWarps);  // consumer and column-sum warps
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(sfull + b, kRdConsumers / 32);
      mbar_init(sempty + b, kRdConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const auto at = [](int r, int c) { return (c >> 5) * kRfAtom + sw128_offset_f32(r, c & 31); };

  if (warp >= kRdConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    const int pw = warp - kRdConsumers / 32;
    if (pw == 0) {
      rd_produce<float, kRfRows, kRfStages, 4, 3>(ring, full, empty, k, v, q, ldk, ldv, ldq, M,
                                                  D, blk, q_stats ? 3 : 2, vec, lane, maps,
                                                  [](int, long) {});
      return;
    }
    // warps 1-3: the column sums of row group pw - 1 of every chunk, in f64
    // in shared memory (see rd_total)
    double* sums = colsum + (pw - 1) * 32 + lane;  // [quantity][e] kRfSumWarps * 32 apart
#pragma unroll
    for (int i = 0; i < 12; ++i) sums[i * kRfSumWarps * 32] = 0.0;
    for (int c = 0; c < blk.chunks; ++c) {
      const int st = c % kRfStages;
      mbar_wait(full + st, (c / kRfStages) & 1);
      if (k_stats || q_stats) {
        const unsigned char* stage = ring + st * kRfStage;
        float cs[3][4];
        rd_chunk_sums<float, kRfRows, kRfSumWarps>(stage, stage + 8 * kRfAtom, pw - 1, lane,
                                                   blk.valid(c), k_stats, q_stats, at, cs[0],
                                                   cs[1], cs[2]);
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          if (i < 8 ? k_stats : q_stats) {
            sums[i * kRfSumWarps * 32] += static_cast<double>(cs[i / 4][i % 4]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (k_stats || q_stats) {  // uniform over the block
      rd_sum_warps_sync();
      for (int col = (pw - 1) * 32 + lane; col < kRdTile; col += kRfSumWarps * 32) {
        rd_store_col<kRfSumWarps>(colsum, col, m0, M, blk.s, k_stats, q_stats, ksum_part, qsq_part,
                                  ksq_part);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  rd_consume_tf32<kRfStages, kRfStage>(ring, vsplit, full, empty, sfull, sempty, blk, M, D,
                                       kvs_part, tid, [](int, int, int, float (&)[4]) {});
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

// The f32 apply on warpgroup MMAs in 3xTF32 (wgmma m64n64k8 tf32, A from
// registers), warp-specialised and fed by the copy engine (TMA). grid
// (ceil(N / 128)), 128 rows a block, one block an SM: two consumer
// warpgroups of 64 rows and a producer warpgroup, which gives its
// registers to the consumers (setmaxnreg). Dynamic shared memory,
// 1024-byte aligned (no static shared memory, so the dynamic block starts
// the block's window), every tile 128-byte swizzled over f32 rows of 32
// (tc::sw128_offset_f32): the q rows as ka = ceil(M / 32) atoms of [128
// rows][32] (16 KB each, 128 KB at M = 256), staged once; a ring of
// kAwStages chunks of kvs^T, each a [64 n][32 k] atom of its tf32 hi and of
// its lo piece (8 KB each; laid out swizzled by tc::split_kvs_kernel,
// column tile by column tile, so that one bulk copy moves a piece's
// chunk); the v / out tile [128][64] (two atoms); den per row; mbarriers.
// 225 KB at M = 256.
//
// The producer warpgroup: warp 0's lane 0 brings the q atoms by a tensor
// map, each on a barrier of its own, interleaved with the first chunks of
// kvs^T, and then every chunk by bulk copies as the consumers free its
// stage (full and empty mbarriers); warp 1 brings each column tile's v
// rows by a tensor map into the v / out tile once the last tile's output
// has left it; warps 2 and 3 form den = inv * (q . ksum) + n of the
// block's rows from the staged q rows (an f32 FMA chain in column order, a
// zero den taken as 1 under the guard). Where the rows' strides or bases
// do not allow a tensor map (vec_q, vec_v 0), warps 2-3 copy the q rows and
// warp 1 the v rows one element a lane at a time.
//
// The consumers run the chunks of every 64-column tile of a = q @ kvs as
// one stream, the 3xTF32 MMAs of the f32 row kernels: each warp's A
// fragments, 16 rows, are loaded from the q atoms as they are needed (plain
// 32-bit loads; the swizzle puts the 32 addresses of a fragment in distinct
// banks) and split into tf32 hi + lo in registers, each product lo*hi' +
// hi*lo' + hi*hi', and every 16 deep (kWgPeriod) the MMAs start fresh sums
// that are added to the tile's sums in f32 round-to-nearest. A chunk's two
// periods are double-buffered, so that the second's MMAs run while the
// warps fold the first's sums; its MMAs are drained before its stage is
// freed, and a finished column tile gets its epilogue: out = (inv * a + n *
// v) / den at each lane's fragment, in the v / out tile in place (the
// division by the row's reciprocal, tc::div_by), stored by the copy engine,
// which clips it to the output (vec_o), or by the warps' own stores. On the
// H100 (PERF.md §6) periods pipelined across chunks made ptxas
// serialise the MMAs (0.497 ms at arxiv against 0.436), and one chain of
// tensor-core sums over the whole depth gained 5 % but came 5x nearer the
// f32 tolerance where q @ kvs carries the output.
constexpr int kAwConsumers = 2 * 128;
constexpr int kAwThreads = kAwConsumers + 128;  // and the producer warpgroup
constexpr int kAwStages = 4;
constexpr int kAwAtom = tc::kTcRows * 128;  // bytes of a [128][32] f32 atom of q or v / out
constexpr int kAwPiece = tc::kKvsPiece;     // bytes of a [64 n][32 k] atom of kvs^T
constexpr int kAwStage = 2 * kAwPiece;       // a chunk's hi and lo atoms

__host__ __device__ constexpr int apply_k_atoms(int M) { return tc::cdiv(M, 32); }

size_t apply_wg_smem_bytes(int M) {
  const int ka = apply_k_atoms(M);
  return static_cast<size_t>(ka) * kAwAtom + static_cast<size_t>(kAwStages) * kAwStage +
         2 * kAwAtom + tc::kTcRows * sizeof(float) +
         (ka + 2 * kAwStages + 3) * sizeof(uint64_t);
}

// the apply's tensor maps: q, v and out rows in [128][32] f32 boxes
struct AwMaps {
  CUtensorMap q, v, out;
};

// the consumers' own barrier (the producer warpgroup has left)
__device__ __forceinline__ void aw_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kAwConsumers) : "memory");
}

__global__ void __launch_bounds__(kAwThreads, 1)
la_apply_wg_kernel(const float* __restrict__ q, const float* __restrict__ v, long ldq, long ldv,
                   float* __restrict__ out, long ldo, int N, int M, int D,
                   const float* __restrict__ hl, const float* __restrict__ ksum,
                   const float* __restrict__ scal, const float* __restrict__ n_total, int guard,
                   int vec_q, int vec_v, int vec_o, const __grid_constant__ AwMaps maps) {
  using namespace tc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const int ka = apply_k_atoms(M);
  const int tiles = cdiv(D, kTcCols);
  const int chunks = tiles * ka;
  unsigned char* Qs = smem_raw;                                          // [ka][128][32]
  unsigned char* Bs = Qs + static_cast<size_t>(ka) * kAwAtom;            // [stage][hi, lo]
  unsigned char* Vs = Bs + static_cast<size_t>(kAwStages) * kAwStage;    // [2][128][32]
  float* den_s = reinterpret_cast<float*>(Vs + 2 * kAwAtom);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(den_s + kTcRows);  // a q atom has landed
  uint64_t* full = qbar + ka;                                     // a stage has landed
  uint64_t* empty = full + kAwStages;                             // a stage's MMAs are done
  uint64_t* vfull = empty + kAwStages;                            // a v tile has landed
  uint64_t* vempty = vfull + 1;                                   // a tile has left the buffer
  uint64_t* denbar = vempty + 1;                                  // den is in den_s

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long r0 = static_cast<long>(blockIdx.x) * kTcRows;

  if (tid == 0) {
    for (int c = 0; c < ka; ++c) mbar_init(qbar + c, vec_q ? 1 : 2);
    for (int i = 0; i < kAwStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kAwConsumers / 32);
    }
    mbar_init(vfull, 1);
    mbar_init(vempty, 1);
    mbar_init(denbar, 2);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kAwConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    const int pw = warp - kAwConsumers / 32;
    if (pw == 0) {
      if (lane == 0) {
        // chunk ch into its stage, once the consumers have freed it
        auto load_b = [&](int ch) {
          const int st = ch % kAwStages;
          if (ch >= kAwStages) mbar_wait(empty + st, (ch / kAwStages - 1) & 1);
          mbar_arrive_expect_tx(full + st, kAwStage);
          const float* src = hl + static_cast<size_t>(ch) * 2 * (kAwPiece / sizeof(float));
          unsigned char* dst = Bs + st * kAwStage;
          bulk_copy_g2s(dst, src, kAwPiece, full + st);
          bulk_copy_g2s(dst + kAwPiece, src + kAwPiece / sizeof(float), kAwPiece, full + st);
        };
        int ch = 0;
        if (vec_q) {  // the q atoms, the first chunks between them
          for (int c = 0; c < ka; ++c) {
            mbar_arrive_expect_tx(qbar + c, kAwAtom);
            tma_load_2d(Qs + c * kAwAtom, &maps.q, 32 * c, static_cast<int>(r0), qbar + c);
            if (ch < kAwStages && ch < chunks) load_b(ch++);
          }
        }
        for (; ch < chunks; ++ch) load_b(ch);
      }
    } else if (pw == 1) {  // each column tile's v rows, once the last tile has left
      for (int t = 0; t < tiles; ++t) {
        if (t > 0) mbar_wait(vempty, (t - 1) & 1);
        if (vec_v) {
          if (lane == 0) {
            mbar_arrive_expect_tx(vfull, 2 * kAwAtom);
            for (int h = 0; h < 2; ++h) {
              tma_load_2d(Vs + h * kAwAtom, &maps.v, kTcCols * t + 32 * h, static_cast<int>(r0),
                          vfull);
            }
          }
        } else {
          for (int i = lane; i < kTcRows * kTcCols; i += 32) {
            const int r = i / kTcCols;
            const int c = i % kTcCols;
            const int col = kTcCols * t + c;
            *reinterpret_cast<float*>(Vs + (c >> 5) * kAwAtom + sw128_offset_f32(r, c & 31)) =
                r0 + r < N && col < D ? v[(r0 + r) * ldv + col] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(vfull);
        }
      }
    } else {  // warps 2 and 3: the q rows where no tensor map reads them, then den
      const int i0 = tid - kAwConsumers - 64;  // 0 .. 63
      if (!vec_q) {
        for (int c = 0; c < ka; ++c) {
          for (int i = i0; i < kTcRows * 32; i += 64) {
            const int r = i >> 5;
            const int col = 32 * c + (i & 31);
            *reinterpret_cast<float*>(Qs + c * kAwAtom + sw128_offset_f32(r, i & 31)) =
                r0 + r < N && col < M ? q[(r0 + r) * ldq + col] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(qbar + c);
        }
      }
      for (int c = 0; c < ka; ++c) mbar_wait(qbar + c, 0);
      const float inv = scal[2];
      const float n = *n_total;
      for (int r = i0; r < kTcRows; r += 64) {
        float b = 0.f;
        for (int c = 0; c < M; ++c) {
          const float x =
              *reinterpret_cast<const float*>(Qs + (c >> 5) * kAwAtom + sw128_offset_f32(r, c & 31));
          b = fmaf(x, __ldg(ksum + c), b);
        }
        const float den = inv * b + n;
        den_s[r] = guard && den == 0.f ? 1.f : den;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(denbar);
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<232>();
  constexpr int kSteps = kWgPeriod / 8;  // k8 steps a period: two periods a 32-deep chunk
  static_assert(kSteps * 2 * 8 == 32, "two periods an atom");
  const float inv = scal[2];
  const float n = *n_total;
  const int g = lane >> 2;
  // the lane's fragment rows 16 * warp + g (+ 8) at k = lane % 4 (+ 4) of each k8 step
  const int a_off = (16 * warp + g) * 128 + (lane & 3) * 4;
  const int g16 = g << 4;  // the swizzle of the rows' 16-byte chunks
  float acc[32], part[2][32];
  unsigned ah[2][kSteps][4], al[2][kSteps][4];
  float den_r[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[0][i] = part[1][i] = 0.f;

  // the A fragments of period p of k atom kc, as tf32 hi + lo
  auto load_a = [&](unsigned (&h)[kSteps][4], unsigned (&l)[kSteps][4], int kc, int p) {
    const unsigned char* a = Qs + kc * kAwAtom + a_off;
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
      wgmma_m64n64k8_tf32(d, l[ks], sw128_desc(b), ks);                 // lo*hi', fresh first
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b + kAwPiece), 1);       // hi*lo'
      wgmma_m64n64k8_tf32(d, h[ks], sw128_desc(b), 1);                  // hi*hi'
    }
    wgmma_commit();
  };
  auto fold = [&](float (&d)[32]) {
    wgmma_fence_operand(d);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
  };
  int stored = -1;  // the chunk whose epilogue's store has yet to leave the tile
  // the store of the last column tile has read the v / out tile: free it
  auto release = [&]() {
    if (tid == 0) {
      bulk_store_wait_read();
      mbar_arrive(vempty);
    }
    stored = -1;
  };
  // column tile t's epilogue from acc, at each lane's fragment
  auto epilogue = [&](int t, int ch) {
    mbar_wait(vfull, t & 1);
    if (t == 0) {
      mbar_wait(denbar, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) den_r[h] = den_s[16 * warp + g + 8 * h];
    }
    float rden[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rden[h] = __frcp_rn(den_r[h]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2* p = reinterpret_cast<float2*>(
            Vs + (j >> 2) * kAwAtom + sw128_offset_f32(16 * warp + g + 8 * h,
                                                       8 * (j & 3) + 2 * (lane & 3)));
        const float2 x = *p;
        *p = make_float2(div_by(inv * acc[4 * j + 2 * h] + n * x.x, den_r[h], rden[h]),
                         div_by(inv * acc[4 * j + 2 * h + 1] + n * x.y, den_r[h], rden[h]));
      }
    fence_proxy_async();  // the tile's next writer may be the copy engine
    const int c0 = kTcCols * t;
    if (vec_o) {  // the tile out by the copy engine, clipped to the output
      aw_consumers_sync();
      if (tid == 0) {
        for (int h = 0; h < 2; ++h) {
          tma_store_2d(&maps.out, c0 + 32 * h, static_cast<int>(r0), Vs + h * kAwAtom);
        }
        bulk_store_commit();
      }
      stored = ch;
    } else {  // the warp's own 16 rows
      __syncwarp();
      for (int i = lane; i < 16 * kTcCols; i += 32) {
        const int r = 16 * warp + i / kTcCols;
        const int c = i % kTcCols;
        const long row = r0 + r;
        if (row < N && c0 + c < D) {
          out[row * ldo + c0 + c] = *reinterpret_cast<const float*>(
              Vs + (c >> 5) * kAwAtom + sw128_offset_f32(r, c & 31));
        }
      }
      fence_proxy_async();
      aw_consumers_sync();
      if (tid == 0) mbar_arrive(vempty);
    }
  };

  for (int ch = 0; ch < chunks; ++ch) {
    const int kc = ch % ka;
    const int st = ch % kAwStages;
    mbar_wait(full + st, (ch / kAwStages) & 1);
    if (ch < ka) mbar_wait(qbar + kc, 0);
    fence_proxy_async();
    const unsigned char* Bh = Bs + st * kAwStage;
    load_a(ah[0], al[0], kc, 0);
    issue(part[0], ah[0], al[0], Bh, 0);
    if (stored >= 0 && ch > stored) release();
    load_a(ah[1], al[1], kc, 1);
    issue(part[1], ah[1], al[1], Bh, 1);
    wgmma_wait<1>();  // the first period is done
    fold(part[0]);
    wgmma_wait<0>();
    fold(part[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (kc == ka - 1) {  // the column tile is done
      epilogue(ch / ka, ch);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
  }
  if (vec_o && tid == 0) bulk_store_wait_read();
}

// The bf16 apply on warpgroup MMAs (wgmma m64n64k16 bf16, f32 sums, both
// operands read through descriptors), warp-specialised, fed by the copy
// engine (TMA) and persistent: grid min(ceil(N / 128), SMs), one block an
// SM, block b taking the 128-row blocks b, b + grid, ... in turn. It
// replaces sgformer_tpu/kernels/attention.py::_apply_kernel for bf16 rows;
// bound by bytes (q and v read once, out written once: 0.078 ms at the
// arxiv shape). Two consumer warpgroups of 64 rows and a producer
// warpgroup, which gives registers to the consumers (setmaxnreg: 72 a
// producer thread, under 56 its loops spilled; without setmaxnreg, 168
// each, the kernel ran 12 % slower).
// Dynamic shared memory, 1024-byte aligned (no static shared memory, so the
// dynamic block starts the block's window), every tile 128-byte swizzled
// ([rows][64] bf16): qbufs buffers of a row block's q rows (kt = ceil(M /
// 64) k-tiles of [128][64], 64 KB at M = 256) and their den; a ring of
// `stages` chunks of kvs^T, each its bf16 hi and lo [64 n][64 k] (8 KB
// each; laid out swizzled by tc::split_kvs_kernel<bf16>, column tile by
// column tile, so that one 16 KB bulk copy moves a chunk); vbufs v / out
// tiles [128][64]; mbarriers. apply_wgmma_layout picks (qbufs, stages,
// vbufs) by what fits beside the q tile: (2, 4, 2) up to M = 256 (225 KB),
// (1, 2, 1) for wider rows up to M = 704.
//
// The producer warpgroup: warp 0's lane 0 brings each row block's q rows by
// a tensor map into the next q buffer (with two buffers the next row
// block's q is issued once the first stages of this one's chunks are, so
// that it lands under this row block's MMAs) and every chunk of kvs^T by a
// bulk copy as the consumers free its stage (full and empty mbarriers);
// warp 1 brings each column tile's v rows by a tensor map into the next v /
// out tile once the tile's last output has left it; warps 2-3 form den =
// inv * (q . ksum) + n of each row block's rows from its staged q rows,
// ahead of the consumers (the code the kernel this replaced ran on its MMA
// warps, 16 rows a warp, 8 columns a lane, f32 FMAs added by a fixed xor
// tree), and where the rows' strides or bases do not allow a tensor map
// (vec_q, vec_v 0) copy the q rows, as warp 1 then copies the v rows, one
// element a lane at a time. The consumers keep that kernel's arithmetic, so
// that the output is bitwise its: each chunk's 8 MMAs (4 k16 steps, hi then
// lo into one accumulator that starts at zero a column tile), and out =
// (inv * a + n * v) / den at each lane's fragment, the numerator fused as
// it was, the division correctly rounded through the row's reciprocal
// (tc::div_by, where an IEEE division a element cost ~10 instructions and a
// branch), rounded to bf16 once. A chunk's MMAs stay in flight while the
// next chunk's are issued (its stage freed once they are done:
// wgmma.wait_group 1); a finished column tile is written in place into its
// v / out tile and stored by the copy engine, which clips it to the output
// (vec_o), or by the warps' own stores, its tile handed back at the next
// chunk once the store has read it. (Copies issued by
// the warps that ran the MMAs, one barrier a chunk across the block, den
// and an IEEE division an element on the MMA warps held that kernel at 2.8x
// its bound: PERF.md.)
constexpr int kAbConsumers = 2 * 128;
constexpr int kAbThreads = kAbConsumers + 128;  // and the producer warpgroup
constexpr int kAbStage = 2 * kWgTile;           // a chunk's hi and lo [64][64]

size_t apply_wgmma_smem(int M, int qbufs, int stages, int vbufs) {
  return static_cast<size_t>(qbufs) * (tc::split_pad(M) / 64) * kWgKTile +
         static_cast<size_t>(stages) * kAbStage + static_cast<size_t>(vbufs) * kWgKTile +
         static_cast<size_t>(qbufs) * kApplyRows * sizeof(float) +
         (3 * qbufs + 2 * stages + 2 * vbufs) * sizeof(uint64_t);
}

// The layout at this width: (qbufs, stages, vbufs) = (2, 4, 2) where it fits
// one block's shared memory (M up to 256), else (1, 2, 1) (no path runs the
// wider rows, so no layout between was kept untimed); false where neither
// fits (M above 704).
bool apply_wgmma_layout(int M, int& qbufs, int& stages, int& vbufs) {
  static constexpr int kLayouts[2][3] = {{2, 4, 2}, {1, 2, 1}};
  for (const auto& p : kLayouts) {
    if (apply_wgmma_smem(M, p[0], p[1], p[2]) <= tc::kSmemPerBlock) {
      qbufs = p[0];
      stages = p[1];
      vbufs = p[2];
      return true;
    }
  }
  return false;
}

// the bf16 apply's tensor maps: q, v and out rows in [128][64] bf16 boxes
struct AbMaps {
  CUtensorMap q, v, out;
};

__global__ void __launch_bounds__(kAbThreads, 1)
la_apply_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v,
                      long ldq, long ldv, __nv_bfloat16* __restrict__ out, long ldo, int N, int M,
                      int D, const __nv_bfloat16* __restrict__ hl, const float* __restrict__ ksum,
                      const float* __restrict__ scal, const float* __restrict__ n_total, int guard,
                      int vec_q, int vec_v, int vec_o, int qbufs, int stages, int vbufs,
                      const __grid_constant__ AbMaps maps) {
  using namespace tc;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
  const int kt = split_pad(M) / 64;  // q's k-tiles and a column tile's chunks
  const int tiles = cdiv(D, 64);
  const int per = kt * tiles;  // chunks a row block
  const int rbs = cdiv(N, kApplyRows);
  unsigned char* Qs = smem_raw;                                          // [qbufs][kt][128][64]
  unsigned char* Bs = Qs + static_cast<size_t>(qbufs) * kt * kWgKTile;   // [stage][hi, lo]
  unsigned char* Vs = Bs + static_cast<size_t>(stages) * kAbStage;       // [vbufs][128][64]
  float* den_s = reinterpret_cast<float*>(Vs + static_cast<size_t>(vbufs) * kWgKTile);  // [qbufs][128]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(den_s + qbufs * kApplyRows);  // q has landed
  uint64_t* qempty = qfull + qbufs;        // a row block's q and den are read
  uint64_t* dfull = qempty + qbufs;        // its den is in den_s
  uint64_t* full = dfull + qbufs;          // a stage has landed
  uint64_t* empty = full + stages;         // a stage's MMAs are done
  uint64_t* vfull = empty + stages;        // a v tile has landed
  uint64_t* vempty = vfull + vbufs;        // a tile has left its buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int b = 0; b < qbufs; ++b) {
      mbar_init(qfull + b, vec_q ? 1 : 2);
      mbar_init(qempty + b, kAbConsumers / 32);
      mbar_init(dfull + b, 2);
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kAbConsumers / 32);
    }
    for (int b = 0; b < vbufs; ++b) {
      mbar_init(vfull + b, 1);
      mbar_init(vempty + b, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kAbConsumers / 32) {  // the producer warpgroup
    setmaxnreg_dec<72>();
    const int pw = warp - kAbConsumers / 32;
    if (pw == 0) {
      if (lane == 0) {
        // row block rb, the block's i-th, into q buffer i % qbufs once the
        // row block qbufs back has freed it
        auto load_q = [&](int i, int rb) {
          const int b = i % qbufs;
          if (i >= qbufs) mbar_wait(qempty + b, (i / qbufs - 1) & 1);
          mbar_arrive_expect_tx(qfull + b, kt * kWgKTile);
          for (int c = 0; c < kt; ++c) {
            tma_load_2d(Qs + static_cast<size_t>(b * kt + c) * kWgKTile, &maps.q, 64 * c,
                        rb * kApplyRows, qfull + b);
          }
        };
        int ch = 0;  // chunks issued
        // a row block's chunk cc (column tile cc / kt, k-tile cc % kt) into
        // its stage, once the consumers have freed it
        auto load_b = [&](int cc) {
          const int st = ch % stages;
          if (ch >= stages) mbar_wait(empty + st, (ch / stages - 1) & 1);
          mbar_arrive_expect_tx(full + st, kAbStage);
          bulk_copy_g2s(Bs + st * kAbStage, hl + static_cast<size_t>(cc) * (kAbStage / 2),
                        kAbStage, full + st);
          ++ch;
        };
        // the next row block's q after this chunk of the row block: after
        // the first stages' with two buffers, else after the last (its
        // buffer is this row block's)
        const int q_at = qbufs > 1 ? min(stages, per) - 1 : per - 1;
        if (vec_q && static_cast<int>(blockIdx.x) < rbs) load_q(0, blockIdx.x);
        int i = 0;
        for (int rb = blockIdx.x; rb < rbs; rb += gridDim.x, ++i) {
          for (int cc = 0; cc < per; ++cc) {
            load_b(cc);
            if (cc == q_at && vec_q && rb + static_cast<int>(gridDim.x) < rbs) {
              load_q(i + 1, rb + gridDim.x);
            }
          }
        }
      }
    } else if (pw == 1) {  // each column tile's v rows, once the tile's last output has left
      int T = 0;
      for (int rb = blockIdx.x; rb < rbs; rb += gridDim.x) {
        const long r0 = static_cast<long>(rb) * kApplyRows;
        for (int t = 0; t < tiles; ++t, ++T) {
          const int b = T % vbufs;
          if (T >= vbufs) mbar_wait(vempty + b, (T / vbufs - 1) & 1);
          unsigned char* dst = Vs + static_cast<size_t>(b) * kWgKTile;
          if (vec_v) {
            if (lane == 0) {
              mbar_arrive_expect_tx(vfull + b, kWgKTile);
              tma_load_2d(dst, &maps.v, 64 * t, static_cast<int>(r0), vfull + b);
            }
          } else {
            for (int i = lane; i < kApplyRows * 64; i += 32) {
              const int r = i >> 6;
              const int col = 64 * t + (i & 63);
              *reinterpret_cast<bf16*>(dst + sw128_offset(r, i & 63)) =
                  r0 + r < N && col < D ? v[(r0 + r) * ldv + col] : __float2bfloat16_rn(0.f);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(vfull + b);
          }
        }
      }
    } else {  // warps 2 and 3: the q rows where no tensor map reads them, then den
      const int w2 = pw - 2;
      const int i0 = tid - kAbConsumers - 64;  // 0 .. 63
      const int Mk = kt * 64;
      const float inv = scal[2];
      const float n = *n_total;
      int i = 0;
      for (int rb = blockIdx.x; rb < rbs; rb += gridDim.x, ++i) {
        const int b = i % qbufs;
        unsigned char* Qb = Qs + static_cast<size_t>(b) * kt * kWgKTile;
        if (!vec_q) {
          if (i >= qbufs) mbar_wait(qempty + b, (i / qbufs - 1) & 1);
          const long r0 = static_cast<long>(rb) * kApplyRows;
          for (int e = i0; e < kApplyRows * Mk; e += 64) {
            const int r = e / Mk;
            const int c = e % Mk;
            *reinterpret_cast<bf16*>(Qb + (c >> 6) * kWgKTile + sw128_offset(r, c & 63)) =
                r0 + r < N && c < M ? q[(r0 + r) * ldq + c] : __float2bfloat16_rn(0.f);
          }
          fence_proxy_async();  // read by the MMAs
          __syncwarp();
          if (lane == 0) mbar_arrive(qfull + b);
        }
        mbar_wait(qfull + b, (i / qbufs) & 1);
        // den = inv * (q . ksum) + n of the row block's 16-row groups w2,
        // w2 + 2, ..., 8 columns a lane (16-byte reads), four rows at once,
        // f32 FMAs in column order added by a fixed xor tree (the kernel
        // this replaced ran the same code on the MMA warps)
        float* den_b = den_s + b * kApplyRows;
        for (int grp = w2; grp < kApplyRows / 16; grp += 2) {
          for (int r4 = 0; r4 < 16; r4 += 4) {
            float acc4[4] = {0.f, 0.f, 0.f, 0.f};
            for (int c = lane * 8; c < Mk; c += 256) {
              float ks[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) ks[e] = c + e < M ? __ldg(ksum + c + e) : 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint4 raw = *reinterpret_cast<const uint4*>(
                    Qb + (c >> 6) * kWgKTile + sw128_offset(grp * 16 + r4 + j, c & 63));
                const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float2 x = __bfloat1622float2(h[e]);
                  acc4[j] = fmaf(x.x, ks[2 * e], acc4[j]);
                  acc4[j] = fmaf(x.y, ks[2 * e + 1], acc4[j]);
                }
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc4[j] += __shfl_xor_sync(0xffffffffu, acc4[j], off);
            if (lane < 4) {  // lane j writes row r4 + j
              const float bj = lane == 0 ? acc4[0] : lane == 1 ? acc4[1] : lane == 2 ? acc4[2]
                                                                                : acc4[3];
              const float den = inv * bj + n;
              den_b[grp * 16 + r4 + lane] = guard && den == 0.f ? 1.f : den;
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(dfull + b);
      }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<216>();
  const float inv = scal[2];
  const float n = *n_total;
  float acc[32];
  float den_r[2] = {1.f, 1.f};  // den of the lane's two fragment rows, and its reciprocal
  float rden[2] = {1.f, 1.f};
  int ch = 0;                   // chunks consumed
  int T = 0;                    // column tiles finished
  int stored = -1;              // the v / out buffer whose store has yet to read it
  // the store of the last tile has read its buffer: free it
  auto release = [&]() {
    if (tid == 0) {
      bulk_store_wait_read();
      mbar_arrive(vempty + stored);
    }
    stored = -1;
  };
  int i = 0;
  for (int rb = blockIdx.x; rb < rbs; rb += gridDim.x, ++i) {
    const long r0 = static_cast<long>(rb) * kApplyRows;
    const int qb = i % qbufs;
    const unsigned char* Qb = Qs + static_cast<size_t>(qb) * kt * kWgKTile;
    mbar_wait(qfull + qb, (i / qbufs) & 1);
    for (int t = 0; t < tiles; ++t, ++T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int kc = 0; kc < kt; ++kc, ++ch) {
        const int st = ch % stages;
        mbar_wait(full + st, (ch / stages) & 1);
        wgmma_fence_operand(acc);
        wgmma_fence();
        const unsigned char* a_tile = Qb + kc * kWgKTile + (warp >> 2) * kWgTile;
        const unsigned char* b_tile = Bs + st * kAbStage;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t da = sw128_desc(a_tile + ks * 32);
          wgmma_m64n64k16(acc, da, sw128_desc(b_tile + ks * 32));
          wgmma_m64n64k16(acc, da, sw128_desc(b_tile + kWgTile + ks * 32));
        }
        wgmma_commit();
        if (stored >= 0) release();
        if (kc > 0) {  // the last chunk's MMAs are done: free its stage
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + (ch - 1) % stages);
        }
      }
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (ch - 1) % stages);
      // the column tile's epilogue at each lane's fragment, in its v / out tile in place
      const int vb = T % vbufs;
      unsigned char* Vb = Vs + static_cast<size_t>(vb) * kWgKTile;
      if (t == 0) {
        mbar_wait(dfull + qb, (i / qbufs) & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          den_r[h] = den_s[qb * kApplyRows + warp * 16 + (lane >> 2) + 8 * h];
          rden[h] = __frcp_rn(den_r[h]);
        }
      }
      // the row block's q and den are read (den only once warps 2-3 have
      // left q: dfull): free both for the row block qbufs on
      if (t == tiles - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(qempty + qb);
      }
      mbar_wait(vfull + vb, (T / vbufs) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162* p =
              reinterpret_cast<__nv_bfloat162*>(Vb + sw128_offset(r, 8 * j + 2 * (lane & 3)));
          const float2 x = __bfloat1622float2(*p);
          // (inv * a + n * v) / den, the numerator fused as the kernel this
          // replaced fused it, the division correctly rounded by the row's
          // reciprocal (div_by)
          const float n0 = __fmaf_rn(inv, acc[4 * j + 2 * h], __fmul_rn(n, x.x));
          const float n1 = __fmaf_rn(inv, acc[4 * j + 2 * h + 1], __fmul_rn(n, x.y));
          *p = __floats2bfloat162_rn(div_by(n0, den_r[h], rden[h]),
                                     div_by(n1, den_r[h], rden[h]));
        }
      }
      const int c0 = 64 * t;
      if (vec_o) {  // the tile out by the copy engine, clipped to the output
        fence_proxy_async();
        aw_consumers_sync();
        if (tid == 0) {
          tma_store_2d(&maps.out, c0, static_cast<int>(r0), Vb);
          bulk_store_commit();
        }
        stored = vb;
      } else {  // the warp's own 16 rows
        __syncwarp();
        for (int e = lane; e < 16 * 64; e += 32) {
          const int r = warp * 16 + (e >> 6);
          const int c = e & 63;
          const long row = r0 + r;
          if (row < N && c0 + c < D) {
            out[row * ldo + c0 + c] = *reinterpret_cast<const bf16*>(Vb + sw128_offset(r, c));
          }
        }
        aw_consumers_sync();
        if (tid == 0) mbar_arrive(vempty + vb);
      }
    }
  }
  if (vec_o && tid == 0) bulk_store_wait_read();
}

// Elements of the input type of the tensor-core apply's scratch (kvs^T as
// hi + lo: bf16 pieces, or tf32 pieces held in f32), or 0 where the apply
// runs on the CUDA cores: an M whose q tile does not fit one block's shared
// memory beside the kvs stages (above 704 in bf16, 256 in f32).
int apply_scratch(int dtype, int M, int D) {
  if (dtype == 1) {
    int qbufs, stages, vbufs;
    if (!apply_wgmma_layout(M, qbufs, stages, vbufs)) return 0;
    return static_cast<int>(tc::split_kvs_elems<__nv_bfloat16>(M, D));
  }
  if (dtype == 0 && apply_wg_smem_bytes(M) <= tc::kSmemPerBlock) {
    return static_cast<int>(tc::split_kvs_elems<float>(M, D));
  }
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
// scal [4] = (qsq, ksq, inv, 0). Both types run on warpgroup MMAs at every
// width (bf16: la_reduce_wgmma_kernel; f32: la_reduce_wg_kernel, 3xTF32),
// then la_finish_kernel and la_scalars_kernel. Returns the first
// cudaError_t of the launches, each checked as it is made.
extern "C" int sgf_la_reduce(const void* q, const void* k, const void* v, long ldq, long ldk,
                             long ldv, int N, int M, int D, int dtype, int slices,
                             int rows_per_slice, int guard, float* kvs_part, float* ksum_part,
                             float* qsq_part, float* ksq_part, float* kvs, float* ksum,
                             float* scal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // tensor maps where the copy engine can read the rows (16-byte aligned
  // bases and row strides; it clips the widths), else the producer's lanes
  // copy them
  const int per = dtype == 0 ? 4 : 8;
  const bool vec = ldq % per == 0 && ldk % per == 0 && ldv % per == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  RdMaps maps = {};
  cudaError_t err;
  if (vec) {
    const CUtensorMapDataType type =
        dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const int elem = dtype == 0 ? 4 : 2;
    const int box_cols = 128 / elem;  // one 128-byte swizzle row
    const int box_rows = dtype == 0 ? kRfRows : kRwRows;
    struct Rows { CUtensorMap* map; const void* base; int width; long ld; };
    const Rows rows[3] = {{&maps.c, q, M, ldq}, {&maps.a, k, M, ldk}, {&maps.b, v, D, ldv}};
    for (const Rows& r : rows) {
      err = tc::encode_rows_map(r.map, r.base, type, elem, N, r.width, r.ld, box_cols, box_rows);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int blocks = slices * tc::cdiv(M, kRdTile) * tc::cdiv(D, kRdTile);
  if (dtype == 0) {
    err = cudaFuncSetAttribute(la_reduce_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kRfSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    la_reduce_wg_kernel<<<blocks, kRdThreads, kRfSmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        ldq, ldk, ldv, N, M, D, rows_per_slice, static_cast<int>(vec), kvs_part, ksum_part,
        qsq_part, ksq_part, maps);
  } else {
    using bf16 = __nv_bfloat16;
    err = cudaFuncSetAttribute(la_reduce_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kRwSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    la_reduce_wgmma_kernel<<<blocks, kRdThreads, kRwSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        ldq, ldk, ldv, N, M, D, rows_per_slice, static_cast<int>(vec), kvs_part, ksum_part,
        qsq_part, ksq_part, maps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t MD = static_cast<size_t>(M) * D;
  const unsigned fin_blocks = static_cast<unsigned>((MD + kThreads - 1) / kThreads);
  la_finish_kernel<<<fin_blocks, kThreads, 0, st>>>(kvs_part, ksum_part, slices, M, D, kvs,
                                                    ksum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  la_scalars_kernel<<<1, kThreads, 0, st>>>(qsq_part, ksq_part, slices * M, guard, scal);
  return static_cast<int>(cudaGetLastError());
}

// The scratch (elements of the input type) of the tensor-core apply for
// these widths, or 0 where the apply runs on the CUDA cores (M above 704 in
// bf16, above 256 in f32).
extern "C" int sgf_la_apply_scratch(int dtype, int M, int D) {
  return apply_scratch(dtype, M, D);
}

// out may be a row-strided view (ldo); n_total is a device float scalar.
// hl: the scratch of sgf_la_apply_scratch elements of the input type where
// that is not 0 (the tensor-core designs: tc::split_kvs_kernel<bf16>, then
// la_apply_wgmma_kernel for bf16; tc::split_kvs_kernel<float>, then
// la_apply_wg_kernel for f32), else unused (la_apply_kernel).
extern "C" int sgf_la_apply(const void* q, const void* v, long ldq, long ldv, void* out,
                            long ldo, int N, int M, int D, int dtype, const float* kvs,
                            const float* ksum, const float* scal, const float* n_total,
                            int guard, void* hl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tensor_cores = apply_scratch(dtype, M, D) > 0;
  if (tensor_cores && dtype == 1) {
    using bf16 = __nv_bfloat16;
    bf16* h = static_cast<bf16*>(hl);
    cudaError_t err = tc::launch_split_kvs(kvs, M, D, h, st);
    if (err != cudaSuccess || N == 0) return static_cast<int>(err);
    // tensor maps where the copy engine can read the rows (16-byte aligned
    // bases and row strides), else left empty
    const int vec_q = ldq % 8 == 0 && aligned16(q);
    const int vec_v = ldv % 8 == 0 && aligned16(v);
    const int vec_o = ldo % 8 == 0 && aligned16(out);
    AbMaps maps = {};
    struct Rows { CUtensorMap* map; const void* base; int width; long ld; int want; };
    const Rows rows[3] = {{&maps.q, q, M, ldq, vec_q}, {&maps.v, v, D, ldv, vec_v},
                          {&maps.out, out, D, ldo, vec_o}};
    for (const Rows& r : rows) {
      if (!r.want) continue;
      err = tc::encode_rows_map(r.map, r.base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), N,
                                r.width, r.ld, 64, kApplyRows);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int qbufs, stages, vbufs;
    apply_wgmma_layout(M, qbufs, stages, vbufs);
    const size_t smem = apply_wgmma_smem(M, qbufs, stages, vbufs);
    err = cudaFuncSetAttribute(la_apply_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = tc::sm_count(sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = std::min(tc::cdiv(N, kApplyRows), sms);
    la_apply_wgmma_kernel<<<blocks, kAbThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(v), ldq, ldv,
        static_cast<bf16*>(out), ldo, N, M, D, h, ksum, scal, n_total, guard, vec_q, vec_v,
        vec_o, qbufs, stages, vbufs, maps);
    return static_cast<int>(cudaGetLastError());
  }
  if (tensor_cores) {  // dtype 0: f32 in 3xTF32
    float* h = static_cast<float*>(hl);
    cudaError_t err = tc::launch_split_kvs(kvs, M, D, h, st);
    if (err != cudaSuccess || N == 0) return static_cast<int>(err);
    // tensor maps where the copy engine can read the rows (16-byte aligned
    // bases and row strides), else left empty
    const int vec_q = ldq % 4 == 0 && aligned16(q);
    const int vec_v = ldv % 4 == 0 && aligned16(v);
    const int vec_o = ldo % 4 == 0 && aligned16(out);
    AwMaps maps = {};
    struct Rows { CUtensorMap* map; const void* base; int width; long ld; int want; };
    const Rows rows[3] = {{&maps.q, q, M, ldq, vec_q}, {&maps.v, v, D, ldv, vec_v},
                          {&maps.out, out, D, ldo, vec_o}};
    for (const Rows& r : rows) {
      if (!r.want) continue;
      err = tc::encode_rows_map(r.map, r.base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), N,
                                r.width, r.ld, 32, tc::kTcRows);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t smem = apply_wg_smem_bytes(M);
    err = cudaFuncSetAttribute(la_apply_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    la_apply_wg_kernel<<<(N + tc::kTcRows - 1) / tc::kTcRows, kAwThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(v), ldq, ldv,
        static_cast<float*>(out), ldo, N, M, D, h, ksum, scal, n_total, guard, vec_q, vec_v,
        vec_o, maps);
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
