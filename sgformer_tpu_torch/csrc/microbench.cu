// Timing probes for Hopper (sm_90a): the card's counterparts of the three
// inline Pallas kernels under scripts/, which measured on the TPU how fast
// rows and tiles can be gathered and where the slab SpMM's time goes. Each
// computes what its TPU kernel computes (not a copy of its DMA
// choreography), so its plain PyTorch version can hold it.
//
//   gather_rows (scripts/microbench_dma_gather.py, dma_kernel):
//     out[c, r, :] = sum_{j < C/8} f32(x[idx[c*C + r*C/8 + j], :])      [E/C, 8, F]
//   The TPU kernel overwrites one output block every step, so only the last
//   chunk's sums survive there; here every chunk's are written. Bound: the
//   random 512-byte row reads, the question the probe asks (how many rows a
//   second the card gathers). Design: persistent blocks, one for each slot
//   the card holds at the ring (the wrapper's plan), each walking chunks
//   blockIdx.x, += gridDim.x; warp r owns group r of each. A warp's rows
//   over all its chunks are one stream through an S-deep ring of 16-byte
//   cp.async pieces in shared memory (lane l copies piece l of each row and
//   reads that same piece back, so its own cp.async.wait_group is all the
//   ordering it needs), kept full across the chunks' ends; the f32 sums stay
//   in registers and each group's rows are added in index order. The ids
//   come 32 at a time, one coalesced read a batch ahead, and a shuffle hands
//   each row's id to the warp, so no id load sits between a row's wait and
//   its copy. Measured on the parent design (one block a chunk, the id read
//   just before each copy, the ring drained at each chunk's end): staging a
//   chunk's ids first took 1.5-18 % off (the most at S = 32), the
//   persistent walk alone -1 to +3 %.
//
//   gather_tiles (scripts/microbench_dma_tile.py, dma_kernel):
//     out[c, r, :] = sum_{k < C} f32(scratch[r*C + k, :]),
//     scratch[8j + i, :] = x[8*idx[c*C + j] + i, :]                   [E/C, 8, F]
//   A step's C tiles of 8 rows (4 KB at F = 256) make a 1 MB scratch, which
//   does not fit shared memory, so the kernel streams. Bound: the 4 KB tile
//   reads. Design: persistent blocks walking steps as above, each a ring of
//   S slots on "full" mbarriers (each tile one TMA bulk copy,
//   cp.async.bulk) and W = gcd(S, 8) warps that sum the tiles with 16-byte
//   shared loads. A step's tiles are streamed interleaved (position p is
//   tile p / 8 of group p % 8), so that slot s only ever serves warp s % W:
//   the warp waits on its slots' uses in order and refills each slot as
//   soon as it has read it, with its tile S positions ahead, the ids read
//   32 at a time a batch ahead. Each column still adds a group's tiles in
//   index order and rows 0-7 of each, the order of the kernel this
//   replaced, so the sums are its bits. No block-wide barrier runs after
//   the mbarriers' set-up. Measured on that kernel (one block a step,
//   thread 0 reading each id just before its copy after a __syncthreads a
//   tile): one wave of persistent blocks, no __syncthreads and 16-byte
//   loads each left S = 8 level (within 4 %) and took 20, 6 and 16 % off
//   S = 32; the serial id read and issue stayed in all three. One producer
//   warp refilling slots on "empty" mbarriers (a thread issuing every copy
//   of the block) was measured too: 0.25 ms at S = 8, but 0.50 ms at S = 32,
//   where one block an SM leaves one issuing thread an SM; with each warp
//   refilling its own slots S = 32 runs as fast as S = 8.
//
//   slab_variant (scripts/microbench_slab_variants.py, make_variant):
//   csr_spmm's own row walk of the whole warp (spmm_walk.cuh: one warp per
//   destination row, edge ids and weights read 32 at a time and shuffled, 8
//   columns a lane with 16-byte loads, f32 sums, held to 32 registers) in
//   three modes that split csr_spmm's time, each an fmaf chain in edge order
//   from 0 for each column:
//     prod           out[i] = sum_e w_e * x[src_e]            (= csr_spmm)
//     static_sub     out[i] = sum_e w_e * x[src_e % 128]      (128 = the TPU's
//                    block_rows; wrong results, timing only: the gather hits
//                    the same 128 rows, which stay in L1/L2)
//     no_src_matmul  out[i] = sum_e (1.0001 * w_e) * x[i]     (no gather: the
//                    row walk alone; the edge ids are still read)
//   Output f32, as the TPU variants write. The rows are walked in the
//   graph's walk order where the caller gives it, as csr_spmm walks them, so
//   the warps in flight gather from one cluster's rows, which L2 holds;
//   the result is the same in any order. Every row takes one warp: on a
//   graph with rows of more than HUB_EDGES edges, which csr_spmm splits
//   into segments, prod is csr_spmm's sum in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "spmm_walk.cuh"

namespace {

using rw::kFull;

__device__ __forceinline__ void add8(const uint4& raw, float (&acc)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- gather_rows

// 8 warps, one per output group; F % 8 == 0 and F <= 256 (lane l owns
// columns 8l .. 8l+7). Shared memory: 8 warps x S slots x F bf16. The block
// walks chunks blockIdx.x, blockIdx.x + gridDim.x, ...; warp r's rows (group
// r of each of those chunks, in order) form one stream, kept S rows deep
// across the chunks' ends. Stream position q's id is read by lane q % 32 a
// batch of 32 ahead and handed out by a shuffle.
// The least number of blocks an SM must hold at S with F = 256, for the
// registers: 8 (the threads' limit), 6, 3 and 1 by shared memory.
template <int S>
struct RowsOccupancy {
  static constexpr int value = S == 4 ? 8 : S == 8 ? 6 : S == 16 ? 3 : 1;
};

template <int S>
__global__ void __launch_bounds__(256, RowsOccupancy<S>::value)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int n_chunks, int C, int F) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = C / 8;
  const bool active = lane * 8 < F;
  const int total = (n_chunks - 1 - static_cast<int>(blockIdx.x)) /
                    static_cast<int>(gridDim.x) * rows + rows;  // this warp's stream
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(rows_smem) +
                        static_cast<size_t>(warp) * S * F + lane * 8;
  auto id_at = [&](int q) -> int {  // the id of stream position q (0 past its end)
    if (q >= total) return 0;
    const size_t chunk = blockIdx.x + static_cast<size_t>(q / rows) * gridDim.x;
    return __ldg(idx + chunk * C + warp * rows + q % rows);
  };
  int ids = id_at(lane), ids_next = id_at(32 + lane);
  auto fetch = [&](int q) {  // called by the whole warp, q = 0, 1, 2, ...
    if ((q & 31) == 0 && q > 0) {
      ids = ids_next;
      ids_next = id_at(q + 32 + lane);
    }
    const int id = __shfl_sync(kFull, ids, q & 31);
    if (q < total && active) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(ring + (q % S) * F)),
                   "l"(x + static_cast<size_t>(id) * F + lane * 8)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty groups keep the count
  };
#pragma unroll 1
  for (int q = 0; q < S; ++q) fetch(q);
  float acc[8] = {};
  size_t chunk = blockIdx.x;
  int j = 0;
#pragma unroll 1
  for (int q = 0; q < total; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");  // row q landed
    if (active) add8(*reinterpret_cast<const uint4*>(ring + (q % S) * F), acc);
    __syncwarp();
    fetch(q + S);
    if (++j == rows) {  // the group's last row: its sum, in index order
      if (active) store8(out + (chunk * 8 + warp) * F + lane * 8, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      j = 0;
      chunk += gridDim.x;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- gather_tiles

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// W = gcd(S, 8) warps. The block walks steps blockIdx.x, blockIdx.x +
// gridDim.x, ...; its stream of tiles takes each step's positions p = 0 ..
// C-1 in turn, position p being tile p / 8 of group p % 8, so that the
// groups' tiles interleave. Stream position k lands in slot k % S and is
// summed by warp k % W; W divides S, so slot s only ever serves warp s % W,
// which waits on the slot's "full" mbarrier use by use and, once its lanes
// have read the tile, refills the slot with its position S ahead (lane 0:
// expect_tx and one bulk copy). Shared memory: S mbarriers (padded to 128
// bytes), then S tiles of 8 x F bf16. F % 8 == 0, F <= 256 (lane l owns
// columns 8l .. 8l+7). With W = 8 the registers leave room for the 6
// blocks an SM holds at S = 8.
template <int W>
__global__ void __launch_bounds__(32 * W, W == 8 ? 6 : 1)
gather_tiles_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int n_steps, int C, int F, int S) {
  constexpr int G = 8 / W;  // groups of one warp
  extern __shared__ __align__(128) unsigned char tiles_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles_smem);
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(tiles_smem + ((S * 8 + 127) / 128) * 128);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = 8 * F;  // elements
  const int total = (n_steps - 1 - static_cast<int>(blockIdx.x)) /
                    static_cast<int>(gridDim.x) * C + C;  // the block's stream
  const int per_group = C / 8;
  const unsigned tile_bytes = static_cast<unsigned>(tile) * 2u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  const int mine_total = (total - warp + W - 1) / W;  // positions warp + W i
  auto id_at = [&](int i) -> int {  // the tile id of this warp's i-th position (0 past the end)
    const int k = warp + W * i;
    if (k >= total) return 0;
    const size_t step = blockIdx.x + static_cast<size_t>(k / C) * gridDim.x;
    const int p = k % C;
    return __ldg(idx + step * C + (p & 7) * per_group + (p >> 3));
  };
  int ids = id_at(lane), ids_next = id_at(32 + lane);
  auto issue = [&](int i) {  // the whole warp, i = 0, 1, 2, ...
    if ((i & 31) == 0 && i > 0) {
      ids = ids_next;
      ids_next = id_at(i + 32 + lane);
    }
    const int id = __shfl_sync(kFull, ids, i & 31);
    const int k = warp + W * i;
    if (lane == 0 && k < total) {
      const int slot = k % S;
      mbar_expect_tx(full + slot, tile_bytes);
      bulk_copy(ring + static_cast<size_t>(slot) * tile, x + static_cast<size_t>(id) * tile,
                tile_bytes, full + slot);
    }
  };
  const int ahead = S / W;  // this warp's slots
#pragma unroll 1
  for (int i = 0; i < ahead; ++i) issue(i);
  const bool active = lane * 8 < F;
  float acc[G][8] = {};
  size_t step = blockIdx.x;
  int left = C / W;  // this warp's positions in the step
#pragma unroll 1
  for (int i = 0; i < mine_total; ++i) {
    const int k = warp + W * i;
    const int slot = k % S;
    mbar_wait(full + slot, (k / S) & 1);
    const int mine = (k & 7) / W;  // which of this warp's groups
    if (active) {
      const __nv_bfloat16* p = ring + static_cast<size_t>(slot) * tile + lane * 8;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p + r * F);
#pragma unroll
        for (int g = 0; g < G; ++g) {  // a register array: no indexing by a variable
          if (g == mine) add8(raw, acc[g]);
        }
      }
    }
    __syncwarp();
    issue(i + ahead);  // the slot's next tile
    if (--left == 0) {  // the step's last tile of this warp's groups: their sums
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (active) store8(out + (step * 8 + warp + g * W) * F + lane * 8, acc[g]);
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[g][r] = 0.f;
      }
      left = C / W;
      step += gridDim.x;
    }
  }
}

// ---------------------------------------------------------------- slab_variant

// x: [N, F] bf16 with F % 8 == 0 and 16-byte aligned rows; out: [N, F] f32.
// Position p of the whole warp's walk of spmm_walk.cuh (csr_spmm's walk of a
// head wider than 128 columns, at its launch bounds), its edges read as
// kSrc says; every row walked by one warp, hub rows too. Row schedule[p] in
// the walk order (kOrdered), else row p.
template <rw::Source kSrc, bool kOrdered>
__global__ void __launch_bounds__(rw::kWarpsPerBlock * 32,
                                  rw::kWholeWarpBlocks<__nv_bfloat16>)
slab_variant_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                    const float* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ out, int n_rows, int F,
                    const int* __restrict__ schedule) {
  rw::walk_position<kSrc, __nv_bfloat16, float, true, kOrdered>(
      blockIdx.x * rw::kWarpsPerBlock + (threadIdx.x >> 5), 0, n_rows, indptr, schedule, src, w,
      x, out, INT_MAX, 1, F);
}

template <rw::Source kSrc>
int launch_slab_variant(const int* indptr, const int* src, const float* w,
                        const __nv_bfloat16* x, float* out, int n_rows, int F,
                        const int* schedule, cudaStream_t st) {
  const dim3 grid((n_rows + rw::kWarpsPerBlock - 1) / rw::kWarpsPerBlock);
  const dim3 block(rw::kWarpsPerBlock * 32);
  if (schedule != nullptr) {
    slab_variant_kernel<kSrc, true><<<grid, block, 0, st>>>(indptr, src, w, x, out, n_rows, F,
                                                            schedule);
  } else {
    slab_variant_kernel<kSrc, false><<<grid, block, 0, st>>>(indptr, src, w, x, out, n_rows,
                                                             F, schedule);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_gather_rows(const void* x, const void* idx, void* out, int n_chunks, int C, int F,
                       int grid, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(8) * S * F * 2;
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_kernel<S><<<grid, 256, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), n_chunks, C, F);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int gather_rows_resident(int F) {
  const size_t smem = static_cast<size_t>(8) * S * F * 2;
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_rows_kernel<S>, 256,
                                                        smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

size_t tiles_smem_bytes(int F, int S) {
  return static_cast<size_t>((S * 8 + 127) / 128) * 128 + static_cast<size_t>(S) * 8 * F * 2;
}

int tiles_warps(int S) {  // gcd(S, 8)
  return S % 8 == 0 ? 8 : S % 4 == 0 ? 4 : S % 2 == 0 ? 2 : 1;
}

template <int W>
int launch_gather_tiles(const void* x, const void* idx, void* out, int n_steps, int C, int F,
                        int S, int grid, cudaStream_t st) {
  const size_t smem = tiles_smem_bytes(F, S);
  cudaError_t err = cudaFuncSetAttribute(gather_tiles_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_tiles_kernel<W><<<grid, 32 * W, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), n_steps, C, F, S);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int gather_tiles_resident(int F, int S) {
  const size_t smem = tiles_smem_bytes(F, S);
  cudaError_t err = cudaFuncSetAttribute(gather_tiles_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_tiles_kernel<W>,
                                                        32 * W, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).

// x [N, F] bf16, idx [n_chunks * C] int32, out [n_chunks, 8, F] f32;
// C % 8 == 0, F % 8 == 0, F <= 256, S in {4, 8, 16, 32}; grid: the
// persistent blocks, at most n_chunks (the wrapper's plan).
extern "C" int sgf_gather_rows(const void* x, const void* idx, void* out, int n_chunks, int C,
                               int F, int S, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 4: return launch_gather_rows<4>(x, idx, out, n_chunks, C, F, grid, st);
    case 8: return launch_gather_rows<8>(x, idx, out, n_chunks, C, F, grid, st);
    case 16: return launch_gather_rows<16>(x, idx, out, n_chunks, C, F, grid, st);
    case 32: return launch_gather_rows<32>(x, idx, out, n_chunks, C, F, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of gather_rows an SM holds at S and F (shared memory, threads
// and registers), or minus the cudaError_t of the query.
extern "C" int sgf_gather_rows_resident(int F, int S) {
  switch (S) {
    case 4: return gather_rows_resident<4>(F);
    case 8: return gather_rows_resident<8>(F);
    case 16: return gather_rows_resident<16>(F);
    case 32: return gather_rows_resident<32>(F);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [8 * n_tiles_in_x, F] bf16, idx [n_steps * C] int32 tile ids, out
// [n_steps, 8, F] f32; C % 8 == 0, F % 8 == 0, F <= 256, S >= 1 with the ring
// within shared memory; grid: the persistent blocks, at most n_steps.
extern "C" int sgf_gather_tiles(const void* x, const void* idx, void* out, int n_steps, int C,
                                int F, int S, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid < 1 || grid > n_steps || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (tiles_warps(S)) {
    case 8: return launch_gather_tiles<8>(x, idx, out, n_steps, C, F, S, grid, st);
    case 4: return launch_gather_tiles<4>(x, idx, out, n_steps, C, F, S, grid, st);
    case 2: return launch_gather_tiles<2>(x, idx, out, n_steps, C, F, S, grid, st);
    default: return launch_gather_tiles<1>(x, idx, out, n_steps, C, F, S, grid, st);
  }
}

// The blocks of gather_tiles an SM holds at F and S, or minus the
// cudaError_t of the query.
extern "C" int sgf_gather_tiles_resident(int F, int S) {
  if (S < 1) return -static_cast<int>(cudaErrorInvalidValue);
  switch (tiles_warps(S)) {
    case 8: return gather_tiles_resident<8>(F, S);
    case 4: return gather_tiles_resident<4>(F, S);
    case 2: return gather_tiles_resident<2>(F, S);
    default: return gather_tiles_resident<1>(F, S);
  }
}

// indptr [N+1], src [E] int32, w [E] f32, x [N, F] bf16 (F % 8 == 0, aligned),
// out [N, F] f32; mode 0 prod, 1 static_sub, 2 no_src_matmul; schedule: the
// walk order, [N] int32, a permutation of the rows (null: row order); the
// result does not depend on it.
extern "C" int sgf_slab_variant(const void* indptr, const void* src, const void* w,
                                const void* x, void* out, int n_rows, int F, int mode,
                                const void* schedule, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* op = static_cast<float*>(out);
  const int* so = static_cast<const int*>(schedule);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_slab_variant<rw::Source::kGather>(ip, sp, wp, xp, op, n_rows, F, so, st);
    case 1:
      return launch_slab_variant<rw::Source::kStaticSub>(ip, sp, wp, xp, op, n_rows, F, so, st);
    case 2:
      return launch_slab_variant<rw::Source::kOwnRow>(ip, sp, wp, xp, op, n_rows, F, so, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
