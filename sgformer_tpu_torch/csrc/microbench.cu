// Timing probes for Hopper (sm_90a): the card's counterparts of the three
// inline Pallas kernels under scripts/, which measured on the TPU how fast
// rows and tiles can be gathered and where the slab SpMM's time goes. Each
// computes what its TPU kernel computes (not a copy of its DMA
// choreography), so its plain PyTorch version can hold it.
//
//   gather_rows (scripts/microbench_dma_gather.py, dma_kernel):
//     out[c, r, :] = sum_{j < C/8} f32(x[idx[c*C + r*C/8 + j], :])      [E/C, 8, F]
//   The TPU kernel overwrites one output block every step, so only the last
//   chunk's sums survive there; here every chunk's are written. One CTA per
//   chunk; warp r owns group r (C/8 consecutive rows) and runs an S-deep
//   cp.async pipeline of 16-byte row pieces into its ring in shared memory:
//   lane l copies piece l of each row and later reads that same piece back,
//   so the lane's own cp.async.wait_group is all the ordering it needs. The
//   f32 sums stay in registers. Bound: the random 512-byte row reads, the
//   question the probe asks (how many rows a second the card gathers).
//
//   gather_tiles (scripts/microbench_dma_tile.py, dma_kernel):
//     out[c, r, :] = sum_{k < C} f32(scratch[r*C + k, :]),
//     scratch[8j + i, :] = x[8*idx[c*C + j] + i, :]                   [E/C, 8, F]
//   A step's C tiles of 8 rows (4 KB at F = 256) make a 1 MB scratch, which
//   does not fit shared memory, so the kernel streams: one CTA per step,
//   each tile one TMA bulk copy (cp.async.bulk with an mbarrier) into an
//   S-stage ring; the CTA sums each tile into its group (8j + i) / C as it
//   lands (all 8 rows of a tile share a group when C % 8 == 0), one column
//   a thread, then frees the slot for the tile S ahead.
//
//   slab_variant (scripts/microbench_slab_variants.py, make_variant): the
//   CSR row kernel of csrc/spmm.cu (one warp per destination row, edge ids
//   and weights read 32 at a time and shuffled, 8 columns a lane with
//   16-byte loads, f32 sums) in three modes that split csr_spmm's time:
//     prod           out[i] = sum_e w_e * x[src_e]            (= csr_spmm)
//     static_sub     out[i] = sum_e w_e * x[src_e % 128]      (128 = the TPU's
//                    block_rows; wrong results, timing only: the gather hits
//                    the same 128 rows, which stay in L1/L2)
//     no_src_matmul  out[i] = sum_e (1.0001 * w_e) * x[i]     (no gather: the
//                    row walk alone; the edge ids are still read)
//   Output f32, as the TPU variants write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add8(const uint4& raw, float (&acc)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

__device__ __forceinline__ void cvt8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
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
// columns 8l .. 8l+7). Shared memory: 8 warps x S slots x F bf16.
template <int S>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int C, int F) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = C / 8;
  const bool active = lane * 8 < F;
  const int* ids = idx + static_cast<size_t>(blockIdx.x) * C + warp * rows;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(rows_smem) +
                        static_cast<size_t>(warp) * S * F;
  auto fetch = [&](int j) {
    if (j < rows && active) {
      const __nv_bfloat16* src = x + static_cast<size_t>(__ldg(ids + j)) * F + lane * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(ring + (j % S) * F + lane * 8)),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty groups keep the count
  };
#pragma unroll 1
  for (int j = 0; j < S; ++j) fetch(j);
  float acc[8] = {};
#pragma unroll 1
  for (int j = 0; j < rows; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");  // row j landed
    if (active) {
      add8(*reinterpret_cast<const uint4*>(ring + (j % S) * F + lane * 8), acc);
    }
    __syncwarp();  // the read of slot j % S is done before it is refilled
    fetch(j + S);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (active) store8(out + (static_cast<size_t>(blockIdx.x) * 8 + warp) * F + lane * 8, acc);
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

// 256 threads, thread t owns column t (F <= 256, F % 8 == 0). Shared
// memory: S mbarriers (padded to 128 bytes), then S tiles of 8 x F bf16.
__global__ void __launch_bounds__(256)
gather_tiles_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int C, int F, int S) {
  extern __shared__ __align__(128) unsigned char tiles_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles_smem);
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(tiles_smem + ((S * 8 + 127) / 128) * 128);
  const int t = threadIdx.x;
  const int tile = 8 * F;  // elements
  const unsigned tile_bytes = static_cast<unsigned>(tile) * 2u;
  const int* ids = idx + static_cast<size_t>(blockIdx.x) * C;
  const int per_group = C / 8;  // tiles of one output group
  auto fetch = [&](int j) {
    uint64_t* bar = bars + j % S;
    mbar_expect_tx(bar, tile_bytes);
    bulk_copy(ring + static_cast<size_t>(j % S) * tile,
              x + static_cast<size_t>(__ldg(ids + j)) * tile, tile_bytes, bar);
  };
  if (t == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int j = 0; j < S && j < C; ++j) fetch(j);
  }
  float acc = 0.f;
#pragma unroll 1
  for (int j = 0; j < C; ++j) {
    const int slot = j % S;
    mbar_wait(bars + slot, (j / S) & 1);
    if (t < F) {
      const __nv_bfloat16* p = ring + static_cast<size_t>(slot) * tile + t;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += __bfloat162float(p[i * F]);
    }
    if ((j + 1) % per_group == 0) {
      if (t < F) out[(static_cast<size_t>(blockIdx.x) * 8 + j / per_group) * F + t] = acc;
      acc = 0.f;
    }
    __syncthreads();  // every thread is done with the slot
    if (t == 0 && j + S < C) fetch(j + S);
  }
}

// ---------------------------------------------------------------- slab_variant

enum Mode { kProd = 0, kStaticSub = 1, kNoSrc = 2 };

constexpr int kWarpsPerBlock = 8;

// x: [N, F] bf16 with F % 8 == 0 and 16-byte aligned rows; out: [N, F] f32.
// The prod mode is csr_spmm_kernel<bf16, f32, true, 32> of csrc/spmm.cu
// (the whole warp a row, which csr_spmm takes above 128 columns) with one
// head, operation for operation.
template <int kMode>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
slab_variant_kernel(const int* __restrict__ indptr, const int* __restrict__ src,
                    const float* __restrict__ w, const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ out, int n_rows, int F) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int start = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = 0; c0 < F; c0 += 256) {
    const int c = c0 + lane * 8;
    const bool active = c < F;
    float acc[8] = {};
    float own[8] = {};  // no_src_matmul: the destination's own row
    if (kMode == kNoSrc && active) {
      cvt8(__ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * F + c)), own);
    }
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
        int sj = __shfl_sync(kFull, s, j);
        float wj = __shfl_sync(kFull, we, j);
        if (!active) continue;
        if (kMode == kNoSrc) {
          if (sj < 0) wj = 0.f;  // keeps the edge-id read: the row walk is what is timed
          const float wm = __fmul_rn(1.0001f, wj);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(wm, own[i], acc[i]);
        } else {
          if (kMode == kStaticSub) sj &= 127;
          float xv[8];
          cvt8(__ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(sj) * F + c)), xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(wj, xv[i], acc[i]);
        }
      }
    }
    if (active) store8(out + static_cast<size_t>(row) * F + c, acc);
  }
}

template <int S>
int launch_gather_rows(const void* x, const void* idx, void* out, int n_chunks, int C, int F,
                       cudaStream_t st) {
  const size_t smem = static_cast<size_t>(8) * S * F * 2;
  cudaError_t err = cudaFuncSetAttribute(gather_rows_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_rows_kernel<S><<<n_chunks, 256, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), C, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).

// x [N, F] bf16, idx [n_chunks * C] int32, out [n_chunks, 8, F] f32;
// C % 8 == 0, F % 8 == 0, F <= 256, S in {4, 8, 16, 32}.
extern "C" int sgf_gather_rows(const void* x, const void* idx, void* out, int n_chunks, int C,
                               int F, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 4: return launch_gather_rows<4>(x, idx, out, n_chunks, C, F, st);
    case 8: return launch_gather_rows<8>(x, idx, out, n_chunks, C, F, st);
    case 16: return launch_gather_rows<16>(x, idx, out, n_chunks, C, F, st);
    case 32: return launch_gather_rows<32>(x, idx, out, n_chunks, C, F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [8 * n_tiles_in_x, F] bf16, idx [n_steps * C] int32 tile ids, out
// [n_steps, 8, F] f32; C % 8 == 0, F % 8 == 0, F <= 256, S >= 1 with the ring
// within shared memory.
extern "C" int sgf_gather_tiles(const void* x, const void* idx, void* out, int n_steps, int C,
                                int F, int S, void* stream) {
  const size_t smem = static_cast<size_t>((S * 8 + 127) / 128) * 128 +
                      static_cast<size_t>(S) * 8 * F * 2;
  cudaError_t err = cudaFuncSetAttribute(gather_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_tiles_kernel<<<n_steps, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), C, F, S);
  return static_cast<int>(cudaGetLastError());
}

// indptr [N+1], src [E] int32, w [E] f32, x [N, F] bf16 (F % 8 == 0, aligned),
// out [N, F] f32; mode 0 prod, 1 static_sub, 2 no_src_matmul.
extern "C" int sgf_slab_variant(const void* indptr, const void* src, const void* w,
                                const void* x, void* out, int n_rows, int F, int mode,
                                void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  switch (mode) {
    case kProd:
      slab_variant_kernel<kProd><<<grid, block, 0, st>>>(ip, sp, wp, xp, op, n_rows, F);
      break;
    case kStaticSub:
      slab_variant_kernel<kStaticSub><<<grid, block, 0, st>>>(ip, sp, wp, xp, op, n_rows, F);
      break;
    case kNoSrc:
      slab_variant_kernel<kNoSrc><<<grid, block, 0, st>>>(ip, sp, wp, xp, op, n_rows, F);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
