// Tensor-core building blocks of the linear-attention kernels
// (linear_attention.cu, linear_attention_bwd.cu), sm_90a. Every product
// runs on warpgroup MMAs (wgmma); nothing here issues mma.sync.
//
// - PTX wrappers: wgmma m64n64k16 and m64n128k16
//   bf16 -> f32 with their fences and the 128-byte-swizzled shared-memory
//   layout and descriptors they read, K-major (the forward apply's, the
//   bf16 backward apply's and rows pass's) and, for m64n64k16, MN-major (the
//   node-axis operands of the bf16 forward reduce and backward P pass);
//   wgmma m64n64k8 and m64n128k8 tf32 -> f32 with A from registers and B
//   from the same swizzle over f32 rows (the f32 kernels); mbarriers, the
//   copy engine's (TMA) bulk and tensor-map copies between device and
//   shared memory, and setmaxnreg (the warp-specialised kernels);
// - TF32: the rounding of an f32 to tf32 and its split into tf32 hi + lo,
//   each product of two f32 operands three TF32 products (3xTF32);
// - the split of kvs^T into bf16 or tf32 pieces, the B operand of
//   a = q @ kvs in the forward apply and the backward reduce's rows pass:
//   [n][k] pieces for the bf16 rows pass (split_t_elems), and the
//   swizzled hi and lo atoms of each (column tile, k atom) chunk for the
//   forward applies and the f32 rows pass (split_kvs_kernel), one bulk
//   copy a chunk;
// - the node-axis reduces' pieces, C[m, n] = sum_r A[r, m] B[r, n] over
//   slices of the N node rows (the [N, M]^T x [N, D] products that the TPU
//   kernels accumulate over their sequential grids): a block's slice and
//   tile (RdBlock), its producer warp (rd_produce), and the f32 forms'
//   consumers in 3xTF32 (rd_split_tf32, rd_consume_tf32): k^T v of the f32
//   forward reduce and P = q^T (g / den) of the f32 backward P pass;
// - the row kernels' tiles (kTcRows x kTcCols) and fresh-sum period
//   (kWgPeriod); the division by a row's reciprocal (div_by), the tensor
//   maps of row tiles (encode_rows_map) and the SM count of the persistent
//   kernels' grids.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a warpgroup's registers a thread, lowered or raised (every warp of the
// warpgroup runs it): a producer warpgroup that only issues copies gives
// its registers to the consumers
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// mbarriers in shared memory and the bulk copy (TMA, one thread) that
// completes on one: bytes from global to shared memory, counted against the
// barrier's expected transaction bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// the barriers' initialisation made visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, int bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// the box at (x, y) of the 2-D tensor map at tmap from shared memory (its
// map's swizzle), the copy engine clipping it to the tensor; then the
// commit of the bulk stores issued so far, and the wait until every
// committed store has read its shared memory
__device__ __forceinline__ void tma_store_2d(const void* tmap, int x, int y, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(tmap)),
      "r"(x), "r"(y), "r"(smem_addr(src))
      : "memory");
}
__device__ __forceinline__ void bulk_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the box at (x, y) (x the inner, contiguous dimension) of the 2-D tensor
// map at tmap (a __grid_constant__ kernel parameter), with its map's swizzle
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// A tensor map of rows [N][width] of `type` (elem_bytes each), ld elements
// apart, read and written in [box_rows][box_cols] boxes in the 128-byte
// swizzle (a box row of 128 bytes), zero past N and width on loads and
// clipped there on stores: cuTensorMapEncodeTiled, taken from the driver
// through the runtime. The rows' base and ld * elem_bytes must be multiples
// of 16 bytes.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                   int elem_bytes, int N, int width, long ld, int box_cols,
                                   int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The streaming multiprocessors of the current device (the persistent
// kernels' grid), asked at each launch (the runtime caches the attribute),
// so that each device gets its own; the query's error where it fails.
inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && sms < 1) err = cudaErrorInvalidValue;
  return err;
}

// x / d correctly rounded from r = 1/d correctly rounded (Markstein: the
// quotient q = x * r corrected once by its residual, exact by an FMA), as
// x / d gives it without over- or underflow: an epilogue that divides every
// element by its row's den pays a dozen instructions an element for the
// division.
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// ---------------------------------------------------------------------------
// TF32 (10 mantissa bits in an f32's layout, the low 13 bits zero).

// x rounded to the nearest tf32, ties away from zero
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~21 significant bits: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// The node-axis reduces' output tile, m and n: kvs = k^T v of the forward
// reduces and P = q^T (g / den) of the backward P passes.
constexpr int kNodeTile = 128;

// ---------------------------------------------------------------------------
// wgmma (sm_90a): warpgroup MMAs reading both operands from shared memory
// through descriptors. Operands are K-major tiles in the 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart, the 16-byte
// chunk j of row r stored at chunk j ^ (r % 8); a tile starts 1024-byte
// aligned, and the k16 step s of a 64-deep tile starts 32*s bytes in.

// Byte offset of element (r, c), c < 64, in a swizzled tile of 64-wide rows.
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared memory written by threads (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] = A[64 x 16] B[16 x 64] + (scale_d ? d : 0), bf16 in, f32
// sums; d as the accumulator fragment: d[4j + 2h + e] at row 16*warp +
// lane/4 + 8h and column 8j + 2*(lane%4) + e of the warpgroup's tile.
// kMN: both operands MN-major (transposed: A stored [k][m], B [k][n]),
// else both K-major.
template <int kMN>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kMN));
}
// d += A B, both K-major (the forward apply's)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  wgmma_m64n64k16<0>(d, desc_a, desc_b, 1);
}

// d[64 x 128] = A[64 x 16] B[16 x 128] + (scale_d ? d : 0), bf16 in, f32
// sums, both operands K-major; d[4j + 2h + e] at row 16*warp + lane/4 + 8h
// and column 8j + 2*(lane%4) + e, j < 16.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The descriptor of an MN-major tile in the same swizzle: rows are k (one
// 128-byte row of 64 m or n values each), 8-row groups 1024 bytes apart,
// so the k16 step s of a tile starts 2048*s bytes in. An operand of 64 m
// or n is one swizzle atom wide, so only the k-group stride is read: it is
// given in both offset fields.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// keeps the compiler from moving accesses of d across the asynchronous MMAs
template <int kN>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// every group of this warpgroup's MMAs but the kPending newest has completed
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// The same swizzle over f32 rows: a row of a K-major tile holds 32 f32 (128
// bytes), so a 64-deep chunk is two such tiles (swizzle atoms) along K, and
// the k8 step s of an atom starts 32*s bytes in; descriptors as sw128_desc
// (the byte layout is the bf16 one's). Byte offset of element (r, c), c < 32.
__device__ __forceinline__ int sw128_offset_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// d[64 x 64] = A[64 x 8] B[8 x 64] + (scale_d ? d : 0), tf32 in, f32 sums.
// A from registers: each warp's 16 rows of the warpgroup's 64 as an m16 x k8
// fragment (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4),
// g = lane / 4, t = lane % 4); B K-major in swizzled shared memory (32-bit
// operands are not transposed); d laid out as wgmma_m64n64k16's.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const unsigned (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// d[64 x 128] = A[64 x 8] B[8 x 128] + (scale_d ? d : 0), tf32 in, f32
// sums: A from registers as wgmma_m64n64k8_tf32's, B K-major ([128 n][32
// k] rows of 128 bytes in the swizzle, one 16 KB atom), d laid out as
// wgmma_m64n128k16's (j < 16).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const unsigned (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr size_t kSmemPerBlock = 232448;  // the H100's dynamic shared memory a block may use

// ---------------------------------------------------------------------------
// The node-axis reduces on warpgroup MMAs (linear_attention.cu's forward
// reduces, linear_attention_bwd.cu's f32 P pass): a block sums one
// kRdTile x kRdTile output tile over one slice of the node rows, two
// consumer warpgroups of 64 m rows by all kRdTile columns, and a producer
// warpgroup (its registers given to the consumers by setmaxnreg), one warp
// of which brings each chunk of the slice's rows into 128-byte-swizzled
// node-major atoms ([kRows nodes][128 bytes]) by the copy engine, through a
// ring of full and empty mbarriers.
constexpr int kRdConsumers = 2 * 128;
constexpr int kRdThreads = kRdConsumers + 128;  // and the producer warpgroup
constexpr int kRdTile = kNodeTile;              // 128 m by 128 d a block
// the f32 forms: 32 node rows a chunk (four k8 steps, one fresh-sum
// period), a swizzled [32 nodes][32] f32 atom, the split B operand's hi or
// lo piece ([128 d][32 nodes], K-major), and the producer warpgroup's three
// other warps, which sum per column while the MMAs run
constexpr int kRfRows = 32;
constexpr int kRfAtom = kRfRows * 128;
constexpr int kRfPiece = kRdTile * 128;
constexpr int kRfSumWarps = 3;

// the consumers' own barrier (the producer warpgroup has left)
__device__ __forceinline__ void rd_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRdConsumers) : "memory");
}
// one consumer warpgroup's barrier
__device__ __forceinline__ void rd_warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
// the column-sum warps' barrier
__device__ __forceinline__ void rd_sum_warps_sync() {
  asm volatile("bar.sync 4, %0;\n" ::"n"(kRfSumWarps * 32) : "memory");
}

// Four adjacent columns of a staged row as floats: 8 bytes of bf16, or 16
// of f32; zeros where !ok.
__device__ __forceinline__ void rd_load4(const bf16* p, bool ok, float (&x)[4]) {
  const uint2 raw = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void rd_load4(const float* p, bool ok, float (&x)[4]) {
  const float4 a = ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

// A reduce block's work: tile b % tiles of slice s = b / tiles (b the
// block, slice-major), the tile's origin (m0, d0), the column sums it takes
// (k_stats: the first column tile; q_stats: the second, or the first when D
// fits one tile), and its slice's rows [r_begin, r_end) in kRows-row chunks.
template <int kRows>
struct RdBlock {
  int s, m0, d0, chunks;
  bool k_stats, q_stats;
  long r_begin, r_end;
  __device__ RdBlock(int N, int M, int D, int rows_per_slice) {
    const int tiles_m = cdiv(M, kRdTile);
    const int tiles_d = cdiv(D, kRdTile);
    const int tiles = tiles_m * tiles_d;
    const int dy = blockIdx.x % tiles / tiles_m;
    s = blockIdx.x / tiles;
    m0 = blockIdx.x % tiles % tiles_m * kRdTile;
    d0 = dy * kRdTile;
    k_stats = dy == 0;
    q_stats = dy == (tiles_d > 1 ? 1 : 0);
    r_begin = static_cast<long>(s) * rows_per_slice;
    r_end = r_begin + rows_per_slice < N ? r_begin + rows_per_slice : static_cast<long>(N);
    chunks = static_cast<int>((r_end - r_begin + kRows - 1) / kRows);
  }
  // the first row of chunk c, and how many of its rows lie in the slice
  __device__ long row0(int c) const { return r_begin + static_cast<long>(c) * kRows; }
  __device__ int valid(int c) const {
    return r_end - row0(c) < kRows ? static_cast<int>(r_end - row0(c)) : kRows;
  }
};

// A reduce's tensor maps, node-major boxes of its operands' rows: a and c
// at m columns (the forward's k and q, the P pass's q), b at d columns (v,
// g).
struct RdMaps {
  CUtensorMap a, b, c;
};

// The producer warpgroup's warp 0: chunk c of the slice's rows into stage c
// % kStages of the ring, once its last reader has freed it, by the copy
// engine where vec, else by the warp's lanes (zero past the slice and the
// widths). A stage has kSlots slots of kParts atoms ([kRows nodes][128
// bytes] of T): a's columns m0 + .. (M wide), b's d0 + .. (D wide) and,
// where parts is 3, c's m0 + .. (M wide), each atom the box at (column
// + a * 128 / sizeof(T), row r0) of its tensor map. rows(st, r0), run by
// every lane before the stage is handed over, stages what else the chunk's
// rows carry and makes its stores visible to the warp.
template <typename T, int kRows, int kStages, int kParts, int kSlots, typename Rows>
__device__ __forceinline__ void rd_produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                           const T* __restrict__ a, const T* __restrict__ b,
                                           const T* __restrict__ c, long lda, long ldb, long ldc,
                                           int M, int D, const RdBlock<kRows>& blk, int parts,
                                           int vec, int lane, const RdMaps& maps, Rows rows) {
  constexpr int kCols = 128 / sizeof(T);        // elements of a swizzle row
  constexpr int kAtom = kRows * 128;            // bytes of an atom
  constexpr int kStage = kSlots * kParts * kAtom;
  for (int ch = 0; ch < blk.chunks; ++ch) {
    const int st = ch % kStages;
    if (ch >= kStages) mbar_wait(empty + st, (ch / kStages - 1) & 1);
    unsigned char* stage = ring + st * kStage;
    const long r0 = blk.row0(ch);
    rows(st, r0);
    if (!vec) {  // one element a lane at a time
      for (int i = lane; i < parts * kRows * kRdTile; i += 32) {
        const int p = i / (kRows * kRdTile);
        const int r = i / kRdTile % kRows;
        const int cc = i % kRdTile;
        const T* X = p == 0 ? a : p == 1 ? b : c;
        const long ld = p == 0 ? lda : p == 1 ? ldb : ldc;
        const int col = (p == 1 ? blk.d0 : blk.m0) + cc;
        const bool ok = r0 + r < blk.r_end && col < (p == 1 ? D : M);
        unsigned char* dst = stage + (kParts * p + cc / kCols) * kAtom;
        if constexpr (std::is_same_v<T, float>) {
          *reinterpret_cast<float*>(dst + sw128_offset_f32(r, cc % kCols)) =
              ok ? X[(r0 + r) * ld + col] : 0.f;
        } else {
          *reinterpret_cast<T*>(dst + sw128_offset(r, cc % kCols)) =
              ok ? X[(r0 + r) * ld + col] : __float2bfloat16_rn(0.f);
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full + st);
    } else if (lane == 0) {
      mbar_arrive_expect_tx(full + st, parts * kParts * kAtom);
      const int y = static_cast<int>(r0);
      for (int at = 0; at < kParts; ++at) {
        tma_load_2d(stage + at * kAtom, &maps.a, blk.m0 + kCols * at, y, full + st);
        tma_load_2d(stage + (kParts + at) * kAtom, &maps.b, blk.d0 + kCols * at, y, full + st);
        if (parts > 2) {
          tma_load_2d(stage + (2 * kParts + at) * kAtom, &maps.c, blk.m0 + kCols * at, y,
                      full + st);
        }
      }
    }
  }
}

// The f32 reduces' B operand: the warpgroup's half (d rows 64 wg .. + 63,
// wg = tid / 128) of a staged chunk's four node-major atoms at src, scaled
// by its node row (scale(r, x): x the row's four d values, read as zeros
// from row valid on), split into tf32 hi (at dst) and lo (kRfPiece on),
// written K-major ([128 d][32 nodes], swizzled), the transpose that tf32
// wgmma, which reads no transposed 32-bit operand, cannot do itself.
// Thread tid takes nodes 4 (tid % 8) .. + 3 by d 4 (tid / 8) .. + 3, four
// 16-byte loads of node rows, and stores each d row's four nodes as 16
// bytes of hi and of lo (the eight lanes of a store's phase hit distinct
// banks).
template <typename Scale>
__device__ __forceinline__ void rd_split_tf32(const unsigned char* src, unsigned char* dst,
                                              int valid, int tid, Scale scale) {
  const int nq = tid & 7;
  const int dq = tid >> 3;
  float x[4][4];  // [node][d]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * nq + i;
    rd_load4(reinterpret_cast<const float*>(src + (dq >> 3) * kRfAtom +
                                            sw128_offset_f32(r, (4 * dq) & 31)),
             r < valid, x[i]);
    scale(r, x[i]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint4 hi, lo;
    split_tf32(x[0][j], hi.x, lo.x);
    split_tf32(x[1][j], hi.y, lo.y);
    split_tf32(x[2][j], hi.z, lo.z);
    split_tf32(x[3][j], hi.w, lo.w);
    const int off = sw128_offset_f32(4 * dq + j, 4 * nq);
    *reinterpret_cast<uint4*>(dst + off) = hi;
    *reinterpret_cast<uint4*>(dst + kRfPiece + off) = lo;
  }
}

// The f32 reduces' consumers (the forward kᵀv, the backward P pass's
// qᵀ(g/den)) in 3xTF32 on warpgroup MMAs, wgmma m64n128k8 tf32 -> f32 with
// the node axis as the MMAs' k: out_part[s] = A^T B over the block's slice
// for its tile, A's atoms at the start of each kStage-byte stage of the
// ring, B's four atoms after them. tf32 wgmma reads no transposed 32-bit
// operand, so the two operands take two routes. A^T comes from registers:
// each warp's fragments (16 m rows by 8 nodes a k8 step) are loaded from
// the node-major atoms and split into tf32 hi + lo as they load (zero past
// the slice). B: each consumer warpgroup splits half of each chunk
// (rd_split_tf32, each node row scaled by scale(st, valid, r, x)) into one
// of two buffers of tf32 hi and lo atoms at bsplit, which mbarriers hand
// over (sfull: a buffer written; sempty: its MMAs done): chunk c + 1's split
// runs while chunk c's MMAs do, and neither warpgroup waits for the other
// at a block barrier, so that one's adds and A loads run under the other's
// MMAs. Each product is lo*hi' + hi*lo' + hi*hi' (the cross terms first), a
// chunk's twelve MMAs (four k8 steps) into fresh sums added to the block's
// with round-to-nearest f32 adds, a 32-row period. Each chunk's MMAs are
// drained before the next are issued (sums kept in flight across the
// loop's back edge make ptxas serialise the MMAs; A fragments loaded a
// chunk ahead gained nothing). Each warp frees a stage (empty) once its A
// fragments are in registers; the block's sums go to out_part [slices, M,
// D] at the end.
template <int kStages, int kStage, typename Scale>
__device__ __forceinline__ void rd_consume_tf32(const unsigned char* ring, unsigned char* bsplit,
                                                uint64_t* full, uint64_t* empty, uint64_t* sfull,
                                                uint64_t* sempty, const RdBlock<kRfRows>& blk,
                                                int M, int D, float* __restrict__ out_part,
                                                int tid, Scale scale) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp & 3;
  // the warp's A rows 16 wq + g (+ 8 i) of the warpgroup's 64: m = m0 + 64
  // wg + 16 wq + g, in atom 2 wg + wq / 2 at column 16 (wq % 2) + g; a k8
  // step s's node rows 8 s + t (+ 4 h) keep the swizzle of rows t (+ 4 h),
  // so their byte offsets are a_off[h][i] + 1024 s
  int a_off[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a_off[h][i] = (2 * wg + (wq >> 1)) * kRfAtom +
                    sw128_offset_f32(t + 4 * h, 16 * (wq & 1) + g + 8 * i);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // the warpgroup's half of chunk c's B (d rows 64 wg .. + 63) into buffer
  // c % 2 as tf32 hi + lo, K-major, once its stage has landed and the
  // buffer's MMAs two chunks back are done
  auto split = [&](int c) {
    const int st = c % kStages;
    const int b = c & 1;
    mbar_wait(full + st, (c / kStages) & 1);
    if (c >= 2) mbar_wait(sempty + b, (c / 2 - 1) & 1);
    const int valid = blk.valid(c);
    rd_split_tf32(ring + st * kStage + 4 * kRfAtom, bsplit + b * 2 * kRfPiece, valid, tid,
                  [&](int r, float (&x)[4]) { scale(st, valid, r, x); });
    fence_proxy_async();  // the split's stores, for the MMAs
    __syncwarp();
    if (lane == 0) mbar_arrive(sfull + b);
  };

  if (blk.chunks > 0) split(0);
  for (int c = 0; c < blk.chunks; ++c) {
    const int st = c % kStages;
    const int b = c & 1;
    const unsigned char* stage = ring + st * kStage;  // landed: split(c) waited for it
    const int valid = blk.valid(c);
    // the chunk's A fragments, split into tf32 hi + lo: node rows 8 s + t
    // (+ 4) of k8 step s
    unsigned ah[4][4], al[4][4];
#pragma unroll
    for (int s8 = 0; s8 < 4; ++s8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const int h = i >> 1;
        const float x = 8 * s8 + t + 4 * h < valid
                            ? *reinterpret_cast<const float*>(stage + a_off[h][i & 1] + 1024 * s8)
                            : 0.f;
        split_tf32(x, ah[s8][i], al[s8][i]);
      }
    }
    mbar_wait(sfull + b, (c / 2) & 1);  // both halves of the chunk's B split
    wgmma_fence_operand(part);
    wgmma_fence();
    const unsigned char* hb = bsplit + b * 2 * kRfPiece;
#pragma unroll
    for (int s8 = 0; s8 < 4; ++s8) {
      const unsigned char* bp = hb + 32 * s8;
      wgmma_m64n128k8_tf32(part, al[s8], sw128_desc(bp), s8);           // lo*hi', fresh first
      wgmma_m64n128k8_tf32(part, ah[s8], sw128_desc(bp + kRfPiece), 1);  // hi*lo'
      wgmma_m64n128k8_tf32(part, ah[s8], sw128_desc(bp), 1);             // hi*hi'
    }
    wgmma_commit();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // the stage's A is in registers
    // while the MMAs run: the warpgroup's half of the next chunk's split
    if (c + 1 < blk.chunks) split(c + 1);
    wgmma_wait<0>();
    wgmma_fence_operand(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(sempty + b);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }

  float* op = out_part + static_cast<size_t>(blk.s) * M * D;
  const bool pairs = (D & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = blk.m0 + 16 * warp + g + 8 * h;
    if (m >= M) continue;
    float* row = op + static_cast<size_t>(m) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = blk.d0 + 8 * j + 2 * t;
      const float x = acc[4 * j + 2 * h];
      const float y = acc[4 * j + 2 * h + 1];
      if (pairs && d + 1 < D) {
        *reinterpret_cast<float2*>(row + d) = make_float2(x, y);
      } else {
        if (d < D) row[d] = x;
        if (d + 1 < D) row[d + 1] = y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The row kernels (the forward applies, the backward reduce's rows passes
// and applies): a block owns kTcRows rows, two warpgroups of 64, and forms
// their products kTcCols output columns (one m64n64 MMA) at a time.

constexpr int kTcRows = 128;
constexpr int kTcCols = 64;
// elements of a 16-byte copy
template <typename T>
constexpr int kPadOf = 16 / static_cast<int>(sizeof(T));
// The f32 (3xTF32) row kernels start fresh sums (scale-d = 0) every
// kWgPeriod deep and add them to a tile's f32 sums in round-to-nearest, so
// that the tensor cores' own accumulation, which may truncate, never chains
// more than one period.
constexpr int kWgPeriod = 16;

// ---------------------------------------------------------------------------
// The B operand of the row kernels' a = q @ kvs: kvs^T, f32 in meaning,
// split into bf16 or tf32 pieces.

constexpr int kSplitPad = 64;

__host__ __device__ constexpr int split_pad(int x) { return cdiv(x, kSplitPad) * kSplitPad; }

// bf16 elements of one [n = D][k = M] piece, both extents padded by zeros
// to kSplitPad (the bf16 rows pass's split)
__host__ __device__ inline size_t split_t_elems(int M, int D) {
  return static_cast<size_t>(split_pad(D)) * split_pad(M);
}

// x as kPieces pieces of type P at p[0], p[off], ...: hi = P(x), then each
// piece the P of what the ones before leave (each difference is exact in
// f32). P = bf16: hi + lo keeps ~16 significant bits, hi + mid + lo all of
// f32's 24; P = float holds tf32 pieces: hi + lo keeps ~21.
template <int kPieces, typename P>
__device__ __forceinline__ void split_store(float x, P* p, size_t off) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    if constexpr (std::is_same_v<P, float>) {
      const float h = __uint_as_float(to_tf32(x));
      p[i * off] = h;
      x -= h;
    } else {
      const bf16 h = __float2bfloat16_rn(x);
      p[i * off] = h;
      x -= __bfloat162float(h);
    }
  }
}

constexpr int kSplitThreads = 256;

// The split that the forward applies and the f32 rows pass stream, one bulk
// copy a chunk: kvs^T as hi + lo pieces of type P (split_store<2, P>: tf32
// in f32, or bf16) in chunks of (column tile ct, k atom kc), column tile by
// column tile, each chunk its hi atom, then its lo atom, each a swizzled
// [64 n][128 bytes of k] tile (kKvsPiece bytes): piece p of chunk (ct, kc)
// starts at element ((ct * ka + kc) * 2 + p) * (kKvsPiece / sizeof(P)) and
// holds element (n, k), d = 64 ct + n and m = kK kc + k (kK = 128 /
// sizeof(P): 32 tf32 pieces or 64 bf16), at its swizzled place, zero past
// the widths.
constexpr int kKvsPiece = kTcCols * 128;

template <typename P>
__host__ __device__ inline size_t split_kvs_elems(int M, int D) {
  return static_cast<size_t>(cdiv(D, kTcCols)) * cdiv(M, 128 / static_cast<int>(sizeof(P))) *
         2 * (kKvsPiece / sizeof(P));
}

template <typename P>
__global__ void __launch_bounds__(kSplitThreads)
split_kvs_kernel(const float* __restrict__ kvs, int M, int D, P* __restrict__ hl) {
  constexpr int kK = 128 / sizeof(P);
  constexpr int kPiece = kKvsPiece / sizeof(P);
  const int ka = cdiv(M, kK);
  const size_t count = split_kvs_elems<P>(M, D) / 2;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int chunk = static_cast<int>(i / kPiece);
    const int n = static_cast<int>(i % kPiece) / kK;
    const int k = static_cast<int>(i % kK);
    const int d = chunk / ka * kTcCols + n;
    const int m = chunk % ka * kK + k;
    const int at = std::is_same_v<P, float> ? sw128_offset_f32(n, k) : sw128_offset(n, k);
    const size_t off = static_cast<size_t>(chunk) * 2 * kPiece + at / sizeof(P);
    split_store<2>(m < M && d < D ? kvs[static_cast<size_t>(m) * D + d] : 0.f, hl + off,
                   kPiece);
  }
}

// The split on stream st: grid-stride, at most 1024 blocks.
template <typename P>
cudaError_t launch_split_kvs(const float* kvs, int M, int D, P* hl, cudaStream_t st) {
  const size_t count = split_kvs_elems<P>(M, D) / 2;
  const size_t want = (count + kSplitThreads - 1) / kSplitThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1024 ? want : 1024);
  split_kvs_kernel<P><<<blocks, kSplitThreads, 0, st>>>(kvs, M, D, hl);
  return cudaGetLastError();
}

}  // namespace tc
