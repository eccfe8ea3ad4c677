// Tensor-core building blocks of the linear-attention kernels
// (linear_attention.cu, linear_attention_bwd.cu), sm_90a:
//
// - PTX wrappers: ldmatrix (plain and transposed), mma.sync m16n8k16 bf16
//   -> f32, cp.async of 16 and 4 bytes; wgmma m64n64k16 bf16 -> f32 with
//   its fences and the 128-byte-swizzled shared-memory layout and
//   descriptors it reads (the forward apply's);
// - TF32: the rounding of an f32 to tf32, mma.sync m16n8k8 tf32 -> f32 and
//   the 3xTF32 product of two f32 operands split into tf32 hi + lo (the f32
//   backward's);
// - the split of kvs^T into bf16 or tf32 pieces, the B operand of
//   a = q @ kvs in the forward apply and the backward reduce's rows pass;
// - the node-axis contraction C[m, n] += sum_r A[r, m] * B[r, n], with A and
//   B held node-major in shared memory (a chunk of kNodeRows node rows of
//   kNodeTile columns each). It is kvs = k^T v of the forward reduce and
//   P = q^T (g / den) of the backward reduce: the [N, M]^T x [N, D] product
//   that the TPU kernels accumulate over their sequential grid and that the
//   card splits over slices of N.
//
// Both operands are node-major, so the MMA's A fragment (row-major m x k)
// and B fragment ("col", k x n) are each the transpose of what shared memory
// holds: ldmatrix.trans loads them. Rows are kNodeStride = kNodeTile + 8
// bf16 apart (272 bytes), so the 8 row addresses of one 8x8 matrix fall in
// distinct 16-byte bank groups.

#pragma once

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// registers only, so not volatile: the compiler may interleave the MMAs
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

// c += a b over a 16 x 8 x 8 tile: tf32 in (a: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b: b0 (k = t, n = g), b1 (t + 4, g),
// with g = lane / 4, t = lane % 4), f32 sums laid out as mma_bf16's
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The node-axis contraction. A block of kNodeThreads threads owns one
// kNodeTile x kNodeTile output tile over a slice of node rows: 8 warps in a
// 4 (m) x 2 (n) grid of 32 x 64 warp tiles, 2 m16 x 8 n8 MMA tiles each.

constexpr int kNodeRows = 32;                   // node rows per staged chunk: two k16 steps
constexpr int kNodeTile = 128;                  // output tile, m and n
constexpr int kNodeStride = kNodeTile + 8;      // bf16 per staged row
constexpr int kNodeThreads = 256;
constexpr int kNodeChunk = kNodeRows * kNodeStride;  // bf16 of one staged operand chunk

// Rows [r0, r0 + kNodeRows) of X (ld elements apart) at columns
// [c0, c0 + kNodeTile) into S [kNodeRows][kNodeStride], zeros at rows from
// r_end and columns from width; T is bf16 or float. vec: 16-byte cp.async
// copies (width and ld multiples of 16 bytes' elements, X 16-byte aligned),
// which the caller commits and waits for; else one element at a time,
// synchronously.
template <typename T>
__device__ __forceinline__ void stage_node_rows(T* S, const T* __restrict__ X, long ld, long r0,
                                                long r_end, int c0, int width, int vec, int tid) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kSegs = kNodeTile / kPer;
#pragma unroll
    for (int it = 0; it < kNodeRows * kSegs / kNodeThreads; ++it) {
      const int i = tid + it * kNodeThreads;
      const int r = i / kSegs;
      const int c = (i % kSegs) * kPer;
      const bool ok = r0 + r < r_end && c0 + c < width;
      cp_async16(S + r * kNodeStride + c, ok ? X + (r0 + r) * ld + c0 + c : X, ok);
    }
  } else {
    for (int i = tid; i < kNodeRows * kNodeTile; i += kNodeThreads) {
      const int r = i / kNodeTile;
      const int c = i % kNodeTile;
      const bool ok = r0 + r < r_end && c0 + c < width;
      if constexpr (std::is_same_v<T, float>) {
        S[r * kNodeStride + c] = ok ? X[(r0 + r) * ld + c0 + c] : 0.f;
      } else {
        S[r * kNodeStride + c] = ok ? X[(r0 + r) * ld + c0 + c] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// acc += A^T B over one staged chunk, for the warp tile at (wm, wn):
// acc[mt][nt] = {(m, n), (m, n+1), (m+8, n), (m+8, n+1)} with m = wm + mt*16
// + lane/4, n = wn + nt*8 + 2*(lane%4). B is given in kHalves bf16 pieces
// (hi, lo of an f32 operand), each one MMA into the same sums.
//
// The chunk's products are summed by the MMAs into fresh accumulators, 16
// columns at a time, and each chunk sum is added to acc with an f32
// round-to-nearest add. A slice chains thousands of rows into one sum: the
// tensor cores' own accumulation, which may truncate, then only ever adds a
// chunk's 32 rows, so a bias of the MMA's rounding cannot grow with the
// slice (it would be ~1e-5 of a sum of positive terms over 160 chained MMAs).
template <int kHalves>
__device__ __forceinline__ void node_mma_chunk(float (&acc)[2][8][4], const bf16* As,
                                               const bf16* const (&Bs)[kHalves], int wm, int wn,
                                               int lane) {
  constexpr int kSteps = kNodeRows / 16;
  const int r = lane & 7;
  const int j = lane >> 3;  // which 8x8 matrix of the x4 this lane addresses
  // A (m x k) of every k-step: matrix j at m + (j & 1) * 8, k + (j >> 1) * 8
  unsigned a[kSteps][2][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4_trans(a[ks][mt], As + (ks * 16 + (j >> 1) * 8 + r) * kNodeStride + wm +
                                       mt * 16 + (j & 1) * 8);
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    float part[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        // B (k x n), two n8 tiles: matrix j at k + (j & 1) * 8, n + (j >> 1) * 8
        unsigned b[4];
        ldmatrix_x4_trans(b, Bs[h] + (ks * 16 + (j & 1) * 8 + r) * kNodeStride + wn + np * 16 +
                                 (j >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(part[mt][0], a[ks][mt], b[0], b[1]);
          mma_bf16(part[mt][1], a[ks][mt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][2 * np + t][e] = __fadd_rn(acc[mt][2 * np + t][e], part[mt][t][e]);
  }
}

// The block's tile of acc into part [rows][cols] (row-major, cols apart),
// at its origin (m0, n0), clipped to rows x cols.
__device__ __forceinline__ void store_node_tile(float* __restrict__ part,
                                                const float (&acc)[2][8][4], int m0, int n0,
                                                int rows, int cols, int wm, int wn, int lane) {
  const bool pairs = (cols & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + (lane >> 2) + half * 8;
      if (m >= rows) continue;
      float* row = part + static_cast<size_t>(m) * cols;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * (lane & 3);
        const float x = acc[mt][nt][half * 2];
        const float y = acc[mt][nt][half * 2 + 1];
        if (pairs && n + 1 < cols) {
          *reinterpret_cast<float2*>(row + n) = make_float2(x, y);
        } else {
          if (n < cols) row[n] = x;
          if (n + 1 < cols) row[n + 1] = y;
        }
      }
    }
}

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

// d[64 x 64] += A[64 x 16] B[16 x 64], bf16 in, f32 sums; d as the
// accumulator fragment: d[4j + 2h + e] at row 16*warp + lane/4 + 8h and
// column 8j + 2*(lane%4) + e of the warpgroup's tile.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// keeps the compiler from moving accesses of d across the asynchronous MMAs
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr size_t kSmemPerBlock = 232448;  // the H100's dynamic shared memory a block may use

// ---------------------------------------------------------------------------
// The B operand of the row kernels' a = q @ kvs (the forward apply, the
// backward reduce's rows pass): kvs^T, f32 in meaning, split into bf16
// pieces, each [n = D][k = M] with both extents padded by zeros to kSplitPad.

constexpr int kSplitPad = 64;

__host__ __device__ constexpr int split_pad(int x) { return cdiv(x, kSplitPad) * kSplitPad; }

// bf16 elements of one piece
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

// hl[...] = kvs^T as kPieces pieces of type P (bf16, or tf32 in an f32),
// each [n = D][k = M], zero in the pads.
template <int kPieces, typename P>
__global__ void __launch_bounds__(kSplitThreads)
split_t_kernel(const float* __restrict__ kvs, int M, int D, P* __restrict__ hl) {
  const int Mk = split_pad(M);
  const size_t count = split_t_elems(M, D);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i / Mk);
    const int m = static_cast<int>(i % Mk);
    split_store<kPieces>(m < M && d < D ? kvs[static_cast<size_t>(m) * D + d] : 0.f, hl + i,
                         count);
  }
}

// The split on stream st: grid-stride, at most 1024 blocks.
template <int kPieces, typename P>
cudaError_t launch_split_t(const float* kvs, int M, int D, P* hl, cudaStream_t st) {
  const size_t count = split_t_elems(M, D);
  const size_t want = (count + kSplitThreads - 1) / kSplitThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1024 ? want : 1024);
  split_t_kernel<kPieces, P><<<blocks, kSplitThreads, 0, st>>>(kvs, M, D, hl);
  return cudaGetLastError();
}

}  // namespace tc
