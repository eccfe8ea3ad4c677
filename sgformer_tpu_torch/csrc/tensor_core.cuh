// Tensor-core building blocks of the linear-attention kernels
// (linear_attention.cu, linear_attention_bwd.cu), sm_90a:
//
// - PTX wrappers: ldmatrix (plain and transposed), mma.sync m16n8k16 bf16
//   -> f32, cp.async of 16 and 4 bytes;
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
// r_end and columns from width. vec: 16-byte cp.async copies (width and ld
// multiples of 8, X 16-byte aligned), which the caller commits and waits
// for; else one element at a time, synchronously.
__device__ __forceinline__ void stage_node_rows(bf16* S, const bf16* __restrict__ X, long ld,
                                                long r0, long r_end, int c0, int width, int vec,
                                                int tid) {
  if (vec) {
    constexpr int kSegs = kNodeTile / 8;
#pragma unroll
    for (int it = 0; it < kNodeRows * kSegs / kNodeThreads; ++it) {
      const int i = tid + it * kNodeThreads;
      const int r = i / kSegs;
      const int c = (i % kSegs) * 8;
      const bool ok = r0 + r < r_end && c0 + c < width;
      cp_async16(S + r * kNodeStride + c, ok ? X + (r0 + r) * ld + c0 + c : X, ok);
    }
  } else {
    for (int i = tid; i < kNodeRows * kNodeTile; i += kNodeThreads) {
      const int r = i / kNodeTile;
      const int c = i % kNodeTile;
      const bool ok = r0 + r < r_end && c0 + c < width;
      S[r * kNodeStride + c] = ok ? X[(r0 + r) * ld + c0 + c] : __float2bfloat16_rn(0.f);
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

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace tc
