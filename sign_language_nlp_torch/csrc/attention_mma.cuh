// Tensor-core building blocks shared by K1 (fused_attention_fwd.cu) and K2
// (fused_attention_bwd.cu): 3xTF32 products on mma.sync, tile copies with
// cp.async, and the score tile S = A B^T that both kernels must compute bit
// for bit alike.
//
// 3xTF32. mma.sync.m16n8k8 takes TF32 operands (a 10-bit mantissa). Each
// f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// a·b is accumulated in f32 as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (the small
// terms first). The dropped lo·lo term is below 2^-22 of |a·b|, so the
// products keep f32 accuracy on the tensor cores.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t+4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                          c3 (g+8, 2t+1)
// A product P·V whose A operand is a C fragment (P) reads it with no
// shuffle: the sum over k does not care about the order of k, so A's
// column t is taken as k = 2t and column t+4 as k = 2t+1, and B's rows as
// the same k (b0 = V[2t][g], b1 = V[2t+1][g]).
//
// Shared-memory tiles hold rows of width W (a multiple of 32) at a stride
// of W + 4 floats: a B fragment of S = A B^T reads rows g, columns t (banks
// 4g + t), and one of P·V reads rows 2t and 2t+1, columns g (banks 8t + g),
// both free of bank conflicts.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace slt {

constexpr int kWarps = 4;  // warps per block, 16 rows (or keys) each
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32, a and b already split.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// An A fragment from four f32 values (a0..a3 in the layout above).
__device__ __forceinline__ void split_a(float x0, float x1, float x2,
                                        float x3, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  split_tf32(x0, ah[0], al[0]);
  split_tf32(x1, ah[1], al[1]);
  split_tf32(x2, ah[2], al[2]);
  split_tf32(x3, ah[3], al[3]);
}

// S[16][NT*8] = A[16][W] B[NT*8][W]^T for one warp: sA points at the warp's
// first row, sB at the tile's first key, both at stride W + 4. The same
// function in K1 and K2 gives the same bits for the same row and key (the
// k loop runs in one order, from zero), which K2's exact zeros need.
template <int W, int NT>
__device__ __forceinline__ void scores_abt(float (&s)[NT][4], const float* sA,
                                           const float* sB, int g, int t) {
  constexpr int LD = W + 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
  for (int kc = 0; kc < W / 8; ++kc) {
    const int c = kc * 8 + t;
    uint32_t ah[4], al[4];
    split_a(sA[g * LD + c], sA[(g + 8) * LD + c], sA[g * LD + c + 4],
            sA[(g + 8) * LD + c + 4], ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = sB + (8 * j + g) * LD + c;
      mma_3xtf32(s[j], ah, al, b[0], b[4]);
    }
  }
}

// acc[n] += P V over one chunk of 8 keys: P's C fragment (p0..p3 = c0..c3
// of that chunk) as the A operand, V rows from sV (the chunk's first key,
// stride W + 4), all W / 8 column tiles.
template <int W>
__device__ __forceinline__ void accumulate_pv(float (&acc)[W / 8][4],
                                              float p0, float p1, float p2,
                                              float p3, const float* sV,
                                              int g, int t) {
  constexpr int LD = W + 4;
  uint32_t ah[4], al[4];
  split_a(p0, p2, p1, p3, ah, al);  // (g,2t), (g+8,2t), (g,2t+1), (g+8,2t+1)
  const float* v0 = sV + (2 * t) * LD + g;
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
    mma_3xtf32(acc[n], ah, al, v0[8 * n], v0[LD + 8 * n]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying rows [r0, r0 + R) of one head's columns [c0, c0 + W) from
// model layout into dst[R][W + 4]; src points at the head's column 0 of row
// 0 (row stride E). Rows at or past n_rows and columns at or past D are
// zero-filled. With vec (D and E multiples of 4, 16-byte aligned tensors),
// 16 bytes a thread; else 4.
template <int R, int W>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n_rows, int c0, int D,
                                          int E, bool vec) {
  constexpr int LD = W + 4;
  if (vec) {
    for (int i = threadIdx.x; i < R * W / 4; i += kThreads) {
      const int r = i / (W / 4), c = (i % (W / 4)) * 4;
      const int row = r0 + r, d = c0 + c;
      const bool ok = row < n_rows && d < D;
      cp_async16(dst + r * LD + c, ok ? src + size_t(row) * E + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += kThreads) {
      const int r = i / W, c = i % W;
      const int row = r0 + r, d = c0 + c;
      const bool ok = row < n_rows && d < D;
      cp_async4(dst + r * LD + c, ok ? src + size_t(row) * E + d : src, ok);
    }
  }
}

// Sum over the four threads of a quad (the threads that share a row of a
// C fragment), in one fixed order.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The padded width of a head: D rounded up to 32, 64, 128 or 256.
inline int padded_width(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Whether load_tile may copy 16 bytes a thread from this tensor.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace slt
