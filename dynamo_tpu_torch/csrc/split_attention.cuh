// Building blocks of the split (flash-decoding) tensor-core attention
// kernels: paged_attention.cu (GQA decode and verify window, bf16) and the
// ragged MLA kernel of mla_attention.cu.
//
// - cp.async 16-byte copies global -> shared, with a zero fill for keys
//   past the end of a walk (a zero row times a zero probability, never
//   0 * junk);
// - ldmatrix (plain and transposed) and mma.sync m16n8k16 bf16 x bf16 ->
//   fp32, the fragment layouts of the PTX ISA: for lane l, g = l / 4 and
//   t = l % 4, an A fragment holds rows g and g + 8, columns 2t, 2t + 1
//   (+ 8); a B fragment columns (the N index) g, rows (the K index) 2t,
//   2t + 1 (+ 8); a C fragment rows g and g + 8, columns 2t, 2t + 1;
// - the merge of partial softmax states (m, l, acc) in a fixed order, so a
//   split walk gives the same bits on every launch.
//
// Scores live in the log2 domain (scaled by log2(e)), so a partial's m is
// a base-2 running max and every exponential is exp2f.  NEG_INF marks a
// row that saw no key: its weight in a merge is 0 and its acc is never
// read, so a partial that was not written cannot leak into the output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace dyn {
namespace tc {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; `valid` false fills the destination with zeros (src unread)
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The row (and column) of a 16x16 tile whose address lane l gives to an x4
// ldmatrix, for the two fragment orders used here:
//   A order (and the transposed B of a [K][N] tile): matrices (rows 0-7,
//     cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
//   B order of an [N][K] tile: (0-7, 0-7), (0-7, 8-15), (8-15, 0-7),
//     (8-15, 8-15) -> registers b0, b1 of N tile 0, then of N tile 1.
__device__ inline int a_row(int l) { return ((l >> 3) & 1) * 8 + (l & 7); }
__device__ inline int a_col(int l) { return (l >> 4) * 8; }
__device__ inline int b_row(int l) { return (l >> 4) * 8 + (l & 7); }
__device__ inline int b_col(int l) { return ((l >> 3) & 1) * 8; }

// d += a * b (m16n8k16, bf16 inputs, fp32 accumulation)
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (x in the low half: the lower column).
__device__ inline uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The high and low bf16 parts of two floats: x = hi + lo to within 2^-17 |x|.
__device__ inline void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Weight of a partial with running max m (log2 domain) against the merged
// max M; 0 for a partial that saw no key.
__device__ inline float merge_weight(float m, float M) {
  return m == NEG_INF ? 0.f : exp2f(m - M);
}

// One online-softmax step for the C-fragment rows of one thread: `s` holds
// the 4 scores (log2 domain) of a row over two N tiles (keys 2t, 2t + 1,
// 8 + 2t, 9 + 2t), NEG_INF where masked; they become probabilities.
// Updates the row's m and thread-partial l; returns the rescale of acc.
__device__ inline float softmax_step(float (&s)[4], float& m, float& l) {
  float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
  const float m_new = fmaxf(m, mx);
  const float alpha = exp2f(m - m_new);  // 1 while both are NEG_INF
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = s[i] == NEG_INF ? 0.f : exp2f(s[i] - m_new);
    sum += s[i];
  }
  m = m_new;
  l = l * alpha + sum;
  return alpha;
}

// The merge weights of n partials of one row, in place: m[0..n) (shared
// memory, their running maxima) becomes w[j] = 2^(m[j] - max m), 0 for a
// partial that saw no key; returns sum_j w[j] l[j], the same value in the
// same summation order in every thread.  Every thread of the block calls
// it after writing m and l; `red` is 2 floats of shared memory.
__device__ inline float merge_weights(float* m, const float* l, int n, float* red) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < 32) {  // the max is exact in any order
    float mx = NEG_INF;
    for (int j = tid; j < n; j += 32) mx = fmaxf(mx, m[j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if (tid == 0) red[0] = mx;
  }
  __syncthreads();
  const float M = red[0];
  for (int j = tid; j < n; j += blockDim.x) m[j] = merge_weight(m[j], M);
  __syncthreads();
  if (tid < 32) {  // a fixed order: lane sums in j order, then a fixed tree
    float sum = 0.f;
    for (int j = tid; j < n; j += 32) sum += m[j] * l[j];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (tid == 0) red[1] = sum;
  }
  __syncthreads();
  return red[1];
}

// Sum of a thread-partial l over the four threads that share a row.
__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace tc
}  // namespace dyn
