// Paged GQA attention over block tables for W queries per sequence.
//
// Replaces: dynamo_tpu/ops/pallas/paged_attention.py
//   paged_window_attention_decode (kernel _window_kernel), which the decode
//   step reaches at W=1 through paged_attention_decode.
//
// Computes: for sequence b, query w (at position ctx_b - W + w) and head h,
//   softmax over cached positions pos <= ctx_b - W + w (and, with a sliding
//   window, pos > that - window) of q.k / sqrt(D), times V, read through the
//   sequence's block table from the [N, bs, KVH, D] cache.
//
// Bound: HBM bytes.  A decode step reads every visible K and V row once
//   (sum_b ctx_b * KVH * D * 2 * sizeof) and does 4 flops per cached
//   element per query head, far below the card's flop-to-byte ratio.
//
// Design: one CTA per (sequence, kv head).  The CTA holds the W * groups
//   query rows of that kv head, so each K/V row of the head is read from HBM
//   once and serves all `groups` query heads (the TPU kernel instead scored
//   a flat [bs*KVH, D] page against every head and masked KVH-1 of every KVH
//   products away).  It walks the block table up to ctx in tiles of KEYS
//   positions, skipping pages wholly below the sliding window, stages the
//   head's K/V rows in shared memory with 16-byte loads, and keeps an fp32
//   online softmax (attention_common.cuh).  The TPU kernel's pages_per_step
//   has no counterpart: the output does not depend on it.  Not yet done:
//   split-K over long contexts (flash-decoding), tensor cores, TMA.

#include "attention_common.cuh"

namespace {

template <typename T>
struct TableKeys {
  const T* k_cache;
  const T* v_cache;
  const int* table;  // this sequence's block-table row
  int bs, kvh, head, D;
  __device__ size_t row(int key) const {
    const int page = table[key / bs];
    return ((size_t)(page * bs + key % bs) * kvh + head) * D;
  }
  __device__ int pos(int key) const { return key; }
  __device__ int lane(int) const { return 0; }
};

template <typename T, int D>
__global__ void __launch_bounds__(dyn::THREADS)
window_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ block_tables,
              const int* __restrict__ context_lens, T* __restrict__ out, int W,
              int H, int KVH, int bs, int max_blocks, int sliding_window) {
  extern __shared__ float smem_raw[];
  const int b = blockIdx.x, head = blockIdx.y;
  const int groups = H / KVH;
  const int rows = W * groups;
  dyn::Smem<D> s(smem_raw, rows);
  // a verify window clamped at the engine's last position can reach past
  // the table: its queries keep their own positions, the keys stop at the
  // table's end (the TPU kernel's grid has max_blocks pages)
  const int ctx_in = context_lens[b];
  const int ctx = min(ctx_in, max_blocks * bs);

  // row r = (window query w, head group g); q/out are [B, W, H, D]
  for (int i = threadIdx.x; i < rows * D; i += dyn::THREADS) {
    const int r = i / D, d = i % D;
    const int w = r / groups, g = r % groups;
    s.q[i] = dyn::to_f32(q[(((size_t)b * W + w) * H + head * groups + g) * D + d]);
  }
  for (int r = threadIdx.x; r < rows; r += dyn::THREADS) {
    s.row_pos[r] = ctx_in - W + r / groups;
    s.row_lane[r] = 0;
  }

  int begin = 0;
  if (sliding_window > 0) {
    // lowest position any window query can see, rounded down to its page
    const int lowest = min(max(0, ctx_in - W - (sliding_window - 1)), ctx);
    begin = (lowest / bs) * bs;
  }
  TableKeys<T> keys{k_cache, v_cache, block_tables + (size_t)b * max_blocks,
                    bs, KVH, head, D};
  const float scale = 1.0f / sqrtf((float)D);
  dyn::attend<T, D>(s, rows, keys, begin, ctx, sliding_window, scale,
                    [&](int r) {
                      const int w = r / groups, g = r % groups;
                      return out + (((size_t)b * W + w) * H + head * groups + g) * D;
                    });
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* lens, void* out, int B, int W, int H, int KVH, int bs,
           int max_blocks, int sliding_window, cudaStream_t stream) {
  const int rows = W * (H / KVH);
  const size_t smem = dyn::Smem<D>::bytes(rows);
  auto kernel = window_kernel<T, D>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KVH);
  kernel<<<grid, dyn::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      tables, lens, static_cast<T*>(out), W, H, KVH, bs, max_blocks, sliding_window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* tables, const int* lens, void* out, int B, int W,
               int H, int KVH, int bs, int max_blocks, int sliding_window,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    case 64: return launch<T, 64>(q, k, v, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    case 128: return launch<T, 128>(q, k, v, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    default: return dyn::ERR_UNSUPPORTED;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// sliding_window <= 0 means full attention.  Returns 0 or an error code.
extern "C" int dyn_paged_window_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* context_lens, void* out, int B,
    int W, int H, int KVH, int D, int bs, int max_blocks, int sliding_window,
    int dtype, void* stream) {
  if (B == 0) return 0;
  if (KVH <= 0 || H % KVH || W * (H / KVH) > dyn::MAX_ROWS) return dyn::ERR_UNSUPPORTED;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_cache, v_cache, tables, lens, out, B, W, H,
                             KVH, bs, max_blocks, sliding_window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, tables, lens, out,
                                     B, W, H, KVH, bs, max_blocks, sliding_window, st);
  return dyn::ERR_UNSUPPORTED;
}
