// Ragged unified-batch paged attention: one launch over a flat token batch
// that mixes chunked-prefill spans and decode tokens of different sequences.
//
// Replaces: dynamo_tpu/ops/pallas/ragged_attention.py
//   ragged_paged_attention (kernel _ragged_kernel).
//
// Computes: token i (lane token_lane[i], position token_pos[i]; -1 = pad)
//   attends, per head, every cached position of its own lane up to its own
//   position (and inside the sliding window when one is set), softmax in
//   fp32.  The flat token axis is cut into blocks of tb tokens; the host
//   (pack_page_meta) lists for each block the physical pages its tokens can
//   see: page_phys/page_lane/page_ord[t, j] for j < page_count[t].
//
// Bound: HBM bytes at decode-heavy mixes (each listed page's K/V rows are
//   read once per token block), flops on long prefill spans: 4 flops per
//   visible (token, position, head, dim).  This simple kernel runs its
//   products on the fp32 CUDA cores, so long spans are compute-bound here;
//   tensor cores (wgmma) are a later step.
//
// Design: one CTA per (token block, kv head), holding the tb * groups query
//   rows of that kv head.  It walks the block's worklist entries j <
//   page_count[t] (the gate matters: pad entries repeat the last page and
//   would be counted twice) in tiles of KEYS cache rows, stages the head's
//   K/V rows in shared memory, and masks each (row, key) pair by the row's
//   own lane and position — one block mixes lanes, so the mask is per row,
//   not per block.  A block with no live entry writes zeros.  The TPU
//   layout is not carried over: no flat [bs*KVH, D] page, no iota GQA mask
//   (which cost KVH x the products), no pages_per_step (the output does not
//   depend on it).

#include "attention_common.cuh"

namespace {

template <typename T>
struct WorklistKeys {
  const T* k_cache;
  const T* v_cache;
  const int* phys;  // this token block's worklist rows
  const int* lanes;
  const int* ords;
  int bs, kvh, head, D;
  __device__ size_t row(int key) const {
    return ((size_t)(phys[key / bs] * bs + key % bs) * kvh + head) * D;
  }
  __device__ int pos(int key) const { return ords[key / bs] * bs + key % bs; }
  __device__ int lane(int key) const { return lanes[key / bs]; }
};

template <typename T, int D>
__global__ void __launch_bounds__(dyn::THREADS)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ token_lane,
              const int* __restrict__ token_pos, const int* __restrict__ page_phys,
              const int* __restrict__ page_lane, const int* __restrict__ page_ord,
              const int* __restrict__ page_count, T* __restrict__ out, int H,
              int KVH, int bs, int tb, int page_slots, int sliding_window) {
  extern __shared__ float smem_raw[];
  const int t = blockIdx.x, head = blockIdx.y;
  const int groups = H / KVH;
  const int rows = tb * groups;
  dyn::Smem<D> s(smem_raw, rows);

  // row r = (token tok of this block, head group g); q/out are [T, H, D]
  for (int i = threadIdx.x; i < rows * D; i += dyn::THREADS) {
    const int r = i / D, d = i % D;
    const int tok = t * tb + r / groups, g = r % groups;
    s.q[i] = dyn::to_f32(q[((size_t)tok * H + head * groups + g) * D + d]);
  }
  for (int r = threadIdx.x; r < rows; r += dyn::THREADS) {
    const int tok = t * tb + r / groups;
    s.row_pos[r] = token_pos[tok];
    s.row_lane[r] = token_lane[tok];
  }

  const size_t wl = (size_t)t * page_slots;
  const int count = min(page_count[t], page_slots);
  WorklistKeys<T> keys{k_cache, v_cache, page_phys + wl, page_lane + wl,
                       page_ord + wl, bs, KVH, head, D};
  const float scale = 1.0f / sqrtf((float)D);
  dyn::attend<T, D>(s, rows, keys, 0, count * bs, sliding_window, scale,
                    [&](int r) {
                      const int tok = t * tb + r / groups, g = r % groups;
                      return out + ((size_t)tok * H + head * groups + g) * D;
                    });
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* tl,
           const int* tp, const int* pp, const int* pl, const int* po,
           const int* pc, void* out, int T_, int H, int KVH, int bs, int tb,
           int page_slots, int sliding_window, cudaStream_t stream) {
  const int rows = tb * (H / KVH);
  const size_t smem = dyn::Smem<D>::bytes(rows);
  auto kernel = ragged_kernel<T, D>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T_ / tb, KVH);
  kernel<<<grid, dyn::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      tl, tp, pp, pl, po, pc, static_cast<T*>(out), H, KVH, bs, tb, page_slots,
      sliding_window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* tl,
               const int* tp, const int* pp, const int* pl, const int* po,
               const int* pc, void* out, int T_, int H, int KVH, int bs, int tb,
               int page_slots, int sliding_window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    case 64: return launch<T, 64>(q, k, v, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    case 128: return launch<T, 128>(q, k, v, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    default: return dyn::ERR_UNSUPPORTED;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// T_ is a multiple of tb; sliding_window <= 0 means full attention.
// Returns 0 or an error code.
extern "C" int dyn_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* token_lane, const void* token_pos, const void* page_phys,
    const void* page_lane, const void* page_ord, const void* page_count,
    void* out, int T_, int H, int KVH, int D, int bs, int tb, int page_slots,
    int sliding_window, int dtype, void* stream) {
  if (T_ == 0) return 0;
  if (KVH <= 0 || H % KVH || tb <= 0 || T_ % tb ||
      tb * (H / KVH) > dyn::MAX_ROWS)
    return dyn::ERR_UNSUPPORTED;
  const int* tl = static_cast<const int*>(token_lane);
  const int* tp = static_cast<const int*>(token_pos);
  const int* pp = static_cast<const int*>(page_phys);
  const int* pl = static_cast<const int*>(page_lane);
  const int* po = static_cast<const int*>(page_ord);
  const int* pc = static_cast<const int*>(page_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_cache, v_cache, tl, tp, pp, pl, po, pc, out,
                             T_, H, KVH, bs, tb, page_slots, sliding_window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, tl, tp, pp, pl, po,
                                     pc, out, T_, H, KVH, bs, tb, page_slots,
                                     sliding_window, st);
  return dyn::ERR_UNSUPPORTED;
}
