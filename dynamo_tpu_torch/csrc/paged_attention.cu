// Paged GQA attention over block tables for W queries per sequence.
//
// Replaces: dynamo_tpu/ops/pallas/paged_attention.py
//   paged_window_attention_decode (kernel _window_kernel), which the decode
//   step reaches at W=1 through paged_attention_decode and speculative
//   verify at W = spec_tokens + 1.
//
// Computes: for sequence b, query w (at position ctx_b - W + w) and head h,
//   softmax over cached positions pos <= ctx_b - W + w (and, with a sliding
//   window, pos > that - window) of q.k / sqrt(D), times V, read through the
//   sequence's block table from the [N, bs, KVH, D] cache.
//
// Cache dtypes: q and out are float32 or bf16, the cache any of
//   attention_common.cuh's CacheType (the TPU kernel upcasts its cache at
//   load).  An fp8 cache (e4m3fn, e5m2) under bf16 queries takes the split
//   walk below: each warp's ring holds the raw fp8 sub-tiles (16 elements a
//   16-byte copy, half the bytes of bf16), and each lane converts the
//   chunks it copied to bf16 in a tile beside the ring (exact) before the
//   same ldmatrix and mma.sync products.  A float16 cache takes the
//   CUDA-core loop, converting on load.
//
// Bound: HBM bytes.  A step reads every visible K and V row once
//   (sum_b ctx_b * KVH * D * 2 * sizeof) and does 4 flops per cached
//   element per query head, far below the card's flop-to-byte ratio.  So
//   the design is about keeping enough bytes in flight on every SM.
//
// Design (bf16, head dims 64 and 128): flash-decoding on the tensor cores.
//   - The cache walk is split across CTAs.  The grid is (split, kv head x
//     row group, sequence); split s walks pages [s * chunk, (s+1) * chunk)
//     of the table, chunk = chunk_pages, chosen by the wrapper from the
//     shapes alone (plan_splits in ops/kernels/paged_attention.py: a grid
//     of about 2 CTAs an SM, chunks of at least 64 positions, at most 64
//     splits; at 8 kv heads and a 128-page table: 32 splits of 4 pages at
//     B = 1, 5 of 26 at B = 8, 2 of 64 at B = 32), never from
//     context_lens, so a step needs no device-to-host read.  A CTA holds the W * H/KVH query rows of one kv
//     head (up to 32; a wider window takes two row groups), so each K/V
//     row is read once for all the heads that share it.
//   - Splits past the context, or wholly below the sliding window, exit at
//     once and write nothing.  The split that walks a sequence's only
//     non-empty chunk writes the output itself; otherwise each non-empty
//     split writes a float32 partial (acc [rows, D], m and l per row) and
//     window_combine_kernel merges them in split order: no float atomics,
//     the same bits on every launch.  A sequence with no key (an idle lane)
//     gets zeros from split 0.
//   - Inside a CTA, each of the 4 warps walks its own 16-key sub-tiles of
//     the chunk (sub-tile i goes to warp i % 4) with its own ring of 3
//     cp.async stages, the page ids looked up one sub-tile ahead; no CTA
//     barrier inside the walk.  K and V stay bf16 in shared memory.  Scores
//     are mma.sync m16n8k16 bf16 with fp32 accumulation, the query rows on
//     the M side (ldmatrix), the keys on N; P is rounded to bf16 for the
//     P.V product (V through ldmatrix.trans); the softmax stays float32
//     with the reference's contract: masked scores NEG_INF, their
//     exponentials 0, the denominator clamped at 1e-20.  The warps' states
//     merge through shared memory at the end.
//   Float32 queries, float32 and float16 caches and head dim 16 (the test
//   geometry) keep the CUDA-core tile loop of attention_common.cuh: one
//   CTA per (sequence, kv head).
//   The TPU kernel's pages_per_step has no counterpart: the output does not
//   depend on it.

#include "attention_common.cuh"
#include "split_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dyn::NEG_INF;
namespace tc = dyn::tc;

// ---------------------------------------------------------------------------
// float32 queries or caches, float16 caches and head dim 16: the CUDA-core
// tile loop
// ---------------------------------------------------------------------------

struct TableKeys {
  const int* table;  // this sequence's block-table row
  int bs, kvh, head, D;
  __device__ size_t row(int key) const {
    const int page = table[key / bs];
    return ((size_t)(page * bs + key % bs) * kvh + head) * D;
  }
  __device__ int pos(int key) const { return key; }
  __device__ int lane(int) const { return 0; }
};

// The keys [begin, end) a sequence's window can see: a verify window
// clamped at the engine's last position can reach past the table, so its
// queries keep their own positions and the keys stop at the table's end
// (the TPU kernel's grid has max_blocks pages); with a sliding window the
// walk starts at the page of the lowest position any query sees.
struct KeySpan {
  int begin, end;
};
__device__ inline KeySpan window_keys(int ctx_in, int W, int bs, int max_blocks,
                                      int sliding_window) {
  const int end = min(ctx_in, max_blocks * bs);
  int begin = 0;
  if (sliding_window > 0) {
    const int lowest = min(max(0, ctx_in - W - (sliding_window - 1)), end);
    begin = (lowest / bs) * bs;
  }
  return {begin, max(end, 0)};
}

template <typename T, int D>
__global__ void __launch_bounds__(dyn::THREADS)
window_kernel(const T* __restrict__ q, const void* __restrict__ k_cache,
              const void* __restrict__ v_cache, int code,
              const int* __restrict__ block_tables,
              const int* __restrict__ context_lens, T* __restrict__ out, int W,
              int H, int KVH, int bs, int max_blocks, int sliding_window) {
  extern __shared__ float smem_raw[];
  const int b = blockIdx.x, head = blockIdx.y;
  const int groups = H / KVH;
  const int rows = W * groups;
  dyn::Smem<D> s(smem_raw, rows);
  const int ctx_in = context_lens[b];
  const KeySpan span = window_keys(ctx_in, W, bs, max_blocks, sliding_window);

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
  TableKeys keys{block_tables + (size_t)b * max_blocks, bs, KVH, head, D};
  const float scale = 1.0f / sqrtf((float)D);
  dyn::attend<D>(s, rows, k_cache, v_cache, code, keys, span.begin, span.end,
                 sliding_window, scale,
                    [&](int r) {
                      const int w = r / groups, g = r % groups;
                      return out + (((size_t)b * W + w) * H + head * groups + g) * D;
                    });
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, int code, const int* tables,
           const int* lens, void* out, int B, int W, int H, int KVH, int bs,
           int max_blocks, int sliding_window, cudaStream_t stream) {
  const int rows = W * (H / KVH);
  const size_t smem = dyn::Smem<D>::bytes(rows);
  auto kernel = window_kernel<T, D>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KVH);
  kernel<<<grid, dyn::THREADS, smem, stream>>>(
      static_cast<const T*>(q), k, v, code, tables, lens, static_cast<T*>(out), W, H, KVH,
      bs, max_blocks, sliding_window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, int code,
               const int* tables, const int* lens, void* out, int B, int W,
               int H, int KVH, int bs, int max_blocks, int sliding_window,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, code, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    case 64: return launch<T, 64>(q, k, v, code, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    case 128: return launch<T, 128>(q, k, v, code, tables, lens, out, B, W, H, KVH, bs, max_blocks, sliding_window, stream);
    default: return dyn::ERR_UNSUPPORTED;
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 128: the split tensor-core walk
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int SUB = 16;       // keys a warp takes at a time: one MMA K step of P.V
constexpr int STAGES = 3;     // sub-tiles in flight per warp
constexpr int ROWS_CTA = 32;  // query rows one CTA holds: two 16-row MMA tiles
constexpr int MAX_SPLITS = 64;  // splits a (sequence, kv head) may have (the combine's)

// Shared memory: the CTA's query rows, then each warp's ring of K/V
// sub-tiles, which the warps' final states overwrite for their merge.  An
// fp8 cache's ring holds raw sub-tiles (RAW bytes a stage: K then V rows
// of D bytes) followed by one bf16 K/V tile the warp converts them into.
template <int D, bool FP8>
struct TcLayout {
  static constexpr int STR = D + 8;  // bf16 row stride: 16-byte rows, ldmatrix without conflicts
  static constexpr int SUB_ELEMS = SUB * STR;
  static constexpr int MSTR = D + 4;  // float row stride of a warp's acc in the merge
  static constexpr int RAW = 2 * SUB * D;  // bytes of a raw fp8 stage
  static constexpr size_t WARP_RING = FP8 ? (size_t)STAGES * RAW + 2 * SUB_ELEMS * sizeof(bf16)
                                          : (size_t)STAGES * 2 * SUB_ELEMS * sizeof(bf16);
  static constexpr size_t Q_BYTES = (size_t)ROWS_CTA * STR * sizeof(bf16);
  static constexpr size_t RING_BYTES = (size_t)TC_WARPS * WARP_RING;
  // acc [warps][rows][MSTR], m and l [warps][rows], merge weights [rows][warps], L [rows]
  static constexpr size_t MERGE_BYTES =
      ((size_t)TC_WARPS * ROWS_CTA * (MSTR + 2) + ROWS_CTA * (TC_WARPS + 1)) * sizeof(float);
  static constexpr size_t BYTES = Q_BYTES + (RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES);
};

// Partial states: acc [B, KVH, S, rows, D], m and l [B, KVH, S, rows]
// (l at ml + B * KVH * S * rows).
struct Partials {
  float* acc;
  float* ml;
  __device__ size_t row(int b, int head, int s, int r, int KVH, int S, int rows) const {
    return (((size_t)b * KVH + head) * S + s) * rows + r;
  }
};

// The splits [first, last] of a sequence that hold a key it can see
// (last < first: none).
struct SplitRange {
  int first, last;
  __device__ int used() const { return last - first + 1; }
};
__device__ inline SplitRange used_splits(const KeySpan& span, int chunk_keys) {
  if (span.end <= span.begin) return {0, -1};
  return {span.begin / chunk_keys, (span.end - 1) / chunk_keys};
}

// FP8: the cache is fp8 (e5m2 when `e5m2`, else e4m3fn), otherwise bf16.
template <int D, int MT, bool FP8>
__global__ void __launch_bounds__(TC_THREADS, 2)
window_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ k_cache,
                 const void* __restrict__ v_cache, bool e5m2,
                 const int* __restrict__ block_tables,
                 const int* __restrict__ context_lens, bf16* __restrict__ out,
                 Partials part, int W, int H, int KVH, int bs, int max_blocks,
                 int sliding_window, int chunk_pages, float scale_log2) {
  using L = TcLayout<D, FP8>;
  constexpr int STR = L::STR;
  constexpr int KS = D / 16;  // MMA K steps of the scores; pairs of N tiles of P.V
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x, b = blockIdx.z;
  const int S = gridDim.x, RG = gridDim.y / KVH;
  const int head = blockIdx.y / RG, rg = blockIdx.y % RG;
  const int G = H / KVH, rows = W * G;
  const int r0 = rg * ROWS_CTA, nrows = min(ROWS_CTA, rows - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group and column pair

  const int ctx_in = context_lens[b];
  const KeySpan span = window_keys(ctx_in, W, bs, max_blocks, sliding_window);
  const int chunk_keys = chunk_pages * bs;
  const SplitRange used = used_splits(span, chunk_keys);
  auto row_off = [&](int r) {  // r: row within the CTA; q and out are [B, W, H, D]
    const int rr = r0 + r, w = rr / G, g = rr % G;
    return (((size_t)b * W + w) * H + head * G + g) * D;
  };
  if (used.used() <= 0) {  // nothing visible: zeros, once
    if (s == 0)
      for (int i = tid; i < nrows * D; i += TC_THREADS) out[row_off(i / D) + i % D] = __float2bfloat16(0.f);
    return;
  }
  if (s < used.first || s > used.last) return;
  const bool direct = used.used() == 1;
  const int kb = max(s * chunk_keys, span.begin), ke = min((s + 1) * chunk_keys, span.end);

  bf16* qs = reinterpret_cast<bf16*>(smem);
  char* wring = smem + L::Q_BYTES + (size_t)warp * L::WARP_RING;
  bf16* ring = reinterpret_cast<bf16*>(wring);
  // fp8: the bf16 tile the warp converts each raw sub-tile into
  bf16* conv = reinterpret_cast<bf16*>(wring + (size_t)STAGES * L::RAW);
  const int* table = block_tables + (size_t)b * max_blocks;
  const int n_sub = tc::ceil_div(ke - kb, SUB);
  const int mine = n_sub > warp ? tc::ceil_div(n_sub - warp, TC_WARPS) : 0;

  // this lane's key (lane % 16) of the warp's n-th sub-tile: its cache row
  // (page * bs + offset), -1 past the end of the walk
  auto lookup = [&](int n) {
    const int key = kb + (warp + n * TC_WARPS) * SUB + (lane & 15);
    return n < mine && key < ke ? table[key / bs] * bs + key % bs : -1;
  };
  constexpr int EL = FP8 ? 16 : 8;  // elements a 16-byte chunk
  constexpr int CH = D / EL;          // 16-byte chunks a row
  auto issue = [&](int n, int my_row) {
    if (n < mine) {
#pragma unroll
      for (int i = lane; i < SUB * CH; i += 32) {
        const int j = i / CH, c = i % CH;
        const int row = __shfl_sync(tc::FULL, my_row, j);
        const size_t off = row >= 0 ? ((size_t)row * KVH + head) * D + c * EL : 0;
        if (FP8) {
          uint8_t* kd = reinterpret_cast<uint8_t*>(wring) + (n % STAGES) * L::RAW;
          tc::cp_async16(kd + j * D + c * 16, static_cast<const uint8_t*>(k_cache) + off, row >= 0);
          tc::cp_async16(kd + (SUB + j) * D + c * 16, static_cast<const uint8_t*>(v_cache) + off,
                         row >= 0);
        } else {
          bf16* kd = ring + (n % STAGES) * 2 * L::SUB_ELEMS;
          tc::cp_async16(kd + j * STR + c * 8, static_cast<const bf16*>(k_cache) + off, row >= 0);
          tc::cp_async16(kd + L::SUB_ELEMS + j * STR + c * 8,
                         static_cast<const bf16*>(v_cache) + off, row >= 0);
        }
      }
    }
    tc::cp_async_commit();  // one group a sub-tile, empty past the last
  };

#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n, lookup(n));
  int row_ahead = lookup(STAGES - 1);

  // the CTA's query rows, bf16, zero rows past the window's
  for (int i = tid; i < MT * 16 * (D / 8); i += TC_THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(q + row_off(r) + c * 8);
    *reinterpret_cast<uint4*>(qs + r * STR + c * 8) = v;
  }
  // positions of this thread's fragment rows (mt * 16 + gq + 8 * half);
  // -1 for padding rows, which then see no key
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gq + 8 * h;
      qpos[mt][h] = r < nrows ? ctx_in - W + (r0 + r) / G : -1;
    }
  __syncthreads();

  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int n = 0; n < mine; ++n) {
    issue(n + STAGES - 1, row_ahead);
    row_ahead = lookup(n + STAGES);
    tc::cp_async_wait<STAGES - 1>();
    if (FP8) {  // this lane's own chunks of the raw sub-tile, to bf16
      const uint8_t* raw = reinterpret_cast<const uint8_t*>(wring) + (n % STAGES) * L::RAW;
#pragma unroll
      for (int i = lane; i < SUB * CH; i += 32) {
        const int j = i / CH, c = i % CH;
        uint4 o[2];
        dyn::fp8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + j * D + c * 16), e5m2, o);
        *reinterpret_cast<uint4*>(conv + j * STR + c * 16) = o[0];
        *reinterpret_cast<uint4*>(conv + j * STR + c * 16 + 8) = o[1];
        dyn::fp8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + (SUB + j) * D + c * 16), e5m2, o);
        *reinterpret_cast<uint4*>(conv + L::SUB_ELEMS + j * STR + c * 16) = o[0];
        *reinterpret_cast<uint4*>(conv + L::SUB_ELEMS + j * STR + c * 16 + 8) = o[1];
      }
    }
    __syncwarp();
    const bf16* ks = FP8 ? conv : ring + (n % STAGES) * 2 * L::SUB_ELEMS;
    const bf16* vs = ks + L::SUB_ELEMS;
    const int key0 = kb + (warp + n * TC_WARPS) * SUB;

    // S = Q K^T: [rows, 16 keys] as two N tiles of 8 keys
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      tc::ldmatrix_x4(kf, ks + tc::b_row(lane) * STR + kk * 16 + tc::b_col(lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        tc::ldmatrix_x4(qa, qs + (mt * 16 + tc::a_row(lane)) * STR + kk * 16 + tc::a_col(lane));
        tc::mma_bf16(sc[mt][0], qa, kf[0], kf[1]);
        tc::mma_bf16(sc[mt][1], qa, kf[2], kf[3]);
      }
    }

    // mask, online softmax, P as bf16 A fragments
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qp = qpos[mt][h];
        float row_s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = i / 2, e = i % 2;
          const int key = key0 + j * 8 + 2 * tq + e;
          bool ok = key < ke && key <= qp;
          if (sliding_window > 0) ok = ok && key > qp - sliding_window;
          row_s[i] = ok ? sc[mt][j][2 * h + e] * scale_log2 : NEG_INF;
        }
        const float alpha = tc::softmax_step(row_s, m[mt][h], l[mt][h]);
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          acc[mt][nd][2 * h] *= alpha;
          acc[mt][nd][2 * h + 1] *= alpha;
        }
        pa[mt][h] = tc::pack_bf16(row_s[0], row_s[1]);      // keys 2t, 2t+1
        pa[mt][2 + h] = tc::pack_bf16(row_s[2], row_s[3]);  // keys 8+2t, 9+2t
      }
    }

    // acc += P V: V [16 keys, D] through ldmatrix.trans, two N tiles a load
#pragma unroll
    for (int dp = 0; dp < KS; ++dp) {
      uint32_t vf[4];
      tc::ldmatrix_x4_trans(vf, vs + tc::a_row(lane) * STR + dp * 16 + tc::a_col(lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tc::mma_bf16(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
        tc::mma_bf16(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
      }
    }
    __syncwarp();  // the sub-tile is consumed before its stage is refilled
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp's walk is done: the ring becomes the merge area

  // each warp's state to shared memory
  float* macc = reinterpret_cast<float*>(smem + L::Q_BYTES);     // [warps][rows][MSTR]
  float* mm = macc + (size_t)TC_WARPS * ROWS_CTA * L::MSTR;    // [warps][rows]
  float* ml = mm + TC_WARPS * ROWS_CTA;                          // [warps][rows]
  float* wgt = ml + TC_WARPS * ROWS_CTA;                         // [rows][warps]
  float* lsum = wgt + ROWS_CTA * TC_WARPS;                       // [rows]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gq + 8 * h;
      float* dst = macc + ((size_t)warp * ROWS_CTA + r) * L::MSTR;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(dst + nd * 8 + 2 * tq) =
            make_float2(acc[mt][nd][2 * h], acc[mt][nd][2 * h + 1]);
      const float lr = tc::quad_sum(l[mt][h]);
      if (tq == 0) {
        mm[warp * ROWS_CTA + r] = m[mt][h];
        ml[warp * ROWS_CTA + r] = lr;
      }
    }
  __syncthreads();
  // merge weights of the warps, in warp order
  for (int r = tid; r < nrows; r += TC_THREADS) {
    float M = NEG_INF;
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, mm[w * ROWS_CTA + r]);
    float Ls = 0.f;
    for (int w = 0; w < TC_WARPS; ++w) {
      const float e = tc::merge_weight(mm[w * ROWS_CTA + r], M);
      wgt[r * TC_WARPS + w] = e;
      Ls += e * ml[w * ROWS_CTA + r];
    }
    lsum[r] = Ls;
    if (!direct) {
      const size_t pr = part.row(b, head, s, r0 + r, KVH, S, rows);
      part.ml[pr] = M;
      part.ml[pr + (size_t)gridDim.z * KVH * S * rows] = Ls;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += TC_THREADS) {
    const int r = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float e = wgt[r * TC_WARPS + w];
      if (e != 0.f) a += e * macc[((size_t)w * ROWS_CTA + r) * L::MSTR + d];
    }
    if (direct)
      out[row_off(r) + d] = __float2bfloat16(a / fmaxf(lsum[r], 1e-20f));
    else
      part.acc[part.row(b, head, s, r0 + r, KVH, S, rows) * D + d] = a;
  }
}

// Merge the partials of every sequence with more than one non-empty split,
// in split order.  One CTA per (row, kv head, sequence), a thread a column.
template <int D>
__global__ void __launch_bounds__(D)
window_combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                      const int* __restrict__ context_lens, bf16* __restrict__ out,
                      int S, int W, int H, int KVH, int bs, int max_blocks,
                      int sliding_window, int chunk_pages) {
  __shared__ float sm[MAX_SPLITS], sl[MAX_SPLITS], red[2];
  const int r = blockIdx.x, head = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const KeySpan span = window_keys(context_lens[b], W, bs, max_blocks, sliding_window);
  const SplitRange used = used_splits(span, chunk_pages * bs);
  if (used.used() <= 1) return;  // written by the walk itself
  const int n = used.used(), G = H / KVH, rows = W * G;
  const Partials part{const_cast<float*>(acc), const_cast<float*>(ml)};
  const size_t l_off = (size_t)gridDim.z * KVH * S * rows;
  for (int j = tid; j < n; j += D) {
    const size_t pr = part.row(b, head, used.first + j, r, KVH, S, rows);
    sm[j] = ml[pr];
    sl[j] = ml[pr + l_off];
  }
  const float Ls = tc::merge_weights(sm, sl, n, red);
  float a = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float wt = sm[j];
    if (wt != 0.f) a += wt * acc[part.row(b, head, used.first + j, r, KVH, S, rows) * D + tid];
  }
  const int w = r / G, g = r % G;
  out[(((size_t)b * W + w) * H + head * G + g) * D + tid] = __float2bfloat16(a / fmaxf(Ls, 1e-20f));
}

template <int D, int MT, bool FP8>
int launch_tc(const void* q, const void* k, const void* v, bool e5m2, const int* tables,
              const int* lens, void* out, float* part_acc, float* part_ml, int B, int W, int H,
              int KVH, int bs, int max_blocks, int sliding_window, int splits, int chunk_pages,
              cudaStream_t stream) {
  using L = TcLayout<D, FP8>;
  auto kernel = window_tc_kernel<D, MT, FP8>;
  cudaError_t err = dyn::allow_smem(kernel, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int rows = W * (H / KVH);
  const int row_groups = (rows + ROWS_CTA - 1) / ROWS_CTA;
  const float scale_log2 = tc::LOG2E / sqrtf((float)D);
  kernel<<<dim3(splits, KVH * row_groups, B), TC_THREADS, L::BYTES, stream>>>(
      static_cast<const bf16*>(q), k, v, e5m2, tables, lens, static_cast<bf16*>(out),
      Partials{part_acc, part_ml}, W, H, KVH, bs, max_blocks, sliding_window, chunk_pages,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  window_combine_kernel<D><<<dim3(rows, KVH, B), D, 0, stream>>>(
      part_acc, part_ml, lens, static_cast<bf16*>(out), splits, W, H, KVH, bs, max_blocks,
      sliding_window, chunk_pages);
  return (int)cudaGetLastError();
}

template <int D, bool FP8>
int dispatch_mt(const void* q, const void* k, const void* v, bool e5m2, const int* tables,
                const int* lens, void* out, float* part_acc, float* part_ml, int B, int W,
                int H, int KVH, int bs, int max_blocks, int sliding_window, int splits,
                int chunk_pages, cudaStream_t stream) {
  // rows a CTA holds: min(W * H/KVH, 32), in one or two 16-row MMA tiles
  if (W * (H / KVH) <= 16)
    return launch_tc<D, 1, FP8>(q, k, v, e5m2, tables, lens, out, part_acc, part_ml, B, W, H,
                                KVH, bs, max_blocks, sliding_window, splits, chunk_pages, stream);
  return launch_tc<D, 2, FP8>(q, k, v, e5m2, tables, lens, out, part_acc, part_ml, B, W, H, KVH,
                              bs, max_blocks, sliding_window, splits, chunk_pages, stream);
}

template <int D>
int dispatch_tc(const void* q, const void* k, const void* v, int code, const int* tables,
                const int* lens, void* out, float* part_acc, float* part_ml, int B, int W,
                int H, int KVH, int bs, int max_blocks, int sliding_window, int splits,
                int chunk_pages, cudaStream_t stream) {
  if (dyn::is_fp8(code))
    return dispatch_mt<D, true>(q, k, v, code == dyn::E5M2, tables, lens, out, part_acc,
                                part_ml, B, W, H, KVH, bs, max_blocks, sliding_window, splits,
                                chunk_pages, stream);
  return dispatch_mt<D, false>(q, k, v, false, tables, lens, out, part_acc, part_ml, B, W, H,
                               KVH, bs, max_blocks, sliding_window, splits, chunk_pages, stream);
}

}  // namespace

// dtype: q and out, 0 = float32, 1 = bfloat16; cache_dtype: the caches, a
// CacheType code (attention_common.cuh).  sliding_window <= 0 means full
// attention.  bf16 queries at head dims 64 and 128 over a bf16 or fp8 cache
// take the split walk: `splits` CTAs a (sequence, kv head) over chunks of
// `chunk_pages` pages (splits * chunk_pages >= max_blocks); with splits > 1,
// part_acc [B, KVH, splits, W*H/KVH, D] and part_ml [2, B, KVH, splits,
// W*H/KVH] are float32 scratch.  Other cases take the CUDA-core loop and
// ignore the three.  Returns 0 or an error code.
extern "C" int dyn_paged_window_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* block_tables, const void* context_lens, void* out, void* part_acc,
    void* part_ml, int B, int W, int H, int KVH, int D, int bs, int max_blocks,
    int sliding_window, int splits, int chunk_pages, int dtype, int cache_dtype,
    void* stream) {
  if (B == 0) return 0;
  if (KVH <= 0 || H % KVH || W * (H / KVH) > dyn::MAX_ROWS) return dyn::ERR_UNSUPPORTED;
  if (cache_dtype < dyn::F32 || cache_dtype > dyn::E5M2) return dyn::ERR_UNSUPPORTED;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool walk = dtype == dyn::BF16 && (D == 64 || D == 128) &&
                    (cache_dtype == dyn::BF16 || dyn::is_fp8(cache_dtype));
  if (dtype == dyn::F32)
    return dispatch_d<float>(D, q, k_cache, v_cache, cache_dtype, tables, lens, out, B, W, H,
                             KVH, bs, max_blocks, sliding_window, st);
  if (dtype != dyn::BF16) return dyn::ERR_UNSUPPORTED;
  if (!walk)
    return dispatch_d<bf16>(D, q, k_cache, v_cache, cache_dtype, tables, lens, out, B, W, H,
                            KVH, bs, max_blocks, sliding_window, st);
  if (splits < 1 || chunk_pages < 1 || (long)splits * chunk_pages < max_blocks ||
      splits > MAX_SPLITS || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return dyn::ERR_UNSUPPORTED;
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (D == 64)
    return dispatch_tc<64>(q, k_cache, v_cache, cache_dtype, tables, lens, out, pa, pm, B, W, H,
                           KVH, bs, max_blocks, sliding_window, splits, chunk_pages, st);
  return dispatch_tc<128>(q, k_cache, v_cache, cache_dtype, tables, lens, out, pa, pm, B, W, H,
                          KVH, bs, max_blocks, sliding_window, splits, chunk_pages, st);
}
