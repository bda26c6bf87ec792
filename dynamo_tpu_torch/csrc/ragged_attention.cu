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
//   see: page_phys/page_lane/page_ord[t, j] for j < page_count[t].  Pad
//   rows and blocks with no live entry come out as zeros.
//
// Bound: HBM bytes at decode-heavy mixes (each listed page's K/V rows once
//   per kv head), operations on long prefill spans: 4 flops per visible
//   (token, position, head, dim).  The engine packs every decode token first
//   in the flat axis, so the first token block of a unified step lists every
//   decode lane's pages: one block can hold most of a step's bytes.
//
// Routes, chosen by shape and dtype (neither is a fallback of the other):
//   - bf16 queries over a bf16 or fp8 (e4m3fn, e5m2) cache at head dims 64
//     and 128, block sizes a multiple of 16 and tb * H/KVH <= 64 query
//     rows: the balanced tensor-core walk below.  An fp8 cache's stages
//     arrive raw (16 elements a 16-byte copy, half the bytes), and each
//     thread converts the chunks it copied to bf16 into one stage beside
//     the ring (exact) behind a CTA barrier, before the same products;
//   - float32 queries, float32 and float16 caches and head dim 16 (the tiny
//     test geometry): the CUDA-core tile loop of attention_common.cuh,
//     converting the cache on load, one CTA per (token block, kv head).
//   Any other shape is refused (dyn::ERR_UNSUPPORTED).
//
// Tensor-core walk (ragged_tc_kernel):
//   - Work items.  The host cuts each block's worklist [0, page_count[t])
//     into items (plan_ragged_work in ops/kernels/ragged_attention.py, from
//     the host copy of page_count that pack_page_meta returns, so no device
//     value is read back): items of about equal length, enough that items x
//     KVH fill the card, so the heavy decode block spreads over many CTAs.
//     The plan lists the items longest first and the grid is (kv head,
//     item), so the longest start first on every head and the short ones
//     fill the tail.  The plan sits in a buffer of fixed capacity
//     (ops/kernels/work_plan.py): a header of live counts, then the items
//     and the combines.  The grids are the capacities and the CTAs past the
//     live counts, read here on the device, exit at once, so one launch
//     (and one captured CUDA graph) serves every plan of a token bucket,
//     a plan with no split block included.  An item that is its block's only one writes the
//     output; otherwise it writes a float32 partial (acc [rows, D], m and l
//     per row) to its slot and ragged_combine_kernel merges a block's
//     partials in entry order: no atomics, the same bits on every launch.
//     Without a plan each block is one item over its whole list.
//   - A CTA holds all tb * H/KVH query rows of one kv head, token-major (row
//     r = token r / G, head group r % G), as MT 16-row MMA tiles (1, 2 or 4;
//     Llama-3-8B: 8 tokens x 4 groups = 2 tiles), so a listed page crosses
//     HBM once per (item, kv head) for every head that shares it.  Q stays in
//     registers as bf16 A fragments.
//   - Stages of 16 * 4/MT keys arrive through a CTA-wide ring of 3 cp.async
//     stages; each 16-key sub-tile lies inside one worklist entry (the block
//     size is a multiple of 16), so it has one lane and contiguous
//     positions.  Warp w takes tile w % MT and sub-tile w / MT of every
//     stage: each tile is walked by 4/MT warps, each sub-tile by MT warps.
//   - A warp skips both products of a sub-tile that none of its 16 rows can
//     see (another lane's page, a page above every row's position, or one
//     wholly below the sliding window): in a decode block a page serves one
//     token's G rows.
//   - Scores and P.V are mma.sync m16n8k16 bf16 with fp32 accumulation, P
//     rounded to bf16 for P.V; the softmax is fp32 in the log2 domain with
//     the reference's contract: masked scores NEG_INF, their exponentials
//     0, the denominator clamped at 1e-20.  The warps of a tile merge their
//     states in warp order through shared memory at the end.
// The TPU kernel's layout (flat [bs*KVH, D] pages, the iota GQA mask,
// pages_per_step) is not carried over: the output does not depend on it.

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

struct WorklistKeys {
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

// One CTA per (token block, kv head), holding the tb * groups query rows of
// that kv head; it walks the block's entries j < page_count[t] (pad entries
// repeat the last page and would count twice) in tiles of dyn::KEYS rows and
// masks each (row, key) by the row's own lane and position.
template <typename T, int D>
__global__ void __launch_bounds__(dyn::THREADS)
ragged_kernel(const T* __restrict__ q, const void* __restrict__ k_cache,
              const void* __restrict__ v_cache, int code, const int* __restrict__ token_lane,
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
  WorklistKeys keys{page_phys + wl, page_lane + wl, page_ord + wl, bs, KVH, head, D};
  const float scale = 1.0f / sqrtf((float)D);
  dyn::attend<D>(s, rows, k_cache, v_cache, code, keys, 0, count * bs, sliding_window, scale,
                    [&](int r) {
                      const int tok = t * tb + r / groups, g = r % groups;
                      return out + ((size_t)tok * H + head * groups + g) * D;
                    });
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, int code, const int* tl,
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
      static_cast<const T*>(q), k, v, code, tl, tp, pp, pl, po, pc, static_cast<T*>(out), H,
      KVH, bs, tb, page_slots, sliding_window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, int code, const int* tl,
               const int* tp, const int* pp, const int* pl, const int* po,
               const int* pc, void* out, int T_, int H, int KVH, int bs, int tb,
               int page_slots, int sliding_window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, code, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    case 64: return launch<T, 64>(q, k, v, code, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    case 128: return launch<T, 128>(q, k, v, code, tl, tp, pp, pl, po, pc, out, T_, H, KVH, bs, tb, page_slots, sliding_window, stream);
    default: return dyn::ERR_UNSUPPORTED;
  }
}

// ---------------------------------------------------------------------------
// bf16, head dims 64 and 128: the balanced tensor-core walk
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int SUB = 16;     // keys of a sub-tile: one MMA K step of P.V
constexpr int STAGES = 3;   // ring stages in flight
constexpr int MAX_ITEMS_PER_BLOCK = 64;  // items a token block may have (the combine's)

// The plan buffer, int4 rows (ops/kernels/work_plan.py): work[0] = (live
// items, live combines, live partials, unused), then cap_items items
//   (token block, first entry, end entry, partial slot or -1),
// then the combines
//   (token block, first slot, slots, unused).

// FP8: the ring holds raw fp8 stages (RAW bytes: K then V rows of D
// bytes) and, after them, the one bf16 stage (K then V) they convert into.
template <int D, int MT, bool FP8>
struct RaggedLayout {
  static constexpr int WPT = TC_WARPS / MT;     // warps a tile = sub-tiles a stage
  static constexpr int STAGE_KEYS = SUB * WPT;
  static constexpr int STR = D + 8;             // bf16 row stride: ldmatrix without conflicts
  static constexpr int QCH = D / 8;             // 16-byte chunks a bf16 query row
  static constexpr int EL = FP8 ? 16 : 8;       // cache elements a 16-byte chunk
  static constexpr int CH = D / EL;             // 16-byte chunks a cache row
  static constexpr int ROW_STEP = TC_THREADS / CH;
  // K (and V) rows a thread copies a stage: row tid / CH + i * ROW_STEP,
  // column tid % CH; a row past the stage is no copy (an fp8 stage of 16
  // keys at D 64 has 64 chunks for 128 threads)
  static constexpr int LOADS = (STAGE_KEYS + ROW_STEP - 1) / ROW_STEP;
  static constexpr int MSTR = D + 4;            // float row stride of a warp's acc in the merge
  static constexpr int ROWS = MT * 16;
  static constexpr int RAW = 2 * STAGE_KEYS * D;  // bytes of a raw fp8 stage
  static constexpr size_t BF16_STAGE = (size_t)2 * STAGE_KEYS * STR * sizeof(bf16);
  static constexpr size_t Q_BYTES = (size_t)ROWS * STR * sizeof(bf16);
  static constexpr size_t RING_BYTES = FP8 ? (size_t)STAGES * RAW + BF16_STAGE
                                           : (size_t)STAGES * BF16_STAGE;
  // acc [warps][16][MSTR], then m and l [warps][16]
  static constexpr size_t MERGE_BYTES = (size_t)TC_WARPS * 16 * (MSTR + 2) * sizeof(float);
  static constexpr size_t BODY_BYTES = RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES;
  static constexpr size_t META_BYTES = (size_t)STAGES * WPT * sizeof(int2);
  static constexpr size_t BYTES = Q_BYTES + BODY_BYTES + META_BYTES;
  static_assert(TC_THREADS % CH == 0 && (STAGE_KEYS % ROW_STEP == 0 || LOADS == 1),
                "a stage's rows spread over the threads");
};

// Three CTAs an SM (registers capped at 170 a thread; shared memory allows
// three at MT 2): a long prefill span, one item a token block, is bound by
// the walk's issue and latency, and the third CTA hides more of both.
// FP8: the cache is fp8 (e5m2 when `e5m2`, else e4m3fn), otherwise bf16.
template <int D, int MT, bool FP8>
__global__ void __launch_bounds__(TC_THREADS, 3)
ragged_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ k_cache,
                 const void* __restrict__ v_cache, bool e5m2, const int* __restrict__ token_lane,
                 const int* __restrict__ token_pos, const int* __restrict__ page_phys,
                 const int* __restrict__ page_lane, const int* __restrict__ page_ord,
                 const int* __restrict__ page_count, const int4* __restrict__ work,
                 bf16* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int cap_partials, int H, int KVH, int bs,
                 int tb, int page_slots, int sliding_window, float scale_log2) {
  using L = RaggedLayout<D, MT, FP8>;
  constexpr int STR = L::STR, KS = D / 16;
  extern __shared__ __align__(16) char smem[];
  if (work && (int)blockIdx.y >= work[0].x) return;  // past the live items
  const int4 item = work ? work[1 + blockIdx.y] : make_int4(blockIdx.y, 0, page_slots, -1);
  const int t = item.x;
  const int head = blockIdx.x;
  const int G = H / KVH, rows = tb * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group and column pair
  const int mt = warp % MT, phase = warp / MT;

  const size_t wl = (size_t)t * page_slots;
  const int count = min(page_count[t], page_slots);
  const int kb = min(item.y, count) * bs, ke = max(min(item.z, count) * bs, kb);
  const int n_stages = tc::ceil_div(ke - kb, L::STAGE_KEYS);

  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::Q_BYTES);
  uint8_t* raw_ring = reinterpret_cast<uint8_t*>(smem + L::Q_BYTES);  // fp8
  bf16* conv = reinterpret_cast<bf16*>(smem + L::Q_BYTES + (size_t)STAGES * L::RAW);  // fp8
  int2* meta = reinterpret_cast<int2*>(smem + L::Q_BYTES + L::BODY_BYTES);
  auto row_off = [&](int r) {  // q and out are [T, H, D]
    return ((size_t)(t * tb + r / G) * H + head * G + r % G) * D;
  };

  // this thread's K/V rows of stage n (key row j = tid / CH + i * ROW_STEP
  // of the stage, if below STAGE_KEYS): cache row page * bs + offset, -1
  // past the walk
  auto my_row = [&](int i) { return tid / L::CH + i * L::ROW_STEP; };
  auto lookup = [&](int n, int (&rid)[L::LOADS]) {
#pragma unroll
    for (int i = 0; i < L::LOADS; ++i) {
      const int key = kb + n * L::STAGE_KEYS + my_row(i);
      rid[i] = n < n_stages && key < ke && my_row(i) < L::STAGE_KEYS
                   ? page_phys[wl + key / bs] * bs + key % bs : -1;
    }
  };
  // sub-tile tid's (lane, position of its first key) of stage n, for tid <
  // WPT; lane -1 past the walk
  auto lookup_meta = [&](int n) {
    const int key = kb + n * L::STAGE_KEYS + tid * SUB;
    if (tid >= L::WPT || n >= n_stages || key >= ke) return make_int2(-1, 0);
    const int e = key / bs;
    return make_int2(page_lane[wl + e], page_ord[wl + e] * bs + key % bs);
  };
  auto issue = [&](int n, const int (&rid)[L::LOADS], int2 sub_meta) {
    if (n < n_stages) {
      const int c = tid % L::CH;
#pragma unroll
      for (int i = 0; i < L::LOADS; ++i) {
        const int j = my_row(i);
        if (j >= L::STAGE_KEYS) break;
        const size_t off = rid[i] >= 0 ? ((size_t)rid[i] * KVH + head) * D + c * L::EL : 0;
        if (FP8) {
          uint8_t* kd = raw_ring + (size_t)(n % STAGES) * L::RAW;
          tc::cp_async16(kd + j * D + c * 16, static_cast<const uint8_t*>(k_cache) + off,
                         rid[i] >= 0);
          tc::cp_async16(kd + (L::STAGE_KEYS + j) * D + c * 16,
                         static_cast<const uint8_t*>(v_cache) + off, rid[i] >= 0);
        } else {
          bf16* kd = ring + (size_t)(n % STAGES) * 2 * L::STAGE_KEYS * STR;
          tc::cp_async16(kd + j * STR + c * 8, static_cast<const bf16*>(k_cache) + off,
                         rid[i] >= 0);
          tc::cp_async16(kd + (L::STAGE_KEYS + j) * STR + c * 8,
                         static_cast<const bf16*>(v_cache) + off, rid[i] >= 0);
        }
      }
      if (tid < L::WPT) meta[(n % STAGES) * L::WPT + tid] = sub_meta;
    }
    tc::cp_async_commit();  // one group a stage, empty past the last
  };

  int rid[L::LOADS];
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    lookup(n, rid);
    issue(n, rid, lookup_meta(n));
  }
  lookup(STAGES - 1, rid);
  int2 meta_ahead = lookup_meta(STAGES - 1);

  // the CTA's query rows, bf16, zero rows past the block's
  for (int i = tid; i < L::ROWS * L::QCH; i += TC_THREADS) {
    const int r = i / L::QCH, c = i % L::QCH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + row_off(r) + c * 8);
    *reinterpret_cast<uint4*>(qs + r * STR + c * 8) = v;
  }
  // position and lane of this thread's fragment rows mt * 16 + gq + 8 h;
  // pad rows (position -1) see no key
  int qpos[2], qlane[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + gq + 8 * h;
    const int tok = t * tb + r / G;
    qpos[h] = r < rows ? token_pos[tok] : -1;
    qlane[h] = qpos[h] >= 0 ? token_lane[tok] : -1;
  }
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    tc::ldmatrix_x4(qa[kk], qs + (mt * 16 + tc::a_row(lane)) * STR + kk * 16 + tc::a_col(lane));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int n = 0; n < n_stages; ++n) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage n landed for every thread; stage n - 1 consumed by every warp
    issue(n + STAGES - 1, rid, meta_ahead);
    lookup(n + STAGES, rid);
    meta_ahead = lookup_meta(n + STAGES);
    if (FP8) {  // this thread's own chunks of raw stage n to the bf16 stage
      const uint8_t* raw = raw_ring + (size_t)(n % STAGES) * L::RAW;
      const int c = tid % L::CH;
#pragma unroll
      for (int i = 0; i < L::LOADS; ++i) {
        const int j = my_row(i);
        if (j >= L::STAGE_KEYS) break;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const int row = kv * L::STAGE_KEYS + j;
          uint4 o[2];
          dyn::fp8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + row * D + c * 16), e5m2, o);
          *reinterpret_cast<uint4*>(conv + row * STR + c * 16) = o[0];
          *reinterpret_cast<uint4*>(conv + row * STR + c * 16 + 8) = o[1];
        }
      }
      __syncthreads();  // the bf16 stage is whole
    }

    const int2 sub = meta[(n % STAGES) * L::WPT + phase];
    const int key_lane = sub.x, pos0 = sub.y;
    bool sees = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool s = key_lane >= 0 && qlane[h] == key_lane && pos0 <= qpos[h];
      if (sliding_window > 0) s = s && pos0 + SUB - 1 > qpos[h] - sliding_window;
      sees = sees || s;
    }
    if (!__any_sync(tc::FULL, sees)) continue;  // no row of this tile sees the sub-tile

    const bf16* ks = (FP8 ? conv : ring + (size_t)(n % STAGES) * 2 * L::STAGE_KEYS * STR) +
                     phase * SUB * STR;
    const bf16* vs = ks + L::STAGE_KEYS * STR;
    // S = Q K^T: [16 rows, 16 keys] as two N tiles of 8 keys
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];
      tc::ldmatrix_x4(kf, ks + tc::b_row(lane) * STR + kk * 16 + tc::b_col(lane));
      tc::mma_bf16(sc[0], qa[kk], kf[0], kf[1]);
      tc::mma_bf16(sc[1], qa[kk], kf[2], kf[3]);
    }
    // mask (own lane, causal, sliding window), online softmax, P as bf16
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = qpos[h];
      const bool own = qlane[h] == key_lane;
      float row_s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i / 2, e = i % 2;
        const int kp = pos0 + j * 8 + 2 * tq + e;
        bool ok = own && kp <= qp;
        if (sliding_window > 0) ok = ok && kp > qp - sliding_window;
        row_s[i] = ok ? sc[j][2 * h + e] * scale_log2 : NEG_INF;
      }
      const float alpha = tc::softmax_step(row_s, m[h], l[h]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][2 * h] *= alpha;
        acc[nd][2 * h + 1] *= alpha;
      }
      pa[h] = tc::pack_bf16(row_s[0], row_s[1]);      // keys 2t, 2t+1
      pa[2 + h] = tc::pack_bf16(row_s[2], row_s[3]);  // keys 8+2t, 9+2t
    }
    // acc += P V: V [16 keys, D] through ldmatrix.trans, two N tiles a load
#pragma unroll
    for (int dp = 0; dp < KS; ++dp) {
      uint32_t vf[4];
      tc::ldmatrix_x4_trans(vf, vs + tc::a_row(lane) * STR + dp * 16 + tc::a_col(lane));
      tc::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
      tc::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp's walk is done: the ring becomes the merge area

  float* macc = reinterpret_cast<float*>(smem + L::Q_BYTES);  // [warps][16][MSTR]
  float* mm = macc + (size_t)TC_WARPS * 16 * L::MSTR;         // [warps][16]
  float* ml = mm + TC_WARPS * 16;                              // [warps][16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h;
    float* dst = macc + ((size_t)warp * 16 + r) * L::MSTR;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8 + 2 * tq) = make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
    const float lr = tc::quad_sum(l[h]);
    if (tq == 0) {
      mm[warp * 16 + r] = m[h];
      ml[warp * 16 + r] = lr;
    }
  }
  __syncthreads();
  // row r's tile is walked by warps r / 16 + MT * p, p < WPT: merge in p order
  const int slot = item.w;
  const size_t l_off = (size_t)cap_partials * KVH * rows;
  for (int i = tid; i < rows * D; i += TC_THREADS) {
    const int r = i / D, d = i % D, rr = r % 16, w0 = r / 16;
    float M = NEG_INF;
#pragma unroll
    for (int p = 0; p < L::WPT; ++p) M = fmaxf(M, mm[(w0 + MT * p) * 16 + rr]);
    float a = 0.f, Ls = 0.f;
#pragma unroll
    for (int p = 0; p < L::WPT; ++p) {
      const int w = w0 + MT * p;
      const float e = tc::merge_weight(mm[w * 16 + rr], M);
      if (e != 0.f) {
        Ls += e * ml[w * 16 + rr];
        a += e * macc[((size_t)w * 16 + rr) * L::MSTR + d];
      }
    }
    if (slot < 0) {
      out[row_off(r) + d] = __float2bfloat16(a / fmaxf(Ls, 1e-20f));
    } else {
      const size_t pr = ((size_t)slot * KVH + head) * rows + r;
      part_acc[pr * D + d] = a;
      if (d == 0) {
        part_ml[pr] = M;
        part_ml[pr + l_off] = Ls;
      }
    }
  }
}

// Merge each split token block's partials in entry (slot) order.  One CTA
// per (row, kv head, combine of the capacity), a thread a column; the
// combines past the live count exit.
template <int D>
__global__ void __launch_bounds__(D)
ragged_combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                      const int4* __restrict__ work, bf16* __restrict__ out, int cap_items,
                      int cap_partials, int H, int KVH, int tb) {
  __shared__ float sm[MAX_ITEMS_PER_BLOCK], sl[MAX_ITEMS_PER_BLOCK], red[2];
  if ((int)blockIdx.z >= work[0].y) return;  // past the live combines
  const int4 c = work[1 + cap_items + blockIdx.z];
  const int r = blockIdx.x, head = blockIdx.y, tid = threadIdx.x;
  const int G = H / KVH, rows = tb * G, n = c.z;
  const size_t l_off = (size_t)cap_partials * KVH * rows;
  auto prow = [&](int j) { return ((size_t)(c.y + j) * KVH + head) * rows + r; };
  for (int j = tid; j < n; j += D) {
    sm[j] = ml[prow(j)];
    sl[j] = ml[prow(j) + l_off];
  }
  const float Ls = tc::merge_weights(sm, sl, n, red);
  float a = 0.f;
  for (int j = 0; j < n; ++j) {
    const float wt = sm[j];
    if (wt != 0.f) a += wt * acc[prow(j) * D + tid];
  }
  const size_t o = ((size_t)(c.x * tb + r / G) * H + head * G + r % G) * D + tid;
  out[o] = __float2bfloat16(a / fmaxf(Ls, 1e-20f));
}

template <int D, int MT, bool FP8>
int launch_tc(const void* q, const void* k, const void* v, bool e5m2, const int* tl,
              const int* tp, const int* pp, const int* pl, const int* po, const int* pc,
              void* out, const int4* work, int cap_items, int cap_combines, float* part_acc,
              float* part_ml, int cap_partials, int H, int KVH, int bs, int tb,
              int page_slots, int sliding_window, cudaStream_t stream) {
  using L = RaggedLayout<D, MT, FP8>;
  auto kernel = ragged_tc_kernel<D, MT, FP8>;
  cudaError_t err = dyn::allow_smem(kernel, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = tc::LOG2E / sqrtf((float)D);
  bf16* o = static_cast<bf16*>(out);
  kernel<<<dim3(KVH, cap_items), TC_THREADS, L::BYTES, stream>>>(
      static_cast<const bf16*>(q), k, v, e5m2, tl, tp, pp, pl, po, pc, work, o, part_acc,
      part_ml, cap_partials, H, KVH, bs, tb, page_slots, sliding_window, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || cap_combines == 0) return (int)err;
  ragged_combine_kernel<D><<<dim3(tb * (H / KVH), KVH, cap_combines), D, 0, stream>>>(
      part_acc, part_ml, work, o, cap_items, cap_partials, H, KVH, tb);
  return (int)cudaGetLastError();
}

template <int D, bool FP8>
int dispatch_mt(int MT, const void* q, const void* k, const void* v, bool e5m2, const int* tl,
                const int* tp, const int* pp, const int* pl, const int* po, const int* pc,
                void* out, const int4* work, int cap_items, int cap_combines, float* pa,
                float* pm, int cap_partials, int H, int KVH, int bs, int tb, int page_slots,
                int sliding_window, cudaStream_t st) {
  switch (MT) {
    case 1: return launch_tc<D, 1, FP8>(q, k, v, e5m2, tl, tp, pp, pl, po, pc, out, work, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs, tb, page_slots, sliding_window, st);
    case 2: return launch_tc<D, 2, FP8>(q, k, v, e5m2, tl, tp, pp, pl, po, pc, out, work, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs, tb, page_slots, sliding_window, st);
    default: return launch_tc<D, 4, FP8>(q, k, v, e5m2, tl, tp, pp, pl, po, pc, out, work, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs, tb, page_slots, sliding_window, st);
  }
}

template <int D>
int dispatch_tc(int MT, const void* q, const void* k, const void* v, int code, const int* tl,
                const int* tp, const int* pp, const int* pl, const int* po, const int* pc,
                void* out, const int4* work, int cap_items, int cap_combines, float* pa,
                float* pm, int cap_partials, int H, int KVH, int bs, int tb, int page_slots,
                int sliding_window, cudaStream_t st) {
  if (dyn::is_fp8(code))
    return dispatch_mt<D, true>(MT, q, k, v, code == dyn::E5M2, tl, tp, pp, pl, po, pc, out,
                                work, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs,
                                tb, page_slots, sliding_window, st);
  return dispatch_mt<D, false>(MT, q, k, v, false, tl, tp, pp, pl, po, pc, out, work, cap_items,
                               cap_combines, pa, pm, cap_partials, H, KVH, bs, tb, page_slots,
                               sliding_window, st);
}

}  // namespace

// dtype: q and out, 0 = float32, 1 = bfloat16; cache_dtype: the caches, a
// CacheType code (attention_common.cuh).  T_ is a multiple of tb;
// sliding_window <= 0 means full attention.  bf16 queries at head dims 64
// and 128 over a bf16 or fp8 cache take the tensor-core walk over `work`:
// the plan buffer of cap_items items and cap_combines combines (see above),
// or, with work null, one item per token block over its whole worklist (the
// capacities and the scratch are then ignored).  With cap_partials > 0,
// part_acc [cap_partials, KVH, tb*H/KVH, D] and part_ml [2, cap_partials,
// KVH, tb*H/KVH] are float32 scratch.  Other cases take the CUDA-core loop
// and ignore work and the scratch.  Returns 0 or an error code.
extern "C" int dyn_ragged_paged_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* token_lane, const void* token_pos, const void* page_phys,
    const void* page_lane, const void* page_ord, const void* page_count,
    void* out, const void* work, void* part_acc, void* part_ml, int T_, int H,
    int KVH, int D, int bs, int tb, int page_slots, int sliding_window, int cap_items,
    int cap_combines, int cap_partials, int dtype, int cache_dtype, void* stream) {
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
  if (cache_dtype < dyn::F32 || cache_dtype > dyn::E5M2) return dyn::ERR_UNSUPPORTED;
  if (dtype == dyn::F32)
    return dispatch_d<float>(D, q, k_cache, v_cache, cache_dtype, tl, tp, pp, pl, po, pc, out,
                             T_, H, KVH, bs, tb, page_slots, sliding_window, st);
  if (dtype != dyn::BF16) return dyn::ERR_UNSUPPORTED;
  if (D == 16 || !(cache_dtype == dyn::BF16 || dyn::is_fp8(cache_dtype)))
    return dispatch_d<bf16>(D, q, k_cache, v_cache, cache_dtype, tl, tp, pp, pl, po, pc, out,
                            T_, H, KVH, bs, tb, page_slots, sliding_window, st);
  if ((D != 64 && D != 128) || bs % SUB) return dyn::ERR_UNSUPPORTED;
  const int4* plan = static_cast<const int4*>(work);
  if (plan == nullptr) {
    cap_items = T_ / tb;
    cap_combines = cap_partials = 0;
  }
  if (cap_items <= 0 || cap_items > 65535 || cap_combines < 0 || cap_combines > 65535 ||
      cap_partials < 0 || (cap_partials > 0 && (part_acc == nullptr || part_ml == nullptr)) ||
      (cap_combines > 0 && cap_partials == 0))
    return dyn::ERR_UNSUPPORTED;
  const int rows = tb * (H / KVH);
  const int MT = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (D == 64)
    return dispatch_tc<64>(MT, q, k_cache, v_cache, cache_dtype, tl, tp, pp, pl, po, pc, out,
                           plan, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs, tb,
                           page_slots, sliding_window, st);
  return dispatch_tc<128>(MT, q, k_cache, v_cache, cache_dtype, tl, tp, pp, pl, po, pc, out,
                          plan, cap_items, cap_combines, pa, pm, cap_partials, H, KVH, bs, tb,
                          page_slots, sliding_window, st);
}
