// MLA (multi-head latent attention, DeepSeek-V2/V3) over the paged latent
// cache: the absorbed decode step, the speculative verify window and the
// ragged unified step.
//
// Replaces: dynamo_tpu/ops/pallas/mla_attention.py
//   mla_paged_attention_decode (kernel _kernel),
//   mla_paged_window_attention_decode (kernel _window_kernel) and
//   ragged_mla_attention (kernel _ragged_kernel).
//
// Computes: for each query row (a token and a head) the two-part scores
//   (q_lat . ck[key] + q_rope . kr[key]) * scale over the keys the row can
//   see, a float32 softmax, and the context in latent space,
//   out[row] = sum_key p * ck[key] (float32, width R): the latent ck is the
//   key's first R columns and the value as well.
//   Decode: sequence b sees positions pos < ctx_b through its block table.
//   Window (verify): sequence b has W queries; query w sits at position
//   ctx_b - W + w (ctx_b includes the window's last token) and sees the
//   positions <= its own.  The W*H rows are w-major (row = w * H + h).
//   Ragged: token i (lane token_lane[i], position token_pos[i]; -1 = pad)
//   sees the positions <= its own of its own lane, walked through the page
//   worklist of its token block (pack_page_meta over the latent tables).
//
// Bound: HBM bytes at decode (every visible latent row, (R + P) elements,
//   is read once per step: 1.15 KB a position at R 512, P 64 in bf16); in
//   the ragged step the float32 queries and output (2 KB a row each at R
//   512) weigh as much as the pages.  Operations: 2 (R + P) + 2 R flops
//   per visible (row, position), far below the tensor cores' rate.
//
// Ragged design (bf16 caches, R 512, P 64, 16-position pages, H a
//   multiple of 16; rtc:: below): a split walk on the tensor cores.
//   - Rows are token-major (row = token * H + head), so a 16-row MMA tile
//     is one token's 16 heads (H = 16).  A CTA holds 4 tiles (4 tokens,
//     half a token block of 8) and walks their token block's worklist once
//     for all 16 heads of each: a page crosses HBM at most twice per token
//     block (once per half), not once per head as in the CUDA-core loop.
//     The 4 x 16 x 512 float32 accumulator does not fit one CTA's
//     registers with the queries beside it, so R is split across warps:
//     warps 2i and 2i + 1 own tile i, each for 256 of the R context
//     columns (128 accumulator registers a thread).  The pair splits the
//     tile's score reduction instead: each scores half of K and they swap
//     the halves through shared memory.
//   - The worklist is split across CTAs in fixed chunks of entries; the
//     chunk count comes from page_slots and the grid's shape (plan_chunks in
//     ops/kernels/mla_attention.py: about 4 CTAs an SM, 16 to 256 entries
//     a chunk; 6 chunks of 60 for 44 token blocks over 360 slots, 128 of
//     16 for one block over 2048), never from page_count's values, so a
//     step needs no device-to-host read, and the decode-heavy token block
//     no longer sets the kernel's time alone.  A CTA first keeps, in order,
//     the entries of its chunk that one of its tokens sees (its lane, not
//     above its position), and walks only those: work follows the visible
//     (token, page) pairs.  A tile skips a page of another lane.
//   - A token block whose worklist fits one chunk is written by that CTA;
//     otherwise each chunk writes float32 partials (acc, m, l per row) and
//     mla_ragged_combine_kernel merges them in chunk order: no atomics, the
//     same bits on every launch.
//   - Pages arrive in a ring of 3 cp.async stages (ck rows, then kr rows,
//     bf16) while the previous page computes.  Both products run on
//     mma.sync m16n8k16 bf16 with fp32 accumulation.  q_lat and P are
//     float32, and a single bf16 pass would miss the float32 reference by
//     more than 2e-4, so each is split into a bf16 high part plus a bf16
//     low part (x = hi + lo to 2^-17 |x|) and runs two passes; the bf16
//     cache operand is exact.  Scores: q_hi.ck + q_lo.ck + q_rope.kr over
//     K = 576, in four accumulator chains summed in a fixed order, the
//     pair's halves added low K first in both warps (the same bits).
//     Context: (P_hi + P_lo).ck over the page's 16 keys into the warp's 256
//     columns, ck through ldmatrix.trans.  The softmax is float32, the
//     reference's contract: masked scores NEG_INF, their exponentials 0,
//     the denominator clamped at 1e-20, so pad rows and token blocks
//     without pages write zeros.
//
// CUDA-core design (decode, window, and the ragged step at other widths or
//   float32 caches): every head reads the same single latent "kv head", so
//   the head axis is the only sharing there is.  One CTA owns `hg` heads of
//   one sequence (decode) or of one token block (ragged): hg grows only
//   while the grid would overflow two CTAs per SM, so small batches still
//   spread over the card, and a CTA never holds more than MAX_ROWS query
//   rows.  These products run on the fp32 CUDA cores, far from either
//   bound; the decode and window kernels' redesign is later work.
//   Shared memory holds the float32 queries [rows, R+P] and accumulator
//   [rows, R], and two tiles of MKEYS latent rows [MKEYS, R+P] in the
//   cache type: tile t+1 copies in with cp.async while tile t computes,
//   so the HBM latency of a tile hides behind the previous one.  No V tile
//   exists: the values are the staged latents.  That keeps a CTA under
//   111 KB at R 512, P 64 and 8 rows (two CTAs per SM), where the GQA tile
//   loop of attention_common.cuh (q, K, V and the accumulator in float32)
//   would not fit.  Scores: one warp per key, lanes across the R+P
//   columns, a shuffle reduction per visible (row, key).  Softmax: one
//   warp per row, one lane per key.  Context: one thread per (row,
//   column), only for rows that see a key of the tile (a ragged token
//   block mixes lanes, and each tile belongs to one lane).  Masked scores are
//   NEG_INF and contribute 0, the denominator is clamped at 1e-20, so pad
//   rows, idle lanes (ctx 0) and token blocks without pages write zeros.
//   pages_per_step of the TPU kernels has no counterpart: the output does
//   not depend on it.
//   The window kernel is the decode kernel with W*H rows a sequence: a CTA
//   owns `hg` consecutive w-major rows, each with its own position limit,
//   so the grid is (B, W*H/hg).  Its known cost: the W*H/hg CTAs of one
//   sequence each read that sequence's latent pages (the TPU kernel folds
//   all W*H rows into one grid step and reads each page once); a CTA that
//   held more rows would need the tensor cores to keep its products fast.

#include <climits>

#include "attention_common.cuh"
#include "split_attention.cuh"

namespace {

constexpr int MTHREADS = 256;  // 8 warps
constexpr int NWARPS = MTHREADS / 32;
constexpr int MKEYS = 32;      // keys per tile: one per lane in the softmax step
constexpr int MAX_ROWS = 8;    // query rows one CTA holds

template <typename T, int R, int P>
struct MlaSmem {
  static constexpr int D = R + P;
  static_assert((R * sizeof(T)) % 16 == 0 && (P * sizeof(T)) % 16 == 0,
                "latent and rope rows must be whole 16-byte chunks");
  float* q;       // [rows, D]   q_lat | q_rope
  float* acc;     // [rows, R]
  float* p;       // [rows, MKEYS] scores, then probabilities
  float* m;       // [rows] running max
  float* l;       // [rows] running denominator
  float* alpha;   // [rows] rescale of the accumulator for this tile
  int* row_pos;   // [rows] query position (-1 = pad row)
  int* row_lane;  // [rows] query lane
  int* row_live;  // [rows] the row sees a key of this tile
  int* key_row;   // [2][MKEYS] cache row (page * bs + offset), per tile buffer
  int* key_pos;   // [2][MKEYS] (INT_MAX past the end of the key list)
  int* key_lane;  // [2][MKEYS]
  T* kt;          // [2][MKEYS, D]  ck | kr rows in the cache type, double-buffered

  __host__ __device__ static size_t head_bytes(int rows) {
    const size_t floats = (size_t)rows * (D + R + MKEYS + 3);
    const size_t ints = 3 * (size_t)rows + 6 * (size_t)MKEYS;
    return ((floats + ints) * 4 + 15) / 16 * 16;  // the tiles start 16-byte aligned
  }
  __host__ __device__ static size_t bytes(int rows) {
    return head_bytes(rows) + 2 * (size_t)MKEYS * D * sizeof(T);
  }

  __device__ MlaSmem(char* base, int rows) {
    q = reinterpret_cast<float*>(base);
    acc = q + rows * D;
    p = acc + rows * R;
    m = p + rows * MKEYS;
    l = m + rows;
    alpha = l + rows;
    row_pos = reinterpret_cast<int*>(alpha + rows);
    row_lane = row_pos + rows;
    row_live = row_lane + rows;
    key_row = row_live + rows;
    key_pos = key_row + 2 * MKEYS;
    key_lane = key_pos + 2 * MKEYS;
    kt = reinterpret_cast<T*>(base + head_bytes(rows));
  }
};

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Walk keys [0, end) of `src` for the rows already staged in `s` (q,
// row_pos, row_lane), then write out_row(r)[0..R) = acc[r] / max(l[r], 1e-20).
// KeySource gives, for a key index: row(key), the cache row (page * bs +
// offset) of its latent and rope key; pos(key); lane(key).  Tiles are
// double-buffered: tile t+1's rows copy in (cp.async) while tile t computes,
// and tile t+2's metadata is read while tile t accumulates.
template <typename T, int R, int P, class KeySource, class OutRow>
__device__ void mla_attend(MlaSmem<T, R, P>& s, int rows, const T* __restrict__ ck,
                           const T* __restrict__ kr, const KeySource& src, int end,
                           float scale, OutRow out_row) {
  constexpr int D = R + P;
  constexpr int CR = R * sizeof(T) / 16, CP = P * sizeof(T) / 16, C = CR + CP;
  constexpr int DI = (D + 31) / 32;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane_id = tid % 32;
  const int tiles = (end + MKEYS - 1) / MKEYS;

  for (int i = tid; i < rows * R; i += MTHREADS) s.acc[i] = 0.f;
  for (int r = tid; r < rows; r += MTHREADS) {
    s.m[r] = dyn::NEG_INF;
    s.l[r] = 0.f;
  }

  auto stage_meta = [&](int tile) {  // one key a thread of the first warp
    if (tid < MKEYS) {
      const int at = (tile & 1) * MKEYS + tid, key = tile * MKEYS + tid;
      const bool ok = key < end;
      s.key_row[at] = ok ? (int)src.row(key) : 0;
      s.key_pos[at] = ok ? src.pos(key) : INT_MAX;
      s.key_lane[at] = ok ? src.lane(key) : -1;
    }
  };
  auto stage_tile = [&](int tile) {  // its metadata is staged; 16 bytes a copy
    if (tile < tiles) {
      const int buf = tile & 1;
      T* kt = s.kt + (size_t)buf * MKEYS * D;
      for (int i = tid; i < MKEYS * C; i += MTHREADS) {
        const int j = i / C, c = i % C;
        uint4* dst = reinterpret_cast<uint4*>(kt + (size_t)j * D) + c;
        if (s.key_pos[buf * MKEYS + j] == INT_MAX) {
          *dst = make_uint4(0u, 0u, 0u, 0u);  // past the end: p is 0, keep 0 * junk out
          continue;
        }
        const size_t row = (size_t)s.key_row[buf * MKEYS + j];
        cp_async16(dst, c < CR ? static_cast<const void*>(
                                     reinterpret_cast<const uint4*>(ck + row * R) + c)
                               : static_cast<const void*>(
                                     reinterpret_cast<const uint4*>(kr + row * P) + (c - CR)));
      }
    }
    cp_async_commit();  // one group a tile, empty past the last
  };

  stage_meta(0);
  __syncthreads();
  stage_tile(0);
  stage_meta(1);
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    __syncthreads();       // tile+1's metadata staged; the other buffer consumed
    stage_tile(tile + 1);  // in flight while this tile computes
    cp_async_wait_one();   // this thread's copies of this tile landed
    __syncthreads();       // ... and every thread's
    const T* kt = s.kt + (size_t)buf * MKEYS * D;
    const int* kpos = s.key_pos + buf * MKEYS;
    const int* klane = s.key_lane + buf * MKEYS;

    // 1) masked scores: one warp per key, lanes across the D columns
    for (int j = warp; j < MKEYS; j += NWARPS) {
      const int kp = kpos[j], kl = klane[j];
      if (kp == INT_MAX) {
        for (int r = lane_id; r < rows; r += 32) s.p[r * MKEYS + j] = dyn::NEG_INF;
        continue;
      }
      float kreg[DI];
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        const int d = lane_id + 32 * i;
        kreg[i] = d < D ? dyn::to_f32(kt[(size_t)j * D + d]) : 0.f;
      }
      for (int r = 0; r < rows; ++r) {
        const bool ok = kl == s.row_lane[r] && kp <= s.row_pos[r];  // warp-uniform
        float a0 = 0.f, a1 = 0.f;
        if (ok) {
          const float* qr = s.q + r * D;
#pragma unroll
          for (int i = 0; i < DI; i += 2) {
            const int d0 = lane_id + 32 * i, d1 = d0 + 32;
            if (d0 < D) a0 = fmaf(qr[d0], kreg[i], a0);
            if (i + 1 < DI && d1 < D) a1 = fmaf(qr[d1], kreg[i + 1], a1);
          }
          a0 += a1;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) a0 += __shfl_xor_sync(0xffffffffu, a0, o);
        }
        if (lane_id == 0) s.p[r * MKEYS + j] = ok ? a0 * scale : dyn::NEG_INF;
      }
    }
    __syncthreads();

    // 2) online softmax: one warp per row, one lane per key
    for (int r = warp; r < rows; r += NWARPS) {
      const float sc = s.p[r * MKEYS + lane_id];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pr = sc == dyn::NEG_INF ? 0.f : expf(sc - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s.p[r * MKEYS + lane_id] = pr;
      __syncwarp();
      if (lane_id == 0) {
        const float a = expf(m_prev - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
        // sum 0: no key of the tile is visible (or all underflow below the
        // running max), so m is unchanged, alpha is 1 and acc stays as it is
        s.row_live[r] = sum > 0.f;
      }
    }
    __syncthreads();
    stage_meta(tile + 2);  // this buffer's metadata is free: read it during step 3

    // 3) acc = acc * alpha + P ck for the rows that see this tile: the
    //    latents are the values
    for (int i = tid; i < rows * R; i += MTHREADS) {
      const int r = i / R, d = i % R;
      if (!s.row_live[r]) continue;
      const float* pr = s.p + r * MKEYS;
      float a0 = s.acc[i] * s.alpha[r], a1 = 0.f;
#pragma unroll
      for (int j = 0; j < MKEYS; j += 2) {
        a0 = fmaf(pr[j], dyn::to_f32(kt[(size_t)j * D + d]), a0);
        a1 = fmaf(pr[j + 1], dyn::to_f32(kt[(size_t)(j + 1) * D + d]), a1);
      }
      s.acc[i] = a0 + a1;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * R; i += MTHREADS) {
    const int r = i / R, d = i % R;
    out_row(r)[d] = s.acc[i] / fmaxf(s.l[r], 1e-20f);
  }
}

// Stage q_lat (float32) and q_rope (cache type) of one row into s.q.
template <typename T, int R, int P>
__device__ void stage_row(MlaSmem<T, R, P>& s, int r, const float* ql, const T* qr) {
  constexpr int D = R + P;
  for (int d = threadIdx.x; d < D; d += MTHREADS)
    s.q[r * D + d] = d < R ? ql[d] : dyn::to_f32(qr[d - R]);
}

struct TableKeys {  // decode: keys are positions 0..ctx-1 through a block table
  const int* table;
  int bs;
  __device__ size_t row(int key) const { return (size_t)table[key / bs] * bs + key % bs; }
  __device__ int pos(int key) const { return key; }
  __device__ int lane(int) const { return 0; }
};

struct WorklistKeys {  // ragged: keys are the pages of a token block's worklist
  const int* phys;
  const int* lanes;
  const int* ords;
  int bs;
  __device__ size_t row(int key) const { return (size_t)phys[key / bs] * bs + key % bs; }
  __device__ int pos(int key) const { return ords[key / bs] * bs + key % bs; }
  __device__ int lane(int key) const { return lanes[key / bs]; }
};

template <typename T, int R, int P>
__global__ void __launch_bounds__(MTHREADS, 2)
mla_decode_kernel(const float* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ck, const T* __restrict__ kr,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ context_lens, float* __restrict__ out,
                  int H, int hg, int bs, int max_blocks, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x, h0 = blockIdx.y * hg;
  MlaSmem<T, R, P> s(smem_raw, hg);
  const int ctx = min(context_lens[b], max_blocks * bs);
  for (int r = 0; r < hg; ++r) {
    const size_t qh = (size_t)b * H + h0 + r;
    stage_row(s, r, q_lat + qh * R, q_rope + qh * P);
  }
  for (int r = threadIdx.x; r < hg; r += MTHREADS) {
    s.row_pos[r] = ctx - 1;
    s.row_lane[r] = 0;
  }
  TableKeys keys{block_tables + (size_t)b * max_blocks, bs};
  mla_attend<T, R, P>(s, hg, ck, kr, keys, ctx, scale, [&](int r) {
    return out + ((size_t)b * H + h0 + r) * R;
  });
}

template <typename T, int R, int P>
__global__ void __launch_bounds__(MTHREADS, 2)
mla_window_kernel(const float* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ck, const T* __restrict__ kr,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ context_lens, float* __restrict__ out,
                  int W, int H, int hg, int bs, int max_blocks, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x, f0 = blockIdx.y * hg;  // first w-major row of this CTA
  MlaSmem<T, R, P> s(smem_raw, hg);
  // a window clamped at the engine's last position can reach past the
  // table: its queries keep their own positions, the keys stop at the
  // table's end (the TPU kernel's grid has max_blocks pages)
  const int ctx_in = context_lens[b];
  const int ctx = min(ctx_in, max_blocks * bs);
  const size_t base = (size_t)b * W * H;  // q and out are [B, W, H, .]
  for (int r = 0; r < hg; ++r)
    stage_row(s, r, q_lat + (base + f0 + r) * R, q_rope + (base + f0 + r) * P);
  for (int r = threadIdx.x; r < hg; r += MTHREADS) {
    s.row_pos[r] = ctx_in - W + (f0 + r) / H;
    s.row_lane[r] = 0;
  }
  TableKeys keys{block_tables + (size_t)b * max_blocks, bs};
  mla_attend<T, R, P>(s, hg, ck, kr, keys, ctx, scale,
                      [&](int r) { return out + (base + f0 + r) * R; });
}

template <typename T, int R, int P>
__global__ void __launch_bounds__(MTHREADS, 2)
mla_ragged_kernel(const float* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const T* __restrict__ ck, const T* __restrict__ kr,
                  const int* __restrict__ token_lane, const int* __restrict__ token_pos,
                  const int* __restrict__ page_phys, const int* __restrict__ page_lane,
                  const int* __restrict__ page_ord, const int* __restrict__ page_count,
                  float* __restrict__ out, int H, int hg, int bs, int tb,
                  int page_slots, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int t = blockIdx.x, h0 = blockIdx.y * hg;
  const int rows = tb * hg;
  MlaSmem<T, R, P> s(smem_raw, rows);
  // row r = (token t * tb + r / hg, head h0 + r % hg); q and out are [T, H, .]
  for (int r = 0; r < rows; ++r) {
    const size_t qh = (size_t)(t * tb + r / hg) * H + h0 + r % hg;
    stage_row(s, r, q_lat + qh * R, q_rope + qh * P);
  }
  for (int r = threadIdx.x; r < rows; r += MTHREADS) {
    const int tok = t * tb + r / hg;
    s.row_pos[r] = token_pos[tok];
    s.row_lane[r] = token_lane[tok];
  }
  const size_t wl = (size_t)t * page_slots;
  const int count = min(page_count[t], page_slots);
  WorklistKeys keys{page_phys + wl, page_lane + wl, page_ord + wl, bs};
  mla_attend<T, R, P>(s, rows, ck, kr, keys, count * bs, scale, [&](int r) {
    return out + ((size_t)(t * tb + r / hg) * H + h0 + r % hg) * R;
  });
}

// ---------------------------------------------------------------------------
// Ragged MLA at DeepSeek widths (bf16 caches, R 512, P 64, 16-token pages,
// H a multiple of 16): the split tensor-core walk.  See the note at the top.
// ---------------------------------------------------------------------------

namespace rtc {
using bf16 = __nv_bfloat16;
namespace tc = dyn::tc;
constexpr int R = 512, P = 64, KEYS = 16;  // KEYS: positions a page, one MMA K step of P.ck
constexpr int TILES = 4;                   // 16-row MMA tiles a CTA: 4 tokens at H = 16
constexpr int WARPS = 2 * TILES;           // two a tile: the two halves of the R columns
constexpr int THREADS = WARPS * 32;
constexpr int HALF = R / 2;
constexpr int STAGES = 3;                  // pages in flight
constexpr int MAX_CHUNK = 256;             // worklist entries a CTA walks at most
constexpr int MAX_CHUNKS = 256;            // chunks a worklist may have (the combine's)
constexpr int QS = R + 8, RS = P + 8;      // bf16 row strides: 16-byte rows, ldmatrix without conflicts
constexpr int LAT_STEPS = R / 16;          // MMA K steps of q_lat.ck; each warp of a pair takes half

struct Layout {
  static constexpr size_t Q_LAT = (size_t)TILES * 16 * QS * sizeof(bf16);  // q_hi, and q_lo
  static constexpr size_t Q_ROPE = (size_t)TILES * 16 * RS * sizeof(bf16);
  static constexpr size_t PAGE = (size_t)KEYS * (QS + RS) * sizeof(bf16);  // ck rows, then kr rows
  static constexpr size_t RING = 2 * Q_LAT + Q_ROPE;                       // offset of the ring
  static constexpr size_t SWAP = RING + STAGES * PAGE;  // partial scores a warp pair swaps
  static constexpr size_t LIST = SWAP + (size_t)WARPS * 32 * 8 * sizeof(float);
  static constexpr size_t BYTES = LIST + (3 * MAX_CHUNK + 2 * TILES + 1) * sizeof(int);
};

// The named barrier of the two warps of tile `rt` (barrier 0 is __syncthreads).
__device__ inline void pair_sync(int rt) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rt) : "memory");
}

// Grid (chunk, tile group, token block).  Rows are token-major (row = token
// * H + head); a CTA holds TILES 16-row tiles of its token block, each tile
// one token's 16 heads (H = 16) or 16 of its heads.  Warps 2i and 2i + 1
// own tile i: each scores half of the K = 576 reduction (q_lat columns
// [0, 256), then [256, 512) and q_rope) and they swap the partial scores
// through shared memory, adding them in one order, so both hold the same
// bits; then each accumulates one half of the R context columns.
__global__ void __launch_bounds__(THREADS, 1)
mla_ragged_tc_kernel(const float* __restrict__ q_lat, const bf16* __restrict__ q_rope,
                     const bf16* __restrict__ ck, const bf16* __restrict__ kr,
                     const int* __restrict__ token_lane, const int* __restrict__ token_pos,
                     const int* __restrict__ page_phys, const int* __restrict__ page_lane,
                     const int* __restrict__ page_ord, const int* __restrict__ page_count,
                     float* __restrict__ out, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int H, int tb, int page_slots,
                     int chunk_pages, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  bf16* q_hi = reinterpret_cast<bf16*>(smem);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + Layout::Q_LAT);
  bf16* q_rp = reinterpret_cast<bf16*>(smem + 2 * Layout::Q_LAT);
  char* ring = smem + Layout::RING;
  float* swap = reinterpret_cast<float*>(smem + Layout::SWAP);  // [warps][32 lanes][8]
  int* l_phys = reinterpret_cast<int*>(smem + Layout::LIST);
  int* l_ord = l_phys + MAX_CHUNK;
  int* l_lane = l_ord + MAX_CHUNK;
  int* t_lane = l_lane + MAX_CHUNK;  // [TILES] the lane and position of each tile's token
  int* t_pos = t_lane + TILES;       //         (-1: a pad token or no tile)
  int* n_list_s = t_pos + TILES;

  const int c = blockIdx.x, grp = blockIdx.y, t = blockIdx.z;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group and column pair
  const int count = min(page_count[t], page_slots);
  const int n_used = tc::ceil_div(count, chunk_pages);
  if (c >= max(n_used, 1)) return;  // past the worklist: nothing to do
  const bool direct = n_used <= 1;  // the only chunk writes the output itself
  const int rows_tb = tb * H, tiles_tb = rows_tb / 16;

  if (tid < TILES) {
    const int tile = grp * TILES + tid;
    int ln = -1, ps = -1;
    if (tile < tiles_tb) {
      const int tok = t * tb + tile * 16 / H;
      ln = token_lane[tok];
      ps = token_pos[tok];
    }
    t_lane[tid] = ln;
    t_pos[tid] = ps;
  }
  __syncthreads();
  // the chunk's worklist entries that some tile of this CTA sees, in
  // worklist order: a page of another lane, or above every token of its
  // lane here, costs nothing more
  if (warp == 0) {
    const int e0 = c * chunk_pages, e1 = min(count, e0 + chunk_pages);
    const size_t wl = (size_t)t * page_slots;
    int n = 0;
    for (int base = e0; base < e1; base += 32) {
      const int e = base + lane;
      int ph = 0, od = 0, ln = -1;
      bool seen = false;
      if (e < e1) {
        ph = page_phys[wl + e];
        od = page_ord[wl + e];
        ln = page_lane[wl + e];
#pragma unroll
        for (int i = 0; i < TILES; ++i)
          seen = seen || (t_pos[i] >= 0 && t_lane[i] == ln && od * KEYS <= t_pos[i]);
      }
      const unsigned mask = __ballot_sync(tc::FULL, seen);
      if (seen) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        l_phys[at] = ph;
        l_ord[at] = od;
        l_lane[at] = ln;
      }
      n += __popc(mask);
    }
    if (lane == 0) *n_list_s = n;
  }
  __syncthreads();
  const int n_list = *n_list_s;

  auto issue = [&](int n) {  // page n of the list into its stage, 16 bytes a copy
    if (n < n_list) {
      bf16* dc = reinterpret_cast<bf16*>(ring + (n % STAGES) * Layout::PAGE);
      bf16* dr = dc + KEYS * QS;
      const bf16* sc_ = ck + (size_t)l_phys[n] * KEYS * R;
      const bf16* sr = kr + (size_t)l_phys[n] * KEYS * P;
      constexpr int CC = R / 8, CR = P / 8;
      for (int i = tid; i < KEYS * (CC + CR); i += THREADS) {
        if (i < KEYS * CC) {
          const int j = i / CC, k = i % CC;
          tc::cp_async16(dc + j * QS + k * 8, sc_ + j * R + k * 8, true);
        } else {
          const int j = (i - KEYS * CC) / CR, k = (i - KEYS * CC) % CR;
          tc::cp_async16(dr + j * RS + k * 8, sr + j * P + k * 8, true);
        }
      }
    }
    tc::cp_async_commit();  // one group a page, empty past the last
  };
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n);

  // the queries of the tiles that see a page: q_lat as bf16 high and low
  // parts (q_lat = hi + lo to 2^-17), q_rope as it is; eight loads in
  // flight a thread at a time
  if (n_list > 0) {
    auto q_row = [&](int r) {  // row r of the CTA's tiles in q [T, H, .]
      const int tile = grp * TILES + r / 16;
      return (size_t)(t * tb + tile * 16 / H) * H + (tile * 16) % H + r % 16;
    };
    constexpr int QV = TILES * 16 * (R / 4) / THREADS;  // float4s a thread
#pragma unroll
    for (int k0 = 0; k0 < QV; k0 += 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = tid + (k0 + u) * THREADS, r = i / (R / 4), k = i % (R / 4);
        x[u] = t_pos[r / 16] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *reinterpret_cast<const float4*>(q_lat + q_row(r) * R + k * 4);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = tid + (k0 + u) * THREADS, r = i / (R / 4), k = i % (R / 4);
        uint2 hi, lo;
        tc::split_bf16(x[u].x, x[u].y, hi.x, lo.x);
        tc::split_bf16(x[u].z, x[u].w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(q_hi + r * QS + k * 4) = hi;
        *reinterpret_cast<uint2*>(q_lo + r * QS + k * 4) = lo;
      }
    }
    constexpr int RV = TILES * 16 * (P / 8) / THREADS;  // 16-byte q_rope pieces a thread
#pragma unroll
    for (int u = 0; u < RV; ++u) {
      const int i = tid + u * THREADS, r = i / (P / 8), k = i % (P / 8);
      *reinterpret_cast<uint4*>(q_rp + r * RS + k * 8) =
          t_pos[r / 16] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                            : *reinterpret_cast<const uint4*>(q_rope + q_row(r) * P + k * 8);
    }
  }

  const int rt = warp / 2, ch = warp % 2;  // this warp's tile and column half
  const int tile = grp * TILES + rt;
  const int my_lane = t_lane[rt], my_pos = t_pos[rt];
  const bf16* qh = q_hi + rt * 16 * QS;
  const bf16* ql = q_lo + rt * 16 * QS;
  const bf16* qr = q_rp + rt * 16 * RS;
  float acc[HALF / 8][4];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {dyn::NEG_INF, dyn::NEG_INF}, l[2] = {0.f, 0.f};  // rows gq, gq + 8

  for (int n = 0; n < n_list; ++n) {
    tc::cp_async_wait<STAGES - 2>();  // page n landed (this thread's copies)
    __syncthreads();                  // ... everyone's; page n - 1 consumed
    issue(n + STAGES - 1);            // into the stage page n - 1 left
    const int ord = l_ord[n];
    if (my_pos < 0 || l_lane[n] != my_lane || ord * KEYS > my_pos) continue;
    const bf16* pc = reinterpret_cast<const bf16*>(ring + (n % STAGES) * Layout::PAGE);
    const bf16* pr = pc + KEYS * QS;

    // scores [16 rows, 16 keys]: q_hi.ck + q_lo.ck (+ q_rope.kr) over this
    // warp's half of K, in four independent accumulator chains per N tile
    // (summed in a fixed order), then the pair's halves swapped and added
    float sc[2][4][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][k][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < LAT_STEPS / 2; ++k2) {
      const int kk = ch * (LAT_STEPS / 2) + k2;
      uint32_t kf[4], ah[4], al[4];
      tc::ldmatrix_x4(kf, pc + tc::b_row(lane) * QS + kk * 16 + tc::b_col(lane));
      tc::ldmatrix_x4(ah, qh + tc::a_row(lane) * QS + kk * 16 + tc::a_col(lane));
      tc::ldmatrix_x4(al, ql + tc::a_row(lane) * QS + kk * 16 + tc::a_col(lane));
      const int par = k2 & 1;
      tc::mma_bf16(sc[0][par], ah, kf[0], kf[1]);
      tc::mma_bf16(sc[1][par], ah, kf[2], kf[3]);
      tc::mma_bf16(sc[0][2 + par], al, kf[0], kf[1]);
      tc::mma_bf16(sc[1][2 + par], al, kf[2], kf[3]);
    }
    if (ch == 1) {
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t kf[4], ar[4];
        tc::ldmatrix_x4(kf, pr + tc::b_row(lane) * RS + kk * 16 + tc::b_col(lane));
        tc::ldmatrix_x4(ar, qr + tc::a_row(lane) * RS + kk * 16 + tc::a_col(lane));
        tc::mma_bf16(sc[0][kk & 1], ar, kf[0], kf[1]);
        tc::mma_bf16(sc[1][kk & 1], ar, kf[2], kf[3]);
      }
    }
    float part[8];  // [N tile][fragment element]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[j * 4 + e] = (sc[j][0][e] + sc[j][1][e]) + (sc[j][2][e] + sc[j][3][e]);
    float4* mine_sw = reinterpret_cast<float4*>(swap + (warp * 32 + lane) * 8);
    mine_sw[0] = make_float4(part[0], part[1], part[2], part[3]);
    mine_sw[1] = make_float4(part[4], part[5], part[6], part[7]);
    pair_sync(rt);
    const float4* other_sw = reinterpret_cast<const float4*>(swap + ((warp ^ 1) * 32 + lane) * 8);
    const float4 o0 = other_sw[0], o1 = other_sw[1];
    const float other[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
    float sfull[8];  // the low-K half first in both warps: the same bits
#pragma unroll
    for (int i = 0; i < 8; ++i) sfull[i] = ch == 0 ? part[i] + other[i] : other[i] + part[i];

    // mask (every key is this token's lane: keep positions <= its own),
    // online softmax per row, P as bf16 high and low A fragments
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // row gq (h = 0) or gq + 8 (h = 1)
      float row_s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i / 2, e = 2 * h + i % 2;
        const int kp = ord * KEYS + j * 8 + 2 * tq + i % 2;
        row_s[i] = kp <= my_pos ? sfull[j * 4 + e] * scale_log2 : dyn::NEG_INF;
      }
      const float alpha = tc::softmax_step(row_s, m[h], l[h]);
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
      tc::split_bf16(row_s[0], row_s[1], ph[h], pl[h]);          // keys 2t, 2t+1
      tc::split_bf16(row_s[2], row_s[3], ph[2 + h], pl[2 + h]);  // keys 8+2t, 9+2t
    }

    // acc += P ck over this warp's half of the columns (ck through
    // ldmatrix.trans, two N tiles a load), the high and low parts of P
#pragma unroll
    for (int dp = 0; dp < HALF / 16; ++dp) {
      uint32_t vf[4];
      tc::ldmatrix_x4_trans(vf, pc + tc::a_row(lane) * QS + ch * HALF + dp * 16 + tc::a_col(lane));
      tc::mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
      tc::mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
      tc::mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
      tc::mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
    }
  }
  tc::cp_async_wait<0>();
  if (tile >= tiles_tb) return;

  const int tok_local = tile * 16 / H, head0 = (tile * 16) % H;
  const size_t tok = (size_t)t * tb + tok_local;
  const int cols = ch * HALF + 2 * tq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = head0 + gq + 8 * h;
    const float lr = tc::quad_sum(l[h]);
    if (direct) {  // the output: zeros for a pad token or a token with no page here
      float* o = out + (tok * H + head) * R + cols;
      const float d = fmaxf(lr, 1e-20f);
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
        *reinterpret_cast<float2*>(o + j * 8) = make_float2(acc[j][2 * h] / d, acc[j][2 * h + 1] / d);
      continue;
    }
    // a partial: m and l always, acc where the row saw a key
    const size_t pr = ((size_t)t * chunks + c) * rows_tb + tok_local * H + head;
    if (ch == 0 && tq == 0) {
      part_ml[pr] = m[h];
      part_ml[pr + (size_t)gridDim.z * chunks * rows_tb] = lr;
    }
    if (m[h] == dyn::NEG_INF) continue;
    float* pa = part_acc + pr * R + cols;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j)
      *reinterpret_cast<float2*>(pa + j * 8) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Merge the partials of every token block whose worklist spans more than
// one chunk, in chunk order.  One CTA per (head, token, token block), a
// thread four columns.
__global__ void __launch_bounds__(R / 4)
mla_ragged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int* __restrict__ page_count, float* __restrict__ out, int H,
                          int tb, int page_slots, int chunks, int chunk_pages) {
  __shared__ float sm[MAX_CHUNKS], sl[MAX_CHUNKS], red[2];
  const int h = blockIdx.x, tl = blockIdx.y, t = blockIdx.z, tid = threadIdx.x;
  const int n = tc::ceil_div(min(page_count[t], page_slots), chunk_pages);
  if (n <= 1) return;  // written by the walk itself
  const int rows_tb = tb * H;
  const size_t row0 = (size_t)t * chunks * rows_tb + tl * H + h;  // chunk 0's row
  const size_t l_off = (size_t)gridDim.z * chunks * rows_tb;
  for (int c = tid; c < n; c += blockDim.x) {
    sm[c] = part_ml[row0 + (size_t)c * rows_tb];
    sl[c] = part_ml[row0 + (size_t)c * rows_tb + l_off];
  }
  const float d = fmaxf(tc::merge_weights(sm, sl, n, red), 1e-20f);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int c = 0; c < n; ++c) {
    const float w = sm[c];
    if (w == 0.f) continue;  // no key in this chunk: its acc was not written
    const float4 x = *reinterpret_cast<const float4*>(part_acc + (row0 + (size_t)c * rows_tb) * R + tid * 4);
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  *reinterpret_cast<float4*>(out + ((size_t)(t * tb + tl) * H + h) * R + tid * 4) =
      make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

int launch(const void* ql, const void* qr, const void* ck, const void* kr, const int* tl,
           const int* tp, const int* pp, const int* pl, const int* po, const int* pc,
           float* out, float* part_acc, float* part_ml, int T_, int H, int tb, int page_slots,
           int chunks, int chunk_pages, float scale, cudaStream_t stream) {
  const int num_tb = T_ / tb;
  const int groups = tc::ceil_div(tb * H / 16, TILES);
  cudaError_t err = dyn::allow_smem(mla_ragged_tc_kernel, Layout::BYTES);
  if (err != cudaSuccess) return (int)err;
  mla_ragged_tc_kernel<<<dim3(chunks, groups, num_tb), THREADS, Layout::BYTES, stream>>>(
      static_cast<const float*>(ql), static_cast<const bf16*>(qr), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(kr), tl, tp, pp, pl, po, pc, out, part_acc, part_ml, H, tb,
      page_slots, chunk_pages, scale * tc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  mla_ragged_combine_kernel<<<dim3(H, tb, num_tb), R / 4, 0, stream>>>(
      part_acc, part_ml, pc, out, H, tb, page_slots, chunks, chunk_pages);
  return (int)cudaGetLastError();
}

}  // namespace rtc

int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        n <= 0)
      n = 132;
  }
  return n;
}

// Heads per CTA: 1, doubled while the grid would overflow two CTAs per SM
// and the CTA's rows stay within MAX_ROWS.
int pick_group(int H, int rows_per_head, long ctas_per_head_group) {
  const long slots = 2L * sm_count();
  int hg = 1;
  while (H % (hg * 2) == 0 && rows_per_head * hg * 2 <= MAX_ROWS &&
         ctas_per_head_group * (H / hg) > slots)
    hg *= 2;
  return hg;
}

template <typename T, int R, int P>
int launch_decode(const void* ql, const void* qr, const void* ck, const void* kr,
                  const int* tables, const int* lens, float* out, int B, int H,
                  int bs, int max_blocks, float scale, cudaStream_t stream) {
  const int hg = pick_group(H, 1, B);
  const size_t smem = MlaSmem<T, R, P>::bytes(hg);
  auto kernel = mla_decode_kernel<T, R, P>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, H / hg), MTHREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const T*>(qr), static_cast<const T*>(ck),
      static_cast<const T*>(kr), tables, lens, out, H, hg, bs, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R, int P>
int launch_window(const void* ql, const void* qr, const void* ck, const void* kr,
                  const int* tables, const int* lens, float* out, int B, int W, int H,
                  int bs, int max_blocks, float scale, cudaStream_t stream) {
  const int hg = pick_group(H, 1, (long)B * W);
  const size_t smem = MlaSmem<T, R, P>::bytes(hg);
  auto kernel = mla_window_kernel<T, R, P>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, W * H / hg), MTHREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const T*>(qr), static_cast<const T*>(ck),
      static_cast<const T*>(kr), tables, lens, out, W, H, hg, bs, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R, int P>
int launch_ragged(const void* ql, const void* qr, const void* ck, const void* kr,
                  const int* tl, const int* tp, const int* pp, const int* pl,
                  const int* po, const int* pc, float* out, int T_, int H, int bs,
                  int tb, int page_slots, float scale, cudaStream_t stream) {
  const int hg = pick_group(H, tb, T_ / tb);
  const size_t smem = MlaSmem<T, R, P>::bytes(tb * hg);
  auto kernel = mla_ragged_kernel<T, R, P>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(T_ / tb, H / hg), MTHREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const T*>(qr), static_cast<const T*>(ck),
      static_cast<const T*>(kr), tl, tp, pp, pl, po, pc, out, H, hg, bs, tb, page_slots,
      scale);
  return (int)cudaGetLastError();
}

// The (R, P) geometries built: DeepSeek-V2/V3 (512, 64) and the tiny_mla
// test geometry (32, 8).
template <class Fn512, class Fn32>
int by_geometry(int R, int P, Fn512 f512, Fn32 f32) {
  if (R == 512 && P == 64) return f512();
  if (R == 32 && P == 8) return f32();
  return dyn::ERR_UNSUPPORTED;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q_rope and both caches share it; q_lat
// and out are float32).  Returns 0 or an error code.
extern "C" int dyn_mla_paged_decode(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* block_tables, const void* context_lens, void* out, int B, int H,
    int R, int P, int bs, int max_blocks, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYN_DECODE(T, R_, P_)                                                      \
  [&] { return launch_decode<T, R_, P_>(q_lat, q_rope, ck_cache, kr_cache, tables, \
                                        lens, o, B, H, bs, max_blocks, scale, st); }
  if (dtype == 0)
    return by_geometry(R, P, DYN_DECODE(float, 512, 64), DYN_DECODE(float, 32, 8));
  if (dtype == 1)
    return by_geometry(R, P, DYN_DECODE(__nv_bfloat16, 512, 64),
                                      DYN_DECODE(__nv_bfloat16, 32, 8));
#undef DYN_DECODE
  return dyn::ERR_UNSUPPORTED;
}

// The verify window: W queries a sequence, q_lat / q_rope / out [B, W, H, .].
// Same dtypes as dyn_mla_paged_decode.  Returns 0 or an error code.
extern "C" int dyn_mla_paged_window_decode(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* block_tables, const void* context_lens, void* out, int B, int W, int H,
    int R, int P, int bs, int max_blocks, float scale, int dtype, void* stream) {
  if (B == 0) return 0;
  if (W <= 0 || H <= 0 || (long)W * H > 65535L) return dyn::ERR_UNSUPPORTED;  // grid y
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYN_WINDOW(T, R_, P_)                                                      \
  [&] { return launch_window<T, R_, P_>(q_lat, q_rope, ck_cache, kr_cache, tables, \
                                        lens, o, B, W, H, bs, max_blocks, scale, st); }
  if (dtype == 0)
    return by_geometry(R, P, DYN_WINDOW(float, 512, 64), DYN_WINDOW(float, 32, 8));
  if (dtype == 1)
    return by_geometry(R, P, DYN_WINDOW(__nv_bfloat16, 512, 64),
                                      DYN_WINDOW(__nv_bfloat16, 32, 8));
#undef DYN_WINDOW
  return dyn::ERR_UNSUPPORTED;
}

// T_ is a multiple of tb and tb <= 8.  bf16 caches at R 512, P 64, bs 16
// and H a multiple of 16 take the split tensor-core walk over `chunks`
// chunks of `chunk_pages` worklist entries (chunks * chunk_pages >=
// page_slots, chunk_pages <= 256); with chunks > 1, part_acc [T_/tb,
// chunks, tb*H, R] and part_ml [2, T_/tb, chunks, tb*H] are float32
// scratch.  Other cases ignore the four.  Returns 0 or an error code.
extern "C" int dyn_ragged_mla_attention(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* token_lane, const void* token_pos, const void* page_phys,
    const void* page_lane, const void* page_ord, const void* page_count, void* out,
    void* part_acc, void* part_ml, int T_, int H, int R, int P, int bs, int tb,
    int page_slots, int chunks, int chunk_pages, float scale, int dtype, void* stream) {
  if (T_ == 0) return 0;
  if (tb <= 0 || T_ % tb || tb > MAX_ROWS) return dyn::ERR_UNSUPPORTED;
  const int* tl = static_cast<const int*>(token_lane);
  const int* tp = static_cast<const int*>(token_pos);
  const int* pp = static_cast<const int*>(page_phys);
  const int* pl = static_cast<const int*>(page_lane);
  const int* po = static_cast<const int*>(page_ord);
  const int* pc = static_cast<const int*>(page_count);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && R == rtc::R && P == rtc::P && bs == rtc::KEYS && H % 16 == 0) {
    if (chunks < 1 || chunk_pages < 1 || chunk_pages > rtc::MAX_CHUNK || chunks > rtc::MAX_CHUNKS ||
        (long)chunks * chunk_pages < page_slots ||
        (chunks > 1 && (part_acc == nullptr || part_ml == nullptr)))
      return dyn::ERR_UNSUPPORTED;
    return rtc::launch(q_lat, q_rope, ck_cache, kr_cache, tl, tp, pp, pl, po, pc, o,
                       static_cast<float*>(part_acc), static_cast<float*>(part_ml), T_, H, tb,
                       page_slots, chunks, chunk_pages, scale, st);
  }
#define DYN_RAGGED(T, R_, P_)                                                        \
  [&] { return launch_ragged<T, R_, P_>(q_lat, q_rope, ck_cache, kr_cache, tl, tp, pp, \
                                        pl, po, pc, o, T_, H, bs, tb, page_slots,      \
                                        scale, st); }
  if (dtype == 0)
    return by_geometry(R, P, DYN_RAGGED(float, 512, 64), DYN_RAGGED(float, 32, 8));
  if (dtype == 1)
    return by_geometry(R, P, DYN_RAGGED(__nv_bfloat16, 512, 64),
                                      DYN_RAGGED(__nv_bfloat16, 32, 8));
#undef DYN_RAGGED
  return dyn::ERR_UNSUPPORTED;
}
