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
//   Window (verify, and decode at W = 1): sequence b has W queries; query
//   w sits at position ctx_b - W + w (ctx_b includes the window's last
//   token) and sees the positions <= its own through the block table.
//   The W*H rows are w-major (row = w * H + h).  Decode is the window at
//   W = 1: positions pos < ctx_b.
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
// Cache dtypes: q_rope is float32 or bf16 (the model's), the caches any
//   of attention_common.cuh's CacheType (the TPU kernels upcast their cache
//   at load, e.g. mla_attention.py's .astype(jnp.float32)).
//
// Routes, chosen by shape and dtype (neither is a fallback of the other):
//   - bf16 queries over bf16 or fp8 (e4m3fn, e5m2) caches at R 512, P 64,
//     16-position pages and H a multiple of 16 (DeepSeek widths): the split
//     tensor-core walks of rtc:: below, the ragged walk over a token
//     block's worklist (row 3) and the table walk over a sequence's block
//     table for decode and verify (rows 4 and 5).  An fp8 page arrives raw
//     in the ring (R + P bytes a position, half of bf16's), and every
//     thread converts the 16-byte chunks it copied into one bf16 page beside
//     the ring (exact) behind a CTA barrier: the products are the bf16
//     walk's;
//   - float32 queries or caches, float16 caches and other geometries (the
//     tiny_mla test geometry, R 32, P 8): the CUDA-core loop mla_attend
//     (mla_window_kernel for decode and verify, mla_ragged_kernel), which
//     stages the cache's own bytes and converts each element at use.
//
// Tensor-core design (rtc::), shared by both walks.
//   - A CTA holds a group of 16-row MMA tiles and walks its pages once for
//     all of them: a page crosses HBM once per tile group, not once per
//     few rows.  Each tile is one position limit's rows: a token's 16
//     heads (ragged; H = 16) or 16 heads of one query of the window.
//   - WPT warps own a tile (a template parameter: 2 in the ragged walk, 4
//     in the table walk, where 4 ran faster than 2 and 8 in
//     chip_smoke.py's sweep).  The
//     16 x 512 float32 accumulator does not fit one warp's registers with
//     the queries beside it, so R is split across them: warp wq of a tile
//     accumulates context columns [wq, wq + 1) * R / WPT (R / WPT / 4
//     accumulator registers a thread).  They split the tile's score
//     reduction instead: each scores 1/WPT of the q_lat columns and of
//     q_rope's K steps, and they swap the partial scores through shared
//     memory, adding them in warp order, so every warp holds the same
//     bits (page_step).
//   - Pages arrive in a ring of 3 cp.async stages (ck rows, then kr rows,
//     bf16) while the previous page computes.  Both products run on
//     mma.sync m16n8k16 bf16 with fp32 accumulation.  q_lat and P are
//     float32, and a single bf16 pass would miss the float32 reference by
//     more than 2e-4, so each is split into a bf16 high part plus a bf16
//     low part (x = hi + lo to 2^-17 |x|) and runs two passes; the bf16
//     cache operand is exact.  Scores: q_hi.ck + q_lo.ck + q_rope.kr over
//     K = 576, in four accumulator chains summed in a fixed order.
//     Context: (P_hi + P_lo).ck over the page's 16 keys, ck through
//     ldmatrix.trans.  The softmax is float32 in the log2 domain (the scale
//     folded into log2 e), the reference's contract: masked scores
//     NEG_INF, their exponentials 0, the denominator clamped at 1e-20, so
//     pad rows, idle lanes (ctx 0) and token blocks without pages write
//     zeros.
//   - The walk is split across CTAs, with no device-to-host read, so a
//     step stays capturable by a CUDA graph.  A unit (a token block, or a
//     sequence) whose walk is one piece is written by that CTA; otherwise
//     each piece writes float32 partials (acc, m, l per row) and a combine
//     merges them in piece order: no atomics, the same bits on every
//     launch.
//
// Ragged walk (mla_ragged_tc_kernel; row 3): rows token-major (row = token
//   * H + head), 4 tiles (4 tokens, half a token block of 8) of two warps a
//   CTA, so a page crosses HBM at most twice per item.  The pieces are the
//   work items of a host plan made from the host copy of page_count
//   (mla_planner in ops/kernels/mla_attention.py, ops/kernels/
//   work_plan.py): items of about equal length, about 1 CTA an SM in
//   all, partial slots only for the token blocks it splits, in a plan
//   buffer of fixed capacity whose live counts the kernels read on the
//   device (so one CUDA graph of a token bucket serves every plan of it,
//   and the partials scratch is bounded by the plan's capacity, not by
//   the worklist's width).  A CTA walks its item's entries in lists of at
//   most MAX_CHUNK: it first keeps, in order, the entries of the list that
//   one of its tokens sees (its lane, not above its position), and walks
//   only those.  A tile skips a page of another lane.
//   mla_ragged_combine_kernel merges a split block's partials in slot
//   order.
//
// Table walk pieces: fixed chunks of a sequence's block table, planned by
//   the wrapper from shapes alone (plan_table_chunks); chunks past a
//   sequence's context exit at once, and mla_combine_kernel merges them in
//   chunk order.
//
// Table walk (mla_table_tc_kernel; rows 4 and 5): grid (chunk, tile group,
//   sequence).  A sequence's W*H w-major rows make W*H/16 tiles, each one
//   query's 16 heads at H = 16; they split into balanced groups of at most
//   three (shared memory and registers; W = 5 at H = 16 is 3 + 2 tiles),
//   so a page crosses HBM once per group.  Chunk c walks table
//   slots [c * chunk_pages, ...) up to the sequence's last page; a tile's
//   limit is its query's position ctx - W + w.  Keys stop at max_blocks *
//   bs, so a window clamped past the table keeps its queries' positions
//   (the TPU kernel's grid has max_blocks pages).  At W = 1 a CTA holds
//   one tile (128 threads) and the planner aims the grid at about 4 CTAs
//   an SM, so a small batch still spreads over the card; a chunk walks at
//   least 64 positions a tile of its group, so a wide window's partials
//   (2 KB a row) stay a fixed share of the pages it reads.
//
// CUDA-core design (the other dtypes, the tiny_mla geometry): every head
//   reads the same single latent "kv head", so the head axis is the only
//   sharing there is.  One CTA owns `hg` rows of one sequence (window) or
//   of one token block (ragged): hg grows only while the grid would
//   overflow two CTAs per SM, so small batches still spread over the card,
//   and a CTA never holds more than MAX_ROWS query rows.  These products
//   run on the fp32 CUDA cores.  Shared memory holds the float32 queries
//   [rows, R+P] and accumulator [rows, R], and two tiles of MKEYS latent
//   rows [MKEYS, R+P] in the cache type (16-byte copies, 8-byte ones where
//   a row is not whole 16-byte chunks: fp8 at P 8): tile t+1 copies in
//   with cp.async while tile t computes.  No V tile exists: the values are the staged
//   latents.  Scores: one warp per key, lanes across the R+P columns, a
//   shuffle reduction per visible (row, key).  Softmax: one warp per row,
//   one lane per key.  Context: one thread per (row, column), only for
//   rows that see a key of the tile (a ragged token block mixes lanes, and
//   each tile belongs to one lane).  Masked scores are NEG_INF and
//   contribute 0, the denominator is clamped at 1e-20.  The window kernel
//   gives each of a CTA's consecutive w-major rows its own position limit,
//   so the grid is (B, W*H/hg).
//   pages_per_step of the TPU kernels has no counterpart: the output does
//   not depend on it.

#include <climits>
#include <type_traits>

#include "attention_common.cuh"
#include "split_attention.cuh"

namespace {

constexpr int MTHREADS = 256;  // 8 warps
constexpr int NWARPS = MTHREADS / 32;
constexpr int MKEYS = 32;      // keys per tile: one per lane in the softmax step
constexpr int MAX_ROWS = 8;    // query rows one CTA holds

template <int R, int P>
struct MlaSmem {
  static constexpr int D = R + P;
  static_assert(R % 8 == 0 && P % 8 == 0, "latent and rope rows are whole 8-byte chunks");
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
  char* kt;       // [2][MKEYS, D]  ck | kr rows in the cache type, double-buffered

  __host__ __device__ static size_t head_bytes(int rows) {
    const size_t floats = (size_t)rows * (D + R + MKEYS + 3);
    const size_t ints = 3 * (size_t)rows + 6 * (size_t)MKEYS;
    return ((floats + ints) * 4 + 15) / 16 * 16;  // the tiles start 16-byte aligned
  }
  __host__ __device__ static size_t bytes(int rows, int elem_bytes) {
    return head_bytes(rows) + 2 * (size_t)MKEYS * D * elem_bytes;
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
    kt = base + head_bytes(rows);
  }
};

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ inline void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Walk keys [0, end) of `src` for the rows already staged in `s` (q,
// row_pos, row_lane), then write out_row(r)[0..R) = acc[r] / max(l[r], 1e-20).
// The caches hold elements of type `code` (CacheType).
// KeySource gives, for a key index: row(key), the cache row (page * bs +
// offset) of its latent and rope key; pos(key); lane(key).  Tiles are
// double-buffered: tile t+1's rows copy in (cp.async) while tile t computes,
// and tile t+2's metadata is read while tile t accumulates.
template <int R, int P, class KeySource, class OutRow>
__device__ void mla_attend(MlaSmem<R, P>& s, int rows, const void* __restrict__ ck,
                           const void* __restrict__ kr, int code, const KeySource& src,
                           int end, float scale, OutRow out_row) {
  constexpr int D = R + P;
  const int esz = dyn::type_bytes(code);
  const int rb = R * esz, pb = P * esz;  // row bytes
  const int cb = rb % 16 == 0 && pb % 16 == 0 ? 16 : 8;  // bytes a copy
  const int CR = rb / cb, C = CR + pb / cb;
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
  auto stage_tile = [&](int tile) {  // its metadata is staged; cb bytes a copy
    if (tile < tiles) {
      const int buf = tile & 1;
      char* kt = s.kt + (size_t)buf * MKEYS * D * esz;
      for (int i = tid; i < MKEYS * C; i += MTHREADS) {
        const int j = i / C, c = i % C;
        char* dst = kt + (size_t)j * D * esz + (size_t)c * cb;
        if (s.key_pos[buf * MKEYS + j] == INT_MAX) {  // past the end: p is 0, keep 0 * junk out
          if (cb == 16)
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          else
            *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
          continue;
        }
        const size_t row = (size_t)s.key_row[buf * MKEYS + j];
        const char* from = c < CR ? static_cast<const char*>(ck) + row * rb + (size_t)c * cb
                                  : static_cast<const char*>(kr) + row * pb + (size_t)(c - CR) * cb;
        if (cb == 16)
          cp_async16(dst, from);
        else
          cp_async8(dst, from);
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
    const char* kt = s.kt + (size_t)buf * MKEYS * D * esz;
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
        kreg[i] = d < D ? dyn::load1(kt, (size_t)j * D + d, code) : 0.f;
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
        a0 = fmaf(pr[j], dyn::load1(kt, (size_t)j * D + d, code), a0);
        a1 = fmaf(pr[j + 1], dyn::load1(kt, (size_t)(j + 1) * D + d, code), a1);
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

// Stage q_lat (float32) and q_rope (the model's type T) of one row into s.q.
template <typename T, int R, int P>
__device__ void stage_row(MlaSmem<R, P>& s, int r, const float* ql, const T* qr) {
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
mla_window_kernel(const float* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const void* __restrict__ ck, const void* __restrict__ kr, int code,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ context_lens, float* __restrict__ out,
                  int W, int H, int hg, int bs, int max_blocks, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x, f0 = blockIdx.y * hg;  // first w-major row of this CTA
  MlaSmem<R, P> s(smem_raw, hg);
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
  mla_attend<R, P>(s, hg, ck, kr, code, keys, ctx, scale,
                      [&](int r) { return out + (base + f0 + r) * R; });
}

template <typename T, int R, int P>
__global__ void __launch_bounds__(MTHREADS, 2)
mla_ragged_kernel(const float* __restrict__ q_lat, const T* __restrict__ q_rope,
                  const void* __restrict__ ck, const void* __restrict__ kr, int code,
                  const int* __restrict__ token_lane, const int* __restrict__ token_pos,
                  const int* __restrict__ page_phys, const int* __restrict__ page_lane,
                  const int* __restrict__ page_ord, const int* __restrict__ page_count,
                  float* __restrict__ out, int H, int hg, int bs, int tb,
                  int page_slots, float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int t = blockIdx.x, h0 = blockIdx.y * hg;
  const int rows = tb * hg;
  MlaSmem<R, P> s(smem_raw, rows);
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
  mla_attend<R, P>(s, rows, ck, kr, code, keys, count * bs, scale, [&](int r) {
    return out + ((size_t)(t * tb + r / hg) * H + h0 + r % hg) * R;
  });
}

// ---------------------------------------------------------------------------
// MLA at DeepSeek widths (bf16 queries, bf16 or fp8 caches, R 512, P 64,
// 16-token pages, H a multiple of 16): the split tensor-core walks.  See
// the note at the top.
// ---------------------------------------------------------------------------

namespace rtc {
using bf16 = __nv_bfloat16;
namespace tc = dyn::tc;
constexpr int R = 512, P = 64, KEYS = 16;  // KEYS: positions a page, one MMA K step of P.ck
constexpr int STAGES = 3;                  // pages in flight
constexpr int MAX_CHUNK = 256;             // worklist entries a ragged CTA lists at a time
constexpr int MAX_CHUNKS = 256;            // pieces a unit's walk may have (the combines')
constexpr int QS = R + 8, RS = P + 8;      // bf16 row strides: 16-byte rows, ldmatrix without conflicts
constexpr int LAT_STEPS = R / 16;          // MMA K steps of q_lat.ck
constexpr int ROPE_STEPS = P / 16;         // ... and of q_rope.kr

// The most 16-row tiles a CTA holds with `wpt` warps a tile: four at two
// (256 threads), three at four (384 threads, so at most 170 registers a
// thread; the accumulator takes 64 of them).
__host__ __device__ constexpr int max_tiles(int wpt) { return wpt == 2 ? 4 : 3; }

// Shared memory of a CTA of `tiles` tiles and `warps` warps, in order:
// q_hi and q_lo [tiles * 16, QS], q_rope [tiles * 16, RS], the ring of
// STAGES pages (ck rows, then kr rows: bf16 PAGEs; over an fp8 cache raw
// RAW_PAGEs, then the one bf16 PAGE they convert into) and the warps' swap
// areas [warps][32 lanes][8 partial scores].
struct Smem {
  static constexpr size_t PAGE = (size_t)KEYS * (QS + RS) * sizeof(bf16);
  static constexpr size_t RAW_PAGE = (size_t)KEYS * (R + P);
  __host__ __device__ static constexpr size_t q_lat(int tiles) {
    return (size_t)tiles * 16 * QS * sizeof(bf16);
  }
  __host__ __device__ static constexpr size_t ring(int tiles) {
    return 2 * q_lat(tiles) + (size_t)tiles * 16 * RS * sizeof(bf16);
  }
  __host__ __device__ static constexpr size_t stage(bool fp8) { return fp8 ? RAW_PAGE : PAGE; }
  __host__ __device__ static constexpr size_t swap(int tiles, bool fp8) {
    return ring(tiles) + STAGES * stage(fp8) + (fp8 ? PAGE : 0);
  }
  __host__ __device__ static constexpr size_t bytes(int tiles, int warps, bool fp8) {
    return swap(tiles, fp8) + (size_t)warps * 32 * 8 * sizeof(float);
  }
};

// The named barrier of the WPT warps of tile `rt` (barrier 0 is __syncthreads).
template <int WPT>
__device__ inline void tile_sync(int rt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rt), "r"(WPT * 32) : "memory");
}

// The number of chunks of `chunk_pages` a sequence's table walk uses: its
// table pages (count = ctx, cap = max_blocks * KEYS, div = KEYS).  The
// walk and the combine derive it alike, on the device.
__device__ inline int used_chunks(int count, int cap, int div, int chunk_pages) {
  return tc::ceil_div(tc::ceil_div(min(max(count, 0), cap), div), chunk_pages);
}

// Page `page` of the caches into ring stage `stage` (ck rows, then kr
// rows), 16 bytes a copy, by `threads` threads (this one is `tid`): bf16
// rows at the strides QS and RS, or (FP8) the raw rows, R and P bytes.
template <bool FP8>
__device__ inline void load_page(char* stage, const void* __restrict__ ck,
                                 const void* __restrict__ kr, size_t page, int tid, int threads) {
  constexpr int EL = FP8 ? 16 : 8;  // elements a copy
  constexpr int CC = R / EL, CR = P / EL;
  constexpr int SC = FP8 ? R : QS, SR = FP8 ? P : RS;  // row strides in elements
  using E = typename std::conditional<FP8, uint8_t, bf16>::type;
  E* dc = reinterpret_cast<E*>(stage);
  E* dr = dc + KEYS * SC;
  const E* sc = static_cast<const E*>(ck) + page * KEYS * R;
  const E* sr = static_cast<const E*>(kr) + page * KEYS * P;
  for (int i = tid; i < KEYS * (CC + CR); i += threads) {
    if (i < KEYS * CC) {
      const int j = i / CC, k = i % CC;
      tc::cp_async16(dc + j * SC + k * EL, sc + j * R + k * EL, true);
    } else {
      const int j = (i - KEYS * CC) / CR, k = (i - KEYS * CC) % CR;
      tc::cp_async16(dr + j * SR + k * EL, sr + j * P + k * EL, true);
    }
  }
}

// The chunks of a raw fp8 page that this thread copied (load_page<true>'s
// mapping), converted into the bf16 page `conv` (ck rows at QS, kr rows at
// RS); a barrier must follow before any thread reads `conv`.
__device__ inline void convert_page(bf16* conv, const char* raw, bool e5m2, int tid,
                                    int threads) {
  constexpr int CC = R / 16, CR = P / 16;
  const uint8_t* rc = reinterpret_cast<const uint8_t*>(raw);
  const uint8_t* rr = rc + KEYS * R;
  for (int i = tid; i < KEYS * (CC + CR); i += threads) {
    const uint8_t* from;
    bf16* to;
    if (i < KEYS * CC) {
      const int j = i / CC, k = i % CC;
      from = rc + j * R + k * 16;
      to = conv + j * QS + k * 16;
    } else {
      const int j = (i - KEYS * CC) / CR, k = (i - KEYS * CC) % CR;
      from = rr + j * P + k * 16;
      to = conv + KEYS * QS + j * RS + k * 16;
    }
    uint4 o[2];
    dyn::fp8x16_to_bf16(*reinterpret_cast<const uint4*>(from), e5m2, o);
    reinterpret_cast<uint4*>(to)[0] = o[0];
    reinterpret_cast<uint4*>(to)[1] = o[1];
  }
}

// The queries of one tile into shared memory, by the tile's own WPT warps
// (thread wt of them): q_lat (float32, 16 consecutive rows from ql) as bf16
// high and low parts (q_lat = hi + lo to 2^-17), q_rope (from qr) as it
// is; zeros when ql is null (a tile with no rows).  Eight loads in flight
// a thread at a time.
template <int WPT>
__device__ __forceinline__ void stage_tile(bf16* sh, bf16* sl, bf16* sr,
                                           const float* __restrict__ ql,
                                           const bf16* __restrict__ qr, int wt) {
  constexpr int T = WPT * 32;
  constexpr int QV = 16 * (R / 4) / T;  // float4s a thread
  static_assert(QV % 8 == 0, "whole batches of eight loads");
#pragma unroll
  for (int k0 = 0; k0 < QV; k0 += 8) {
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = wt + (k0 + u) * T, r = i / (R / 4), k = i % (R / 4);
      x[u] = ql == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : *reinterpret_cast<const float4*>(ql + (size_t)r * R + k * 4);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = wt + (k0 + u) * T, r = i / (R / 4), k = i % (R / 4);
      uint2 hi, lo;
      tc::split_bf16(x[u].x, x[u].y, hi.x, lo.x);
      tc::split_bf16(x[u].z, x[u].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(sh + r * QS + k * 4) = hi;
      *reinterpret_cast<uint2*>(sl + r * QS + k * 4) = lo;
    }
  }
  for (int i = wt; i < 16 * (P / 8); i += T) {  // 16-byte q_rope pieces
    const int r = i / (P / 8), k = i % (P / 8);
    *reinterpret_cast<uint4*>(sr + r * RS + k * 8) =
        ql == nullptr ? make_uint4(0u, 0u, 0u, 0u)
                      : *reinterpret_cast<const uint4*>(qr + (size_t)r * P + k * 8);
  }
}

// A tile's softmax state in each of its warps: the warp's R / WPT context
// columns of rows gq and gq + 8 (C fragments, gq = lane / 4), their running
// max m (log2 domain) and thread-partial denominators l.
template <int WPT>
struct TileState {
  static constexpr int COLS = R / WPT;
  float acc[COLS / 8][4];
  float m[2], l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    m[0] = m[1] = dyn::NEG_INF;
    l[0] = l[1] = 0.f;
  }
};

// One page of a walk for one tile, run by the tile's WPT warps (this is
// warp wq of them, rt the tile's index in the CTA), only for a page the
// tile sees.  qh, ql, qr: the tile's staged queries; pc, pr: the page's ck
// and kr rows; sw: the tile's swap area [WPT][32][8].  Keys sit at
// positions kpos0 + j; the tile sees those <= limit.
template <int WPT>
__device__ __forceinline__ void page_step(TileState<WPT>& st, const bf16* qh, const bf16* ql,
                                          const bf16* qr, const bf16* pc, const bf16* pr,
                                          float* sw, int wq, int rt, int kpos0, int limit,
                                          float scale_log2) {
  constexpr int COLS = TileState<WPT>::COLS, KL = LAT_STEPS / WPT;
  static_assert(LAT_STEPS % WPT == 0 && ROPE_STEPS % WPT == 0, "K splits evenly");
  const int lane = threadIdx.x % 32, tq = lane % 4;

  // scores [16 rows, 16 keys] over this warp's share of K: q_lat columns
  // [wq * KL, (wq + 1) * KL) * 16 (hi and lo parts) and q_rope K steps wq,
  // wq + WPT, ..., in four independent accumulator chains per N tile
  // (summed in a fixed order)
  float sc[2][4][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][k][e] = 0.f;
#pragma unroll
  for (int k2 = 0; k2 < KL; ++k2) {
    const int kk = wq * KL + k2;
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
#pragma unroll
  for (int i = 0; i < ROPE_STEPS / WPT; ++i) {
    const int kk = i * WPT + wq;
    uint32_t kf[4], ar[4];
    tc::ldmatrix_x4(kf, pr + tc::b_row(lane) * RS + kk * 16 + tc::b_col(lane));
    tc::ldmatrix_x4(ar, qr + tc::a_row(lane) * RS + kk * 16 + tc::a_col(lane));
    tc::mma_bf16(sc[0][i & 1], ar, kf[0], kf[1]);
    tc::mma_bf16(sc[1][i & 1], ar, kf[2], kf[3]);
  }
  float part[8];  // [N tile][fragment element]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[j * 4 + e] = (sc[j][0][e] + sc[j][1][e]) + (sc[j][2][e] + sc[j][3][e]);
  float4* mine = reinterpret_cast<float4*>(sw + (wq * 32 + lane) * 8);
  mine[0] = make_float4(part[0], part[1], part[2], part[3]);
  mine[1] = make_float4(part[4], part[5], part[6], part[7]);
  tile_sync<WPT>(rt);
  float sfull[8];  // the warps' shares added in warp order in every warp: the same bits
#pragma unroll
  for (int w = 0; w < WPT; ++w) {
    const float4* o = reinterpret_cast<const float4*>(sw + (w * 32 + lane) * 8);
    const float4 o0 = o[0], o1 = o[1];
    const float x[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) sfull[i] = w == 0 ? x[i] : sfull[i] + x[i];
  }

  // mask (positions <= limit), online softmax per row, P as bf16 high and
  // low A fragments
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // row gq (h = 0) or gq + 8 (h = 1)
    float row_s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i / 2, e = 2 * h + i % 2;
      const int kp = kpos0 + j * 8 + 2 * tq + i % 2;
      row_s[i] = kp <= limit ? sfull[j * 4 + e] * scale_log2 : dyn::NEG_INF;
    }
    const float alpha = tc::softmax_step(row_s, st.m[h], st.l[h]);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      st.acc[j][2 * h] *= alpha;
      st.acc[j][2 * h + 1] *= alpha;
    }
    tc::split_bf16(row_s[0], row_s[1], ph[h], pl[h]);          // keys 2t, 2t+1
    tc::split_bf16(row_s[2], row_s[3], ph[2 + h], pl[2 + h]);  // keys 8+2t, 9+2t
  }

  // acc += P ck over this warp's columns (ck through ldmatrix.trans, two N
  // tiles a load), the high and low parts of P
#pragma unroll
  for (int dp = 0; dp < COLS / 16; ++dp) {
    uint32_t vf[4];
    tc::ldmatrix_x4_trans(vf, pc + tc::a_row(lane) * QS + wq * COLS + dp * 16 + tc::a_col(lane));
    tc::mma_bf16(st.acc[2 * dp], ph, vf[0], vf[1]);
    tc::mma_bf16(st.acc[2 * dp + 1], ph, vf[2], vf[3]);
    tc::mma_bf16(st.acc[2 * dp], pl, vf[0], vf[1]);
    tc::mma_bf16(st.acc[2 * dp + 1], pl, vf[2], vf[3]);
  }
}

// A tile's 16 rows after its walk.  direct: output rows out_row.. (width
// R) = acc / max(l, 1e-20), zeros for a row that saw no key.  Otherwise
// the float32 partial at rows part_row..: m and l always (m at
// part_ml[row], l at part_ml[row + l_off]), acc where the row saw a key.
template <int WPT>
__device__ __forceinline__ void finish_tile(const TileState<WPT>& st, int wq, bool direct,
                                            float* __restrict__ out, size_t out_row,
                                            float* __restrict__ part_acc,
                                            float* __restrict__ part_ml, size_t part_row,
                                            size_t l_off) {
  constexpr int COLS = TileState<WPT>::COLS;
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int cols = wq * COLS + 2 * tq;
  const float lr[2] = {tc::quad_sum(st.l[0]), tc::quad_sum(st.l[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = gq + 8 * h;
    if (direct) {
      float* o = out + (out_row + r) * R + cols;
      const float d = fmaxf(lr[h], 1e-20f);
#pragma unroll
      for (int j = 0; j < COLS / 8; ++j)
        *reinterpret_cast<float2*>(o + j * 8) =
            make_float2(st.acc[j][2 * h] / d, st.acc[j][2 * h + 1] / d);
      continue;
    }
    const size_t pr = part_row + r;
    if (wq == 0 && tq == 0) {
      part_ml[pr] = st.m[h];
      part_ml[pr + l_off] = lr[h];
    }
    if (st.m[h] == dyn::NEG_INF) continue;
    float* pa = part_acc + pr * R + cols;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
      *reinterpret_cast<float2*>(pa + j * 8) = make_float2(st.acc[j][2 * h], st.acc[j][2 * h + 1]);
  }
}

// The ragged walk: two warps a tile, four tiles a CTA, the filtered
// worklist after the swap areas.
constexpr int RAG_WPT = 2;
constexpr int RAG_TILES = max_tiles(RAG_WPT);
constexpr int RAG_THREADS = RAG_TILES * RAG_WPT * 32;
__host__ __device__ constexpr size_t rag_list(bool fp8) {
  return Smem::bytes(RAG_TILES, RAG_TILES * RAG_WPT, fp8);
}
__host__ __device__ constexpr size_t rag_bytes(bool fp8) {
  return rag_list(fp8) + (3 * MAX_CHUNK + 2 * RAG_TILES + 6) * sizeof(int);
}

// Grid (tile group, item of the capacity).  Rows are token-major (row =
// token * H + head); a CTA holds RAG_TILES 16-row tiles of its item's token
// block, each tile one token's 16 heads (H = 16) or 16 of its heads, and
// walks the item's entries [first, end) of the block's worklist in lists of
// at most MAX_CHUNK: it keeps, in order, the entries one of its tiles sees,
// then walks them.  An item past the live count (work[0].x) exits at once;
// without a plan (work null) item blockIdx.y is token block blockIdx.y over
// its whole worklist.  FP8: the caches are fp8 (e5m2 when `e5m2`), else bf16.
template <bool FP8>
__global__ void __launch_bounds__(RAG_THREADS, 1)
mla_ragged_tc_kernel(const float* __restrict__ q_lat, const bf16* __restrict__ q_rope,
                     const void* __restrict__ ck, const void* __restrict__ kr, bool e5m2,
                     const int* __restrict__ token_lane, const int* __restrict__ token_pos,
                     const int* __restrict__ page_phys, const int* __restrict__ page_lane,
                     const int* __restrict__ page_ord, const int* __restrict__ page_count,
                     const int4* __restrict__ work, float* __restrict__ out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int cap_partials, int H, int tb, int page_slots, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  bf16* q_hi = reinterpret_cast<bf16*>(smem);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + Smem::q_lat(RAG_TILES));
  bf16* q_rp = reinterpret_cast<bf16*>(smem + 2 * Smem::q_lat(RAG_TILES));
  char* ring = smem + Smem::ring(RAG_TILES);
  bf16* conv = reinterpret_cast<bf16*>(ring + STAGES * Smem::stage(FP8));  // fp8
  float* swap = reinterpret_cast<float*>(smem + Smem::swap(RAG_TILES, FP8));
  int* l_phys = reinterpret_cast<int*>(smem + rag_list(FP8));
  int* l_ord = l_phys + MAX_CHUNK;
  int* l_lane = l_ord + MAX_CHUNK;
  int* t_lane = l_lane + MAX_CHUNK;  // [RAG_TILES] the lane and position of each tile's token
  int* t_pos = t_lane + RAG_TILES;   //            (-1: a pad token or no tile)
  int* n_list_s = t_pos + RAG_TILES;
  // the item, its entries clamped to page_count: (token block, first
  // entry, end entry, partial slot or -1), and whether the queries are
  // staged.  Held here, not in registers: the walk's accumulators take
  // nearly all of them
  int* s_item = n_list_s + 1;

  if (work && (int)blockIdx.y >= work[0].x) return;  // past the live items
  const int grp = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows_tb = tb * H, tiles_tb = rows_tb / 16;

  if (tid < RAG_TILES) {
    const int4 item = work ? work[1 + blockIdx.y] : make_int4(blockIdx.y, 0, page_slots, -1);
    const int t = item.x, tile = grp * RAG_TILES + tid;
    int ln = -1, ps = -1;
    if (tile < tiles_tb) {
      const int tok = t * tb + tile * 16 / H;
      ln = token_lane[tok];
      ps = token_pos[tok];
    }
    t_lane[tid] = ln;
    t_pos[tid] = ps;
    if (tid == 0) {
      const int count = min(max(page_count[t], 0), page_slots);
      s_item[0] = t;
      s_item[1] = min(item.y, count);
      s_item[2] = min(item.z, count);
      s_item[3] = item.w;
      s_item[4] = 0;
    }
  }
  __syncthreads();

  const int rt = warp / RAG_WPT, wq = warp % RAG_WPT;  // this warp's tile and share
  const int my_lane = t_lane[rt], my_pos = t_pos[rt];
  bf16* qh = q_hi + rt * 16 * QS;
  bf16* ql = q_lo + rt * 16 * QS;
  bf16* qr = q_rp + rt * 16 * RS;
  // the tile's first row in q and out
  auto first_row = [&](int tile) {
    return ((size_t)s_item[0] * tb + tile * 16 / H) * H + (tile * 16) % H;
  };
  TileState<RAG_WPT> st;
  st.init();

  for (int base = s_item[1]; base < s_item[2]; base += MAX_CHUNK) {
    // the list's entries that some tile of this CTA sees, in worklist
    // order: a page of another lane, or above every token of its lane
    // here, costs nothing more
    if (warp == 0) {
      const int e1 = min(s_item[2], base + MAX_CHUNK);
      const size_t wl = (size_t)s_item[0] * page_slots;
      int n = 0;
      for (int b = base; b < e1; b += 32) {
        const int e = b + lane;
        int ph = 0, od = 0, ln = -1;
        bool seen = false;
        if (e < e1) {
          ph = page_phys[wl + e];
          od = page_ord[wl + e];
          ln = page_lane[wl + e];
#pragma unroll
          for (int i = 0; i < RAG_TILES; ++i)
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

    auto issue = [&](int n) {  // page n of the list into its stage
      if (n < n_list)
        load_page<FP8>(ring + (n % STAGES) * Smem::stage(FP8), ck, kr, (size_t)l_phys[n], tid,
                       RAG_THREADS);
      tc::cp_async_commit();  // one group a page, empty past the last
    };
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) issue(n);
    if (n_list > 0 && !s_item[4]) {  // the queries, once, behind the first pages seen
      const size_t q0 = first_row(grp * RAG_TILES + rt);
      stage_tile<RAG_WPT>(qh, ql, qr, my_pos < 0 ? nullptr : q_lat + q0 * R,
                          my_pos < 0 ? nullptr : q_rope + q0 * P, tid % (RAG_WPT * 32));
    }

    for (int n = 0; n < n_list; ++n) {
      tc::cp_async_wait<STAGES - 2>();  // page n landed (this thread's copies)
      __syncthreads();                  // ... everyone's; page n - 1 consumed
      issue(n + STAGES - 1);            // into the stage page n - 1 left
      if (FP8) {  // page n's raw chunks this thread copied, to the bf16 page
        convert_page(conv, ring + (n % STAGES) * Smem::RAW_PAGE, e5m2, tid, RAG_THREADS);
        __syncthreads();
      }
      const int ord = l_ord[n];
      if (my_pos < 0 || l_lane[n] != my_lane || ord * KEYS > my_pos) continue;
      const bf16* pc =
          FP8 ? conv : reinterpret_cast<const bf16*>(ring + (n % STAGES) * Smem::PAGE);
      page_step<RAG_WPT>(st, qh, ql, qr, pc, pc + KEYS * QS, swap + rt * RAG_WPT * 32 * 8, wq,
                         rt, ord * KEYS, my_pos, scale_log2);
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the ring and the list are free for the next list
    if (tid == 0 && n_list > 0) s_item[4] = 1;  // read after the next list's barrier
  }
  const int tile = grp * RAG_TILES + rt;
  if (tile >= tiles_tb) return;
  // zeros for a pad token or a token with no page here
  const int slot = s_item[3];
  const size_t q0 = first_row(tile);
  finish_tile<RAG_WPT>(st, wq, slot < 0, out, q0, part_acc, part_ml,
                       (size_t)max(slot, 0) * rows_tb + (tile * 16 / H) * H + (tile * 16) % H,
                       (size_t)cap_partials * rows_tb);
}

// Merge each split token block's partials (slots [first, first + n) of its
// combine, rows_tb rows each) in slot order into its output rows.  One CTA
// per (row, combine of the capacity), a thread four columns; the combines
// past the live count (work[0].y) exit.
__global__ void __launch_bounds__(R / 4)
mla_ragged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int4* __restrict__ work, float* __restrict__ out, int rows,
                          int cap_items, int cap_partials) {
  __shared__ float sm[MAX_CHUNKS], sl[MAX_CHUNKS], red[2];
  if ((int)blockIdx.y >= work[0].y) return;
  const int4 c = work[1 + cap_items + blockIdx.y];
  const int row = blockIdx.x, tid = threadIdx.x, n = c.z;
  const size_t row0 = (size_t)c.y * rows + row;  // the first slot's partial row
  const size_t l_off = (size_t)cap_partials * rows;
  for (int j = tid; j < n; j += blockDim.x) {
    sm[j] = part_ml[row0 + (size_t)j * rows];
    sl[j] = part_ml[row0 + (size_t)j * rows + l_off];
  }
  const float d = fmaxf(tc::merge_weights(sm, sl, n, red), 1e-20f);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float w = sm[j];
    if (w == 0.f) continue;  // no key in this item: its acc was not written
    const float4 x =
        *reinterpret_cast<const float4*>(part_acc + (row0 + (size_t)j * rows) * R + tid * 4);
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  *reinterpret_cast<float4*>(out + ((size_t)c.x * rows + row) * R + tid * 4) =
      make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

// The table walk: four warps a tile (128 context columns and a quarter of
// the score reduction each), at most three tiles a CTA.
constexpr int TAB_WPT = 4;
constexpr int TAB_TILES = max_tiles(TAB_WPT);

// Grid (chunk, tile group, sequence).  A sequence's W * H w-major rows
// make W * H / 16 tiles in gridDim.y balanced groups; this CTA holds group
// blockIdx.y (blockDim.x / (TAB_WPT * 32) tiles of room) and walks table
// slots [c * chunk_pages, (c + 1) * chunk_pages) of its sequence, up to its
// last page.  Tile i's rows are query w = 16 i / H's heads, at position
// ctx - W + w.  FP8: the caches are fp8 (e5m2 when `e5m2`), else bf16.
template <bool FP8>
__global__ void __launch_bounds__(TAB_TILES * TAB_WPT * 32, 1)
mla_table_tc_kernel(const float* __restrict__ q_lat, const bf16* __restrict__ q_rope,
                    const void* __restrict__ ck, const void* __restrict__ kr, bool e5m2,
                    const int* __restrict__ block_tables, const int* __restrict__ context_lens,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int W, int H, int max_blocks,
                    int chunk_pages, float scale_log2) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x, groups = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32;
  const int ctx = context_lens[b];
  const int n_used = used_chunks(ctx, max_blocks * KEYS, KEYS, chunk_pages);
  if (c >= max(n_used, 1)) return;  // past the context: nothing to do
  const bool direct = n_used <= 1;  // the only chunk writes the output itself
  const int n_pages = tc::ceil_div(min(max(ctx, 0), max_blocks * KEYS), KEYS);
  const int p0 = c * chunk_pages;
  const int n_list = max(0, min(chunk_pages, n_pages - p0));

  const int room = blockDim.x / (TAB_WPT * 32);
  bf16* q_hi = reinterpret_cast<bf16*>(smem);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + Smem::q_lat(room));
  bf16* q_rp = reinterpret_cast<bf16*>(smem + 2 * Smem::q_lat(room));
  char* ring = smem + Smem::ring(room);
  bf16* conv = reinterpret_cast<bf16*>(ring + STAGES * Smem::stage(FP8));  // fp8
  float* swap = reinterpret_cast<float*>(smem + Smem::swap(room, FP8));
  const int* pages = block_tables + (size_t)b * max_blocks + p0;

  auto issue = [&](int n) {  // table slot p0 + n into its stage
    if (n < n_list)
      load_page<FP8>(ring + (n % STAGES) * Smem::stage(FP8), ck, kr, (size_t)pages[n], tid,
                     blockDim.x);
    tc::cp_async_commit();  // one group a page, empty past the last
  };
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n);

  const int tiles = W * H / 16;
  const int t0 = grp * tiles / groups, nt = (grp + 1) * tiles / groups - t0;
  const int rt = warp / TAB_WPT, wq = warp % TAB_WPT;  // this warp's tile and share
  const bool live = rt < nt;
  const int row0 = (t0 + rt) * 16;             // the tile's first w-major row
  const int limit = ctx - W + row0 / H;        // its query's position
  const size_t q0 = (size_t)b * W * H + row0;  // ... and row in q and out [B, W, H, .]
  bf16* qh = q_hi + rt * 16 * QS;
  bf16* ql = q_lo + rt * 16 * QS;
  bf16* qr = q_rp + rt * 16 * RS;
  if (n_list > 0)
    stage_tile<TAB_WPT>(qh, ql, qr, live ? q_lat + q0 * R : nullptr,
                        live ? q_rope + q0 * P : nullptr, tid % (TAB_WPT * 32));
  TileState<TAB_WPT> st;
  st.init();

  for (int n = 0; n < n_list; ++n) {
    tc::cp_async_wait<STAGES - 2>();  // page n landed (this thread's copies)
    __syncthreads();                  // ... everyone's; page n - 1 consumed
    issue(n + STAGES - 1);            // into the stage page n - 1 left
    if (FP8) {  // page n's raw chunks this thread copied, to the bf16 page
      convert_page(conv, ring + (n % STAGES) * Smem::RAW_PAGE, e5m2, tid, blockDim.x);
      __syncthreads();
    }
    const int kpos0 = (p0 + n) * KEYS;
    if (!live || kpos0 > limit) continue;
    const bf16* pc =
        FP8 ? conv : reinterpret_cast<const bf16*>(ring + (n % STAGES) * Smem::PAGE);
    page_step<TAB_WPT>(st, qh, ql, qr, pc, pc + KEYS * QS, swap + rt * TAB_WPT * 32 * 8, wq, rt,
                       kpos0, limit, scale_log2);
  }
  tc::cp_async_wait<0>();
  if (!live) return;
  // zeros for an idle lane (ctx 0) or a query below position 0
  finish_tile<TAB_WPT>(st, wq, direct, out, q0, part_acc, part_ml,
                       ((size_t)b * chunks + c) * W * H + row0,
                       (size_t)gridDim.z * chunks * W * H);
}

// Merge the partials of every unit (a sequence of the table walk) whose
// walk used more than one chunk, in
// chunk order: partial row (u * chunks + c) * rows + row, output row
// u * rows + row; used_chunks(counts[u], cap, div, chunk_pages) of them.
// One CTA per (row, unit), a thread four columns.
__global__ void __launch_bounds__(R / 4)
mla_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   const int* __restrict__ counts, float* __restrict__ out, int rows,
                   int chunks, int chunk_pages, int cap, int div) {
  __shared__ float sm[MAX_CHUNKS], sl[MAX_CHUNKS], red[2];
  const int row = blockIdx.x, u = blockIdx.y, tid = threadIdx.x;
  const int n = used_chunks(counts[u], cap, div, chunk_pages);
  if (n <= 1) return;  // written by the walk itself
  const size_t row0 = (size_t)u * chunks * rows + row;  // chunk 0's partial row
  const size_t l_off = (size_t)gridDim.y * chunks * rows;
  for (int c = tid; c < n; c += blockDim.x) {
    sm[c] = part_ml[row0 + (size_t)c * rows];
    sl[c] = part_ml[row0 + (size_t)c * rows + l_off];
  }
  const float d = fmaxf(tc::merge_weights(sm, sl, n, red), 1e-20f);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int c = 0; c < n; ++c) {
    const float w = sm[c];
    if (w == 0.f) continue;  // no key in this chunk: its acc was not written
    const float4 x =
        *reinterpret_cast<const float4*>(part_acc + (row0 + (size_t)c * rows) * R + tid * 4);
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  *reinterpret_cast<float4*>(out + ((size_t)u * rows + row) * R + tid * 4) =
      make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

template <bool FP8>
int launch_ragged(const void* ql, const void* qr, const void* ck, const void* kr, bool e5m2,
                  const int* tl, const int* tp, const int* pp, const int* pl, const int* po,
                  const int* pc, float* out, const int4* work, float* part_acc, float* part_ml,
                  int T_, int H, int tb, int page_slots, int cap_items, int cap_combines,
                  int cap_partials, float scale, cudaStream_t stream) {
  const int groups = tc::ceil_div(tb * H / 16, RAG_TILES);
  auto kernel = mla_ragged_tc_kernel<FP8>;
  cudaError_t err = dyn::allow_smem(kernel, rag_bytes(FP8));
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(groups, work ? cap_items : T_ / tb), RAG_THREADS, rag_bytes(FP8), stream>>>(
      static_cast<const float*>(ql), static_cast<const bf16*>(qr), ck, kr, e5m2, tl, tp, pp, pl,
      po, pc, work, out, part_acc, part_ml, cap_partials, H, tb, page_slots,
      scale * tc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || cap_combines == 0) return (int)err;
  mla_ragged_combine_kernel<<<dim3(tb * H, cap_combines), R / 4, 0, stream>>>(
      part_acc, part_ml, work, out, tb * H, cap_items, cap_partials);
  return (int)cudaGetLastError();
}

template <bool FP8>
int launch_table(const void* ql, const void* qr, const void* ck, const void* kr, bool e5m2,
                 const int* tables, const int* lens, float* out, float* part_acc,
                 float* part_ml, int B, int W, int H, int max_blocks, int group_tiles,
                 int chunks, int chunk_pages, float scale, cudaStream_t stream) {
  const int tiles = W * H / 16;
  const int groups = tc::ceil_div(tiles, group_tiles);
  const int room = tc::ceil_div(tiles, groups);  // the largest balanced group
  const size_t bytes = Smem::bytes(room, room * TAB_WPT, FP8);
  auto kernel = mla_table_tc_kernel<FP8>;
  cudaError_t err = dyn::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(chunks, groups, B), room * TAB_WPT * 32, bytes, stream>>>(
      static_cast<const float*>(ql), static_cast<const bf16*>(qr), ck, kr, e5m2, tables, lens,
      out, part_acc, part_ml, W, H, max_blocks, chunk_pages, scale * tc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  mla_combine_kernel<<<dim3(W * H, B), R / 4, 0, stream>>>(
      part_acc, part_ml, lens, out, W * H, chunks, chunk_pages, max_blocks * KEYS, KEYS);
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
int launch_window(const void* ql, const void* qr, const void* ck, const void* kr, int code,
                  const int* tables, const int* lens, float* out, int B, int W, int H,
                  int bs, int max_blocks, float scale, cudaStream_t stream) {
  const int hg = pick_group(H, 1, (long)B * W);
  const size_t smem = MlaSmem<R, P>::bytes(hg, dyn::type_bytes(code));
  auto kernel = mla_window_kernel<T, R, P>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, W * H / hg), MTHREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const T*>(qr), ck, kr, code, tables, lens, out,
      W, H, hg, bs, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R, int P>
int launch_ragged(const void* ql, const void* qr, const void* ck, const void* kr, int code,
                  const int* tl, const int* tp, const int* pp, const int* pl,
                  const int* po, const int* pc, float* out, int T_, int H, int bs,
                  int tb, int page_slots, float scale, cudaStream_t stream) {
  const int hg = pick_group(H, tb, T_ / tb);
  const size_t smem = MlaSmem<R, P>::bytes(tb * hg, dyn::type_bytes(code));
  auto kernel = mla_ragged_kernel<T, R, P>;
  cudaError_t err = dyn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(T_ / tb, H / hg), MTHREADS, smem, stream>>>(
      static_cast<const float*>(ql), static_cast<const T*>(qr), ck, kr, code, tl, tp, pp, pl,
      po, pc, out, H, hg, bs, tb, page_slots, scale);
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

// The verify window, and decode at W = 1: W queries a sequence, q_lat
// (float32) / q_rope / out (float32) [B, W, H, .]; dtype: q_rope's, 0 =
// float32, 1 = bfloat16; cache_dtype: both caches', a CacheType code.
// bf16 queries over bf16 or fp8 caches at R 512, P 64, bs 16 and H a
// multiple of 16 take the split tensor-core table walk
// and must come with group_tiles (1 to 3: the most tiles a CTA holds) and
// the plan: `chunks` chunks of
// `chunk_pages` table slots (chunks * chunk_pages >= max_blocks, chunks
// <= 256); with chunks > 1, part_acc [B, chunks, W*H, R] and part_ml [2, B,
// chunks, W*H] are float32 scratch.  Other cases take the CUDA-core loop
// and must come with group_tiles 0.  Returns 0 or an error code.
extern "C" int dyn_mla_paged_window_decode(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* block_tables, const void* context_lens, void* out, void* part_acc,
    void* part_ml, int B, int W, int H, int R, int P, int bs, int max_blocks, int group_tiles,
    int chunks, int chunk_pages, float scale, int dtype, int cache_dtype, void* stream) {
  if (B == 0) return 0;
  if (W <= 0 || H <= 0 || (long)W * H > 65535L) return dyn::ERR_UNSUPPORTED;  // grid y
  if (cache_dtype < dyn::F32 || cache_dtype > dyn::E5M2) return dyn::ERR_UNSUPPORTED;
  const bool tc_cache = cache_dtype == dyn::BF16 || dyn::is_fp8(cache_dtype);
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(context_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool walk = dtype == dyn::BF16 && tc_cache && R == rtc::R && P == rtc::P &&
                    bs == rtc::KEYS && H % 16 == 0;
  if (walk != (group_tiles != 0)) return dyn::ERR_UNSUPPORTED;  // the route the wrapper planned
  if (walk) {
    if (group_tiles < 1 || group_tiles > rtc::TAB_TILES || B > 65535 || chunks < 1 ||
        chunk_pages < 1 || chunks > rtc::MAX_CHUNKS || (long)chunks * chunk_pages < max_blocks ||
        (chunks > 1 && (part_acc == nullptr || part_ml == nullptr)))
      return dyn::ERR_UNSUPPORTED;
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
    if (dyn::is_fp8(cache_dtype))
      return rtc::launch_table<true>(q_lat, q_rope, ck_cache, kr_cache,
                                     cache_dtype == dyn::E5M2, tables, lens, o, pa, pm, B, W, H,
                                     max_blocks, group_tiles, chunks, chunk_pages, scale, st);
    return rtc::launch_table<false>(q_lat, q_rope, ck_cache, kr_cache, false, tables, lens, o,
                                    pa, pm, B, W, H, max_blocks, group_tiles, chunks,
                                    chunk_pages, scale, st);
  }
#define DYN_WINDOW(T, R_, P_)                                                             \
  [&] { return launch_window<T, R_, P_>(q_lat, q_rope, ck_cache, kr_cache, cache_dtype,   \
                                        tables, lens, o, B, W, H, bs, max_blocks, scale, st); }
  if (dtype == 0)
    return by_geometry(R, P, DYN_WINDOW(float, 512, 64), DYN_WINDOW(float, 32, 8));
  if (dtype == 1)
    return by_geometry(R, P, DYN_WINDOW(__nv_bfloat16, 512, 64),
                                      DYN_WINDOW(__nv_bfloat16, 32, 8));
#undef DYN_WINDOW
  return dyn::ERR_UNSUPPORTED;
}

// T_ is a multiple of tb and tb <= 8; dtype and cache_dtype as in
// dyn_mla_paged_window_decode.  bf16 queries over bf16 or fp8 caches at R
// 512, P 64, bs 16 and H a multiple of 16 take the split tensor-core walk
// over `work`: the
// plan buffer (int4 rows: live items, live combines, live partials; then
// cap_items items (token block, first entry, end entry, partial slot or
// -1); then cap_combines combines (token block, first slot, slots)), or,
// with work null, one item a token block over its whole worklist.  With
// cap_partials > 0, part_acc [cap_partials, tb*H, R] and part_ml [2,
// cap_partials, tb*H] are float32 scratch.  Other cases ignore the plan
// and the scratch.  Returns 0 or an error code.
extern "C" int dyn_ragged_mla_attention(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* token_lane, const void* token_pos, const void* page_phys,
    const void* page_lane, const void* page_ord, const void* page_count, void* out,
    const void* work, void* part_acc, void* part_ml, int T_, int H, int R, int P, int bs,
    int tb, int page_slots, int cap_items, int cap_combines, int cap_partials, float scale,
    int dtype, int cache_dtype, void* stream) {
  if (T_ == 0) return 0;
  if (cache_dtype < dyn::F32 || cache_dtype > dyn::E5M2) return dyn::ERR_UNSUPPORTED;
  const bool tc_cache = cache_dtype == dyn::BF16 || dyn::is_fp8(cache_dtype);
  if (tb <= 0 || T_ % tb || tb > MAX_ROWS) return dyn::ERR_UNSUPPORTED;
  const int* tl = static_cast<const int*>(token_lane);
  const int* tp = static_cast<const int*>(token_pos);
  const int* pp = static_cast<const int*>(page_phys);
  const int* pl = static_cast<const int*>(page_lane);
  const int* po = static_cast<const int*>(page_ord);
  const int* pc = static_cast<const int*>(page_count);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dyn::BF16 && tc_cache && R == rtc::R && P == rtc::P && bs == rtc::KEYS &&
      H % 16 == 0) {
    const int4* plan = static_cast<const int4*>(work);
    if (plan == nullptr) {
      cap_items = T_ / tb;
      cap_combines = cap_partials = 0;
    }
    if (cap_items <= 0 || cap_items > 65535 || cap_combines < 0 || cap_combines > 65535 ||
        cap_partials < 0 || (cap_partials > 0 && (part_acc == nullptr || part_ml == nullptr)) ||
        (cap_combines > 0 && cap_partials == 0))
      return dyn::ERR_UNSUPPORTED;
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
    if (dyn::is_fp8(cache_dtype))
      return rtc::launch_ragged<true>(q_lat, q_rope, ck_cache, kr_cache, cache_dtype == dyn::E5M2,
                                      tl, tp, pp, pl, po, pc, o, plan, pa, pm, T_, H, tb,
                                      page_slots, cap_items, cap_combines, cap_partials, scale, st);
    return rtc::launch_ragged<false>(q_lat, q_rope, ck_cache, kr_cache, false, tl, tp, pp, pl, po,
                                     pc, o, plan, pa, pm, T_, H, tb, page_slots, cap_items,
                                     cap_combines, cap_partials, scale, st);
  }
#define DYN_RAGGED(T, R_, P_)                                                             \
  [&] { return launch_ragged<T, R_, P_>(q_lat, q_rope, ck_cache, kr_cache, cache_dtype,   \
                                        tl, tp, pp, pl, po, pc, o, T_, H, bs, tb,         \
                                        page_slots, scale, st); }
  if (dtype == 0)
    return by_geometry(R, P, DYN_RAGGED(float, 512, 64), DYN_RAGGED(float, 32, 8));
  if (dtype == 1)
    return by_geometry(R, P, DYN_RAGGED(__nv_bfloat16, 512, 64),
                                      DYN_RAGGED(__nv_bfloat16, 32, 8));
#undef DYN_RAGGED
  return dyn::ERR_UNSUPPORTED;
}
