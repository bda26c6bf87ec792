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
//   is read once per step: 1.15 KB a position at R 512, P 64 in bf16),
//   operations on long prefill spans (2 (R + P) + 2 R flops per visible
//   (row, position)).  This simple kernel runs its products on the fp32
//   CUDA cores, so it is far from either bound; wgmma and TMA are later
//   work.
//
// Design: every head reads the same single latent "kv head", so the head
//   axis is the only sharing there is.  One CTA owns `hg` heads of one
//   sequence (decode) or of one token block (ragged): hg grows only while
//   the grid would overflow two CTAs per SM, so small batches still spread
//   over the card, and a CTA never holds more than MAX_ROWS query rows.
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

// T_ is a multiple of tb and tb <= 8.  Returns 0 or an error code.
extern "C" int dyn_ragged_mla_attention(
    const void* q_lat, const void* q_rope, const void* ck_cache, const void* kr_cache,
    const void* token_lane, const void* token_pos, const void* page_phys,
    const void* page_lane, const void* page_ord, const void* page_count, void* out,
    int T_, int H, int R, int P, int bs, int tb, int page_slots, float scale,
    int dtype, void* stream) {
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
