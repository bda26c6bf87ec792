// Shared tile loop of the paged attention kernels (paged_attention.cu,
// ragged_attention.cu), and the cache dtypes every attention kernel reads.
//
// One CTA owns a set of query rows that share one kv head: the `groups`
// query heads of that kv head for one or more query tokens.  It walks a
// list of keys in tiles of KEYS keys.  For each tile it stages that kv
// head's K and V rows in shared memory (as float32, converted from the
// cache's dtype on load), scores every (row, key) pair, and folds the tile
// into an online softmax with a float32 [rows, D] accumulator,
// flash-attention style.  What differs between the kernels is only where a
// key lives and what position and lane it carries: each kernel passes a
// KeySource functor that answers that for a key index.
//
// Numerics are the reference's (dynamo_tpu/ops/pallas/*_attention.py):
// masked scores are NEG_INF, exponentials of masked scores are taken as 0,
// the denominator is clamped at 1e-20, so a row that sees no key (a pad
// token, an idle lane, a token block with no pages) comes out as zeros.
//
// Cache dtypes (the engine's kv_cache_dtype; the TPU kernels upcast their
// cache at load, e.g. dynamo_tpu/ops/pallas/paged_attention.py:96-98):
// float32, bfloat16, float16, fp8 e4m3fn and fp8 e5m2, named by the codes
// of CacheType (ops/kernels/common.py keeps the same numbers).  Every value
// of every one of them is exact in float32, and every fp8 value is exact
// in bf16 (through half), so a tensor-core walk that reads bf16 keys reads
// an fp8 cache converted to bf16 with the same products and numerics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dyn {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // 4 warps
constexpr int KEYS = 32;      // keys per tile: one per lane in the softmax step
constexpr int MAX_ROWS = 64;  // query rows one CTA can hold

// Error codes returned to the Python wrapper besides cudaError_t values.
constexpr int ERR_UNSUPPORTED = 10000;

// Element types of q, out and the caches (ops/kernels/common.py's codes).
enum CacheType : int { F32 = 0, BF16 = 1, F16 = 2, E4M3 = 3, E5M2 = 4 };
__host__ __device__ inline int type_bytes(int code) {
  return code == F32 ? 4 : code == BF16 || code == F16 ? 2 : 1;
}
__host__ __device__ inline bool is_fp8(int code) { return code == E4M3 || code == E5M2; }

// Two fp8 values (the low byte first) as floats, exactly.
__device__ inline float2 fp8x2_to_float2(uint16_t x, bool e5m2) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(x), e5m2 ? __NV_E5M2 : __NV_E4M3);
  return __half22float2(__half2(h));
}

// Sixteen fp8 values (16 bytes, the first in the low byte) as sixteen
// bf16 values (32 bytes), exactly.
__device__ inline void fp8x16_to_bf16(const uint4& raw, bool e5m2, uint4 (&out)[2]) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(&raw);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = fp8x2_to_float2(p[i], e5m2);
    __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    o[i] = *reinterpret_cast<uint32_t*>(&b);
  }
}

// Eight consecutive cache elements from element offset `off` (a multiple
// of 8) of a cache of type `code`, as floats.
__device__ inline void load8(const void* base, size_t off, int code, float* dst) {
  switch (code) {
    case F32: {
      const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
      const float4 a = p[0], b = p[1];
      dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
      dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
      return;
    }
    case BF16: {
      const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
      }
      return;
    }
    case F16: {
      const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __half*>(base) + off);
      const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __half22float2(h[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
      }
      return;
    }
    default: {  // E4M3, E5M2
      const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) + off);
      const uint16_t* p = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = fp8x2_to_float2(p[i], code == E5M2);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
      }
    }
  }
}

// Element `idx` of a cache (or a staged copy of one) of type `code`.
__device__ inline float load1(const void* base, size_t idx, int code) {
  switch (code) {
    case F32: return static_cast<const float*>(base)[idx];
    case BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx]);
    case F16: return __half2float(static_cast<const __half*>(base)[idx]);
    default: {
      const uint8_t b = static_cast<const uint8_t*>(base)[idx];
      return fp8x2_to_float2(b, code == E5M2).x;
    }
  }
}

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Shared-memory layout of one CTA, in floats then ints.
template <int D>
struct Smem {
  float* q;       // [rows, D]
  float* k;       // [KEYS, D + 1]  (padded: conflict-free column reads)
  float* v;       // [KEYS, D]
  float* p;       // [rows, KEYS]   scores, then probabilities
  float* acc;     // [rows, D]
  float* m;       // [rows] running max
  float* l;       // [rows] running denominator
  float* alpha;   // [rows] rescale of the accumulator for this tile
  int* row_pos;   // [rows] query position (-1 = pad row)
  int* row_lane;  // [rows] query lane
  int* key_pos;   // [KEYS]
  int* key_lane;  // [KEYS]
  int* key_ok;    // [KEYS] key exists (inside the walked list)

  static size_t bytes(int rows) {
    size_t floats = (size_t)rows * D * 2 + (size_t)KEYS * (D + 1) +
                    (size_t)KEYS * D + (size_t)rows * KEYS + 3 * (size_t)rows;
    size_t ints = 2 * (size_t)rows + 3 * (size_t)KEYS;
    return (floats + ints) * 4;
  }

  __device__ Smem(float* base, int rows) {
    q = base;
    k = q + rows * D;
    v = k + KEYS * (D + 1);
    p = v + KEYS * D;
    acc = p + rows * KEYS;
    m = acc + rows * D;
    l = m + rows;
    alpha = l + rows;
    row_pos = reinterpret_cast<int*>(alpha + rows);
    row_lane = row_pos + rows;
    key_pos = row_lane + rows;
    key_lane = key_pos + KEYS;
    key_ok = key_lane + KEYS;
  }
};

// Walk keys [begin, end) of `src` for the rows already staged in `s`
// (q, row_pos, row_lane), then write out[r] = acc[r] / max(l[r], 1e-20)
// through `out_row(r)`.  The caches k_cache and v_cache hold elements of
// type `code` (CacheType).  KeySource gives, for a key index:
//   __device__ size_t row(int key) const;  // element offset of its K/V row
//   __device__ int pos(int key) const;     // its absolute position
//   __device__ int lane(int key) const;    // the lane that owns it
template <int D, class KeySource, class OutRow>
__device__ void attend(Smem<D>& s, int rows, const void* k_cache, const void* v_cache,
                       int code, const KeySource& src, int begin, int end,
                       int sliding_window, float scale, OutRow out_row) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane_id = tid % 32;
  constexpr int VN = 8;  // elements a load
  constexpr int CHUNKS = D / VN;

  for (int i = tid; i < rows * D; i += THREADS) s.acc[i] = 0.f;
  for (int r = tid; r < rows; r += THREADS) {
    s.m[r] = NEG_INF;
    s.l[r] = 0.f;
  }

  for (int base = begin; base < end; base += KEYS) {
    __syncthreads();  // previous tile fully consumed; q/meta staged
    // 1) stage K/V rows and key metadata
    for (int i = tid; i < KEYS * CHUNKS; i += THREADS) {
      const int j = i / CHUNKS, c = i % CHUNKS;
      const int key = base + j;
      float kf[VN], vf[VN];
      if (key < end) {
        const size_t off = src.row(key) + (size_t)c * VN;
        load8(k_cache, off, code, kf);
        load8(v_cache, off, code, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        s.k[j * (D + 1) + c * VN + e] = kf[e];
        s.v[j * D + c * VN + e] = vf[e];
      }
    }
    for (int j = tid; j < KEYS; j += THREADS) {
      const int key = base + j;
      const bool ok = key < end;
      s.key_ok[j] = ok;
      s.key_pos[j] = ok ? src.pos(key) : 0;
      s.key_lane[j] = ok ? src.lane(key) : -1;
    }
    __syncthreads();

    // 2) masked scores
    for (int i = tid; i < rows * KEYS; i += THREADS) {
      const int r = i / KEYS, j = i % KEYS;
      const int qp = s.row_pos[r], kp = s.key_pos[j];
      bool ok = s.key_ok[j] && s.key_lane[j] == s.row_lane[r] && kp <= qp;
      if (sliding_window > 0) ok = ok && kp > qp - sliding_window;
      float acc = NEG_INF;
      if (ok) {
        const float* qr = s.q + r * D;
        const float* kr = s.k + j * (D + 1);
        acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        acc *= scale;
      }
      s.p[i] = acc;
    }
    __syncthreads();

    // 3) online softmax, one warp per row, one lane per key
    for (int r = warp; r < rows; r += THREADS / 32) {
      const float sc = s.p[r * KEYS + lane_id];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pr = sc == NEG_INF ? 0.f : expf(sc - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s.p[r * KEYS + lane_id] = pr;
      __syncwarp();
      if (lane_id == 0) {
        const float a = expf(m_prev - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
      }
    }
    __syncthreads();

    // 4) acc = acc * alpha + P V
    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = s.p + r * KEYS;
      float a = s.acc[i] * s.alpha[r];
#pragma unroll 8
      for (int j = 0; j < KEYS; ++j) a = fmaf(pr[j], s.v[j * D + d], a);
      s.acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    store(out_row(r) + d, s.acc[i] / fmaxf(s.l[r], 1e-20f));
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory once.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace dyn
