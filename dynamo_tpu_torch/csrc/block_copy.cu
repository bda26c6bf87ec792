// KV block gather and scatter by id list, for Hopper (sm_90a).
//
// Replaces the Pallas kernels dynamo_tpu/ops/pallas/block_copy.py
// `gather_blocks` (:25, kernel `_gather_kernel` :20) and `scatter_blocks`
// (:56, kernel `_scatter_kernel` :49), which move whole blocks between a
// cache pool and a batch through scalar-prefetched id arrays, one grid step
// a block.
//
// Both entry points copy bytes over a pool viewed as [outer, N, row_bytes]
// and a batch viewed as [outer, n, row_bytes]:
//   gather:  out[o, i, :]       = pool[o, ids[i], :]
//   scatter: pool[o, ids[i], :] = blocks[o, i, :]   (in place)
// With outer = 1 this is the Pallas kernels' [N, *block] pool (the KVBM's
// G1 pool); with outer = L it serves the engine's [L, N, ...] cache leaves
// without a transpose.  Any dtype: the wrapper casts `blocks` to the pool's
// dtype first, so the kernel sees bytes only.
//
// Bound: bytes.  Each copied byte is read once and written once, nothing is
// computed, so the least time is 2 * outer * n * row_bytes over the card's
// memory rate.  Design, simple first: one CTA per (block, outer) row (grid
// n x outer), 16-byte vector loads and stores, four in flight a thread,
// when both row pointers are 16-byte aligned, a byte loop otherwise and for
// the tail.  Offsets are 64-bit: an 8B model's leaf passes 2 GiB at 2048
// blocks.  The wrapper checks ids on the host (in range; no duplicate
// scatter target, whose last writer neither the Pallas grid order nor
// XLA's scatter would fix the same way), so the kernel trusts them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int ERR_UNSUPPORTED = 10000;  // as dyn::ERR_UNSUPPORTED
constexpr long long MAX_OUTER = 65535;  // gridDim.y

__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         int64_t row_bytes) {
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int64_t vecs = row_bytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    int64_t i = threadIdx.x;
    for (; i + (UNROLL - 1) * THREADS < vecs; i += UNROLL * THREADS) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = s[i + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) d[i + u * THREADS] = v[u];
    }
    for (; i < vecs; i += THREADS) d[i] = s[i];
    done = vecs << 4;
  }
  for (int64_t i = done + threadIdx.x; i < row_bytes; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint8_t* __restrict__ pool, const int32_t* __restrict__ ids,
              uint8_t* __restrict__ out, int64_t n_pool, int64_t n, int64_t row_bytes) {
  const int64_t i = blockIdx.x;
  const int64_t o = blockIdx.y;
  const int64_t src = o * n_pool + ids[i];
  const int64_t dst = o * n + i;
  copy_row(pool + src * row_bytes, out + dst * row_bytes, row_bytes);
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(uint8_t* __restrict__ pool, const int32_t* __restrict__ ids,
               const uint8_t* __restrict__ blocks, int64_t n_pool, int64_t n,
               int64_t row_bytes) {
  const int64_t i = blockIdx.x;
  const int64_t o = blockIdx.y;
  const int64_t src = o * n + i;
  const int64_t dst = o * n_pool + ids[i];
  copy_row(blocks + src * row_bytes, pool + dst * row_bytes, row_bytes);
}

bool shape_ok(long long outer, long long n_pool, long long n, long long row_bytes) {
  return outer >= 0 && outer <= MAX_OUTER && n_pool >= 0 && n >= 0 && n <= INT32_MAX &&
         row_bytes >= 0;
}

}  // namespace

extern "C" int dyn_gather_blocks(const void* pool, const void* ids, void* out,
                                 long long outer, long long n_pool, long long n,
                                 long long row_bytes, void* stream) {
  if (!shape_ok(outer, n_pool, n, row_bytes)) return ERR_UNSUPPORTED;
  if (outer == 0 || n == 0 || row_bytes == 0) return 0;
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(outer));
  gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(ids),
      static_cast<uint8_t*>(out), n_pool, n, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dyn_scatter_blocks(void* pool, const void* ids, const void* blocks,
                                  long long outer, long long n_pool, long long n,
                                  long long row_bytes, void* stream) {
  if (!shape_ok(outer, n_pool, n, row_bytes)) return ERR_UNSUPPORTED;
  if (outer == 0 || n == 0 || row_bytes == 0) return 0;
  dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(outer));
  scatter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(pool), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(blocks), n_pool, n, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
