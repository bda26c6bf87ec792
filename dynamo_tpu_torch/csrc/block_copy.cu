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
// memory rate.  The design follows a plan made on the host from the shapes,
// the SM count and the pointers' alignment only (`plan_copy` in
// ops/kernels/block_copy.py), never from the id values:
// - Pieces, not rows.  Each row is cut into pieces of equal size (at most
//   the plan's piece_bytes; one piece for a small row), numbered over
//   (outer, i, piece) with the piece fastest.  The grid is about k CTAs an
//   SM whatever n and outer are; warp w of the grid copies pieces w, w + W,
//   w + 2W, ... (W warps in all).  So a 2 MiB KVBM block spreads over every
//   SM, and eight small rows share one CTA, a warp each.
// - The widest vector the rows allow: 16, 8, 4 or 2 bytes, the largest
//   that divides both base pointers and row_bytes (so every row and piece
//   start), and a byte loop only for odd sizes; eight vectors in flight a
//   lane, the ragged last round of a piece too.  (TMA bulk copies through
//   shared memory were timed against this on an H100 and were no faster on
//   a KVBM block or a Llama leaf: PERF.md.)
// - Ids reach the card without a copy of their own: up to the largest of
//   ID_CAPS they travel by value in the kernel's parameters (a
//   __grid_constant__ struct, which CUDA >= 12.1 allows up to 32,764 bytes
//   of), filled here from the caller's host array; a longer list is staged
//   by the wrapper in device memory (one non-blocking copy ordered on the
//   stream) and read from there.  So a call never waits for the stream.
// Offsets are 64-bit: an 8B model's leaf passes 2 GiB at 4096 blocks.  The
// wrapper checks ids on the host (in range; no duplicate scatter target,
// whose last writer neither the Pallas grid order nor XLA's scatter would
// fix the same way) and this entry checks the plan, so the kernels trust
// both.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;  // eight warps, a piece each at a time
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // vectors in flight a lane
constexpr int ERR_UNSUPPORTED = 10000;  // as dyn::ERR_UNSUPPORTED
// By-value capacities, as ops/kernels/block_copy.py ID_CAPS: 64 bytes of
// header and 8160 ids fill 32,704 of the 32,764 bytes a launch may pass.
// The smaller ones keep a short list's launch cheap: on an H100 the full
// struct costs about 5 us more host time a launch (PERF.md).
constexpr int ID_CAPS[] = {64, 1024, 8160};

template <int CAP> struct ValueIds {
  int32_t v[CAP];
  __device__ __forceinline__ int32_t operator[](int64_t i) const { return v[i]; }
};

struct DeviceIds {
  const int32_t* p;
  __device__ __forceinline__ int32_t operator[](int64_t i) const { return __ldg(p + i); }
};

struct Header {
  const uint8_t* src;  // gather: the pool; scatter: the batch
  uint8_t* dst;        // gather: the batch; scatter: the pool
  int64_t n_pool, n, row_bytes, piece_bytes, pieces_per_row, pieces;
};

template <class Ids> struct Copy {
  Header h;
  Ids ids;
};

struct Piece {
  const uint8_t* src;
  uint8_t* dst;
  int64_t bytes;
};

// Piece t of the (outer, i, piece) numbering: where it is read and written,
// and its length (a row's last piece may be shorter).
template <bool GATHER, class Ids>
__device__ __forceinline__ Piece locate(const Copy<Ids>& c, int64_t t) {
  const Header& h = c.h;
  const int64_t row = t / h.pieces_per_row;  // o * n + i: the batch row
  const int64_t off = (t - row * h.pieces_per_row) * h.piece_bytes;
  const int64_t o = row / h.n;
  const int64_t block = o * h.n_pool + c.ids[row - o * h.n];  // the pool row
  const int64_t src_row = GATHER ? block : row;
  const int64_t dst_row = GATHER ? row : block;
  const int64_t left = h.row_bytes - off;
  return {h.src + src_row * h.row_bytes + off, h.dst + dst_row * h.row_bytes + off,
          left < h.piece_bytes ? left : h.piece_bytes};
}

template <typename V, bool GATHER, class Ids>
__global__ void __launch_bounds__(THREADS) copy_kernel(const __grid_constant__ Copy<Ids> c) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       t < c.h.pieces; t += stride) {
    const Piece pc = locate<GATHER>(c, t);
    const V* s = reinterpret_cast<const V*>(pc.src);
    V* d = reinterpret_cast<V*>(pc.dst);
    const int64_t vecs = pc.bytes / static_cast<int64_t>(sizeof(V));
    // every load of a round in flight before its stores, the ragged last
    // round too (predicated)
    for (int64_t i = lane; i < vecs; i += UNROLL * 32) {
      V v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * 32 < vecs) v[u] = s[i + u * 32];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (i + u * 32 < vecs) d[i + u * 32] = v[u];
      }
    }
  }
}

template <bool GATHER, class Ids>
int launch(const Copy<Ids>& c, int vec, long long grid, cudaStream_t stream) {
  const unsigned g = static_cast<unsigned>(grid);
  switch (vec) {
    case 16: copy_kernel<uint4, GATHER, Ids><<<g, THREADS, 0, stream>>>(c); break;
    case 8: copy_kernel<uint2, GATHER, Ids><<<g, THREADS, 0, stream>>>(c); break;
    case 4: copy_kernel<uint32_t, GATHER, Ids><<<g, THREADS, 0, stream>>>(c); break;
    case 2: copy_kernel<uint16_t, GATHER, Ids><<<g, THREADS, 0, stream>>>(c); break;
    case 1: copy_kernel<uint8_t, GATHER, Ids><<<g, THREADS, 0, stream>>>(c); break;
    default: return ERR_UNSUPPORTED;
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool GATHER, int CAP>
int launch_by_value(const Header& h, const void* host_ids, int vec, long long grid,
                    cudaStream_t stream) {
  Copy<ValueIds<CAP>> c;
  c.h = h;
  memcpy(c.ids.v, host_ids, static_cast<size_t>(h.n) * sizeof(int32_t));
  return launch<GATHER>(c, vec, grid, stream);
}

bool aligned(const void* p, long long a) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(a) == 0;
}

// The plan's checks, then one launch.  ids_cap 0: the ids are in device
// memory at dev_ids; else by value, n of them at host_ids.
template <bool GATHER>
int copy_blocks(const void* src, void* dst, const void* host_ids, const void* dev_ids,
                long long outer, long long n_pool, long long n, long long row_bytes,
                long long piece_bytes, long long grid, int vec, int ids_cap, void* stream) {
  const bool vec_ok = vec == 1 || vec == 2 || vec == 4 || vec == 8 || vec == 16;
  if (outer < 1 || n_pool < 1 || n < 1 || n > INT32_MAX || row_bytes < 1 || !vec_ok ||
      row_bytes % vec || piece_bytes < 1 || piece_bytes > row_bytes || piece_bytes % vec ||
      grid < 1 || grid > INT32_MAX || !aligned(src, vec) || !aligned(dst, vec)) {
    return ERR_UNSUPPORTED;
  }
  Header h{static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n_pool, n, row_bytes,
           piece_bytes, (row_bytes + piece_bytes - 1) / piece_bytes, 0};
  h.pieces = outer * n * h.pieces_per_row;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_cap == 0) {
    if (dev_ids == nullptr) return ERR_UNSUPPORTED;
    Copy<DeviceIds> c{h, {static_cast<const int32_t*>(dev_ids)}};
    return launch<GATHER>(c, vec, grid, s);
  }
  if (host_ids == nullptr || n > ids_cap) return ERR_UNSUPPORTED;
  switch (ids_cap) {
    case ID_CAPS[0]: return launch_by_value<GATHER, ID_CAPS[0]>(h, host_ids, vec, grid, s);
    case ID_CAPS[1]: return launch_by_value<GATHER, ID_CAPS[1]>(h, host_ids, vec, grid, s);
    case ID_CAPS[2]: return launch_by_value<GATHER, ID_CAPS[2]>(h, host_ids, vec, grid, s);
    default: return ERR_UNSUPPORTED;
  }
}

static_assert(sizeof(Copy<ValueIds<ID_CAPS[2]>>) <= 32764, "kernel parameters over 32,764 bytes");

}  // namespace

extern "C" int dyn_gather_blocks(const void* pool, void* out, const void* host_ids,
                                 const void* dev_ids, long long outer, long long n_pool,
                                 long long n, long long row_bytes, long long piece_bytes,
                                 long long grid, int vec, int ids_cap, void* stream) {
  return copy_blocks<true>(pool, out, host_ids, dev_ids, outer, n_pool, n, row_bytes,
                           piece_bytes, grid, vec, ids_cap, stream);
}

extern "C" int dyn_scatter_blocks(void* pool, const void* blocks, const void* host_ids,
                                  const void* dev_ids, long long outer, long long n_pool,
                                  long long n, long long row_bytes, long long piece_bytes,
                                  long long grid, int vec, int ids_cap, void* stream) {
  return copy_blocks<false>(blocks, pool, host_ids, dev_ids, outer, n_pool, n, row_bytes,
                            piece_bytes, grid, vec, ids_cap, stream);
}
