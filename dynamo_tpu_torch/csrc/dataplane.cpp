// Native data-plane codec: incremental two-part frame decoder.
//
// The response data plane streams one two-part frame per token
// (dynamo_tpu/runtime/codec.py; reference:
// lib/runtime/src/pipeline/network/codec/two_part.rs and the response pump
// in tcp/server.rs:407).  The Python asyncio reader costs three awaits and
// several bytes-object copies per frame; this decoder turns raw socket
// chunks into frame boundaries with zero per-byte Python work: feed()
// appends a chunk, next() yields (header, payload) views into the internal
// buffer.
//
// C ABI (ctypes-friendly, no pybind11):
//   dp_decoder_new/free
//   dp_feed(handle, data, len)            -> 0 ok, -1 overflow guard hit
//   dp_next(handle, &hdr,&hlen,&pay,&plen)-> 1 frame, 0 need more data,
//                                            -1 corrupt stream
//   dp_pending(handle)                    -> buffered-but-unparsed bytes
//
// Returned pointers are valid until the next dp_feed call (which may
// compact/reallocate); the Python binding copies immediately.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kMaxHeader = 1ull << 20;   // 1 MiB  (codec.py MAX_HEADER)
constexpr uint64_t kMaxPayload = 1ull << 31;  // 2 GiB  (codec.py MAX_PAYLOAD)
constexpr size_t kCompactThreshold = 1 << 16;

struct Decoder {
  std::vector<uint8_t> buf;
  size_t off = 0;  // consumed prefix
  bool corrupt = false;
};

uint32_t read_u32_be(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

void* dp_decoder_new() { return new Decoder(); }

void dp_decoder_free(void* h) { delete static_cast<Decoder*>(h); }

int dp_feed(void* h, const uint8_t* data, int64_t len) {
  auto* d = static_cast<Decoder*>(h);
  if (d->corrupt || len < 0) return -1;
  // compact consumed prefix before growing
  if (d->off > kCompactThreshold) {
    d->buf.erase(d->buf.begin(), d->buf.begin() + d->off);
    d->off = 0;
  }
  d->buf.insert(d->buf.end(), data, data + len);
  return 0;
}

int dp_next(void* h, const uint8_t** hdr, int64_t* hdr_len, const uint8_t** pay,
            int64_t* pay_len) {
  auto* d = static_cast<Decoder*>(h);
  if (d->corrupt) return -1;
  size_t avail = d->buf.size() - d->off;
  if (avail < 8) return 0;
  const uint8_t* base = d->buf.data() + d->off;
  uint64_t hlen = read_u32_be(base);
  uint64_t plen = read_u32_be(base + 4);
  if (hlen > kMaxHeader || plen > kMaxPayload) {
    d->corrupt = true;
    return -1;
  }
  if (avail < 8 + hlen + plen) return 0;
  *hdr = base + 8;
  *hdr_len = static_cast<int64_t>(hlen);
  *pay = base + 8 + hlen;
  *pay_len = static_cast<int64_t>(plen);
  d->off += 8 + hlen + plen;
  return 1;
}

int64_t dp_pending(void* h) {
  auto* d = static_cast<Decoder*>(h);
  return static_cast<int64_t>(d->buf.size() - d->off);
}

// Batch drain: parse up to max_frames complete frames in ONE call.  Writes
// 4 int64 per frame into `spans` (header off/len, payload off/len, relative
// to *region) and points *region at the parsed byte range.  Returns the
// frame count, or -1 on a corrupt stream.  One ctypes roundtrip + one
// region copy per chunk instead of two calls per frame.
int32_t dp_drain(void* h, int64_t* spans, int32_t max_frames,
                 const uint8_t** region, int64_t* region_len) {
  auto* d = static_cast<Decoder*>(h);
  if (d->corrupt) return -1;
  const uint8_t* base = d->buf.data() + d->off;
  size_t avail = d->buf.size() - d->off;
  size_t pos = 0;
  int32_t n = 0;
  while (n < max_frames && avail - pos >= 8) {
    const uint8_t* p = base + pos;
    uint64_t hlen = read_u32_be(p);
    uint64_t plen = read_u32_be(p + 4);
    if (hlen > kMaxHeader || plen > kMaxPayload) {
      d->corrupt = true;
      return -1;
    }
    if (avail - pos < 8 + hlen + plen) break;
    spans[n * 4 + 0] = static_cast<int64_t>(pos + 8);
    spans[n * 4 + 1] = static_cast<int64_t>(hlen);
    spans[n * 4 + 2] = static_cast<int64_t>(pos + 8 + hlen);
    spans[n * 4 + 3] = static_cast<int64_t>(plen);
    pos += 8 + hlen + plen;
    n++;
  }
  *region = base;
  *region_len = static_cast<int64_t>(pos);
  d->off += pos;
  return n;
}

}  // extern "C"

// Sender-side note: per-frame coalescing is already provided by the asyncio
// transport write buffer (writer.write per token, drain only above the
// high-water mark), so no native batch encoder is needed on that side.
