// Native record-file scanner for the data subsystem.
//
// The reference's data path is native too (ref: src/io/ — dmlc record-IO
// readers + iterators, 6.4k LoC C++).  The wire format here mirrors
// dmlc-core's recordio (ref: 3rdparty/dmlc-core/include/dmlc/recordio.h):
// each record is [u32 magic | u32 lrec | payload | pad-to-4], where the
// low 29 bits of lrec are the payload length.  Writing is cold-path
// Python; this scanner is the hot path that builds the random-access
// index over a (possibly multi-GB) record file in one pass.

#include <cstdint>
#include <cstring>

extern "C" {

static const uint32_t kGeoRecMagic = 0xced7230a;

// Scan `buf` and emit (offset, length) pairs of record payloads.
// Returns the record count, or -(1 + byte_offset) on a corrupt record
// boundary so the caller can report where the file went bad.
int64_t geo_recordio_index(const uint8_t* buf, int64_t size,
                           int64_t max_records, int64_t* offsets,
                           int64_t* lengths) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos + 8 <= size && n < max_records) {
    uint32_t magic, lrec;
    std::memcpy(&magic, buf + pos, 4);
    std::memcpy(&lrec, buf + pos + 4, 4);
    if (magic != kGeoRecMagic) return -(1 + pos);
    const int64_t len = static_cast<int64_t>(lrec & ((1u << 29) - 1));
    if (pos + 8 + len > size) return -(1 + pos);
    offsets[n] = pos + 8;
    lengths[n] = len;
    ++n;
    pos += 8 + ((len + 3) & ~int64_t(3));  // payload padded to 4 bytes
  }
  if (pos != size && n < max_records) return -(1 + pos);
  return n;
}

}  // extern "C"
