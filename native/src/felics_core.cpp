// felics_core — native runtime core for felics_tpu.
//
// A from-scratch C++ implementation of the FELICS codec semantics pinned by
// felics_tpu/core/oracle.py (behavioral reference: visanalexandru/felics,
// src/compression.rs:76-248 and src/coding/*). This is the fast sequential
// path of the framework: single-stream FLCS decode is irreducibly serial at
// pixel granularity (each pixel's context needs previously decoded pixels and
// the adaptive k tables need every prior out-of-range residual), so the
// production decode path is native; the accelerator owns the parallel encode
// and the tiled (FLCT) mode.
//
// Design notes (deliberately not a port of the Rust structure):
//   * one 64-bit accumulator bit writer / branch-light bit reader;
//   * the k-estimator stores one flat row per context, allocated lazily so
//     the 16-bit depth's 131071-context table costs nothing until touched;
//   * all decode paths return error codes — no aborts on malformed input.
//
// C ABI (see felics_tpu/native/runtime.py):
//   fel_compress / fel_decompress / fel_free, plus fel_version.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Error codes (mirror felics_tpu.errors)
// ---------------------------------------------------------------------------
enum FelStatus : int {
  FEL_OK = 0,
  FEL_EIO = -1,
  FEL_EINVALID_VALUE = -2,
  FEL_EOVERFLOW = -3,
  FEL_EDIMENSIONS = -4,
  FEL_ECOLOR_TYPE = -5,
  FEL_EPIXEL_DEPTH = -6,
  FEL_ESIGNATURE = -7,
  FEL_ENOMEM = -8,
};

constexpr int kColorGray = 0;
constexpr int kColorRgb = 1;
constexpr int kDepth8 = 0;
constexpr int kDepth16 = 1;
constexpr size_t kHeaderSize = 14;

// ---------------------------------------------------------------------------
// Last-error detail (analog of the reference's DecompressionError variants,
// src/compression/error.rs:4-19): every error-return site records WHAT
// failed, and fel_last_error() surfaces it through the C ABI so the Python
// exception says e.g. "FLCT tile table truncated" instead of a bare code.
// Thread-local so concurrent callers cannot clobber each other; tile worker
// threads report through per-tile status codes, translated at the join.
// ---------------------------------------------------------------------------
thread_local char g_err[192] = "";

inline int fel_fail(int code, const char* msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
  return code;
}

inline const char* code_detail(int code) {
  switch (code) {
    case FEL_EIO:
      return "tile stream ended prematurely";
    case FEL_EINVALID_VALUE:
      return "decoded value out of range";
    case FEL_EOVERFLOW:
      return "arithmetic overflow on a decoded value";
    default:
      return "decode failed";
  }
}

struct CodingParams {
  uint32_t max_context;
  const uint8_t* k_values;
  int num_k;
  uint32_t halve_at;  // 0 = disabled
};

constexpr uint8_t kK8[] = {0, 1, 2, 3, 4, 5};
constexpr uint8_t kK16[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14};

CodingParams params_for_depth(int depth) {
  if (depth == kDepth8) return {510u, kK8, 6, 1024u};
  return {131070u, kK16, 15, 1024u};
}

// ---------------------------------------------------------------------------
// Bit I/O — MSB-first, matching bitstream-io BigEndian semantics.
// ---------------------------------------------------------------------------
class BitSink {
 public:
  explicit BitSink(std::vector<uint8_t>* out) : out_(out) {}

  inline void put(uint32_t nbits, uint64_t value) {
    // nbits <= 32; value's low nbits are emitted MSB-first.
    acc_ = (acc_ << nbits) | (value & ((nbits == 64 ? 0 : (1ull << nbits)) - 1));
    fill_ += nbits;
    while (fill_ >= 8) {
      fill_ -= 8;
      out_->push_back(static_cast<uint8_t>(acc_ >> fill_));
    }
    acc_ &= (1ull << fill_) - 1;
  }

  inline void put_bit(uint32_t bit) { put(1, bit); }

  inline void put_unary0(uint32_t q) {
    while (q >= 32) {
      put(32, 0xFFFFFFFFull);
      q -= 32;
    }
    // q ones then a terminating zero.
    put(q + 1, ((1ull << q) - 1) << 1);
  }

  inline void put_i32(int32_t v) { put(32, static_cast<uint32_t>(v)); }

  void byte_align() {
    if (fill_) put(8 - fill_, 0);
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t acc_ = 0;
  uint32_t fill_ = 0;
};

class BitSource {
 public:
  BitSource(const uint8_t* data, size_t len) : data_(data), bitlen_(len * 8) {}

  inline bool get_bit(uint32_t* bit) {
    if (pos_ >= bitlen_) return false;
    *bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1u;
    ++pos_;
    return true;
  }

  bool get(uint32_t nbits, uint32_t* value) {
    if (pos_ + nbits > bitlen_) return false;
    uint64_t result = 0;
    uint32_t remaining = nbits;
    while (remaining) {
      size_t byte_idx = pos_ >> 3;
      uint32_t bit_off = pos_ & 7;
      uint32_t take = 8 - bit_off;
      if (take > remaining) take = remaining;
      uint32_t chunk = (data_[byte_idx] >> (8 - bit_off - take)) &
                       ((1u << take) - 1u);
      result = (result << take) | chunk;
      pos_ += take;
      remaining -= take;
    }
    *value = static_cast<uint32_t>(result);
    return true;
  }

  bool get_unary0(uint32_t* count) {
    uint32_t c = 0, bit;
    for (;;) {
      if (!get_bit(&bit)) return false;
      if (!bit) {
        *count = c;
        return true;
      }
      if (++c == 0) return false;  // > 2^32 ones: malformed
    }
  }

  bool get_i32(int32_t* v) {
    uint32_t raw;
    if (!get(32, &raw)) return false;
    *v = static_cast<int32_t>(raw);
    return true;
  }

 private:
  const uint8_t* data_;
  size_t bitlen_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------------
// Entropy codes
// ---------------------------------------------------------------------------
inline void rice_encode(BitSink& sink, uint32_t k, uint32_t value) {
  sink.put_unary0(value >> k);
  sink.put(k, value & ((k ? (1u << k) : 1u) - 1u));
}

inline bool rice_decode(BitSource& src, uint32_t k, uint32_t* value) {
  uint32_t q, r;
  if (!src.get_unary0(&q)) return false;
  if (!src.get(k, &r)) return false;
  uint64_t result = (static_cast<uint64_t>(q) << k) + r;
  if (result > 0xFFFFFFFFull) return false;
  *value = static_cast<uint32_t>(result);
  return true;
}

inline uint32_t rice_length(uint32_t value, uint32_t k) {
  return (value >> k) + 1 + k;
}

struct PhaseIn {
  uint32_t n, m, left_p, right_p;
  explicit PhaseIn(uint32_t n_) : n(n_) {
    m = 31 - static_cast<uint32_t>(__builtin_clz(n));
    left_p = n - (1u << m);
    right_p = (1u << (m + 1)) - n;
  }
  inline void encode(BitSink& sink, uint32_t value) const {
    uint32_t r = (value + n - left_p) % n;
    if (r < right_p) {
      sink.put(m, r);
    } else {
      uint32_t off = r - right_p;
      sink.put(m, (off >> 1) + right_p);
      sink.put_bit(off & 1);
    }
  }
  inline bool decode(BitSource& src, uint32_t* out) const {
    uint32_t first;
    if (!src.get(m, &first)) return false;
    uint32_t number;
    if (first < right_p) {
      number = first;
    } else {
      uint32_t bit;
      if (!src.get_bit(&bit)) return false;
      number = (first - right_p) * 2 + right_p + bit;
    }
    *out = (number + left_p) % n;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Adaptive k selection — lazily allocated per-context rows.
// ---------------------------------------------------------------------------
class KEstimator {
 public:
  // prior: optional (contexts x num_k) k-table seed (FLCT v2 per-image
  // k-prior; contexts are buckets there). nullptr = all-zero init.
  KEstimator(const CodingParams& p, const uint32_t* prior = nullptr)
      : p_(p), prior_(prior), rows_(p.max_context + 1, nullptr) {
    storage_.reserve(256);
  }

  inline uint32_t get_k(uint32_t context) {
    const uint32_t* row = rows_[context];
    if (!row) {
      if (!prior_) return p_.k_values[p_.num_k - 1];  // all-zero: largest k
      row = prior_ + static_cast<size_t>(context) * p_.num_k;
    }
    uint32_t smallest = 0xFFFFFFFFu;
    int best = 0;
    for (int i = 0; i < p_.num_k; ++i) {
      if (row[i] <= smallest) {  // '<=': ties pick the largest k
        best = i;
        smallest = row[i];
      }
    }
    return p_.k_values[best];
  }

  inline void update(uint32_t context, uint32_t encoded) {
    uint32_t* row = rows_[context];
    if (!row) {
      storage_.emplace_back(p_.num_k, 0u);
      row = rows_[context] = storage_.back().data();
      if (prior_)
        memcpy(row, prior_ + static_cast<size_t>(context) * p_.num_k,
               sizeof(uint32_t) * p_.num_k);
    }
    uint32_t min_v = 0xFFFFFFFFu;
    for (int i = 0; i < p_.num_k; ++i) {
      row[i] += rice_length(encoded, p_.k_values[i]);
      if (row[i] < min_v) min_v = row[i];
    }
    if (p_.halve_at && min_v > p_.halve_at) {
      for (int i = 0; i < p_.num_k; ++i) row[i] >>= 1;
    }
  }

 private:
  CodingParams p_;
  const uint32_t* prior_;
  std::vector<uint32_t*> rows_;
  std::vector<std::vector<uint32_t>> storage_;
};

// ---------------------------------------------------------------------------
// Context model — causal two-neighbour indices in raster order.
// ---------------------------------------------------------------------------
inline void neighbours(size_t i, size_t w, size_t* a, size_t* b) {
  // Caller guarantees i >= 2 (and for the y==1,x==0 case that w > 1).
  size_t x = i % w, y = i / w;
  if (x > 0 && y > 0) {
    *a = i - 1;
    *b = i - w;
  } else if (y == 0) {
    *a = i - 1;
    *b = i - 2;
  } else if (y >= 2) {
    *a = i - w;
    *b = i - 2 * w;
  } else {
    *a = i - w;
    *b = i - w + 1;
  }
}

// ---------------------------------------------------------------------------
// Channel codec
// ---------------------------------------------------------------------------
// FLCT's k-estimator bucketing: min(bit_length(context), kQctxCap) (see
// felics_tpu/ops/kscan_tiled.py and config.QCTX_CAP — a format-level
// constant; merging the rare high-ctx buckets measured free on ratio).
// FLCS uses the exact context.
constexpr uint32_t kQctxCap = 5;
inline uint32_t k_context(uint32_t context, bool bucketed) {
  if (!bucketed) return context;
  const uint32_t bl = context == 0 ? 0 : 32 - __builtin_clz(context);
  return bl < kQctxCap ? bl : kQctxCap;
}
inline int num_buckets(uint32_t max_context) {
  const int bl = 32 - __builtin_clz(max_context);
  return (bl < static_cast<int>(kQctxCap) ? bl
                                          : static_cast<int>(kQctxCap)) + 1;
}

void compress_channel(const int32_t* chan, uint32_t width, uint32_t height,
                      const CodingParams& params, BitSink& sink,
                      bool bucketed_k = false, uint32_t pre_bits = 32,
                      const uint32_t* prior = nullptr) {
  // pre_bits: raw first-two-pixels preamble width. FLCS uses 32 (reference
  // interop, src/compression.rs:104-107); FLCT uses depth(+1 for the signed
  // Co/Cg planes) — two's-complement truncation, see tiling.py format spec.
  const size_t total = static_cast<size_t>(width) * height;
  if (width == 0 || height == 0) {
    sink.put(pre_bits, 0);
    sink.put(pre_bits, 0);
    return;
  }
  if (width == 1 && height == 1) {
    sink.put(pre_bits, static_cast<uint32_t>(chan[0]));
    sink.put(pre_bits, 0);
    return;
  }
  sink.put(pre_bits, static_cast<uint32_t>(chan[0]));
  sink.put(pre_bits, static_cast<uint32_t>(chan[1]));

  KEstimator estimator(params, prior);
  for (size_t i = 2; i < total; ++i) {
    size_t a, b;
    neighbours(i, width, &a, &b);
    const int32_t p = chan[i];
    const int32_t v1 = chan[a], v2 = chan[b];
    const int32_t h = v1 > v2 ? v1 : v2;
    const int32_t l = v1 < v2 ? v1 : v2;
    const uint32_t context = static_cast<uint32_t>(h - l);

    if (p >= l && p <= h) {
      sink.put_bit(1);
      PhaseIn(context + 1).encode(sink, static_cast<uint32_t>(p - l));
    } else {
      const uint32_t kctx = k_context(context, bucketed_k);
      const uint32_t k = estimator.get_k(kctx);
      uint32_t to_encode;
      if (p < l) {
        sink.put(2, 0b00);
        to_encode = static_cast<uint32_t>(l - p - 1);
      } else {
        sink.put(2, 0b01);
        to_encode = static_cast<uint32_t>(p - h - 1);
      }
      rice_encode(sink, k, to_encode);
      estimator.update(kctx, to_encode);
    }
  }
}

int decompress_channel(uint32_t width, uint32_t height,
                       const CodingParams& params, BitSource& src,
                       int32_t* out, bool bucketed_k = false,
                       uint32_t pre_bits = 32, bool pre_signed = false,
                       const uint32_t* prior = nullptr) {
  int32_t pixel1, pixel2;
  uint32_t raw1, raw2;
  if (!src.get(pre_bits, &raw1) || !src.get(pre_bits, &raw2))
    return fel_fail(FEL_EIO, "channel preamble (first two pixels) truncated");
  if (pre_bits == 32) {
    pixel1 = static_cast<int32_t>(raw1);
    pixel2 = static_cast<int32_t>(raw2);
  } else if (pre_signed) {
    const uint32_t sh = 32 - pre_bits;
    pixel1 = static_cast<int32_t>(raw1 << sh) >> sh;
    pixel2 = static_cast<int32_t>(raw2 << sh) >> sh;
  } else {
    pixel1 = static_cast<int32_t>(raw1);
    pixel2 = static_cast<int32_t>(raw2);
  }
  if (width == 0 || height == 0) return FEL_OK;
  if (width == 1 && height == 1) {
    out[0] = pixel1;
    return FEL_OK;
  }
  const size_t total = static_cast<size_t>(width) * height;
  out[0] = pixel1;
  out[1] = pixel2;

  KEstimator estimator(params, prior);
  for (size_t i = 2; i < total; ++i) {
    size_t a, b;
    neighbours(i, width, &a, &b);
    const int32_t v1 = out[a], v2 = out[b];
    const int32_t h = v1 > v2 ? v1 : v2;
    const int32_t l = v1 < v2 ? v1 : v2;
    const int64_t context64 = static_cast<int64_t>(h) - l;
    if (context64 < 0 || context64 > params.max_context)
      return fel_fail(FEL_EINVALID_VALUE,
                      "neighbour context out of range (corrupt stream)");
    const uint32_t context = static_cast<uint32_t>(context64);

    uint32_t first;
    if (!src.get_bit(&first))
      return fel_fail(FEL_EIO, "stream ended at a range-marker bit");
    int64_t value;
    if (first) {
      uint32_t p;
      if (!PhaseIn(context + 1).decode(src, &p))
        return fel_fail(FEL_EIO, "stream ended inside a phase-in codeword");
      value = static_cast<int64_t>(p) + l;
    } else {
      uint32_t above;
      if (!src.get_bit(&above))
        return fel_fail(FEL_EIO, "stream ended at the out-of-range sign bit");
      const uint32_t kctx = k_context(context, bucketed_k);
      const uint32_t k = estimator.get_k(kctx);
      uint32_t encoded;
      if (!rice_decode(src, k, &encoded))
        return fel_fail(FEL_EIO, "stream ended inside a Rice codeword");
      estimator.update(kctx, encoded);
      if (encoded > 0x7FFFFFFFu)
        return fel_fail(FEL_EINVALID_VALUE,
                        "Rice codeword exceeds the value range");
      value = above ? static_cast<int64_t>(encoded) + h + 1
                    : static_cast<int64_t>(l) - encoded - 1;
    }
    if (value < INT32_MIN || value > INT32_MAX)
      return fel_fail(FEL_EOVERFLOW, "decoded value overflows int32");
    out[i] = static_cast<int32_t>(value);
  }
  return FEL_OK;
}

// ---------------------------------------------------------------------------
// Color transform — YCoCg-R with truncating division (Rust i32 '/' semantics).
// ---------------------------------------------------------------------------
inline int32_t div2_trunc(int32_t x) { return (x + ((x >> 31) & 1)) >> 1; }

inline void to_ycocg(int32_t r, int32_t g, int32_t b, int32_t* y, int32_t* co,
                     int32_t* cg) {
  *co = r - b;
  const int32_t t = b + div2_trunc(*co);
  *cg = g - t;
  *y = t + div2_trunc(*cg);
}

inline void to_rgb(int32_t y, int32_t co, int32_t cg, int32_t* r, int32_t* g,
                   int32_t* b) {
  const int32_t t = y - div2_trunc(cg);
  *g = cg + t;
  *b = t - div2_trunc(co);
  *r = *b + co;
}

// ---------------------------------------------------------------------------
// Container
// ---------------------------------------------------------------------------
void write_header(std::vector<uint8_t>& out, int color, int depth,
                  uint32_t width, uint32_t height) {
  const uint8_t magic[4] = {'F', 'L', 'C', 'S'};
  out.insert(out.end(), magic, magic + 4);
  out.push_back(static_cast<uint8_t>(color));
  out.push_back(static_cast<uint8_t>(depth));
  for (int shift = 24; shift >= 0; shift -= 8)
    out.push_back(static_cast<uint8_t>(width >> shift));
  for (int shift = 24; shift >= 0; shift -= 8)
    out.push_back(static_cast<uint8_t>(height >> shift));
}

int read_header(const uint8_t* data, size_t len, int* color, int* depth,
                uint32_t* width, uint32_t* height) {
  if (len < kHeaderSize) return fel_fail(FEL_EIO, "FLCS header truncated");
  if (memcmp(data, "FLCS", 4) != 0)
    return fel_fail(FEL_ESIGNATURE, "not a FLCS file (bad signature)");
  *color = data[4];
  *depth = data[5];
  if (*color != kColorGray && *color != kColorRgb)
    return fel_fail(FEL_ECOLOR_TYPE, "FLCS header: unknown color type");
  if (*depth != kDepth8 && *depth != kDepth16)
    return fel_fail(FEL_EPIXEL_DEPTH, "FLCS header: unknown pixel depth");
  *width = (static_cast<uint32_t>(data[6]) << 24) |
           (static_cast<uint32_t>(data[7]) << 16) |
           (static_cast<uint32_t>(data[8]) << 8) | data[9];
  *height = (static_cast<uint32_t>(data[10]) << 24) |
            (static_cast<uint32_t>(data[11]) << 16) |
            (static_cast<uint32_t>(data[12]) << 8) | data[13];
  return FEL_OK;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

const char* fel_version() { return "felics_core 0.1.0"; }

// Detail string for the calling thread's most recent error return (empty
// if the last call succeeded or predates this export). Valid until the
// same thread's next felics call.
const char* fel_last_error() { return g_err; }

// FLCT context-bucket cap. Must equal felics_tpu.config.QCTX_CAP — the
// Python runtime asserts this at library load so the two constants cannot
// silently drift (they define the FLCT bitstream).
uint32_t fel_qctx_cap() { return kQctxCap; }

void fel_free(void* ptr) { free(ptr); }

// pixels: interleaved raster order; gray = 1 value/pixel, rgb = 3.
int fel_compress(const int32_t* pixels, uint32_t width, uint32_t height,
                 int color_type, int pixel_depth, uint8_t** out,
                 size_t* out_len) {
  if (color_type != kColorGray && color_type != kColorRgb)
    return fel_fail(FEL_ECOLOR_TYPE, "unsupported color type");
  if (pixel_depth != kDepth8 && pixel_depth != kDepth16)
    return fel_fail(FEL_EPIXEL_DEPTH, "unsupported pixel depth");
  const uint64_t total64 = static_cast<uint64_t>(width) * height;
  if (total64 > (1ull << 31))
    return fel_fail(FEL_EDIMENSIONS, "image exceeds 2^31 pixels");
  const size_t total = static_cast<size_t>(total64);
  const CodingParams params = params_for_depth(pixel_depth);

  std::vector<uint8_t> buf;
  buf.reserve(total + 64);
  write_header(buf, color_type, pixel_depth, width, height);
  BitSink sink(&buf);

  if (color_type == kColorGray) {
    compress_channel(pixels, width, height, params, sink);
  } else {
    std::vector<int32_t> y(total), co(total), cg(total);
    for (size_t i = 0; i < total; ++i)
      to_ycocg(pixels[3 * i], pixels[3 * i + 1], pixels[3 * i + 2], &y[i],
               &co[i], &cg[i]);
    compress_channel(y.data(), width, height, params, sink);
    compress_channel(co.data(), width, height, params, sink);
    compress_channel(cg.data(), width, height, params, sink);
  }
  sink.byte_align();

  uint8_t* result = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");
  memcpy(result, buf.data(), buf.size());
  *out = result;
  *out_len = buf.size();
  return FEL_OK;
}

int fel_decompress(const uint8_t* data, size_t len, int32_t** out_pixels,
                   uint32_t* width, uint32_t* height, int* color_type,
                   int* pixel_depth) {
  int color, depth;
  uint32_t w, h;
  int status = read_header(data, len, &color, &depth, &w, &h);
  if (status != FEL_OK) return status;
  const uint64_t total64 = static_cast<uint64_t>(w) * h;
  if (total64 > (1ull << 31))
    return fel_fail(FEL_EDIMENSIONS, "image exceeds 2^31 pixels");
  const size_t total = static_cast<size_t>(total64);
  const CodingParams params = params_for_depth(depth);
  const int nchan = color == kColorGray ? 1 : 3;

  BitSource src(data + kHeaderSize, len - kHeaderSize);
  const int32_t lo = 0;
  const int32_t hi = depth == kDepth8 ? 255 : 65535;

  int32_t* result =
      static_cast<int32_t*>(malloc(total ? total * nchan * sizeof(int32_t) : 4));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");

  if (color == kColorGray) {
    status = decompress_channel(w, h, params, src, result);
    if (status == FEL_OK) {
      for (size_t i = 0; i < total; ++i)
        if (result[i] < lo || result[i] > hi) {
          status = fel_fail(FEL_EINVALID_VALUE,
                            "decoded pixel does not fit the pixel depth");
          break;
        }
    }
  } else {
    std::vector<int32_t> y(total), co(total), cg(total);
    status = decompress_channel(w, h, params, src, y.data());
    if (status == FEL_OK) status = decompress_channel(w, h, params, src, co.data());
    if (status == FEL_OK) status = decompress_channel(w, h, params, src, cg.data());
    if (status == FEL_OK) {
      for (size_t i = 0; i < total; ++i) {
        int32_t r, g, b;
        to_rgb(y[i], co[i], cg[i], &r, &g, &b);
        if (r < lo || r > hi || g < lo || g > hi || b < lo || b > hi) {
          status = fel_fail(FEL_EINVALID_VALUE,
                            "decoded pixel does not fit the pixel depth");
          break;
        }
        result[3 * i] = r;
        result[3 * i + 1] = g;
        result[3 * i + 2] = b;
      }
    }
  }

  if (status != FEL_OK) {
    free(result);
    return status;
  }
  *out_pixels = result;
  *width = w;
  *height = h;
  *color_type = color;
  *pixel_depth = depth;
  return FEL_OK;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLCT tiled container (spec: felics_tpu/parallel/tiling.py).
// Tiles are independent streams -> encode/decode parallelize across a thread
// pool; the k-estimator is indexed by bit_length(context).
// ---------------------------------------------------------------------------

namespace {

constexpr size_t kTiledFixedHeader = 24;
// FLCT v2 header flags + prior weight (spec: felics_tpu/parallel/tiling.py;
// must match tiling.FLAG_TABLE_U16 / FLAG_K_PRIOR / PRIOR_WEIGHT).
constexpr uint16_t kFlagTableU16 = 0x0001;
constexpr uint16_t kFlagKPrior = 0x0002;
constexpr uint16_t kKnownFlags = kFlagTableU16 | kFlagKPrior;
constexpr uint32_t kPriorWeight = 4;

void write_u16be(std::vector<uint8_t>& out, uint16_t v) {
  out.push_back(static_cast<uint8_t>(v >> 8));
  out.push_back(static_cast<uint8_t>(v));
}

void write_u32be(std::vector<uint8_t>& out, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) out.push_back(static_cast<uint8_t>(v >> s));
}

uint32_t read_u32be(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

inline void tile_plane(const int32_t* pixels, uint32_t width, uint32_t height,
                       int nchan, int chan, uint32_t ty, uint32_t tx,
                       uint32_t th, uint32_t tw, int32_t* out) {
  // Extract one channel plane of one tile with edge-replicate padding,
  // applying YCoCg-R on the fly for RGB (channel 0=Y, 1=Co, 2=Cg).
  for (uint32_t yy = 0; yy < th; ++yy) {
    const uint32_t sy = ty * th + yy < height ? ty * th + yy : height - 1;
    for (uint32_t xx = 0; xx < tw; ++xx) {
      const uint32_t sx = tx * tw + xx < width ? tx * tw + xx : width - 1;
      const size_t src = (static_cast<size_t>(sy) * width + sx) * nchan;
      int32_t v;
      if (nchan == 1) {
        v = pixels[src];
      } else {
        int32_t y, co, cg;
        to_ycocg(pixels[src], pixels[src + 1], pixels[src + 2], &y, &co, &cg);
        v = chan == 0 ? y : (chan == 1 ? co : cg);
      }
      out[yy * tw + xx] = v;
    }
  }
}

void run_on_pool(int n_threads, size_t n_items,
                 const std::function<void(size_t)>& fn) {
  if (n_threads <= 1 || n_items <= 1) {
    for (size_t i = 0; i < n_items; ++i) fn(i);
    return;
  }
  const size_t workers =
      std::min<size_t>(n_threads, std::max<size_t>(1, n_items));
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (size_t t = 0; t < workers; ++t) {
    pool.emplace_back([&, t]() {
      for (size_t i = t; i < n_items; i += workers) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int fel_compress_tiled(const int32_t* pixels, uint32_t width, uint32_t height,
                       int color_type, int pixel_depth, uint16_t tile_w,
                       uint16_t tile_h, int n_threads, uint8_t** out,
                       size_t* out_len) {
  if (color_type != kColorGray && color_type != kColorRgb)
    return fel_fail(FEL_ECOLOR_TYPE, "unsupported color type");
  if (pixel_depth != kDepth8 && pixel_depth != kDepth16)
    return fel_fail(FEL_EPIXEL_DEPTH, "unsupported pixel depth");
  const CodingParams params = params_for_depth(pixel_depth);
  const int nchan = color_type == kColorGray ? 1 : 3;

  uint32_t th = tile_h, tw = tile_w;
  if (height > 0 && th > height) th = height;
  if (width > 0 && tw > width) tw = width;
  if (th < 2) th = 2;
  if (tw < 2) tw = 2;

  const uint32_t ty_n = height ? (height + th - 1) / th : 0;
  const uint32_t tx_n = width ? (width + tw - 1) / tw : 0;
  const uint32_t n_tiles = (width && height) ? ty_n * tx_n : 0;

  // FLCT: bucketed-k estimator, no periodic count scaling (see the format
  // spec in felics_tpu/parallel/tiling.py).
  CodingParams tiled_params = params;
  tiled_params.halve_at = 0;
  const int nb = num_buckets(params.max_context);
  const int K = params.num_k;
  const size_t tsz = static_cast<size_t>(th) * tw;

  // Pass 1 (parallel): extract planes once, accumulate per-tile Rice-length
  // sums per (channel, bucket, k) for the per-image k0 prior (exact uint64,
  // matching felics_tpu.parallel.tiling.compute_k0 bit for bit).
  std::vector<int32_t> all_planes(n_tiles * nchan * tsz);
  std::vector<uint64_t> stats(static_cast<size_t>(n_tiles) * nchan * nb * K,
                              0);
  run_on_pool(n_threads, n_tiles, [&](size_t t) {
    const uint32_t tyi = static_cast<uint32_t>(t) / tx_n;
    const uint32_t txi = static_cast<uint32_t>(t) % tx_n;
    uint64_t* st = stats.data() + t * nchan * nb * K;
    for (int c = 0; c < nchan; ++c) {
      int32_t* plane = all_planes.data() + (t * nchan + c) * tsz;
      tile_plane(pixels, width, height, nchan, c, tyi, txi, th, tw, plane);
      for (size_t i = 2; i < tsz; ++i) {
        size_t a, b;
        neighbours(i, tw, &a, &b);
        const int32_t p = plane[i];
        const int32_t v1 = plane[a], v2 = plane[b];
        const int32_t h = v1 > v2 ? v1 : v2;
        const int32_t l = v1 < v2 ? v1 : v2;
        if (p >= l && p <= h) continue;
        const uint32_t ctx = static_cast<uint32_t>(h - l);
        const uint32_t bucket = k_context(ctx, true);
        const uint32_t res =
            p < l ? static_cast<uint32_t>(l - p - 1)
                  : static_cast<uint32_t>(p - h - 1);
        uint64_t* row = st + (static_cast<size_t>(c) * nb + bucket) * K;
        for (int ki = 0; ki < K; ++ki)
          row[ki] += (res >> params.k_values[ki]) + 1 + params.k_values[ki];
      }
    }
  });

  // Reduce, pick k0 per (channel, bucket): ties/all-zero -> largest k.
  std::vector<uint8_t> k0(static_cast<size_t>(nchan) * nb, 0);
  std::vector<uint32_t> prior(static_cast<size_t>(nchan) * nb * K, 0);
  for (int c = 0; c < nchan; ++c) {
    for (int b = 0; b < nb; ++b) {
      uint64_t best_v = UINT64_MAX;
      int best = 0;
      for (int ki = 0; ki < K; ++ki) {
        uint64_t tot = 0;
        for (uint32_t t = 0; t < n_tiles; ++t)
          tot += stats[(static_cast<size_t>(t) * nchan + c) * nb * K +
                       static_cast<size_t>(b) * K + ki];
        if (tot <= best_v) {  // '<=': ties pick the largest k
          best_v = tot;
          best = ki;
        }
      }
      k0[static_cast<size_t>(c) * nb + b] = params.k_values[best];
      for (int ki = 0; ki < K; ++ki) {
        const int d = static_cast<int>(params.k_values[ki]) -
                      static_cast<int>(params.k_values[best]);
        prior[(static_cast<size_t>(c) * nb + b) * K + ki] =
            kPriorWeight * static_cast<uint32_t>(d < 0 ? -d : d);
      }
    }
  }

  // Pass 2 (parallel): encode every tile with the shared prior.
  std::vector<std::vector<uint8_t>> streams(n_tiles);
  run_on_pool(n_threads, n_tiles, [&](size_t t) {
    BitSink sink(&streams[t]);
    for (int c = 0; c < nchan; ++c) {
      const int32_t* plane = all_planes.data() + (t * nchan + c) * tsz;
      const uint32_t pre =
          (pixel_depth == kDepth8 ? 8u : 16u) + (c > 0 ? 1u : 0u);
      compress_channel(plane, tw, th, tiled_params, sink,
                       /*bucketed_k=*/true, pre,
                       prior.data() + static_cast<size_t>(c) * nb * K);
    }
    sink.byte_align();
  });

  size_t max_len = 0;
  for (const auto& s : streams) max_len = std::max(max_len, s.size());
  uint16_t flags = n_tiles ? kFlagKPrior : 0;
  if (max_len < (1u << 16)) flags |= kFlagTableU16;

  std::vector<uint8_t> buf;
  const uint8_t magic[4] = {'F', 'L', 'C', 'T'};
  buf.insert(buf.end(), magic, magic + 4);
  buf.push_back(static_cast<uint8_t>(color_type));
  buf.push_back(static_cast<uint8_t>(pixel_depth));
  write_u32be(buf, width);
  write_u32be(buf, height);
  write_u16be(buf, static_cast<uint16_t>(tw));
  write_u16be(buf, static_cast<uint16_t>(th));
  write_u16be(buf, n_tiles ? flags : 0);
  write_u32be(buf, n_tiles);
  if (n_tiles) {  // k-prior nibbles, channel-major, high nibble first
    for (size_t i = 0; i < k0.size(); i += 2) {
      const uint8_t hi = k0[i] & 0x0F;
      const uint8_t lo = i + 1 < k0.size() ? (k0[i + 1] & 0x0F) : 0;
      buf.push_back(static_cast<uint8_t>((hi << 4) | lo));
    }
  }
  for (const auto& s : streams) {
    if (flags & kFlagTableU16)
      write_u16be(buf, static_cast<uint16_t>(s.size()));
    else
      write_u32be(buf, static_cast<uint32_t>(s.size()));
  }
  for (const auto& s : streams) buf.insert(buf.end(), s.begin(), s.end());

  uint8_t* result = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");
  memcpy(result, buf.data(), buf.size());
  *out = result;
  *out_len = buf.size();
  return FEL_OK;
}

int fel_decompress_tiled(const uint8_t* data, size_t len, int n_threads,
                         int32_t** out_pixels, uint32_t* width,
                         uint32_t* height, int* color_type, int* pixel_depth) {
  if (len < kTiledFixedHeader)
    return fel_fail(FEL_EIO, "FLCT header truncated");
  if (memcmp(data, "FLCT", 4) != 0)
    return fel_fail(FEL_ESIGNATURE, "not a FLCT file (bad signature)");
  const int color = data[4];
  const int depth = data[5];
  if (color != kColorGray && color != kColorRgb)
    return fel_fail(FEL_ECOLOR_TYPE, "FLCT header: unknown color type");
  if (depth != kDepth8 && depth != kDepth16)
    return fel_fail(FEL_EPIXEL_DEPTH, "FLCT header: unknown pixel depth");
  const uint32_t w = read_u32be(data + 6);
  const uint32_t h = read_u32be(data + 10);
  const uint32_t tw = (data[14] << 8) | data[15];
  const uint32_t th = (data[16] << 8) | data[17];
  const uint32_t flags = (data[18] << 8) | data[19];
  const uint32_t n_tiles = read_u32be(data + 20);
  if (flags & ~kKnownFlags)
    return fel_fail(FEL_EINVALID_VALUE, "FLCT header: unknown flags");

  const uint64_t total64 = static_cast<uint64_t>(w) * h;
  if (total64 > (1ull << 31))
    return fel_fail(FEL_EDIMENSIONS, "image exceeds 2^31 pixels");
  // Validate tile geometry BEFORE any division (a zeroed tile_h would trap
  // with SIGFPE) and require the header's n_tiles to match the grid the
  // dims imply — the Python read_tiled_header enforces the same.
  if (th < 2 || tw < 2)
    return fel_fail(FEL_EDIMENSIONS, "FLCT tile dims below the minimum (2)");
  {
    const uint64_t expect =
        total64 == 0 ? 0
                     : (static_cast<uint64_t>(h) + th - 1) / th *
                           ((static_cast<uint64_t>(w) + tw - 1) / tw);
    if (n_tiles != expect)
      return fel_fail(FEL_EDIMENSIONS,
                      "FLCT n_tiles does not match the tile grid");
  }
  const int nchan = color == kColorGray ? 1 : 3;
  const CodingParams params = params_for_depth(depth);
  const int nb = num_buckets(params.max_context);
  const int K = params.num_k;

  // Optional k-prior block, then the tile length table (u16 or u32).
  size_t pos = kTiledFixedHeader;
  std::vector<uint32_t> prior;  // (nchan * nb * K); empty = zero seed
  if (flags & kFlagKPrior) {
    const size_t nbytes = (static_cast<size_t>(nchan) * nb + 1) / 2;
    if (len < pos + nbytes)
      return fel_fail(FEL_EIO, "FLCT k-prior block truncated");
    prior.assign(static_cast<size_t>(nchan) * nb * K, 0);
    for (size_t i = 0; i < static_cast<size_t>(nchan) * nb; ++i) {
      uint32_t k0 = (i % 2 == 0) ? (data[pos + i / 2] >> 4)
                                 : (data[pos + i / 2] & 0x0F);
      const uint32_t kmax = params.k_values[K - 1];
      if (k0 > kmax) k0 = kmax;  // corrupt nibble: clamp (prior-only effect)
      for (int ki = 0; ki < K; ++ki) {
        const int d =
            static_cast<int>(params.k_values[ki]) - static_cast<int>(k0);
        prior[i * K + ki] = kPriorWeight * static_cast<uint32_t>(d < 0 ? -d : d);
      }
    }
    pos += nbytes;
  }
  const size_t entry = (flags & kFlagTableU16) ? 2 : 4;
  if (len < pos + entry * n_tiles)
    return fel_fail(FEL_EIO, "FLCT tile table truncated");

  int32_t* result = static_cast<int32_t*>(
      malloc(total64 ? total64 * nchan * sizeof(int32_t) : 4));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");

  if (total64 == 0 || n_tiles == 0) {
    *out_pixels = result;
    *width = w;
    *height = h;
    *color_type = color;
    *pixel_depth = depth;
    return FEL_OK;
  }

  const uint32_t ty_n = (h + th - 1) / th;
  const uint32_t tx_n = (w + tw - 1) / tw;

  // Per-tile payload offsets.
  std::vector<size_t> starts(n_tiles + 1, 0);
  const uint8_t* table = data + pos;
  for (uint32_t t = 0; t < n_tiles; ++t)
    starts[t + 1] =
        starts[t] + (entry == 2
                         ? ((static_cast<uint32_t>(table[2 * t]) << 8) |
                            table[2 * t + 1])
                         : read_u32be(table + 4ull * t));
  const uint8_t* payload = table + entry * n_tiles;
  if (len < pos + entry * n_tiles + starts[n_tiles]) {
    free(result);
    return fel_fail(FEL_EIO, "FLCT payload truncated");
  }

  CodingParams tiled_params = params;
  tiled_params.halve_at = 0;
  const int32_t lo = 0;
  const int32_t hi = depth == kDepth8 ? 255 : 65535;
  std::vector<int> statuses(n_tiles, FEL_OK);
  run_on_pool(n_threads, n_tiles, [&](size_t t) {
    const uint32_t tyi = static_cast<uint32_t>(t) / tx_n;
    const uint32_t txi = static_cast<uint32_t>(t) % tx_n;
    BitSource src(payload + starts[t], starts[t + 1] - starts[t]);
    const size_t tsz = static_cast<size_t>(th) * tw;
    std::vector<int32_t> planes(tsz * nchan);
    for (int c = 0; c < nchan; ++c) {
      const uint32_t pre =
          (depth == kDepth8 ? 8u : 16u) + (c > 0 ? 1u : 0u);
      int st = decompress_channel(tw, th, tiled_params, src,
                                  planes.data() + c * tsz,
                                  /*bucketed_k=*/true, pre,
                                  /*pre_signed=*/c > 0,
                                  prior.empty()
                                      ? nullptr
                                      : prior.data() +
                                            static_cast<size_t>(c) * nb * K);
      if (st != FEL_OK) {
        statuses[t] = st;
        return;
      }
    }
    // Crop + inverse transform into the output image.
    for (uint32_t yy = 0; yy < th; ++yy) {
      const uint32_t dy = tyi * th + yy;
      if (dy >= h) break;
      for (uint32_t xx = 0; xx < tw; ++xx) {
        const uint32_t dx = txi * tw + xx;
        if (dx >= w) continue;
        const size_t p = yy * tw + xx;
        const size_t dst = (static_cast<size_t>(dy) * w + dx) * nchan;
        if (nchan == 1) {
          const int32_t v = planes[p];
          if (v < lo || v > hi) {
            statuses[t] = FEL_EINVALID_VALUE;
            return;
          }
          result[dst] = v;
        } else {
          int32_t r, g, b;
          to_rgb(planes[p], planes[tsz + p], planes[2 * tsz + p], &r, &g, &b);
          if (r < lo || r > hi || g < lo || g > hi || b < lo || b > hi) {
            statuses[t] = FEL_EINVALID_VALUE;
            return;
          }
          result[dst] = r;
          result[dst + 1] = g;
          result[dst + 2] = b;
        }
      }
    }
  });

  for (uint32_t t = 0; t < n_tiles; ++t) {
    if (statuses[t] != FEL_OK) {
      free(result);
      // Worker threads report via per-tile codes (their thread_local
      // detail dies with the pool); translate here with the tile index.
      std::snprintf(g_err, sizeof(g_err), "tile %u: %s", t,
                    code_detail(statuses[t]));
      return statuses[t];
    }
  }
  *out_pixels = result;
  *width = w;
  *height = h;
  *color_type = color;
  *pixel_depth = depth;
  return FEL_OK;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// QOI ("Quite OK Image", qoiformat.org/qoi-specification.pdf) encode/decode.
// The reference benchmark compares FELICS against qoi files produced by
// ImageMagick (bench/benchmark-small-corpus.py:39-69); this image has no
// external tools, so the comparison codec ships here — implemented from the
// public one-page spec. 8-bit, 3 (RGB) or 4 (RGBA) channels.

namespace qoi {

constexpr uint8_t kOpIndex = 0x00;  // 00xxxxxx
constexpr uint8_t kOpDiff = 0x40;   // 01xxxxxx
constexpr uint8_t kOpLuma = 0x80;   // 10xxxxxx
constexpr uint8_t kOpRun = 0xC0;    // 11xxxxxx
constexpr uint8_t kOpRgb = 0xFE;
constexpr uint8_t kOpRgba = 0xFF;

struct Px {
  uint8_t r = 0, g = 0, b = 0, a = 255;
  bool operator==(const Px& o) const {
    return r == o.r && g == o.g && b == o.b && a == o.a;
  }
};

inline int hash(const Px& p) {
  return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) & 63;
}

inline void put32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v >> 24);
  out.push_back(v >> 16);
  out.push_back(v >> 8);
  out.push_back(v);
}

}  // namespace qoi

extern "C" {

// pixels: interleaved uint8, `channels` = 3 or 4.
int fel_qoi_encode(const uint8_t* pixels, uint32_t width, uint32_t height,
                   int channels, uint8_t** out, size_t* out_len) {
  using namespace qoi;
  if (channels != 3 && channels != 4)
    return fel_fail(FEL_ECOLOR_TYPE, "QOI input must have 3 or 4 channels");
  if (width == 0 || height == 0)
    return fel_fail(FEL_EDIMENSIONS, "QOI input has a zero dimension");
  const uint64_t total64 = static_cast<uint64_t>(width) * height;
  if (total64 > (1ull << 31))
    return fel_fail(FEL_EDIMENSIONS, "image exceeds 2^31 pixels");
  const size_t total = static_cast<size_t>(total64);

  std::vector<uint8_t> buf;
  buf.reserve(total + 64);
  buf.push_back('q'); buf.push_back('o'); buf.push_back('i'); buf.push_back('f');
  put32(buf, width);
  put32(buf, height);
  buf.push_back(static_cast<uint8_t>(channels));
  buf.push_back(0);  // colorspace: sRGB with linear alpha

  Px cache[64] = {};
  Px prev;  // spec start value {0,0,0,255}
  int run = 0;
  for (size_t i = 0; i < total; ++i) {
    Px cur;
    cur.r = pixels[i * channels];
    cur.g = pixels[i * channels + 1];
    cur.b = pixels[i * channels + 2];
    cur.a = channels == 4 ? pixels[i * channels + 3] : 255;

    if (cur == prev) {
      if (++run == 62) {
        buf.push_back(kOpRun | (run - 1));
        run = 0;
      }
    } else {
      if (run > 0) {
        buf.push_back(kOpRun | (run - 1));
        run = 0;
      }
      const int idx = hash(cur);
      if (cache[idx] == cur) {
        buf.push_back(kOpIndex | idx);
      } else {
        cache[idx] = cur;
        if (cur.a == prev.a) {
          const int8_t dr = cur.r - prev.r;
          const int8_t dg = cur.g - prev.g;
          const int8_t db = cur.b - prev.b;
          const int8_t dg_r = dr - dg;
          const int8_t dg_b = db - dg;
          if (dr >= -2 && dr <= 1 && dg >= -2 && dg <= 1 && db >= -2 &&
              db <= 1) {
            buf.push_back(kOpDiff | ((dr + 2) << 4) | ((dg + 2) << 2) |
                          (db + 2));
          } else if (dg >= -32 && dg <= 31 && dg_r >= -8 && dg_r <= 7 &&
                     dg_b >= -8 && dg_b <= 7) {
            buf.push_back(kOpLuma | (dg + 32));
            buf.push_back(((dg_r + 8) << 4) | (dg_b + 8));
          } else {
            buf.push_back(kOpRgb);
            buf.push_back(cur.r);
            buf.push_back(cur.g);
            buf.push_back(cur.b);
          }
        } else {
          buf.push_back(kOpRgba);
          buf.push_back(cur.r);
          buf.push_back(cur.g);
          buf.push_back(cur.b);
          buf.push_back(cur.a);
        }
      }
      prev = cur;
    }
  }
  if (run > 0) buf.push_back(kOpRun | (run - 1));
  for (int i = 0; i < 7; ++i) buf.push_back(0);
  buf.push_back(1);

  uint8_t* result = static_cast<uint8_t*>(malloc(buf.size()));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");
  memcpy(result, buf.data(), buf.size());
  *out = result;
  *out_len = buf.size();
  return FEL_OK;
}

int fel_qoi_decode(const uint8_t* data, size_t len, uint8_t** out,
                   uint32_t* width, uint32_t* height, int* channels) {
  using namespace qoi;
  if (len < 14 + 8) return fel_fail(FEL_EIO, "QOI header truncated");
  if (data[0] != 'q' || data[1] != 'o' || data[2] != 'i' || data[3] != 'f')
    return fel_fail(FEL_ESIGNATURE, "not a QOI file (bad signature)");
  const uint32_t w = (uint32_t(data[4]) << 24) | (uint32_t(data[5]) << 16) |
                     (uint32_t(data[6]) << 8) | data[7];
  const uint32_t h = (uint32_t(data[8]) << 24) | (uint32_t(data[9]) << 16) |
                     (uint32_t(data[10]) << 8) | data[11];
  const int ch = data[12];
  if (ch != 3 && ch != 4)
    return fel_fail(FEL_ECOLOR_TYPE, "QOI header: unknown channel count");
  const uint64_t total64 = static_cast<uint64_t>(w) * h;
  if (total64 == 0 || total64 > (1ull << 31))
    return fel_fail(FEL_EDIMENSIONS, "QOI header: invalid dimensions");
  const size_t total = static_cast<size_t>(total64);

  uint8_t* result = static_cast<uint8_t*>(malloc(total * ch));
  if (!result) return fel_fail(FEL_ENOMEM, "out of memory");

  Px cache[64] = {};
  Px px;
  size_t p = 14;
  const size_t chunks_end = len - 8;  // 7x00 + 01 end marker
  for (size_t i = 0; i < total; ++i) {
    int run = 0;
    if (p < chunks_end) {
      const uint8_t b0 = data[p++];
      if (b0 == kOpRgb) {
        if (p + 3 > chunks_end) { free(result); return fel_fail(FEL_EIO, "QOI chunk stream truncated"); }
        px.r = data[p++]; px.g = data[p++]; px.b = data[p++];
      } else if (b0 == kOpRgba) {
        if (p + 4 > chunks_end) { free(result); return fel_fail(FEL_EIO, "QOI chunk stream truncated"); }
        px.r = data[p++]; px.g = data[p++]; px.b = data[p++]; px.a = data[p++];
      } else if ((b0 & 0xC0) == kOpIndex) {
        px = cache[b0 & 63];
      } else if ((b0 & 0xC0) == kOpDiff) {
        px.r += ((b0 >> 4) & 3) - 2;
        px.g += ((b0 >> 2) & 3) - 2;
        px.b += (b0 & 3) - 2;
      } else if ((b0 & 0xC0) == kOpLuma) {
        if (p + 1 > chunks_end) { free(result); return fel_fail(FEL_EIO, "QOI chunk stream truncated"); }
        const uint8_t b1 = data[p++];
        const int dg = (b0 & 63) - 32;
        px.r += dg - 8 + ((b1 >> 4) & 15);
        px.g += dg;
        px.b += dg - 8 + (b1 & 15);
      } else {  // kOpRun
        run = b0 & 63;
      }
      cache[hash(px)] = px;
    }
    result[i * ch] = px.r;
    result[i * ch + 1] = px.g;
    result[i * ch + 2] = px.b;
    if (ch == 4) result[i * ch + 3] = px.a;
    for (; run > 0 && i + 1 < total; --run) {
      ++i;
      result[i * ch] = px.r;
      result[i * ch + 1] = px.g;
      result[i * ch + 2] = px.b;
      if (ch == 4) result[i * ch + 3] = px.a;
    }
  }
  *out = result;
  *width = w;
  *height = h;
  *channels = ch;
  return FEL_OK;
}

}  // extern "C"
