// Host rANS range coder of the shallow_ntc_tpu_torch codec
// (shallow_ntc_tpu_torch/codec/api.py).
//
// The GPU computes the latents, their coding grids and the quantized CDF
// tables; this library does the sequential entropy coding on the host. Its
// coder is a copy of the JAX package's (shallow_ntc_tpu/codec/rans.cc), kept
// byte for byte below this comment, so that both packages write the same
// bytes for the same symbols.
//
// Design: byte-renormalized rANS (range asymmetric numeral system) with a
// 32-bit state and 16-bit probability resolution. Symbols outside a table's
// alphabet are escape-coded (last slot of every table) followed by a 32-bit
// zig-zag raw value, so any integer is codable regardless of table range.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rans.cc -o librans.so (codec/bindings.py
// builds it at first use).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // lower bound of the normalized interval

struct RansEncoder {
  uint32_t x = kRansL;
  uint8_t* begin;   // start of buffer (inclusive)
  uint8_t* ptr;     // writes move DOWN from the end
  bool overflow = false;

  RansEncoder(uint8_t* buf, int64_t capacity)
      : begin(buf), ptr(buf + capacity) {}

  inline void put_byte(uint8_t b) {
    if (ptr == begin) { overflow = true; return; }
    *--ptr = b;
  }

  // Encode a symbol with cumulative range [start, start+freq) / 2^16.
  inline void put(uint32_t start, uint32_t freq) {
    // Renormalize: keep x < ((L >> 16) << 8) * freq after the state update.
    const uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
    while (x >= x_max) {
      put_byte(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
    x = ((x / freq) << kProbBits) + (x % freq) + start;
  }

  // Raw `bits`-bit value (uniform); used for escape payloads.
  inline void put_bits(uint32_t val, uint32_t bits) {
    // Equivalent to a uniform symbol with freq 1 in a 2^bits table.
    const uint32_t x_max = ((kRansL >> bits) << 8);
    while (x >= x_max) {
      put_byte(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
    x = (x << bits) | (val & ((1u << bits) - 1u));
  }

  // Flush the final state (4 bytes).
  inline void flush() {
    for (int i = 0; i < 4; ++i) {
      put_byte(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
  }
};

struct RansDecoder {
  uint32_t x = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* end = nullptr;

  RansDecoder() = default;
  RansDecoder(const uint8_t* buf, int64_t size) : ptr(buf), end(buf + size) {
    // The encoder flushes the state low-byte-first while writing DOWNWARD,
    // so the stream starts with [x>>24, x>>16, x>>8, x] in ascending order.
    for (int i = 0; i < 4; ++i) {
      x = (x << 8) | (ptr + i < end ? ptr[i] : 0);
    }
    ptr += 4;
  }

  inline uint32_t peek() const { return x & (kProbScale - 1); }

  inline void advance(uint32_t start, uint32_t freq) {
    x = freq * (x >> kProbBits) + (x & (kProbScale - 1)) - start;
    while (x < kRansL && ptr < end) {
      x = (x << 8) | *ptr++;
    }
  }

  inline uint32_t get_bits(uint32_t bits) {
    const uint32_t val = x & ((1u << bits) - 1u);
    x >>= bits;
    while (x < kRansL && ptr < end) {
      x = (x << 8) | *ptr++;
    }
    return val;
  }
};

inline uint32_t zigzag(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline int32_t unzigzag(uint32_t u) {
  return static_cast<int32_t>(u >> 1) ^ -static_cast<int32_t>(u & 1);
}

// Binary search: largest s with cdf[s] <= cum. Branchless form: the
// conditional add compiles to a cmov, so the loop carries no unpredictable
// branches (symbol values are data-dependent and mispredict badly in the
// plain lo/hi form).
inline int32_t find_symbol(const uint32_t* cdf, int32_t size, uint32_t cum) {
  int32_t lo = 0;
  int32_t n = size;  // candidate positions [lo, lo+n); cdf has size+1 entries
  while (n > 1) {
    const int32_t half = n >> 1;
    lo += (cdf[lo + half] <= cum) ? half : 0;
    n -= half;
  }
  return lo;
}

// Bucket-LUT lookup: lut[cum >> (16-B)] = largest s with
// cdf[s] <= (bucket << (16-B)), then a short forward refine. The binary
// search costs ~log2(size) dependent loads per symbol (the decode hot-path
// bottleneck: Gaussian tables run to hundreds of slots); the LUT answer is
// 1 load + O(1) expected refine steps (a 16-codepoint bucket rarely holds
// more than one probability-weighted symbol).
constexpr uint32_t kLutBits = 12;
constexpr uint32_t kLutSize = 1u << kLutBits;

inline int32_t find_symbol_lut(const uint32_t* cdf, const int32_t* lut,
                               uint32_t cum) {
  int32_t s = lut[cum >> (kProbBits - kLutBits)];
  while (cdf[s + 1] <= cum) ++s;
  return s;
}

}  // namespace

extern "C" {

// Fill `lut_out` (num_tables * 2^12 int32 entries) so that
// lut_out[t*2^12 + b] = largest s with cdf_t[s] <= (b << 4). One forward
// sweep per table; callers cache the result per table set (the tables are a
// fixed function of the model params).
void rans_build_lut(const uint32_t* cdfs, const int64_t* cdf_offsets,
                    const int32_t* cdf_sizes, int32_t num_tables,
                    int32_t* lut_out) {
  for (int32_t t = 0; t < num_tables; ++t) {
    const uint32_t* cdf = cdfs + cdf_offsets[t];
    const int32_t size = cdf_sizes[t];
    int32_t* lut = lut_out + static_cast<int64_t>(t) * kLutSize;
    int32_t s = 0;
    for (uint32_t b = 0; b < kLutSize; ++b) {
      const uint32_t lo = b << (kProbBits - kLutBits);
      while (s + 1 < size && cdf[s + 1] <= lo) ++s;
      lut[b] = s;
    }
  }
}

// Encode `n` symbols. For element i, table `indexes[i]` applies; the symbol
// alphabet of table t is [0, cdf_sizes[t]-1) plus an escape slot at
// cdf_sizes[t]-1. `symbols[i]` may be ANY int32: in-alphabet values are
// entropy-coded, others escape-coded. CDFs are concatenated; table t spans
// cdfs[cdf_offsets[t] .. cdf_offsets[t]+cdf_sizes[t]] (size+1 entries,
// cdf[0]=0, cdf[size]=65536).
// Returns the number of bytes written at the START of `out`, or -1 if
// out_capacity was insufficient.
int64_t rans_encode(const int32_t* symbols, const int32_t* indexes, int64_t n,
                    const uint32_t* cdfs, const int64_t* cdf_offsets,
                    const int32_t* cdf_sizes, int32_t num_tables,
                    uint8_t* out, int64_t out_capacity) {
  RansEncoder enc(out, out_capacity);
  // rANS is LIFO: encode in reverse so the decoder emits in forward order.
  for (int64_t i = n - 1; i >= 0; --i) {
    const int32_t t = indexes[i];
    if (t < 0 || t >= num_tables) return -2;
    const uint32_t* cdf = cdfs + cdf_offsets[t];
    const int32_t size = cdf_sizes[t];
    const int32_t escape = size - 1;
    const int32_t s = symbols[i];
    if (s >= 0 && s < escape) {
      enc.put(cdf[s], cdf[s + 1] - cdf[s]);
    } else {
      // Escape: decoder reads the escape symbol FIRST, then two 16-bit
      // halves (low then high). Encode in reverse order.
      const uint32_t zz = zigzag(s);
      enc.put_bits(zz >> 16, 16);
      enc.put_bits(zz & 0xffff, 16);
      enc.put(cdf[escape], cdf[escape + 1] - cdf[escape]);
    }
    if (enc.overflow) return -1;
  }
  enc.flush();
  if (enc.overflow) return -1;
  const int64_t nbytes = (out + out_capacity) - enc.ptr;
  std::memmove(out, enc.ptr, static_cast<size_t>(nbytes));
  return nbytes;
}

// Decode `n` symbols written by rans_encode with the same indexes/tables.
// Returns 0 on success.
int32_t rans_decode(const uint8_t* bytes, int64_t nbytes,
                    const int32_t* indexes, int64_t n, const uint32_t* cdfs,
                    const int64_t* cdf_offsets, const int32_t* cdf_sizes,
                    int32_t num_tables, const int32_t* lut,
                    int32_t* symbols_out) {
  RansDecoder dec(bytes, nbytes);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t t = indexes[i];
    if (t < 0 || t >= num_tables) return -2;
    const uint32_t* cdf = cdfs + cdf_offsets[t];
    const int32_t size = cdf_sizes[t];
    const int32_t escape = size - 1;
    const uint32_t cum = dec.peek();
    const int32_t s =
        lut ? find_symbol_lut(cdf, lut + static_cast<int64_t>(t) * kLutSize,
                              cum)
            : find_symbol(cdf, size, cum);
    dec.advance(cdf[s], cdf[s + 1] - cdf[s]);
    if (s == escape) {
      const uint32_t lo = dec.get_bits(16);
      const uint32_t hi = dec.get_bits(16);
      symbols_out[i] = unzigzag((hi << 16) | lo);
    } else {
      symbols_out[i] = s;
    }
  }
  return 0;
}

// Decode `num_stripes` independent streams laid out back to back in
// `bytes` (stripe i spans bytes[byte_offsets[i] .. byte_offsets[i+1]) and
// produces symbols [sym_offsets[i], sym_offsets[i+1])). Stripes are decoded
// in interleaved groups of 8: each stream is a serial dependency chain
// (state update -> renormalize -> table lookup), so a single chain leaves
// the core mostly idle; eight independent chains in one loop let the
// out-of-order core overlap them (~ILP speedup), which is the single-core
// complement to thread-per-stripe parallelism on multi-core hosts. With the
// LUT the per-symbol chain is short enough that 8 lanes saturate better
// than 4 (A/B-measured on the 1-core bench host).
// Returns 0 on success.
int32_t rans_decode_multi(const uint8_t* bytes, const int64_t* byte_offsets,
                          const int64_t* sym_offsets, int32_t num_stripes,
                          const int32_t* indexes, const uint32_t* cdfs,
                          const int64_t* cdf_offsets, const int32_t* cdf_sizes,
                          int32_t num_tables, const int32_t* lut,
                          int32_t* symbols_out) {
  constexpr int32_t kLanes = 8;
  int32_t status = 0;
  for (int32_t group = 0; group < num_stripes; group += kLanes) {
    const int32_t lanes =
        num_stripes - group < kLanes ? num_stripes - group : kLanes;
    RansDecoder dec[kLanes];
    int64_t pos[kLanes];
    int64_t stop[kLanes];
    int64_t lockstep = INT64_MAX;
    for (int32_t l = 0; l < lanes; ++l) {
      const int32_t i = group + l;
      dec[l] = RansDecoder(bytes + byte_offsets[i],
                           byte_offsets[i + 1] - byte_offsets[i]);
      pos[l] = sym_offsets[i];
      stop[l] = sym_offsets[i + 1];
      const int64_t count = stop[l] - pos[l];
      lockstep = count < lockstep ? count : lockstep;
    }
    auto decode_one = [&](RansDecoder& d, int64_t p) {
      const int32_t t = indexes[p];
      if (t < 0 || t >= num_tables) { status = -2; return; }
      const uint32_t* cdf = cdfs + cdf_offsets[t];
      const int32_t size = cdf_sizes[t];
      const uint32_t cum = d.peek();
      const int32_t s =
          lut ? find_symbol_lut(
                    cdf, lut + static_cast<int64_t>(t) * kLutSize, cum)
              : find_symbol(cdf, size, cum);
      d.advance(cdf[s], cdf[s + 1] - cdf[s]);
      if (s == size - 1) {  // escape
        const uint32_t lo = d.get_bits(16);
        const uint32_t hi = d.get_bits(16);
        symbols_out[p] = unzigzag((hi << 16) | lo);
      } else {
        symbols_out[p] = s;
      }
    };
    for (int64_t j = 0; j < lockstep; ++j) {
      for (int32_t l = 0; l < lanes; ++l) {
        decode_one(dec[l], pos[l]++);
      }
    }
    for (int32_t l = 0; l < lanes; ++l) {
      while (pos[l] < stop[l]) decode_one(dec[l], pos[l]++);
    }
    if (status != 0) return status;
  }
  return status;
}

}  // extern "C"
