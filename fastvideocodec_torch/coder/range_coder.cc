// First-party range coder for real bitstreams.
//
// Replaces the reference's third-party native coders (torchac arithmetic
// coder + compressai _CXX rANS; SURVEY.md §2.9): a classic carry-less
// byte-oriented range coder over 16-bit quantized CDF tables, with an
// escape + Exp-Golomb bypass for out-of-support values (same contract as
// compressai's encode_with_indexes / decode_with_indexes, so bpp parity is
// table-for-table).
//
// Build: g++ -O3 -shared -fPIC range_coder.cc -o librangecoder.so
// The Python side (fastvideocodec_tpu/coder/__init__.py) binds via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBottom = 1u << 16;
constexpr int kPrecision = 16;  // CDF tables sum to 2^16

class RangeEncoder {
 public:
  explicit RangeEncoder(std::vector<uint8_t>* out)
      : low_(0), range_(0xFFFFFFFFu), out_(out) {}

  void Encode(uint32_t cum, uint32_t freq, uint32_t tot_bits) {
    range_ >>= tot_bits;
    low_ += cum * range_;
    range_ *= freq;
    Normalize();
  }

  // bypass bit with p=1/2
  void EncodeBit(uint32_t bit) {
    range_ >>= 1;
    if (bit) low_ += range_;
    Normalize();
  }

  void Flush() {
    for (int i = 0; i < 4; ++i) {
      out_->push_back(static_cast<uint8_t>(low_ >> 24));
      low_ <<= 8;
    }
  }

 private:
  void Normalize() {
    // carry-less normalization (Subbotin): emit bytes while the top byte is
    // settled or the range got too small.
    while ((low_ ^ (low_ + range_)) < kTop ||
           (range_ < kBottom && ((range_ = -low_ & (kBottom - 1)), true)) ) {
      out_->push_back(static_cast<uint8_t>(low_ >> 24));
      low_ <<= 8;
      range_ <<= 8;
    }
  }

  uint32_t low_;
  uint32_t range_;
  std::vector<uint8_t>* out_;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t size)
      : low_(0), range_(0xFFFFFFFFu), code_(0), data_(data), size_(size), pos_(0) {
    for (int i = 0; i < 4; ++i) code_ = (code_ << 8) | NextByte();
  }

  uint32_t DecodeFreq(uint32_t tot_bits) {
    range_ >>= tot_bits;
    return (code_ - low_) / range_;
  }

  void Decode(uint32_t cum, uint32_t freq) {
    low_ += cum * range_;
    range_ *= freq;
    Normalize();
  }

  uint32_t DecodeBit() {
    range_ >>= 1;
    uint32_t bit = (code_ - low_) >= range_;
    if (bit) low_ += range_;
    Normalize();
    return bit;
  }

 private:
  uint8_t NextByte() { return pos_ < size_ ? data_[pos_++] : 0; }

  void Normalize() {
    while ((low_ ^ (low_ + range_)) < kTop ||
           (range_ < kBottom && ((range_ = -low_ & (kBottom - 1)), true)) ) {
      code_ = (code_ << 8) | NextByte();
      low_ <<= 8;
      range_ <<= 8;
    }
  }

  uint32_t low_, range_, code_;
  const uint8_t* data_;
  size_t size_;
  size_t pos_;
};

void EncodeGolomb(RangeEncoder* enc, uint32_t v) {
  // Exp-Golomb via bypass bits: unary length prefix then raw bits.
  uint32_t n = v + 1;
  int nbits = 0;
  for (uint32_t t = n; t > 1; t >>= 1) ++nbits;
  for (int i = 0; i < nbits; ++i) enc->EncodeBit(0);
  enc->EncodeBit(1);
  for (int i = nbits - 1; i >= 0; --i) enc->EncodeBit((n >> i) & 1);
}

uint32_t DecodeGolomb(RangeDecoder* dec) {
  int nbits = 0;
  while (dec->DecodeBit() == 0) ++nbits;
  uint32_t n = 1;
  for (int i = 0; i < nbits; ++i) n = (n << 1) | dec->DecodeBit();
  return n - 1;
}

}  // namespace

extern "C" {

// symbols: integer latent values. indexes[i] selects the CDF row for symbol
// i. cdfs is [rows, stride] row-major cumulative tables summing to 2^16;
// cdf_lengths[r] counts valid cdf entries (= #symbols + 1); offsets[r] maps
// value -> table bucket (bucket = value - offset). Bucket cdf_lengths-2 is
// the escape bucket, followed by Exp-Golomb bypass of the overflow.
//
// Returns number of bytes written, or -1 if out_cap too small.
long rc_encode_with_indexes(
    const int32_t* symbols, const int32_t* indexes, long n,
    const uint32_t* cdfs, long cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, uint8_t* out, long out_cap) {
  std::vector<uint8_t> buf;
  buf.reserve(n / 2 + 64);
  RangeEncoder enc(&buf);
  for (long i = 0; i < n; ++i) {
    const int32_t r = indexes[i];
    const uint32_t* row = cdfs + r * cdf_stride;
    const int32_t num_buckets = cdf_lengths[r] - 1;  // symbols in table
    const int32_t max_bucket = num_buckets - 1;      // escape bucket
    int32_t bucket = symbols[i] - offsets[r];
    uint32_t overflow = 0;
    if (bucket < 0) {
      overflow = static_cast<uint32_t>(-2 * bucket - 1);
      bucket = max_bucket;
    } else if (bucket >= max_bucket) {
      overflow = static_cast<uint32_t>(2 * (bucket - max_bucket));
      bucket = max_bucket;
    }
    enc.Encode(row[bucket], row[bucket + 1] - row[bucket], kPrecision);
    if (bucket == max_bucket) EncodeGolomb(&enc, overflow);
  }
  enc.Flush();
  if (static_cast<long>(buf.size()) > out_cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<long>(buf.size());
}

long rc_decode_with_indexes(
    const uint8_t* data, long size, const int32_t* indexes, long n,
    const uint32_t* cdfs, long cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, int32_t* symbols) {
  RangeDecoder dec(data, static_cast<size_t>(size));
  for (long i = 0; i < n; ++i) {
    const int32_t r = indexes[i];
    const uint32_t* row = cdfs + r * cdf_stride;
    const int32_t num_buckets = cdf_lengths[r] - 1;
    const int32_t max_bucket = num_buckets - 1;
    const uint32_t f = dec.DecodeFreq(kPrecision);
    // binary search for bucket with row[b] <= f < row[b+1]
    int lo = 0, hi = num_buckets;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (row[mid] <= f) lo = mid; else hi = mid;
    }
    const int bucket = lo;
    dec.Decode(row[bucket], row[bucket + 1] - row[bucket]);
    int32_t value;
    if (bucket == max_bucket) {
      const uint32_t overflow = DecodeGolomb(&dec);
      if (overflow & 1) value = -static_cast<int32_t>((overflow + 1) >> 1);
      else value = max_bucket + static_cast<int32_t>(overflow >> 1);
    } else {
      value = bucket;
    }
    symbols[i] = value + offsets[r];
  }
  return n;
}

}  // extern "C"
