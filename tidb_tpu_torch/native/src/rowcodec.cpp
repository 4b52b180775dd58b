// Native scan-decode kernel: rowcodec v2 rows -> columnar buffers.
//
// This is the framework's C++ runtime component for the host-side hot loop
// the reference executes in native code on the store side (TiKV, Rust:
// row decode feeding the coprocessor; in-repo semantics:
// pkg/util/rowcodec/decoder.go ChunkDecoder used at
// unistore/cophandler/cop_handler.go:424-467, value encodings
// rowcodec/encoder.go, decimal binary pkg/types/mydecimal.go FromBin,
// comparable float pkg/util/codec/float.go).
//
// One call decodes a whole region batch: for each row, parse the v2 header
// ([128][flags][notnull u16][null u16][ids][end-offsets][values]) once,
// binary-search each requested column id, and write fixed-width values
// (int64 bit-space), null flags, and string bytes into caller-allocated
// column-major buffers. Any malformed byte aborts the batch with an error
// code; the Python caller falls back to the row-at-a-time decoder.
//
// ABI kept C-plain (ctypes): no exceptions, no allocation, int return.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kDig2Bytes[10] = {0, 1, 1, 2, 2, 3, 3, 4, 4, 4};
constexpr int kDigitsPerWord = 9;
constexpr int kWordSize = 4;

// column classes (must match tidb_tpu/native/__init__.py)
enum Cls : uint8_t {
  CLS_INT = 0,      // signed compact LE
  CLS_UINT = 1,     // unsigned compact LE (also packed time, enum/set/bit)
  CLS_FLOAT = 2,    // comparable float64 (bitcast into the int64 slot)
  CLS_DECIMAL = 3,  // [prec][frac][bin] -> scaled int64 at col_scale
  CLS_STRING = 5,   // raw bytes -> per-column pool
  CLS_HANDLE = 7,   // from the handles array, not the row
};

inline int64_t read_int_le(const uint8_t* p, int64_t n) {
  switch (n) {
    case 1: return static_cast<int8_t>(p[0]);
    case 2: { int16_t v; std::memcpy(&v, p, 2); return v; }
    case 4: { int32_t v; std::memcpy(&v, p, 4); return v; }
    case 8: { int64_t v; std::memcpy(&v, p, 8); return v; }
    default: return INT64_MIN;  // signalled by caller via size check
  }
}

inline uint64_t read_uint_le(const uint8_t* p, int64_t n) {
  switch (n) {
    case 1: return p[0];
    case 2: { uint16_t v; std::memcpy(&v, p, 2); return v; }
    case 4: { uint32_t v; std::memcpy(&v, p, 4); return v; }
    case 8: { uint64_t v; std::memcpy(&v, p, 8); return v; }
    default: return 0;
  }
}

inline uint64_t read_be(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; i++) v = (v << 8) | p[i];
  return v;
}

inline double decode_float_cmp(const uint8_t* p) {
  uint64_t u = read_be(p, 8);
  if (u & 0x8000000000000000ULL) {
    u &= 0x7FFFFFFFFFFFFFFFULL;
  } else {
    u = ~u;
  }
  double d;
  std::memcpy(&d, &u, 8);
  return d;
}

const int64_t kPow10[19] = {
    1LL, 10LL, 100LL, 1000LL, 10000LL, 100000LL, 1000000LL, 10000000LL,
    100000000LL, 1000000000LL, 10000000000LL, 100000000000LL,
    1000000000000LL, 10000000000000LL, 100000000000000LL,
    1000000000000000LL, 10000000000000000LL, 100000000000000000LL,
    1000000000000000000LL};

// Decode MySQL binary decimal at `p` (after the [prec][frac] header) into a
// scaled int64 at target_scale. Returns false on malformed input.
bool decode_decimal_bin(const uint8_t* p, int64_t avail, int prec, int frac,
                        int target_scale, int64_t* out) {
  if (prec <= 0 || frac < 0 || frac > prec) return false;
  const int int_digits = prec - frac;
  const int leading = int_digits % kDigitsPerWord;
  const int trailing = frac % kDigitsPerWord;
  const int size = kDig2Bytes[leading] + (int_digits / kDigitsPerWord) * kWordSize +
                   (frac / kDigitsPerWord) * kWordSize + kDig2Bytes[trailing];
  if (size <= 0 || size > avail || size > 64) return false;
  uint8_t buf[64];
  std::memcpy(buf, p, size);
  const bool neg = !(buf[0] & 0x80);
  buf[0] ^= 0x80;
  if (neg)
    for (int i = 0; i < size; i++) buf[i] ^= 0xFF;

  __int128 intpart = 0, fracpart = 0;
  int cur = 0;
  if (leading) {
    intpart = read_be(buf + cur, kDig2Bytes[leading]);
    cur += kDig2Bytes[leading];
  }
  for (int w = 0; w < int_digits / kDigitsPerWord; w++) {
    intpart = intpart * 1000000000 + read_be(buf + cur, kWordSize);
    cur += kWordSize;
  }
  int frac_digits = 0;
  for (int w = 0; w < frac / kDigitsPerWord; w++) {
    fracpart = fracpart * 1000000000 + read_be(buf + cur, kWordSize);
    cur += kWordSize;
    frac_digits += kDigitsPerWord;
  }
  if (trailing) {
    uint64_t t = read_be(buf + cur, kDig2Bytes[trailing]);
    fracpart = fracpart * kPow10[trailing] + t;
    frac_digits += trailing;
  }
  // kPow10 covers exponents 0..18 (int64-scaled values cannot exceed that
  // anyway); wider MySQL scales fall back to the Python decoder
  if (frac_digits > 18 || target_scale > 18 ||
      (target_scale > frac_digits && target_scale - frac_digits > 18) ||
      (frac_digits > target_scale && frac_digits - target_scale > 18))
    return false;
  // value = intpart.fracpart ; scale to target_scale with round-half-away
  __int128 scaled;
  if (target_scale >= frac_digits) {
    scaled = (intpart * kPow10[frac_digits] + fracpart);
    scaled *= kPow10[target_scale - frac_digits];
  } else {
    __int128 full = intpart * kPow10[frac_digits] + fracpart;
    __int128 div = kPow10[frac_digits - target_scale];
    __int128 q = full / div, r = full % div;
    if (2 * r >= div) q += 1;
    scaled = q;
  }
  if (neg) scaled = -scaled;
  *out = static_cast<int64_t>(scaled);
  return true;
}

struct RowHeader {
  bool large;
  int n_notnull, n_null;
  const uint8_t* ids;
  const uint8_t* offs;
  const uint8_t* data;
  int64_t data_len;
};

inline bool parse_header(const uint8_t* b, int64_t len, RowHeader* h) {
  if (len < 6 || b[0] != 128) return false;
  h->large = (b[1] & 1) != 0;
  h->n_notnull = b[2] | (b[3] << 8);
  h->n_null = b[4] | (b[5] << 8);
  const int id_sz = h->large ? 4 : 1;
  const int off_sz = h->large ? 4 : 2;
  const int64_t ids_off = 6;
  const int64_t offs_off = ids_off + (int64_t)(h->n_notnull + h->n_null) * id_sz;
  const int64_t data_off = offs_off + (int64_t)h->n_notnull * off_sz;
  if (data_off > len) return false;
  h->ids = b + ids_off;
  h->offs = b + offs_off;
  h->data = b + data_off;
  h->data_len = len - data_off;
  return true;
}

inline int64_t id_at(const RowHeader& h, int i) {
  if (h.large) {
    uint32_t v;
    std::memcpy(&v, h.ids + 4 * i, 4);
    return v;
  }
  return h.ids[i];
}

inline int64_t end_off(const RowHeader& h, int i) {
  if (h.large) {
    uint32_t v;
    std::memcpy(&v, h.offs + 4 * i, 4);
    return v;
  }
  uint16_t v;
  std::memcpy(&v, h.offs + 2 * i, 2);
  return v;
}

// -1: null/absent; -2: malformed; >=0: value found, sets *start/*vlen
inline int find_value(const RowHeader& h, int64_t col_id, int64_t* start, int64_t* vlen) {
  int lo = 0, hi = h.n_notnull;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    int64_t cid = id_at(h, mid);
    if (cid < col_id) lo = mid + 1;
    else if (cid > col_id) hi = mid;
    else {
      int64_t s = mid ? end_off(h, mid - 1) : 0;
      int64_t e = end_off(h, mid);
      if (s < 0 || e < s || e > h.data_len) return -2;
      *start = s;
      *vlen = e - s;
      return 0;
    }
  }
  return -1;  // null or absent (both decode as NULL)
}

}  // namespace

extern "C" {

// Returns 0 on success; <0 on the first malformed row (caller falls back).
// Layouts: out_fixed/out_null/out_len are column-major [n_cols][n_rows];
// str_pool is [n_cols][pool_stride] — column c's string bytes append from
// str_pool + c*pool_stride, lengths recorded in out_len.
// col_pool[c] is the pool-row index for string columns (-1 otherwise), so
// the pool only needs one stride per STRING column, not per column.
int tt_decode_rows(const uint8_t* blob, const int64_t* row_offs, int64_t n_rows,
                   const int64_t* handles, const int64_t* col_ids,
                   const uint8_t* col_cls, const int32_t* col_scale,
                   const int32_t* col_pool, int64_t n_cols, int64_t* out_fixed,
                   uint8_t* out_null, int64_t* out_len, uint8_t* str_pool,
                   int64_t pool_stride) {
  // per-column string write cursors (stack cap: plenty for any schema)
  int64_t str_cur[256];
  if (n_cols > 256) return -100;
  for (int64_t c = 0; c < n_cols; c++) str_cur[c] = 0;

  for (int64_t r = 0; r < n_rows; r++) {
    const uint8_t* row = blob + row_offs[r];
    const int64_t row_len = row_offs[r + 1] - row_offs[r];
    RowHeader h;
    if (!parse_header(row, row_len, &h)) return -1;
    for (int64_t c = 0; c < n_cols; c++) {
      int64_t* slot = out_fixed + c * n_rows + r;
      uint8_t* nul = out_null + c * n_rows + r;
      int64_t* slen = out_len + c * n_rows + r;
      *slen = 0;
      const uint8_t cls = col_cls[c];
      if (cls == CLS_HANDLE) {
        *slot = handles[r];
        *nul = 0;
        continue;
      }
      int64_t start = 0, vlen = 0;
      int rc = find_value(h, col_ids[c], &start, &vlen);
      if (rc == -2) return -2;
      if (rc < 0) {
        *slot = 0;
        *nul = 1;
        continue;
      }
      const uint8_t* v = h.data + start;
      *nul = 0;
      switch (cls) {
        case CLS_INT: {
          if (vlen != 1 && vlen != 2 && vlen != 4 && vlen != 8) return -3;
          *slot = read_int_le(v, vlen);
          break;
        }
        case CLS_UINT: {
          if (vlen != 1 && vlen != 2 && vlen != 4 && vlen != 8) return -3;
          uint64_t u = read_uint_le(v, vlen);
          std::memcpy(slot, &u, 8);
          break;
        }
        case CLS_FLOAT: {
          if (vlen != 8) return -4;
          double d = decode_float_cmp(v);
          std::memcpy(slot, &d, 8);
          break;
        }
        case CLS_DECIMAL: {
          if (vlen < 3) return -5;
          int prec = v[0], frac = v[1];
          int64_t out;
          if (!decode_decimal_bin(v + 2, vlen - 2, prec, frac, col_scale[c], &out))
            return -5;
          *slot = out;
          break;
        }
        case CLS_STRING: {
          const int32_t pr = col_pool[c];
          if (pr < 0 || str_cur[c] + vlen > pool_stride) return -6;
          std::memcpy(str_pool + (int64_t)pr * pool_stride + str_cur[c], v, vlen);
          str_cur[c] += vlen;
          *slen = vlen;
          *slot = 0;
          break;
        }
        default:
          return -7;
      }
    }
  }
  return 0;
}

int tt_version() { return 2; }

}  // extern "C"
