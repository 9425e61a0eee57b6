// Native zero-copy response codec for the serve front door.
//
// Encodes the four hot /v1/* response shapes (ratings, leaderboard,
// winprob, tiers) straight from the engine's numpy result slabs into a
// caller-provided reusable output arena — no per-response python dict
// walk, no intermediate str objects, one memcpy-free pass per body.
//
// The byte contract (docs/serving.md "Front door"): output is
// BIT-IDENTICAL to ``json.dumps(obj, sort_keys=True) + "\n"`` on the
// python response dict. That pins three sub-contracts:
//
//   * float formatting reproduces CPython's ``repr(float)`` — the
//     SHORTEST decimal string that round-trips to the same double,
//     rendered fixed for decimal exponents in (-4, 16] and scientific
//     ("1e+16", two-digit signed exponent) outside. Older libstdc++
//     (GCC 10) has no floating-point std::to_chars, so the shortest
//     digits come from a binary search over printf precision
//     with a strtod round-trip check: both sides of that probe are
//     correctly rounded (ties-to-even) per IEEE-754, which is the same
//     choice CPython's dtoa makes, so the digit strings agree. A small
//     thread-local direct-mapped cache short-circuits repeated values
//     (padded ratings pages repeat ids; seed columns repeat per tier).
//   * string escaping matches ensure_ascii=True: `"` `\` named control
//     escapes, \u00xx for other C0 bytes, \uxxxx (lowercase hex,
//     surrogate pairs above the BMP) for everything non-ASCII.
//   * key order is the sorted order json.dumps(sort_keys=True) emits,
//     baked per shape.
//
// Non-finite floats return an error instead of bytes: JSON has no
// NaN/Infinity, the engine never produces them (unrated rows are
// null), and silently emitting python-style "NaN" would hand every
// client a parse error — the NaN/inf-free guarantee is differential-
// pinned in tests/test_torch_frontdoor.py.
//
// Return convention (all encoders): bytes written into `out`, or
//   -1  output arena too small (caller grows and retries),
//   -2  non-finite float in the payload,
//   -3  invalid UTF-8 in a string slab.
//
// Built with g++ into analyzer_tpu_torch/_build/ at its first use by
// serve/_native_json.py (ctypes; never at import), the pattern of
// io/_native_csv.py; ImportError on any failure routes the caller to the
// counted python json.dumps fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// ---------------------------------------------------------------------
// CPython-repr double formatting.

struct ReprCacheEntry {
  uint64_t bits;
  uint8_t len;  // 0 = empty slot
  char txt[25];
};

constexpr int kCacheSlots = 4096;  // direct-mapped, per thread (no races)
thread_local ReprCacheEntry g_repr_cache[kCacheSlots];

// Shortest scientific digits: the smallest precision p in [1, 17] whose
// correctly-rounded "%.*e" rendering parses back to exactly v. The
// round-trip property is monotone in p (more digits never parse
// farther from v), so binary search is sound.
inline int shortest_sci(double v, char* buf, size_t bufsz) {
  int lo = 1, hi = 17;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    snprintf(buf, bufsz, "%.*e", mid - 1, v);
    if (strtod(buf, nullptr) == v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return snprintf(buf, bufsz, "%.*e", lo - 1, v);
}

// repr(float) bytes for a FINITE v into out (>= 25 bytes). Returns the
// length. The scientific rendering is re-shaped to CPython's rule:
// fixed notation for decimal point positions in (-4, 16], scientific
// with a signed two-digit-minimum exponent otherwise.
inline int repr_double_uncached(double v, char* out) {
  char buf[48];
  shortest_sci(v, buf, sizeof buf);
  const char* p = buf;
  char* w = out;
  if (*p == '-') {
    *w++ = '-';
    ++p;
  }
  // Mantissa digits: first digit, optional separator (locale byte —
  // rendered back as '.') and more digits, then 'e'.
  char digits[24];
  int nd = 0;
  digits[nd++] = *p++;
  if (*p != 'e' && *p != 'E') {
    ++p;  // decimal separator, whatever the locale made it
    while (*p != 'e' && *p != 'E' && *p != '\0') digits[nd++] = *p++;
  }
  ++p;  // 'e'
  int esign = (*p == '-') ? -1 : 1;
  ++p;  // exponent sign (printf always emits one)
  int e10 = 0;
  while (*p >= '0' && *p <= '9') e10 = e10 * 10 + (*p++ - '0');
  e10 *= esign;
  int decpt = e10 + 1;  // v = 0.digits * 10^decpt
  if (-4 < decpt && decpt <= 16) {
    if (decpt <= 0) {
      *w++ = '0';
      *w++ = '.';
      for (int i = 0; i < -decpt; ++i) *w++ = '0';
      memcpy(w, digits, nd);
      w += nd;
    } else if (decpt >= nd) {
      memcpy(w, digits, nd);
      w += nd;
      for (int i = 0; i < decpt - nd; ++i) *w++ = '0';
      *w++ = '.';
      *w++ = '0';
    } else {
      memcpy(w, digits, decpt);
      w += decpt;
      *w++ = '.';
      memcpy(w, digits + decpt, nd - decpt);
      w += nd - decpt;
    }
  } else {
    *w++ = digits[0];
    if (nd > 1) {
      *w++ = '.';
      memcpy(w, digits + 1, nd - 1);
      w += nd - 1;
    }
    *w++ = 'e';
    *w++ = (e10 < 0) ? '-' : '+';
    int mag = (e10 < 0) ? -e10 : e10;
    char ebuf[8];
    int en = 0;
    do {
      ebuf[en++] = static_cast<char>('0' + mag % 10);
      mag /= 10;
    } while (mag);
    if (en < 2) ebuf[en++] = '0';  // repr pads the exponent to 2 digits
    while (en) *w++ = ebuf[--en];
  }
  return static_cast<int>(w - out);
}

// Cached repr: returns length, or -2 for non-finite v.
inline int repr_double(double v, char* out) {
  uint64_t bits;
  memcpy(&bits, &v, sizeof bits);
  if ((bits & 0x7ff0000000000000ULL) == 0x7ff0000000000000ULL) {
    return -2;  // inf / nan — JSON-hostile, the engine never emits them
  }
  uint64_t h = bits * 0x9e3779b97f4a7c15ULL;
  ReprCacheEntry& e = g_repr_cache[(h >> 40) & (kCacheSlots - 1)];
  if (e.len != 0 && e.bits == bits) {
    memcpy(out, e.txt, e.len);
    return e.len;
  }
  int n = repr_double_uncached(v, out);
  if (n > 0 && n <= static_cast<int>(sizeof e.txt)) {
    e.bits = bits;
    memcpy(e.txt, out, n);
    e.len = static_cast<uint8_t>(n);
  }
  return n;
}

// ---------------------------------------------------------------------
// Output writer over the caller's arena.

struct Writer {
  char* out;
  int64_t cap;
  int64_t n = 0;
  int err = 0;  // sticky: -1 overflow, -2 non-finite, -3 bad utf-8

  explicit Writer(char* o, int64_t c) : out(o), cap(c) {}

  inline void byte(char c) {
    if (n >= cap) {
      err = err ? err : -1;
      return;
    }
    out[n++] = c;
  }

  inline void raw(const char* s, int64_t len) {
    if (n + len > cap) {
      err = err ? err : -1;
      n = cap;
      return;
    }
    memcpy(out + n, s, len);
    n += len;
  }

  inline void lit(const char* s) { raw(s, static_cast<int64_t>(strlen(s))); }

  inline void num_f64(double v) {
    char buf[32];
    int len = repr_double(v, buf);
    if (len < 0) {
      err = err ? err : len;
      return;
    }
    raw(buf, len);
  }

  inline void num_i64(int64_t v) {
    char buf[24];
    char* w = buf + sizeof buf;
    uint64_t mag = (v < 0) ? 0 - static_cast<uint64_t>(v)
                           : static_cast<uint64_t>(v);
    do {
      *--w = static_cast<char>('0' + mag % 10);
      mag /= 10;
    } while (mag);
    if (v < 0) *--w = '-';
    raw(w, buf + sizeof buf - w);
  }

  inline void hex4(uint32_t cp) {
    static const char* kHex = "0123456789abcdef";  // json.dumps lowercase
    byte('\\');
    byte('u');
    byte(kHex[(cp >> 12) & 0xf]);
    byte(kHex[(cp >> 8) & 0xf]);
    byte(kHex[(cp >> 4) & 0xf]);
    byte(kHex[cp & 0xf]);
  }

  // One JSON string from UTF-8 bytes, ensure_ascii semantics.
  void str(const char* s, int64_t len) {
    byte('"');
    int64_t i = 0;
    while (i < len) {
      unsigned char c = static_cast<unsigned char>(s[i]);
      if (c < 0x80) {
        switch (c) {
          case '"': lit("\\\""); break;
          case '\\': lit("\\\\"); break;
          case '\b': lit("\\b"); break;
          case '\t': lit("\\t"); break;
          case '\n': lit("\\n"); break;
          case '\f': lit("\\f"); break;
          case '\r': lit("\\r"); break;
          default:
            if (c < 0x20) {
              hex4(c);
            } else {
              byte(static_cast<char>(c));
            }
        }
        ++i;
        continue;
      }
      // Multi-byte UTF-8 -> codepoint -> \uxxxx (+ surrogate pair).
      int extra;
      uint32_t cp;
      if ((c & 0xe0) == 0xc0) {
        extra = 1;
        cp = c & 0x1f;
      } else if ((c & 0xf0) == 0xe0) {
        extra = 2;
        cp = c & 0x0f;
      } else if ((c & 0xf8) == 0xf0) {
        extra = 3;
        cp = c & 0x07;
      } else {
        err = err ? err : -3;
        return;
      }
      if (i + extra >= len) {
        err = err ? err : -3;
        return;
      }
      for (int k = 1; k <= extra; ++k) {
        unsigned char cc = static_cast<unsigned char>(s[i + k]);
        if ((cc & 0xc0) != 0x80) {
          err = err ? err : -3;
          return;
        }
        cp = (cp << 6) | (cc & 0x3f);
      }
      i += extra + 1;
      if (cp > 0x10ffff) {
        err = err ? err : -3;
        return;
      }
      if (cp >= 0x10000) {
        cp -= 0x10000;
        hex4(0xd800 + (cp >> 10));
        hex4(0xdc00 + (cp & 0x3ff));
      } else {
        hex4(cp);
      }
    }
    byte('"');
  }

  inline int64_t finish() {
    if (err) return err;
    byte('\n');  // json_body's trailing newline — part of the contract
    return err ? err : n;
  }
};

}  // namespace

extern "C" {

// repr(float) probe surface: writes CPython's repr of v into out
// (>= 32 bytes), returns the length or -2 for non-finite v. The
// differential parity tests drive this directly.
int64_t fj_repr_double(double v, char* out) {
  int n = repr_double(v, out);
  return static_cast<int64_t>(n);
}

// {"ratings": [entry...], "unknown": [id...], "version": V}
// entry = {"conservative": f|null, "id": s, "mu": f|null, "rated": b,
//          "seed_mu": f, "seed_sigma": f, "sigma": f|null}
// ids/unknown arrive as one UTF-8 blob + (n+1)/(n_unknown+1) offsets;
// vals is [n, 5] float64: mu, sigma, conservative, seed_mu, seed_sigma
// (rows with rated=0 read only the seed columns).
int64_t fj_encode_ratings(int64_t n, const char* ids_blob,
                          const int64_t* ids_off, const uint8_t* rated,
                          const double* vals, int64_t n_unknown,
                          const char* unk_blob, const int64_t* unk_off,
                          int64_t version, char* out, int64_t cap) {
  Writer w(out, cap);
  w.lit("{\"ratings\": [");
  for (int64_t i = 0; i < n; ++i) {
    if (i) w.lit(", ");
    const double* row = vals + i * 5;
    w.lit("{\"conservative\": ");
    if (rated[i]) {
      w.num_f64(row[2]);
    } else {
      w.lit("null");
    }
    w.lit(", \"id\": ");
    w.str(ids_blob + ids_off[i], ids_off[i + 1] - ids_off[i]);
    w.lit(", \"mu\": ");
    if (rated[i]) {
      w.num_f64(row[0]);
    } else {
      w.lit("null");
    }
    w.lit(rated[i] ? ", \"rated\": true" : ", \"rated\": false");
    w.lit(", \"seed_mu\": ");
    w.num_f64(row[3]);
    w.lit(", \"seed_sigma\": ");
    w.num_f64(row[4]);
    w.lit(", \"sigma\": ");
    if (rated[i]) {
      w.num_f64(row[1]);
    } else {
      w.lit("null");
    }
    w.byte('}');
  }
  w.lit("], \"unknown\": [");
  for (int64_t i = 0; i < n_unknown; ++i) {
    if (i) w.lit(", ");
    w.str(unk_blob + unk_off[i], unk_off[i + 1] - unk_off[i]);
  }
  w.lit("], \"version\": ");
  w.num_i64(version);
  w.byte('}');
  return w.finish();
}

// {"leaders": [{"conservative": f, "id": s, "mu": f, "rank": N,
//               "sigma": f}...], "version": V}
// vals is [n, 3] float64: mu, sigma, conservative; ranks int64[n].
int64_t fj_encode_leaderboard(int64_t n, const int64_t* ranks,
                              const char* ids_blob, const int64_t* ids_off,
                              const double* vals, int64_t version, char* out,
                              int64_t cap) {
  Writer w(out, cap);
  w.lit("{\"leaders\": [");
  for (int64_t i = 0; i < n; ++i) {
    if (i) w.lit(", ");
    const double* row = vals + i * 3;
    w.lit("{\"conservative\": ");
    w.num_f64(row[2]);
    w.lit(", \"id\": ");
    w.str(ids_blob + ids_off[i], ids_off[i + 1] - ids_off[i]);
    w.lit(", \"mu\": ");
    w.num_f64(row[0]);
    w.lit(", \"rank\": ");
    w.num_i64(ranks[i]);
    w.lit(", \"sigma\": ");
    w.num_f64(row[1]);
    w.byte('}');
  }
  w.lit("], \"version\": ");
  w.num_i64(version);
  w.byte('}');
  return w.finish();
}

// {"p_a": f, "quality": f, "version": V}
int64_t fj_encode_winprob(double p_a, double quality, int64_t version,
                          char* out, int64_t cap) {
  Writer w(out, cap);
  w.lit("{\"p_a\": ");
  w.num_f64(p_a);
  w.lit(", \"quality\": ");
  w.num_f64(quality);
  w.lit(", \"version\": ");
  w.num_i64(version);
  w.byte('}');
  return w.finish();
}

// Without score (has_score=0):
//   {"counts": [...], "edges": [...], "rated": N, "version": V}
// With score (the /v1/tiers?score= merge):
//   {"below": N, "counts": [...], "edges": [...], "percentile": f|null,
//    "rated": N, "score": f, "version": V}
// has_pct=0 renders percentile as null (rated == 0).
int64_t fj_encode_tiers(const double* edges, int64_t n_edges,
                        const int64_t* counts, int64_t n_counts,
                        int64_t rated, int64_t version, int32_t has_score,
                        double score, int64_t below, int32_t has_pct,
                        double percentile, char* out, int64_t cap) {
  Writer w(out, cap);
  w.byte('{');
  if (has_score) {
    w.lit("\"below\": ");
    w.num_i64(below);
    w.lit(", ");
  }
  w.lit("\"counts\": [");
  for (int64_t i = 0; i < n_counts; ++i) {
    if (i) w.lit(", ");
    w.num_i64(counts[i]);
  }
  w.lit("], \"edges\": [");
  for (int64_t i = 0; i < n_edges; ++i) {
    if (i) w.lit(", ");
    w.num_f64(edges[i]);
  }
  w.lit("], ");
  if (has_score) {
    w.lit("\"percentile\": ");
    if (has_pct) {
      w.num_f64(percentile);
    } else {
      w.lit("null");
    }
    w.lit(", ");
  }
  w.lit("\"rated\": ");
  w.num_i64(rated);
  if (has_score) {
    w.lit(", \"score\": ");
    w.num_f64(score);
  }
  w.lit(", \"version\": ");
  w.num_i64(version);
  w.byte('}');
  return w.finish();
}

}  // extern "C"
