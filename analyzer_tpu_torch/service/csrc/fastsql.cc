// Columnar sqlite scanner + string-id hash join for SqlStore.load_stream.
//
// The pure-python bulk path (sql_store._sqlite_bulk) walks the table once
// PER COLUMN with group_concat and re-parses the concatenated text in
// numpy — measured 44.5 s for the 1M-match / 7.3M-participant fixture on
// this host (BASELINE.md round 3), single-core parse-bound. This scanner
// walks each query ONCE via the sqlite3 C API into C++ column buffers
// (no per-row Python, no text round-trip, no second sort pass for
// ORDER BY queries), exposed to Python behind an opaque handle; numpy
// arrays are filled by memcpy afterwards.
//
// sq_lookup is the companion join: load_stream maps participant/roster
// TEXT foreign keys to dense row indices, and numpy's S-dtype
// argsort+searchsorted costs ~4.3 s at the same scale — an FNV-1a
// open-addressing hash table over the raw fixed-width bytes does the
// same join in a few hundred ms.
//
// The sqlite3 C ABI has been stable since 2004; the runtime image ships
// libsqlite3.so.0 (the stdlib sqlite3 module links it) but no dev
// package, so the prototypes are declared here and resolved with dlopen
// at first use — no -lsqlite3 at build time, and glibc >= 2.34 folds
// dlopen into libc so the shared build command (native_build.py) needs
// no extra flags. The scanner opens the database READ-ONLY by path: it
// sees committed data only, like the python bulk path's second
// connection.

#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <string>
#include <vector>

typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
typedef int64_t i64;
typedef uint64_t u64;

namespace {

struct Api {
  int (*open_v2)(const char *, sqlite3 **, int, const char *);
  int (*prepare_v2)(sqlite3 *, const char *, int, sqlite3_stmt **,
                    const char **);
  int (*step)(sqlite3_stmt *);
  i64 (*column_int64)(sqlite3_stmt *, int);
  double (*column_double)(sqlite3_stmt *, int);
  const unsigned char *(*column_text)(sqlite3_stmt *, int);
  int (*column_bytes)(sqlite3_stmt *, int);
  int (*column_type)(sqlite3_stmt *, int);
  int (*column_count)(sqlite3_stmt *);
  int (*finalize)(sqlite3_stmt *);
  int (*close_db)(sqlite3 *);  // sqlite3_close
  const char *(*errmsg)(sqlite3 *);
  int (*busy_timeout)(sqlite3 *, int);
};

const int kOpenReadonly = 0x1;
const int kRow = 100;
const int kDone = 101;
const int kOk = 0;
const int kTypeNull = 5;
// How long a scan waits on a lock another connection holds (a service
// worker's commit or WAL checkpoint) before failing: the python store's
// own PRAGMA busy_timeout, so the native path gives way no sooner.
const int kBusyTimeoutMs = 30000;

// Column kinds, matching _native_sql.py's spec encoding.
const int kStr = 0;
const int kInt = 1;
const int kFloat = 2;

void fail(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s", msg);
  }
}

Api *api(char *err, int errlen) {
  static Api a;
  static int state = 0;  // 0 = untried, 1 = loaded, -1 = unavailable
  if (state == 0) {
    void *h = dlopen("libsqlite3.so.0", RTLD_NOW);
    if (!h) h = dlopen("libsqlite3.so", RTLD_NOW);
    if (!h) {
      state = -1;
    } else {
#define RESOLVE(field, sym)                   \
  a.field = (decltype(a.field))dlsym(h, sym); \
  if (!a.field) state = -1;
      RESOLVE(open_v2, "sqlite3_open_v2")
      RESOLVE(prepare_v2, "sqlite3_prepare_v2")
      RESOLVE(step, "sqlite3_step")
      RESOLVE(column_int64, "sqlite3_column_int64")
      RESOLVE(column_double, "sqlite3_column_double")
      RESOLVE(column_text, "sqlite3_column_text")
      RESOLVE(column_bytes, "sqlite3_column_bytes")
      RESOLVE(column_type, "sqlite3_column_type")
      RESOLVE(column_count, "sqlite3_column_count")
      RESOLVE(finalize, "sqlite3_finalize")
      RESOLVE(close_db, "sqlite3_close")
      RESOLVE(errmsg, "sqlite3_errmsg")
      RESOLVE(busy_timeout, "sqlite3_busy_timeout")
#undef RESOLVE
      if (state == 0) state = 1;
    }
  }
  if (state != 1) {
    fail(err, errlen, "libsqlite3 unavailable");
    return nullptr;
  }
  return &a;
}

struct ScanCol {
  int kind = kStr;
  std::vector<i64> ints;        // kInt
  std::vector<double> floats;   // kFloat
  std::string arena;            // kStr: concatenated bytes...
  std::vector<i64> offs{0};     // ...with nrows+1 offsets
  i64 maxlen = 0;
};

struct Scan {
  i64 nrows = 0;
  std::vector<ScanCol> cols;
};

}  // namespace

// Runs `sql` against the sqlite database at `path` (read-only), buffering
// every column in memory. Returns an opaque handle (free with
// sq_scan_free), or nullptr with `err` filled. NULL values follow the
// python bulk path's conventions: "" for strings, 0 for ints (sqlite's
// own NULL->0 coercion), NaN for floats.
extern "C" void *sq_scan_open(const char *path, const char *sql,
                              int32_t ncols, const int32_t *spec, char *err,
                              int errlen) {
  Api *q = api(err, errlen);
  if (!q) return nullptr;
  sqlite3 *db = nullptr;
  if (q->open_v2(path, &db, kOpenReadonly, nullptr) != kOk || !db) {
    fail(err, errlen, db ? q->errmsg(db) : "sqlite3_open_v2 failed");
    if (db) q->close_db(db);
    return nullptr;
  }
  q->busy_timeout(db, kBusyTimeoutMs);
  sqlite3_stmt *st = nullptr;
  if (q->prepare_v2(db, sql, -1, &st, nullptr) != kOk || !st) {
    fail(err, errlen, q->errmsg(db));
    if (st) q->finalize(st);
    q->close_db(db);
    return nullptr;
  }
  if (q->column_count(st) != ncols) {
    fail(err, errlen, "column count mismatch between SQL and spec");
    q->finalize(st);
    q->close_db(db);
    return nullptr;
  }
  Scan *s = new Scan;
  s->cols.resize(ncols);
  for (int c = 0; c < ncols; ++c) s->cols[c].kind = spec[c];
  int rc;
  while ((rc = q->step(st)) == kRow) {
    for (int c = 0; c < ncols; ++c) {
      ScanCol &col = s->cols[c];
      switch (col.kind) {
        case kInt:
          // sqlite coerces TEXT -> int here, matching the python path's
          // text parse; NULL reads as 0 (the COALESCE(col, 0) contract).
          col.ints.push_back(q->column_int64(st, c));
          break;
        case kFloat:
          col.floats.push_back(q->column_type(st, c) == kTypeNull
                                   ? NAN
                                   : q->column_double(st, c));
          break;
        default: {
          const unsigned char *txt = q->column_text(st, c);
          const i64 len = txt ? q->column_bytes(st, c) : 0;
          if (len > 0) col.arena.append((const char *)txt, (size_t)len);
          col.offs.push_back((i64)col.arena.size());
          if (len > col.maxlen) col.maxlen = len;
          break;
        }
      }
    }
    ++s->nrows;
  }
  if (rc != kDone) {
    fail(err, errlen, q->errmsg(db));
    q->finalize(st);
    q->close_db(db);
    delete s;
    return nullptr;
  }
  q->finalize(st);
  q->close_db(db);
  return s;
}

extern "C" i64 sq_scan_nrows(void *h) { return ((Scan *)h)->nrows; }

// Max byte length of a string column's values (its "S" dtype width).
extern "C" i64 sq_scan_width(void *h, int32_t col) {
  return ((Scan *)h)->cols[col].maxlen;
}

// Copies column `col` into a caller-allocated buffer: int64*/double* for
// int/float columns, or a fixed-width (`width` bytes, zero-padded)
// char buffer for string columns. Returns 0, or -1 on a too-small width.
extern "C" int32_t sq_scan_copy(void *h, int32_t col, void *buf, i64 width) {
  Scan *s = (Scan *)h;
  ScanCol &c = s->cols[col];
  switch (c.kind) {
    case kInt:
      memcpy(buf, c.ints.data(), sizeof(i64) * (size_t)s->nrows);
      return 0;
    case kFloat:
      memcpy(buf, c.floats.data(), sizeof(double) * (size_t)s->nrows);
      return 0;
    default: {
      if (width < c.maxlen) return -1;
      char *dst = (char *)buf;
      for (i64 r = 0; r < s->nrows; ++r) {
        const i64 len = c.offs[r + 1] - c.offs[r];
        if (len > 0) memcpy(dst, c.arena.data() + c.offs[r], (size_t)len);
        if (len < width) memset(dst + len, 0, (size_t)(width - len));
        dst += width;
      }
      return 0;
    }
  }
}

extern "C" void sq_scan_free(void *h) { delete (Scan *)h; }

namespace {

// Effective length of a fixed-width ("S" dtype) slot: numpy S-comparison
// ignores trailing NULs, so the join must too.
inline i64 efflen(const char *p, i64 width) {
  while (width > 0 && p[width - 1] == '\0') --width;
  return width;
}

inline u64 fnv1a(const char *p, i64 len) {
  u64 h = 1469598103934665603ull;
  for (i64 i = 0; i < len; ++i) {
    h ^= (u64)(unsigned char)p[i];
    h *= 1099511628211ull;
  }
  return h;
}

}  // namespace

// Occurrence index of each element within its key group, in arrival
// order: out[i] = #{j < i : keys[j] == keys[i]}. Keys must lie in
// [0, minlen) — enforced per element (an out-of-range key returns -2
// instead of corrupting the heap; the contract lived only in a Python
// docstring before). The numpy fallback needs a stable argsort +
// segmented arange (~1.2 s at 9M rows); this is one pass over a dense
// counter array. Returns 0, -1 when the counter allocation fails, or
// -2 on a key outside [0, minlen).
extern "C" int32_t sq_cumcount(const i64 *keys, i64 n, i64 minlen,
                               i64 *out) {
  std::vector<i64> cnt;
  try {
    cnt.assign((size_t)minlen, 0);
  } catch (...) {
    return -1;
  }
  for (i64 i = 0; i < n; ++i) {
    if ((u64)keys[i] >= (u64)minlen) return -2;
    out[i] = cnt[(size_t)keys[i]]++;
  }
  return 0;
}

// Hash join over fixed-width byte-string ids: for each of `nn` needles
// (width nw) find the index of the equal key among `nk` keys (width kw),
// writing it to out[i], or -1 when absent. Duplicate keys resolve to the
// SMALLEST key index (numpy stable argsort + searchsorted-left parity).
// Trailing NUL padding is ignored on both sides. Returns 0, or -1 when
// the table allocation fails.
extern "C" int32_t sq_lookup(const char *keys, i64 kw, i64 nk,
                             const char *needles, i64 nw, i64 nn,
                             i64 *out) {
  u64 cap = 16;
  while ((i64)cap < nk * 2 + 1) cap <<= 1;
  std::vector<i64> slots;
  try {
    slots.assign(cap, -1);
  } catch (...) {
    return -1;
  }
  const u64 mask = cap - 1;
  for (i64 k = 0; k < nk; ++k) {
    const char *kp = keys + k * kw;
    const i64 kl = efflen(kp, kw);
    u64 pos = fnv1a(kp, kl) & mask;
    for (;;) {
      i64 cur = slots[pos];
      if (cur < 0) {
        slots[pos] = k;
        break;
      }
      const char *cp = keys + cur * kw;
      const i64 cl = efflen(cp, kw);
      if (cl == kl && memcmp(cp, kp, (size_t)kl) == 0) {
        break;  // duplicate key: first (smallest) index wins
      }
      pos = (pos + 1) & mask;
    }
  }
  for (i64 i = 0; i < nn; ++i) {
    const char *np_ = needles + i * nw;
    const i64 nl = efflen(np_, nw);
    u64 pos = fnv1a(np_, nl) & mask;
    i64 found = -1;
    for (;;) {
      i64 cur = slots[pos];
      if (cur < 0) break;
      const char *cp = keys + cur * kw;
      const i64 cl = efflen(cp, kw);
      if (cl == nl && memcmp(cp, np_, (size_t)nl) == 0) {
        found = cur;
        break;
      }
      pos = (pos + 1) & mask;
    }
    out[i] = found;
  }
  return 0;
}
