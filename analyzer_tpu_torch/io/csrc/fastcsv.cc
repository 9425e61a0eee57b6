// Native CSV match-stream parser — the host-side data loader.
//
// The python csv module parses the 10M-match interchange file in minutes
// (~13 s per 1M rows); this single-pass scanner does it in under a second
// per million. Format is csv_codec.py's writer output:
//
//   match_id,mode,winner,afk,team0,team1\r?\n
//
// with team columns ';'-joined player ids, an optional header line, and
// rows already in chronological order (the reference's ORDER BY
// created_at ASC contract, worker.py:176). Mode names arrive as a
// '\n'-joined candidate list so the mapping stays owned by
// core/constants.py — unknown names map to -1 (UNSUPPORTED_MODE_ID),
// which the python side carries through like the reference's
// log-and-skip (rater.py:83-85).
//
// Two entry points share one row grammar:
//
//   * parse_stream_csv — the whole-file two-pass loader (probe then
//     exact-width decode), unchanged ABI since it landed;
//   * parse_csv_window — the WIRE-SPEED INGEST entry (io/ingest.py):
//     decodes up to cap_rows rows starting at *cursor into
//     caller-provided fixed-width column slabs (the pinned staging
//     arena's reusable buffers, sched/feed.py) and advances *cursor,
//     so a stream decodes window by window through a few slabs instead
//     of one giant allocation, and each window can H2D while the next
//     decodes.
//
// The port's copy of analyzer_tpu/io/fastcsv.cc (the same code). Built
// with g++ at first use by io/_native_csv.py into analyzer_tpu_torch/_build/
// (native_build.build_and_load) and loaded with ctypes, never at import.
// Returns rows parsed, or -(1+row) on a
// malformed row so the caller can fall back to the permissive python
// parser (quoted fields etc.).

#include <cstdint>
#include <cstring>

namespace {

// Parses a non-negative integer, advancing *p. Returns -1 if no digits
// or the value exceeds INT32_MAX — ids wrap to negative in the int32
// output and would silently read as empty padding slots downstream,
// where the python parser raises OverflowError; rejecting here routes
// corrupt data to that loud path.
inline int64_t parse_uint(const char** p, const char* end) {
  const char* s = *p;
  int64_t v = 0;
  bool any = false;
  while (s < end && *s >= '0' && *s <= '9') {
    v = v * 10 + (*s - '0');
    if (v > INT32_MAX) {  // also bounds the digit run before int64 overflow
      while (s < end && *s >= '0' && *s <= '9') ++s;
      *p = s;
      return -1;
    }
    ++s;
    any = true;
  }
  *p = s;
  return any ? v : -1;
}

struct ModeTable {
  const char* ptr[64];
  int64_t len[64];
  int64_t n;
};

inline ModeTable split_modes(const char* modes, int64_t n_modes) {
  ModeTable mt;
  const char* m = modes;
  const char* mend = modes + std::strlen(modes);
  int64_t k = 0;
  while (m < mend && k < n_modes && k < 64) {
    const char* nl = static_cast<const char*>(
        std::memchr(m, '\n', static_cast<size_t>(mend - m)));
    if (!nl) nl = mend;
    mt.ptr[k] = m;
    mt.len[k] = nl - m;
    ++k;
    m = nl + 1;
  }
  mt.n = k;
  return mt;
}

// One row of the writer's grammar. Advances *pp past the row's newline;
// returns 0 on success, -1 malformed (*pp position is undefined then —
// callers report the row index and stop). Output pointers may be null
// (probe mode). `out` is the row's [2, max_team] player block; unused
// slots are filled with -1 so a reused slab needs no host-side reset.
inline int parse_row(const char** pp, const char* end, const ModeTable& mt,
                     int64_t max_team, int32_t* out, int32_t* w_out,
                     int32_t* m_out, uint8_t* a_out, int64_t* tmax) {
  const char* p = *pp;
  // field 0: match_id (ignored)
  const char* c = static_cast<const char*>(
      std::memchr(p, ',', static_cast<size_t>(end - p)));
  if (!c) return -1;
  p = c + 1;
  // field 1: mode name
  c = static_cast<const char*>(
      std::memchr(p, ',', static_cast<size_t>(end - p)));
  if (!c) return -1;
  int32_t mid = -1;
  for (int64_t k = 0; k < mt.n; ++k) {
    if (mt.len[k] == c - p && std::memcmp(mt.ptr[k], p, mt.len[k]) == 0) {
      mid = static_cast<int32_t>(k);
      break;
    }
  }
  if (m_out) *m_out = mid;
  p = c + 1;
  // field 2: winner (0/1)
  int64_t w = parse_uint(&p, end);
  if (w < 0 || p >= end || *p != ',') return -1;
  if (w_out) *w_out = static_cast<int32_t>(w);
  ++p;
  // field 3: afk (0/1)
  int64_t a = parse_uint(&p, end);
  if (a < 0 || p >= end || *p != ',') return -1;
  if (a_out) *a_out = static_cast<uint8_t>(a != 0);
  ++p;
  // fields 4-5: team id lists
  for (int team = 0; team < 2; ++team) {
    int32_t* slots = out ? out + team * max_team : nullptr;
    int64_t slot = 0;
    const char sep_end = team == 0 ? ',' : '\n';
    if (p < end && *p != sep_end && *p != '\r') {
      while (true) {
        int64_t id = parse_uint(&p, end);
        if (id < 0) return -1;
        if (slot >= max_team) return -1;
        if (slots) slots[slot] = static_cast<int32_t>(id);
        ++slot;
        if (p < end && *p == ';') {
          ++p;
          continue;
        }
        break;
      }
    }
    if (slots) {
      for (int64_t s = slot; s < max_team; ++s) slots[s] = -1;
    }
    if (slot > *tmax) *tmax = slot;
    if (team == 0) {
      if (p >= end || *p != ',') return -1;
      ++p;
    } else {
      if (p < end && *p == '\r') ++p;
      if (p < end) {
        if (*p != '\n') return -1;
        ++p;
      }
    }
  }
  *pp = p;
  return 0;
}

inline const char* skip_header(const char* p, const char* end) {
  if (end - p >= 8 && std::strncmp(p, "match_id", 8) == 0) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!nl) return end;
    return nl + 1;
  }
  return p;
}

}  // namespace

extern "C" {

// player_idx [cap_rows, 2, max_team] need not arrive prefilled: unused
// team slots are written -1 by the scanner. out_tmax receives the widest
// team seen. Returns rows parsed (>= 0) or -(row + 1) of the first
// malformed row.
//
// PROBE MODE: passing NULL output arrays (player_idx/winner/mode_id/afk)
// runs the same grammar scan without writing — callers use it as a first
// pass to learn (rows, tmax) and allocate exactly, instead of paying a
// worst-case-width buffer (e.g. ~1.3 GB at 10M rows x 16 team slots).
int64_t parse_stream_csv(const char* buf, int64_t len, const char* modes,
                         int64_t n_modes, int64_t max_team, int64_t cap_rows,
                         int32_t* player_idx, int32_t* winner,
                         int32_t* mode_id, uint8_t* afk, int64_t* out_tmax) {
  const ModeTable mt = split_modes(modes, n_modes);
  const char* p = buf;
  const char* end = buf + len;
  if (len >= 8) p = skip_header(p, end);

  int64_t row = 0;
  int64_t tmax = 1;
  while (p < end) {
    if (*p == '\n' || *p == '\r') {  // blank/trailing line
      ++p;
      continue;
    }
    if (row >= cap_rows) return -(row + 1);
    int32_t* out = player_idx ? player_idx + row * 2 * max_team : nullptr;
    if (parse_row(&p, end, mt, max_team, out,
                  winner ? winner + row : nullptr,
                  mode_id ? mode_id + row : nullptr,
                  afk ? afk + row : nullptr, &tmax) != 0) {
      return -(row + 1);
    }
    ++row;
  }
  *out_tmax = tmax;
  return row;
}

// Windowed streaming decode — the ingest plane's entry (docs/ingest.md).
// Parses up to cap_rows rows starting at byte *cursor into the caller's
// FIXED-WIDTH column slabs (player_idx [cap_rows, 2, max_team], winner/
// mode_id [cap_rows], afk [cap_rows] — the reusable pinned staging
// buffers), writes -1 into unused team slots itself (a reused slab needs
// no reset), advances *cursor to the first unconsumed byte, and returns
// the rows decoded. 0 means end of stream. A malformed row ENDS the
// window early: the valid prefix is returned (those rows are real work)
// with *cursor left at the offending row's first byte, so the next call
// sees the bad row first and returns -1 — the caller attributes the
// poison to an absolute row index and routes the remaining bytes to the
// permissive python parser without losing the prefix.
// The optional header line is consumed only when *cursor == 0.
// out_tmax receives the widest team seen IN THIS WINDOW (floor 0).
int64_t parse_csv_window(const char* buf, int64_t len, const char* modes,
                         int64_t n_modes, int64_t max_team, int64_t cap_rows,
                         int64_t* cursor, int32_t* player_idx,
                         int32_t* winner, int32_t* mode_id, uint8_t* afk,
                         int64_t* out_tmax) {
  const ModeTable mt = split_modes(modes, n_modes);
  const char* end = buf + len;
  const char* p = buf + *cursor;
  if (*cursor == 0 && len >= 8) p = skip_header(p, end);

  int64_t row = 0;
  int64_t tmax = 0;
  while (p < end && row < cap_rows) {
    if (*p == '\n' || *p == '\r') {  // blank/trailing line
      ++p;
      continue;
    }
    const char* row_start = p;
    if (parse_row(&p, end, mt, max_team,
                  player_idx + row * 2 * max_team, winner + row,
                  mode_id + row, afk + row, &tmax) != 0) {
      *cursor = row_start - buf;
      if (row == 0) return -1;  // the bad row leads: the caller's turn
      *out_tmax = tmax;
      return row;  // valid prefix; the next call reports the poison
    }
    ++row;
  }
  *cursor = p - buf;
  *out_tmax = tmax;
  return row;
}

}  // extern "C"
