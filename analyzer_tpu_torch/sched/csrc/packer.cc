// Native superstep assignment — the host-side hot loops of the scheduler.
//
// The port's own copy of the JAX package's packer (same loops, so both
// packages emit byte-equal schedules). Both recurrences run sequentially
// over the chronological stream (each match depends on the running
// per-player table), so numpy cannot vectorize them; at 10M matches the
// python loops in superstep.py take minutes. Built with g++ at first use by
// _native.py and loaded with ctypes.
//
// Contract (mirrors _assign_supersteps_py / _assign_batches_first_fit_py):
//   idx       [n_matches, slots] int32 player rows, -1 for empty slots
//   ratable   [n_matches] uint8, 0 => no state access (result -1)
//
// The windowed first-fit (assign_ff_*) is the migration engine's front
// half: the same recurrence with its state carried across decode windows
// behind a handle (migrate/assign.py).
//
// plan_residency at the end is the fused feed's residency planner
// (residency.plan_windows): a chunk's fused windows in one pass, no sorts.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Restartable first-fit state, field for field the python recurrence of
// migrate/assign.py: the per-player frontier (last[p] = batch of p's most
// recent ratable match), the per-batch fill counts, the disjoint-set "next
// batch with space" pointer, the high-water batch and the stream cursor.
struct AssignFFState {
  int64_t capacity;
  int64_t n_assigned = 0;
  int64_t max_batch = -1;
  std::vector<int64_t> last;
  std::vector<int64_t> fill;
  std::vector<int64_t> next_free;

  AssignFFState(int64_t cap, int64_t n_hint)
      : capacity(cap),
        last(static_cast<size_t>(n_hint > 0 ? n_hint : 1024), -1) {}

  void ensure(int64_t b) {
    while (static_cast<int64_t>(fill.size()) <= b) {
      fill.push_back(0);
      next_free.push_back(static_cast<int64_t>(next_free.size()));
    }
  }
  int64_t find(int64_t b) {
    ensure(b);
    int64_t root = b;
    while (true) {
      ensure(root);
      if (next_free[root] == root) break;
      root = next_free[root];
    }
    while (next_free[b] != root) {  // path compression
      int64_t nb = next_free[b];
      next_free[b] = root;
      b = nb;
    }
    return root;
  }
  void grow_players(int64_t top) {
    // Geometric doubling, -1 filled: the python frontier's _grow_players.
    int64_t size = static_cast<int64_t>(last.size());
    while (size <= top) size *= 2;
    last.resize(static_cast<size_t>(size), -1);
  }
};

// Publish cadence of the windowed loop (matches), equal to
// migrate/assign.py's PROGRESS_EVERY, so the native and python assigners
// publish at the same positions. A power of two: the check is one mask.
constexpr int64_t kFFProgressEvery = 2048;

}  // namespace

extern "C" {

// ASAP superstep per match: 1 + max(last step of each of its players).
//   out  [n_matches] int64 superstep index, -1 for non-ratable
void assign_supersteps(const int32_t* idx, int64_t n_matches,
                       int64_t slots, const uint8_t* ratable,
                       int64_t n_players, int64_t* out) {
  std::vector<int64_t> last(static_cast<size_t>(n_players > 0 ? n_players : 1),
                            -1);
  for (int64_t i = 0; i < n_matches; ++i) {
    if (!ratable[i]) {
      out[i] = -1;
      continue;
    }
    const int32_t* row = idx + i * slots;
    int64_t s = -1;
    for (int64_t j = 0; j < slots; ++j) {
      const int32_t p = row[j];
      if (p >= 0 && last[p] > s) s = last[p];
    }
    ++s;
    out[i] = s;
    for (int64_t j = 0; j < slots; ++j) {
      const int32_t p = row[j];
      if (p >= 0) last[p] = s;
    }
  }
}

// Capacity-aware first-fit batch assignment: each ratable match, in stream
// order, goes to the EARLIEST batch that is strictly later than every one
// of its players' previous batches and still has free capacity. A
// disjoint-set "next batch with space" pointer makes the pass O(n alpha(n)).
//   capacity  slots per batch (B)
//   out       [n_matches] int64 batch index, -1 for non-ratable matches
//   out_slot  [n_matches] int64 slot within the batch (fill order = stream
//             order), -1 for non-ratable
//   progress  [2] int64 or null, published every kPublishEvery matches and
//             at the end: progress[0] = matches processed so far (release
//             store: the out/out_slot writes of [0, progress[0]) are visible
//             before it), progress[1] = the batch watermark (first batch that
//             can still receive matches; every batch below it is final;
//             relaxed). A consumer thread can feed the final batches while
//             this loop runs — ctypes releases the GIL for the call.
void assign_batches_first_fit(const int32_t* idx, int64_t n_matches,
                              int64_t slots, const uint8_t* ratable,
                              int64_t n_players, int64_t capacity,
                              int64_t* out, int64_t* out_slot,
                              int64_t* progress) {
  std::vector<int64_t> last(static_cast<size_t>(n_players > 0 ? n_players : 1),
                            -1);
  std::vector<int64_t> fill;       // per-batch occupancy
  std::vector<int64_t> next_free;  // DSU skip pointer: first batch >= b with space

  auto ensure = [&](int64_t b) {
    while (static_cast<int64_t>(fill.size()) <= b) {
      fill.push_back(0);
      next_free.push_back(static_cast<int64_t>(next_free.size()));
    }
  };
  auto find = [&](int64_t b) {
    ensure(b);
    int64_t root = b;
    while (true) {
      ensure(root);
      if (next_free[root] == root) break;
      root = next_free[root];
    }
    while (next_free[b] != root) {  // path compression
      int64_t nb = next_free[b];
      next_free[b] = root;
      b = nb;
    }
    return root;
  };

  constexpr int64_t kPublishEvery = 16384;
  int64_t max_b = -1;  // highest batch actually assigned
  for (int64_t i = 0; i < n_matches; ++i) {
    if (!ratable[i]) {
      out[i] = -1;
      out_slot[i] = -1;
    } else {
      const int32_t* row = idx + i * slots;
      int64_t floor_b = 0;
      for (int64_t j = 0; j < slots; ++j) {
        const int32_t p = row[j];
        if (p >= 0 && last[p] + 1 > floor_b) floor_b = last[p] + 1;
      }
      const int64_t b = find(floor_b);
      out[i] = b;
      if (b > max_b) max_b = b;
      out_slot[i] = fill[b];
      if (++fill[b] == capacity) {
        ensure(b + 1);
        next_free[b] = b + 1;
      }
      for (int64_t j = 0; j < slots; ++j) {
        const int32_t p = row[j];
        if (p >= 0) last[p] = b;
      }
    }
    if (progress && (i + 1) % kPublishEvery == 0) {
      __atomic_store_n(&progress[1], find(0), __ATOMIC_RELAXED);
      __atomic_store_n(&progress[0], i + 1, __ATOMIC_RELEASE);
    }
  }
  if (progress) {
    // The final watermark is the batches actually used, not fill.size():
    // filling a batch to exactly capacity pre-creates an empty successor.
    __atomic_store_n(&progress[1], max_b + 1, __ATOMIC_RELAXED);
    __atomic_store_n(&progress[0], n_matches, __ATOMIC_RELEASE);
  }
}

// Windowed, state-carrying first-fit: the migration engine never holds the
// whole stream, so the recurrence's state lives behind a handle and each
// decode window feeds only its newly visible slice:
//
//   h = assign_ff_create(capacity, n_hint)   n_hint sizes the player
//                                            frontier (0 -> 1024)
//   assign_ff_feed(h, idx_window, slots, ratable_window, lo, hi,
//                  out_batch, out_slot, progress) -> hi - lo, or -1
//   assign_ff_finish(h, progress) -> batches used (idempotent)
//   assign_ff_destroy(h)
//
// idx_window / ratable_window are WINDOW-local ([hi-lo, slots] int32 /
// [hi-lo] uint8); lo / hi, out_batch / out_slot and the published counts
// are absolute stream positions, so the caller passes the same full-stream
// buffers every call and a concurrent reader reads entries below
// progress[0] as it does under the one-shot loop. progress[0] is
// published with release semantics at absolute multiples of
// kFFProgressEvery and at the end of every window; progress[1] is written
// only by finish (batches used). feed returns -1 on a contract violation
// (null handle, hi < lo, or a lo that does not continue the last window)
// and leaves the state untouched.
//
// Unlike the one-shot loop, non-ratable matches are consumed INLINE as
// dependency-free capacity (first-fit from batch 0, frontier untouched)
// instead of being held for a backfill pass, which needs the whole
// stream's filler population. They read and write no rating state.

void* assign_ff_create(int64_t capacity, int64_t n_hint) {
  if (capacity < 1) return nullptr;
  return new AssignFFState(capacity, n_hint);
}

int64_t assign_ff_feed(void* handle, const int32_t* idx, int64_t slots,
                       const uint8_t* ratable, int64_t lo, int64_t hi,
                       int64_t* out_batch, int64_t* out_slot,
                       int64_t* progress) {
  AssignFFState* st = static_cast<AssignFFState*>(handle);
  if (st == nullptr || hi < lo || lo != st->n_assigned) return -1;
  const int64_t cap = st->capacity;
  for (int64_t i = lo; i < hi; ++i) {
    if (progress && i > lo && (i & (kFFProgressEvery - 1)) == 0) {
      // Release: the out_batch / out_slot stores of [lo, i) are visible
      // before the published count.
      __atomic_store_n(&progress[0], i, __ATOMIC_RELEASE);
    }
    const int32_t* row = idx + (i - lo) * slots;
    const bool rat = ratable[i - lo] != 0;
    int64_t floor_b = 0;
    if (rat) {
      for (int64_t j = 0; j < slots; ++j) {
        const int32_t p = row[j];
        if (p < 0) continue;
        if (p >= static_cast<int64_t>(st->last.size())) st->grow_players(p);
        if (st->last[p] + 1 > floor_b) floor_b = st->last[p] + 1;
      }
    }
    const int64_t b = st->find(floor_b);
    out_batch[i] = b;
    out_slot[i] = st->fill[b];
    if (++st->fill[b] == cap) {
      st->ensure(b + 1);
      st->next_free[b] = b + 1;
    }
    if (b > st->max_batch) st->max_batch = b;
    if (rat) {
      for (int64_t j = 0; j < slots; ++j) {
        const int32_t p = row[j];
        if (p >= 0) st->last[p] = b;
      }
    }
  }
  st->n_assigned = hi;
  if (progress) __atomic_store_n(&progress[0], hi, __ATOMIC_RELEASE);
  return hi - lo;
}

int64_t assign_ff_finish(void* handle, int64_t* progress) {
  AssignFFState* st = static_cast<AssignFFState*>(handle);
  if (st == nullptr) return -1;
  const int64_t used = st->max_batch + 1;
  if (progress) {
    __atomic_store_n(&progress[1], used, __ATOMIC_RELAXED);
    __atomic_store_n(&progress[0], st->n_assigned, __ATOMIC_RELEASE);
  }
  return used;
}

void assign_ff_destroy(void* handle) {
  delete static_cast<AssignFFState*>(handle);
}

// Residency plans for a chunk's fused windows, in one pass over its rows
// (residency.plan_windows; the numpy planner there is the oracle, and the
// plans are equal field for field):
//
//   rows      [n_steps, per_step] int32 player rows, each in [0, n_rows)
//   valid     [n_steps, per_step] uint8 written-slot mask (the
//             writebacks-avoided count only)
//   table     [n_rows] uint64 row -> slot scratch, owned by the caller and
//             reused across calls: generation << 32 | slot, where only the
//             current window's generation counts, so no window clears it
//   generation  in/out: the last generation used; the table's entries
//             hold no later one (all-zero table: 0)
//
// Per window: slot 0 is pad_row; every other row gets the next slot at its
// first touch. A step whose working set (padding row included) would pass
// max_rows is cut off and opens the next window, so each window ends at
// the last step that fits (spilled when that is short of `window` steps).
// A second pass over the kept steps' slots, in cache, gives each slot's
// last step and the written rows.
//
// Outputs: slot_idx [n_steps, per_step]; per window w, meta[4w..4w+3] =
// (steps, n_live, spilled, writebacks_avoided), and its n_live slots'
// rows, first and last steps at the running offset (the sum of the
// earlier windows' n_live) of live_rows / first_use / last_use, which hold
// `capacity` entries. Returns the window count, or on a fault -1 (a step
// alone passes max_rows: fault = {its working set, the step}), -2 (a row
// outside [0, n_rows): fault = {the row, its flat position}) or -3 (the
// live buffers are too small). Entries the table holds stay valid on
// every return: the generation is written back first.
int64_t plan_residency(const int32_t* rows, const uint8_t* valid,
                       int64_t n_steps, int64_t per_step, int32_t pad_row,
                       int64_t window, int64_t max_rows, uint64_t* table,
                       int64_t n_rows, uint32_t* generation,
                       int32_t* slot_idx, int32_t* live_rows,
                       int32_t* first_use, int32_t* last_use,
                       int64_t capacity, int64_t* meta, int64_t* fault) {
  // Prefetch distance in elements: a cold row's table entry misses the
  // cache, and the rows ahead are read in order anyway.
  constexpr int64_t kAhead = 32;
  const int64_t total = n_steps * per_step;
  const uint64_t urows = static_cast<uint64_t>(n_rows);
  const int64_t mark_size =
      (max_rows < total + 1 ? max_rows : total + 1) + 1;
  std::vector<uint32_t> mark(static_cast<size_t>(mark_size), 0);
  uint32_t gen = *generation;
  int64_t n_win = 0, off = 0, s0 = 0;
  int64_t code = 0;
  while (s0 < n_steps) {
    if (gen == UINT32_MAX) {  // tags exhausted: clear once, start over
      std::memset(table, 0, static_cast<size_t>(n_rows) * sizeof(uint64_t));
      gen = 0;
    }
    ++gen;
    const uint64_t tag = static_cast<uint64_t>(gen) << 32;
    if (off >= capacity) { code = -3; break; }
    int32_t* lr = live_rows + off;
    int32_t* fu = first_use + off;
    int32_t* lu = last_use + off;
    table[pad_row] = tag;
    lr[0] = pad_row;
    fu[0] = 0;
    int64_t n_live = 1, kept_live = 1;
    const int64_t s1 = s0 + window < n_steps ? s0 + window : n_steps;
    int64_t s = s0;
    for (; s < s1; ++s) {
      const int64_t base = s * per_step;
      const int32_t local = static_cast<int32_t>(s - s0);
      // Only a window's first step runs to its end past the budget: its
      // whole working set is the fault's number.
      const bool first_step = s == s0;
      bool over = false;
      for (int64_t j = 0; j < per_step; ++j) {
        const int64_t i = base + j;
        if (i + kAhead < total) {
          const uint32_t ahead = static_cast<uint32_t>(rows[i + kAhead]);
          if (ahead < urows) __builtin_prefetch(table + ahead, 1, 1);
        }
        const int32_t row = rows[i];
        if (static_cast<uint32_t>(row) >= urows) {
          fault[0] = row;
          fault[1] = i;
          code = -2;
          break;
        }
        if (off + n_live >= capacity) { code = -3; break; }
        // Branch-free: whether a row is fresh is data-dependent and would
        // mispredict, so a seen row takes the same stores (its own entry
        // again; lr / fu at n_live, which the next fresh row overwrites).
        const uint64_t e = table[row];
        const bool fresh = (e & 0xFFFFFFFF00000000ull) != tag;
        const uint32_t slot =
            fresh ? static_cast<uint32_t>(n_live) : static_cast<uint32_t>(e);
        table[row] = tag | slot;
        lr[n_live] = row;
        fu[n_live] = local;
        n_live += fresh;
        slot_idx[i] = static_cast<int32_t>(slot);
        if (n_live > max_rows && !first_step) { over = true; break; }
      }
      if (code != 0 || over || n_live > max_rows) break;
      kept_live = n_live;
    }
    if (code != 0) break;
    if (s == s0) {  // the window's first step alone passes the budget
      fault[0] = n_live;
      fault[1] = s0;
      code = -1;
      break;
    }
    // Second pass over the kept steps [s0, s): last uses, written rows.
    lu[0] = 0;
    const uint32_t stamp = static_cast<uint32_t>(n_win + 1);
    int64_t written = 0, unique_written = 0;
    for (int64_t t = s0; t < s; ++t) {
      const int32_t local = static_cast<int32_t>(t - s0);
      const int32_t* si = slot_idx + t * per_step;
      const uint8_t* v = valid + t * per_step;
      for (int64_t j = 0; j < per_step; ++j) {
        const int32_t slot = si[j];
        lu[slot] = local;
        const uint32_t w = v[j] != 0;
        const uint32_t m = mark[slot];
        written += w;
        unique_written += w & (m != stamp);
        mark[slot] = w ? stamp : m;
      }
    }
    meta[4 * n_win + 0] = s - s0;
    meta[4 * n_win + 1] = kept_live;
    meta[4 * n_win + 2] = s < s1 ? 1 : 0;
    meta[4 * n_win + 3] = written - unique_written;
    ++n_win;
    off += kept_live;
    s0 = s;
  }
  *generation = gen;
  return code != 0 ? code : n_win;
}

}  // extern "C"
