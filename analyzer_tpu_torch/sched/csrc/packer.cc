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
// The windowed first-fit at the end (assign_ff_*) is the migration
// engine's front half: the same recurrence with its state carried across
// decode windows behind a handle (migrate/assign.py).

#include <cstddef>
#include <cstdint>
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

}  // extern "C"
