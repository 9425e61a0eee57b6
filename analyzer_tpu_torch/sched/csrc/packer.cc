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

#include <cstddef>
#include <cstdint>
#include <vector>

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

}  // extern "C"
