// Host box ops of the mining pipeline (a copy of the JAX package's
// diffmining_tpu/native/boxops.cpp).
//
// Greedy non-overlap box suppression (reference: diffmining/typicality/
// utils.py:94-102, a pandas-filter loop; and the per-pixel DataFrame scan of
// cluster.py:183-215). Picking the top-k non-overlapping boxes of a score map
// is host work; this C++ version is the fast path behind
// ops/pool.get_non_overlapping, whose numpy loop
// (get_non_overlapping_plain) is its plain version.
//
// Built at first use by native/boxops.py (g++ -O3 -shared -fPIC) into
// build/native/.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// boxes: [n, 4] int64 (x_start, y_start, x_end, y_end); scores: [n] float32.
// Writes up to k indices (into the input order) of greedily selected,
// mutually non-overlapping boxes, descending by score (stable ties).
// Returns the number selected.
int64_t non_overlap_suppress(const int64_t* boxes, const float* scores,
                             int64_t n, int64_t k, int64_t* out_idx) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [scores](int64_t a, int64_t b) { return scores[a] > scores[b]; });

  std::vector<int64_t> picked;
  picked.reserve(k);
  for (int64_t oi = 0; oi < n && (int64_t)picked.size() < k; ++oi) {
    const int64_t i = order[oi];
    const int64_t* b = boxes + 4 * i;
    bool overlaps = false;
    for (int64_t j : picked) {
      const int64_t* p = boxes + 4 * j;
      // rectangles overlap iff they intersect (closed intervals, matching the
      // reference's <= / >= comparisons)
      if (b[0] <= p[2] && b[2] >= p[0] && b[1] <= p[3] && b[3] >= p[1]) {
        overlaps = true;
        break;
      }
    }
    if (!overlaps) picked.push_back(i);
  }
  std::copy(picked.begin(), picked.end(), out_idx);
  return (int64_t)picked.size();
}

}  // extern "C"
