// packcore: native host packing engine for the dense solver.
//
// C++ implementation of the counts-based bin packing in
// solver/pack_counts.py (pack_counts + assign_bins fused into one pass).
// Bit-for-bit semantics parity with the Python reference is required — the
// Python path stays as the fallback and the differential test
// (tests/test_native.py) holds the two to identical outputs.
//
// The role this plays mirrors where the reference spends its scheduler hot
// loop (pkg/controllers/provisioning/scheduling/scheduler.go:189-232): the
// per-pod placement inner loop. Here that loop is already reduced to
// counts-scale work (see pack_counts.py docstring); this native core removes
// the remaining Python interpreter overhead from the per-bucket pack and the
// P-scale bin-id assignment.
//
// Exposed as a tiny C ABI (ctypes-loaded; no pybind11 in this image).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// Comparison tolerance — must match utils/resources.py:tolerance().
inline double tolerance(double total) {
  return total > 0.0 ? 1e-6 + 1e-9 * std::fabs(total) : 1e-12;
}

}  // namespace

extern "C" {

// Pack `counts[u]` items of size `unique[u*R..]` into identical bins of
// capacity `cap`, then expand the bin patterns into a per-item bin id.
//
//   unique   [U, R] row-major float64, sorted descending (FFD order)
//   counts   [U] int64
//   inverse  [P] int64  (item -> size class)
//   cap      [R] float64
//   first_bin_id        id of the first emitted bin
//   bin_of_item [P] int64 out (-1 = unplaced)
//   unplaced    [U] int64 out (items that fit no empty bin)
//
// Returns next_bin_id (first_bin_id + number of bins), or -1 on invalid
// arguments.
int64_t pack_assign(const double* unique, const int64_t* counts, int64_t U,
                    int64_t R, const int64_t* inverse, int64_t P,
                    const double* cap, int64_t first_bin_id,
                    int64_t* bin_of_item, int64_t* unplaced) {
  if (U < 0 || R <= 0 || P < 0) return -1;
  std::vector<double> tol(R);
  for (int64_t r = 0; r < R; ++r) tol[r] = tolerance(cap[r]);

  std::vector<int64_t> remaining(counts, counts + U);
  std::fill(bin_of_item, bin_of_item + P, int64_t{-1});
  std::fill(unplaced, unplaced + U, int64_t{0});

  // items that can never fit (single item exceeds empty-bin capacity)
  for (int64_t u = 0; u < U; ++u) {
    for (int64_t r = 0; r < R; ++r) {
      if (unique[u * R + r] > cap[r] + tol[r]) {
        unplaced[u] = remaining[u];
        remaining[u] = 0;
        break;
      }
    }
  }

  // per-class item rows in original order (counting sort over `inverse`)
  std::vector<int64_t> class_offset(U + 1, 0);
  for (int64_t p = 0; p < P; ++p) {
    int64_t u = inverse[p];
    if (u < 0 || u >= U) return -1;
    ++class_offset[u + 1];
  }
  for (int64_t u = 0; u < U; ++u) class_offset[u + 1] += class_offset[u];
  std::vector<int64_t> class_rows(P);
  {
    std::vector<int64_t> fill(class_offset.begin(), class_offset.end() - 1);
    for (int64_t p = 0; p < P; ++p) class_rows[fill[inverse[p]]++] = p;
  }
  std::vector<int64_t> cursor(class_offset.begin(), class_offset.end() - 1);

  std::vector<int64_t> pattern(U);
  std::vector<double> free_cap(R);
  int64_t bin_id = first_bin_id;
  int64_t total_remaining = 0;
  for (int64_t u = 0; u < U; ++u) total_remaining += remaining[u];

  const int64_t guard_max = 4 * U + 64;  // safety net; should be unreachable
  int64_t guard = 0;
  while (total_remaining > 0) {
    if (++guard > guard_max) {
      for (int64_t u = 0; u < U; ++u) unplaced[u] += remaining[u];
      break;
    }
    // fill one bin greedily, largest size class first
    std::fill(pattern.begin(), pattern.end(), int64_t{0});
    std::memcpy(free_cap.data(), cap, R * sizeof(double));
    int64_t placed_in_bin = 0;
    for (int64_t u = 0; u < U; ++u) {
      if (remaining[u] <= 0) continue;
      const double* size = unique + u * R;
      // how many items of size u fit in the remaining free capacity
      int64_t k = remaining[u];
      for (int64_t r = 0; r < R; ++r) {
        if (size[r] > 1e-9) {
          double per = std::floor((free_cap[r] + tol[r]) / size[r]);
          int64_t kp = per >= static_cast<double>(remaining[u])
                           ? remaining[u]
                           : static_cast<int64_t>(per);
          if (kp < k) k = kp;
        }
      }
      if (k > 0) {
        pattern[u] = k;
        for (int64_t r = 0; r < R; ++r) free_cap[r] -= size[r] * k;
        placed_in_bin += k;
      }
    }
    if (placed_in_bin == 0) {
      for (int64_t u = 0; u < U; ++u) unplaced[u] += remaining[u];
      break;
    }
    // emit this bin pattern as many times as the remaining counts allow
    int64_t repeat = std::numeric_limits<int64_t>::max();
    for (int64_t u = 0; u < U; ++u) {
      if (pattern[u] > 0) {
        int64_t rep = remaining[u] / pattern[u];
        if (rep < repeat) repeat = rep;
      }
    }
    if (repeat < 1) repeat = 1;
    for (int64_t inst = 0; inst < repeat; ++inst) {
      for (int64_t u = 0; u < U; ++u) {
        for (int64_t t = 0; t < pattern[u]; ++t) {
          bin_of_item[class_rows[cursor[u]++]] = bin_id;
        }
      }
      ++bin_id;
    }
    for (int64_t u = 0; u < U; ++u) {
      remaining[u] -= pattern[u] * repeat;
      total_remaining -= pattern[u] * repeat;
    }
  }
  return bin_id;
}

// Dedicated-bucket assignment: one item per bin when it fits an empty bin.
// Mirrors solver/dense.py:_pack_bucket's `dedicated` branch.
int64_t pack_dedicated(const double* requests, int64_t P, int64_t R,
                       const double* cap, int64_t first_bin_id,
                       int64_t* bin_of_item) {
  std::vector<double> limit(R);
  for (int64_t r = 0; r < R; ++r) limit[r] = cap[r] + tolerance(cap[r]);
  int64_t bin_id = first_bin_id;
  for (int64_t p = 0; p < P; ++p) {
    bool fits = true;
    for (int64_t r = 0; r < R; ++r) {
      if (requests[p * R + r] > limit[r]) {
        fits = false;
        break;
      }
    }
    bin_of_item[p] = fits ? bin_id++ : -1;
  }
  return bin_id;
}

// ABI version tag so the loader can reject stale build artifacts.
int64_t packcore_abi_version() { return 2; }

}  // extern "C"
