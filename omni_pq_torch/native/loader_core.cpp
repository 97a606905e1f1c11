// Native data-loader core: the host-side per-scene hot ops (the port's own
// copy of the JAX package's loader core, the same code).
//
// Called from the Python loaders via ctypes (calls release the GIL, so the
// PrefetchLoader's worker threads get real parallelism):
//   - morton_argsort: Morton-code spatial ordering of a cloud
//     (data/spatial.py semantics)
//   - compute_votes: per-point vote targets from instance membership
//     (scannet_detection_dataset.py:229-246 semantics -- the per-instance
//     Python loop is the slowest part of a scene load)
//   - gather_rows: downsample-with-choices gather
//   - estimate_normals: k-NN PCA normals for the offline preprocessing
//
// Built by omni_pq_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC -std=c++17 loader_core.cpp -o <build dir>/...so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

static inline uint64_t spread_bits(uint64_t v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// points: (n, stride) float32, first 3 columns are xyz; out_order: (n,) int64
void morton_argsort(const float* points, int64_t n, int64_t stride,
                    int64_t* out_order) {
  if (n == 0) return;
  float lo[3] = {points[0], points[1], points[2]};
  float hi[3] = {points[0], points[1], points[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      float v = points[i * stride + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  }
  std::vector<uint64_t> codes(n);
  float scale[3];
  for (int d = 0; d < 3; ++d)
    scale[d] = hi[d] > lo[d] ? 1023.0f / (hi[d] - lo[d]) : 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int d = 0; d < 3; ++d) {
      float v = (points[i * stride + d] - lo[d]) * scale[d];
      v = std::max(0.0f, std::min(1023.0f, v));
      q[d] = (uint64_t)v;
    }
    codes[i] = spread_bits(q[0]) | (spread_bits(q[1]) << 1)
             | (spread_bits(q[2]) << 2);
  }
  std::iota(out_order, out_order + n, 0);
  std::stable_sort(out_order, out_order + n, [&](int64_t a, int64_t b) {
    return codes[a] < codes[b];
  });
}

// pc (n,3) f32, instance (n,) i64, sem_in_care (n,) uint8 (1 = semantic class
// belongs to the detection set), gt_centers (k,3) f32 (padded far away),
// outputs: votes (n,3) f32, votes_mask (n,) f32, point_instance (n,) i64
void compute_votes(const float* pc, const int64_t* instance,
                   const uint8_t* sem_in_care, int64_t n,
                   const float* gt_centers, int64_t k,
                   float* votes, float* votes_mask, int64_t* point_instance) {
  std::memset(votes, 0, sizeof(float) * n * 3);
  std::memset(votes_mask, 0, sizeof(float) * n);
  for (int64_t i = 0; i < n; ++i) point_instance[i] = -1;

  // group point indices by instance id
  int64_t max_inst = -1;
  for (int64_t i = 0; i < n; ++i) max_inst = std::max(max_inst, instance[i]);
  if (max_inst < 0) return;
  std::vector<std::vector<int64_t>> groups(max_inst + 1);
  for (int64_t i = 0; i < n; ++i)
    if (instance[i] >= 0) groups[instance[i]].push_back(i);

  for (int64_t g = 0; g <= max_inst; ++g) {
    const auto& idx = groups[g];
    if (idx.empty()) continue;
    if (!sem_in_care[idx[0]]) continue;  // first point decides, like the ref
    float mn[3], mx[3];
    for (int d = 0; d < 3; ++d) mn[d] = mx[d] = pc[idx[0] * 3 + d];
    for (int64_t i : idx) {
      for (int d = 0; d < 3; ++d) {
        mn[d] = std::min(mn[d], pc[i * 3 + d]);
        mx[d] = std::max(mx[d], pc[i * 3 + d]);
      }
    }
    float center[3] = {(mn[0] + mx[0]) * 0.5f, (mn[1] + mx[1]) * 0.5f,
                       (mn[2] + mx[2]) * 0.5f};
    // nearest gt center -> instance label
    int64_t best = 0;
    float bestd = 3.4e38f;
    for (int64_t j = 0; j < k; ++j) {
      float d2 = 0;
      for (int d = 0; d < 3; ++d) {
        float diff = center[d] - gt_centers[j * 3 + d];
        d2 += diff * diff;
      }
      if (d2 < bestd) { bestd = d2; best = j; }
    }
    for (int64_t i : idx) {
      for (int d = 0; d < 3; ++d)
        votes[i * 3 + d] = center[d] - pc[i * 3 + d];
      votes_mask[i] = 1.0f;
      point_instance[i] = best;
    }
  }
}

// src (n, c) f32, choices (m,) i64 -> dst (m, c) f32
void gather_rows(const float* src, int64_t n, int64_t c,
                 const int64_t* choices, int64_t m, float* dst) {
  for (int64_t i = 0; i < m; ++i)
    std::memcpy(dst + i * c, src + choices[i] * c, sizeof(float) * c);
}

// ---- PCA normal estimation (preprocess.estimate_normals hot path) ----
//
// The reference does this offline with pymeshlab (C++); the numpy fallback
// is O(n^2) brute force. Here: exact k-NN via a uniform grid hash with
// ring expansion bounded by the kth-distance guarantee, 3x3 symmetric
// Jacobi eigensolve, smallest-eigenvalue eigenvector, viewpoint flip.

// cyclic Jacobi for a symmetric 3x3; writes the unit eigenvector of the
// smallest eigenvalue
static void eig3_smallest_vec(double a[3][3], float out[3]) {
  double v[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = std::abs(a[0][1]) + std::abs(a[0][2]) + std::abs(a[1][2]);
    if (off < 1e-14) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (std::abs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::abs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int r = 0; r < 3; ++r) {
          double arp = a[r][p], arq = a[r][q];
          a[r][p] = c * arp - s * arq;
          a[r][q] = s * arp + c * arq;
        }
        for (int r = 0; r < 3; ++r) {
          double apr = a[p][r], aqr = a[q][r];
          a[p][r] = c * apr - s * aqr;
          a[q][r] = s * apr + c * aqr;
          double vrp = v[r][p], vrq = v[r][q];
          v[r][p] = c * vrp - s * vrq;
          v[r][q] = s * vrp + c * vrq;
        }
      }
    }
  }
  int best = 0;
  if (a[1][1] < a[best][best]) best = 1;
  if (a[2][2] < a[best][best]) best = 2;
  double norm = std::sqrt(v[0][best] * v[0][best] + v[1][best] * v[1][best] +
                          v[2][best] * v[2][best]);
  if (norm < 1e-30) norm = 1.0;
  for (int d = 0; d < 3; ++d) out[d] = (float)(v[d][best] / norm);
}

// pts (n,3) f32, k neighbors (incl. self), viewpoint (3,) f32;
// out_normals (n,3) f32, unit, flipped so dot(p - viewpoint, n) >= 0
void estimate_normals(const float* pts, int64_t n, int64_t k,
                      const float* viewpoint, float* out_normals) {
  if (n == 0) return;
  if (k > n) k = n;
  float lo[3], hi[3];
  for (int d = 0; d < 3; ++d) lo[d] = hi[d] = pts[d];
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[i * 3 + d]);
      hi[d] = std::max(hi[d], pts[i * 3 + d]);
    }
  // cell size targeting ~k points per cell so ring 1 usually suffices
  double vol = 1.0;
  for (int d = 0; d < 3; ++d) vol *= std::max((double)(hi[d] - lo[d]), 1e-6);
  double h = std::cbrt(vol * (double)k / (double)n);
  int dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max(1, std::min(512, (int)((hi[d] - lo[d]) / h) + 1));
  }
  auto cell_of = [&](const float* p, int out[3]) {
    for (int d = 0; d < 3; ++d) {
      int c = (int)((p[d] - lo[d]) / h);
      out[d] = std::max(0, std::min(dims[d] - 1, c));
    }
  };
  int64_t ncells = (int64_t)dims[0] * dims[1] * dims[2];
  std::vector<int64_t> counts(ncells + 1, 0), order(n);
  std::vector<int> cidx(n * 3);
  for (int64_t i = 0; i < n; ++i) {
    cell_of(pts + i * 3, &cidx[i * 3]);
    int64_t c = ((int64_t)cidx[i * 3] * dims[1] + cidx[i * 3 + 1]) * dims[2]
              + cidx[i * 3 + 2];
    counts[c + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      int64_t c = ((int64_t)cidx[i * 3] * dims[1] + cidx[i * 3 + 1]) * dims[2]
                + cidx[i * 3 + 2];
      order[cursor[c]++] = i;
    }
  }

  // per-point work is independent after the grid build (read-only shared
  // state, per-thread candidate buffer): thread it on multi-core hosts
  auto worker = [&](int64_t i_lo, int64_t i_hi) {
  std::vector<std::pair<float, int64_t>> cand;
  for (int64_t i = i_lo; i < i_hi; ++i) {
    const float* p = pts + i * 3;
    cand.clear();
    int base[3] = {cidx[i * 3], cidx[i * 3 + 1], cidx[i * 3 + 2]};
    int max_ring = 0;
    for (int d = 0; d < 3; ++d)
      max_ring = std::max(max_ring,
                          std::max(base[d], dims[d] - 1 - base[d]));
    for (int ring = 0; ring <= max_ring; ++ring) {
      // shell of cells at Chebyshev distance == ring
      for (int dx = -ring; dx <= ring; ++dx) {
        int cx = base[0] + dx;
        if (cx < 0 || cx >= dims[0]) continue;
        for (int dy = -ring; dy <= ring; ++dy) {
          int cy = base[1] + dy;
          if (cy < 0 || cy >= dims[1]) continue;
          for (int dz = -ring; dz <= ring; ++dz) {
            if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != ring)
              continue;
            int cz = base[2] + dz;
            if (cz < 0 || cz >= dims[2]) continue;
            int64_t c = ((int64_t)cx * dims[1] + cy) * dims[2] + cz;
            for (int64_t s = counts[c]; s < counts[c + 1]; ++s) {
              int64_t j = order[s];
              float d2 = 0;
              for (int d = 0; d < 3; ++d) {
                float diff = p[d] - pts[j * 3 + d];
                d2 += diff * diff;
              }
              cand.emplace_back(d2, j);
            }
          }
        }
      }
      if ((int64_t)cand.size() >= k) {
        std::nth_element(cand.begin(), cand.begin() + (k - 1), cand.end());
        float dk = std::sqrt(cand[k - 1].first);
        // every point within radius ring*h of p lies in rings <= ring+1;
        // once dk <= ring*h no farther ring can hold a closer neighbor
        if (dk <= (float)(ring * h) || ring == max_ring) break;
      }
    }
    int64_t kk = std::min<int64_t>(k, cand.size());
    // covariance of the kk nearest (first kk after nth_element)
    double mean[3] = {0, 0, 0};
    for (int64_t s = 0; s < kk; ++s)
      for (int d = 0; d < 3; ++d) mean[d] += pts[cand[s].second * 3 + d];
    for (int d = 0; d < 3; ++d) mean[d] /= (double)kk;
    double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    for (int64_t s = 0; s < kk; ++s) {
      double e[3];
      for (int d = 0; d < 3; ++d)
        e[d] = pts[cand[s].second * 3 + d] - mean[d];
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) cov[a][b] += e[a] * e[b];
    }
    float nrm[3];
    eig3_smallest_vec(cov, nrm);
    double dot = 0;
    for (int d = 0; d < 3; ++d) dot += (p[d] - viewpoint[d]) * nrm[d];
    float sign = dot < 0 ? -1.0f : 1.0f;
    for (int d = 0; d < 3; ++d) out_normals[i * 3 + d] = sign * nrm[d];
  }
  };  // worker

  int64_t nthreads = std::max(1u, std::thread::hardware_concurrency());
  nthreads = std::min<int64_t>(nthreads, std::max<int64_t>(1, n / 4096));
  if (nthreads <= 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    int64_t step = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t)
      threads.emplace_back(worker, t * step, std::min(n, (t + 1) * step));
    for (auto& th : threads) th.join();
  }
}

}  // extern "C"
