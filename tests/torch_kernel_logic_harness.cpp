// Host harness of omni_pq_torch/csrc/point_logic.cuh, the index logic of the
// FPS and ball-query CUDA kernels. It builds serial models of the kernels'
// loops from the header's functions, one lane at a time: FPS's per-thread,
// per-warp and per-slot candidates, and the ball query's chunk boxes and
// ascending chunk-skipping query of one centre. The models are this file's
// own (the kernels run the same decisions as warp-wide ballots and
// butterflies); what they share with the kernels is the header.
// tests/test_torch_port_kernel_logic.py builds it with
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC -I omni_pq_torch/csrc
// and holds it against the plain versions and the JAX package's oracles.
#include <vector>

#include "point_logic.cuh"

using namespace point_logic;

namespace {

// One candidate of a step: a thread's, a warp's or a CTA's best point, with
// its coordinates, so that whoever merges holds the next centre too.
struct FpsCand {
  float v;
  int i;
  float x, y, z;
};

FpsCand fps_empty_cand() { return {-FLT_MAX, INT_MAX, 0.f, 0.f, 0.f}; }

// The best of n candidates by fps_better (the kernel merges its slots with
// a warp butterfly instead: the order is total, so the pick is the same).
FpsCand fps_merge(const FpsCand* c, int n) {
  FpsCand best = fps_empty_cand();
  for (int j = 0; j < n; ++j)
    if (fps_better(c[j].v, c[j].i, best.v, best.i)) best = c[j];
  return best;
}

// The box table of an N-point row p (xyz interleaved) in the layout that
// chunk_may_hit reads: six arrays of nchunks bounds, each chunk's min and
// max per axis over its points (the last chunk may hold fewer than 32).
std::vector<float> chunk_table(const float* p, int N) {
  const int nchunks = (N + kChunk - 1) / kChunk;
  std::vector<float> table(6 * nchunks);
  for (int ch = 0; ch < nchunks; ++ch)
    for (int a = 0; a < 3; ++a) {
      float lo = FLT_MAX, hi = -FLT_MAX;
      for (int n = ch * kChunk; n < N && n < (ch + 1) * kChunk; ++n) {
        lo = fminf(lo, p[3 * n + a]);
        hi = fmaxf(hi, p[3 * n + a]);
      }
      table[2 * a * nchunks + ch] = lo;
      table[(2 * a + 1) * nchunks + ch] = hi;
    }
  return table;
}

// The query of one centre, serially: chunks in ascending order, a chunk
// whose box fails the test skipped (table null: none skipped), the points
// of the others tested in index order, stopping at K hits. Skipped chunks
// hold no hit, so the slots are the first K hits by index, as without the
// skip. Unfilled slots repeat the first hit, or index 0 when there is none.
// Returns the chunks whose points were tested.
int query_centre(const float* p, int N, const float* table, float cx,
                 float cy, float cz, int K, float r2, float r2_box,
                 int* out) {
  const int nchunks = (N + kChunk - 1) / kChunk;
  int count = 0;
  int scanned = 0;
  for (int ch = 0; ch < nchunks && count < K; ++ch) {
    if (table && !chunk_may_hit(table, nchunks, ch, cx, cy, cz, r2_box))
      continue;
    ++scanned;
    for (int n = ch * kChunk; n < N && n < (ch + 1) * kChunk && count < K;
         ++n)
      if (point_hits(p[3 * n], p[3 * n + 1], p[3 * n + 2], cx, cy, cz, r2))
        out[count++] = n;
  }
  const int first = count > 0 ? out[0] : 0;
  for (int k = count; k < K; ++k) out[k] = first;
  return scanned;
}

}  // namespace

extern "C" {

int fps_max_points() { return kFpsMaxPoints; }

void fps_plan_of(int N, int* plan3) {
  const FpsPlan plan = fps_plan(N);
  plan3[0] = plan.cluster;
  plan3[1] = plan.threads;
  plan3[2] = plan.ppt;
}

// FPS of one N-point row over the slices of a cluster of P CTAs
// (fps_shape(N, P), fps_slice): each thread's first maximum over its
// points, each warp's best by fps_better, then all P x warps slots merged.
void fps_row(const float* p, int N, int npoint, int P, int* out) {
  const FpsPlan plan = fps_shape(N, P);
  const int nwarps = plan.threads / 32;
  std::vector<float> md(N);
  for (int n = 0; n < N; ++n)
    md[n] = fps_initial_mind(p[3 * n], p[3 * n + 1], p[3 * n + 2]);
  std::vector<FpsCand> slots(P * nwarps);
  out[0] = 0;
  float cx = p[0], cy = p[1], cz = p[2];
  for (int step = 1; step < npoint; ++step) {
    for (int rank = 0; rank < P; ++rank) {
      int begin, end;
      fps_slice(N, P, rank, begin, end);
      for (int w = 0; w < nwarps; ++w) {
        FpsCand wbest = fps_empty_cand();
        for (int lane = 0; lane < 32; ++lane) {
          const int t = w * 32 + lane;
          FpsCand tb = fps_empty_cand();
          for (int k = 0; k < plan.ppt; ++k) {
            const int n = begin + t + k * plan.threads;
            if (n >= end) break;
            const float d = sq_norm(sub_rn(p[3 * n], cx),
                                    sub_rn(p[3 * n + 1], cy),
                                    sub_rn(p[3 * n + 2], cz));
            const float m = fminf(md[n], d);
            md[n] = m;
            if (m > tb.v) tb = {m, n, p[3 * n], p[3 * n + 1], p[3 * n + 2]};
          }
          if (fps_better(tb.v, tb.i, wbest.v, wbest.i)) wbest = tb;
        }
        slots[rank * nwarps + w] = wbest;
      }
    }
    const FpsCand pick = fps_merge(slots.data(), P * nwarps);
    out[step] = pick.i;
    cx = pick.x;
    cy = pick.y;
    cz = pick.z;
  }
}

float box_threshold(float r2) { return bq_box_threshold(r2); }

int skips_chunks(int N) { return bq_skips_chunks(N); }

// Ball query of B rows with query_centre: mode 0 scans every chunk, mode 1
// skips by the chunk boxes with the kernel's inflated threshold, mode 2
// with r2 itself. Returns the chunks whose points were tested, over all
// centres.
long long bq_query(const float* xyz, int B, int N, const float* ctr, int S,
                   int K, float r2, int mode, int* idx) {
  const float r2_box = mode == 1 ? bq_box_threshold(r2) : r2;
  long long scanned = 0;
  for (int b = 0; b < B; ++b) {
    const float* p = xyz + static_cast<long long>(b) * N * 3;
    const std::vector<float> table = chunk_table(p, N);
    for (int s = 0; s < S; ++s) {
      const float* c = ctr + (static_cast<long long>(b) * S + s) * 3;
      scanned += query_centre(p, N, mode ? table.data() : nullptr, c[0],
                              c[1], c[2], K, r2, r2_box,
                              idx + (static_cast<long long>(b) * S + s) * K);
    }
  }
  return scanned;
}

// (centre, chunk) pairs of one row where a point of the chunk hits but the
// box test with r2 itself (no margin) rejects the chunk: 0 if the test is
// conservative.
long long bq_box_misses(const float* p, int N, const float* ctr, int S,
                        float r2) {
  const int nchunks = (N + kChunk - 1) / kChunk;
  const std::vector<float> table = chunk_table(p, N);
  long long misses = 0;
  for (int ch = 0; ch < nchunks; ++ch)
    for (int s = 0; s < S; ++s) {
      const float* c = ctr + 3 * s;
      if (chunk_may_hit(table.data(), nchunks, ch, c[0], c[1], c[2], r2))
        continue;
      for (int n = ch * kChunk; n < N && n < (ch + 1) * kChunk; ++n)
        if (point_hits(p[3 * n], p[3 * n + 1], p[3 * n + 2], c[0], c[1],
                       c[2], r2)) {
          ++misses;
          break;
        }
    }
  return misses;
}

}  // extern "C"
