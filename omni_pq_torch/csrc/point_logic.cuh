// Index logic of the FPS and ball-query kernels that a CPU can run too.
//
// nvcc compiles this header into csrc/fps.cu and csrc/ball_query.cu; g++
// compiles it into the host harness of tests/test_torch_port_kernel_logic.py
// (tests/torch_kernel_logic_harness.cpp, built with -ffp-contract=off), which
// builds serial models of the kernels' loops from it and holds them bitwise
// against the plain versions and the JAX package's oracles. Under g++ the
// CUDA qualifiers are defined away and the __f*_rn intrinsics become plain
// float operations, which round the same way when nothing is contracted
// into an FMA. Everything here is compiled into a kernel or its launcher.
//
// What lives here:
//   - the distance ((dx*dx + dy*dy) + dz*dz) with one rounding an operation;
//   - FPS: the (larger value, then lower index) order, the launch plan (the
//     cluster size P, threads and points a thread, chosen from the shape),
//     the slice of a row each cluster CTA owns, a point's starting distance;
//   - ball query: which rows skip chunks, the layout of a row's chunk-box
//     table, the conservative ball-vs-box test and its threshold, and the
//     point test.
#pragma once

#include <cfloat>
#include <climits>
#include <cmath>

#ifdef __CUDACC__
#define PL_HD __host__ __device__ __forceinline__
#else
#define PL_HD inline
#endif

namespace point_logic {

PL_HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

PL_HD float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

PL_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// ((x*x + y*y) + z*z), each operation rounded once: the plain versions'
// order. A fused or reordered form moves near-ties and boundary points.
PL_HD float sq_norm(float x, float y, float z) {
  return add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
}

// ---------------------------------------------------------------- FPS ----

constexpr float kFpsSkipNormSq = 1e-3f;  // |p|^2 <= this: never picked
constexpr int kFpsSmallN = 2048;         // rows up to this: one CTA, P = 1
constexpr int kFpsSmallPpt = 8;          // points a thread, small rows
constexpr int kFpsMaxCluster = 16;       // non-portable cluster size
constexpr int kFpsMaxThreads = 512;
constexpr int kFpsPpt = 16;              // points a thread, large rows
constexpr int kFpsMaxPoints = kFpsMaxCluster * kFpsMaxThreads * kFpsPpt;

// the argmax order: the larger value wins, the lower index on ties. A total
// order on (value, index) pairs, so any reduction tree gives the same pick.
PL_HD bool fps_better(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

PL_HD void take_better(float& v, int& i, float ov, int oi) {
  if (fps_better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

struct FpsPlan {
  int cluster;  // P CTAs a batch row; 0: the row does not fit
  int threads;  // a CTA
  int ppt;      // points a thread, held in registers
};

PL_HD int round_up32(int n) { return (n + 31) / 32 * 32; }

// Threads a CTA and points a thread for an N-point row over P CTAs: rows
// of up to kFpsSmallN points on one CTA take at most 256 threads, 8 points
// a thread; otherwise the fewest warps that hold the CTA's slice at 16
// points a thread (fewer warps mean fewer candidates to exchange and merge
// each step: on the H100 that beat more threads with fewer points each).
PL_HD FpsPlan fps_shape(int N, int P) {
  FpsPlan plan;
  plan.cluster = P;
  plan.ppt = (P == 1 && N <= kFpsSmallN) ? kFpsSmallPpt : kFpsPpt;
  const int chunk = (N + P - 1) / P;
  const int t = round_up32((chunk + plan.ppt - 1) / plan.ppt);
  plan.threads = t < 32 ? 32 : t;
  return plan;
}

// The launch plan of an N-point row: up to kFpsSmallN points, one CTA (its
// steps are bound by the reduction's latency, which a cluster's exchange
// would only lengthen); larger rows, a cluster of 16 CTAs, whatever the
// batch (on the H100 16 CTAs a row beat 8 at B=16 too, though 16 x 16 CTAs
// exceed the 132 SMs: the step's latency shrinks with the slice). cluster
// 0: the row does not fit in a cluster's registers.
PL_HD FpsPlan fps_plan(int N) {
  if (N <= kFpsSmallN) return fps_shape(N, 1);
  FpsPlan plan = fps_shape(N, kFpsMaxCluster);
  if (plan.threads > kFpsMaxThreads) plan.cluster = 0;
  return plan;
}

// CTA `rank` of a P-CTA cluster owns the points [begin, end) of an N-point
// row; thread t holds begin + t + k * threads for k < ppt, below end.
PL_HD void fps_slice(int N, int P, int rank, int& begin, int& end) {
  const int chunk = (N + P - 1) / P;
  begin = rank * chunk < N ? rank * chunk : N;
  end = begin + chunk < N ? begin + chunk : N;
}

// The running min distance a point starts with: -1 for near-origin
// padding, which min() keeps below every real distance.
PL_HD float fps_initial_mind(float x, float y, float z) {
  return sq_norm(x, y, z) > kFpsSkipNormSq ? 1e10f : -1.0f;
}

// ---------------------------------------------------------- ball query ----

constexpr int kChunk = 32;  // points a chunk: one warp's step
// rows of up to this many points (64 chunks) are scanned whole: a full scan
// is short there, and the box pre-pass would cost a launch (the rows of the
// model's sa2-sa4 and vote aggregation, FPS-ordered, where boxes span the
// room and prune little)
constexpr int kBqScanMaxPoints = 2048;

PL_HD bool bq_skips_chunks(int N) { return N > kBqScanMaxPoints; }

// The distance from centre coordinate c to [lo, hi] along one axis, in the
// point test's rounding: for any p in [lo, hi], gap <= |fl(c - p)|, because
// fl(lo - c) <= fl(p - c) and fl(c - hi) <= fl(c - p) (rounding is monotone
// and odd).
PL_HD float box_gap(float lo, float hi, float c) {
  const float below = sub_rn(lo, c);  // > 0: c lies below the box
  const float above = sub_rn(c, hi);  // > 0: c lies above it
  return fmaxf(fmaxf(below, above), 0.f);
}

// Whether a chunk with bounds box = (xlo, xhi, ylo, yhi, zlo, zhi) may hold a
// point p with ((c-p).x^2 + (c-p).y^2) + (c-p).z^2 < r2 in float32. Each
// gap is at most its |fl(c - p)| and every rounded square and sum is
// monotone, so box_d2 <= the point's rounded d2: a chunk that fails holds no
// hit. r2_box (bq_box_threshold) adds a margin on top, which only admits
// more chunks.
PL_HD bool box_may_hit(const float* box, float cx, float cy, float cz,
                       float r2_box) {
  const float d2 = sq_norm(box_gap(box[0], box[1], cx),
                           box_gap(box[2], box[3], cy),
                           box_gap(box[4], box[5], cz));
  return d2 < r2_box;
}

// r2 of the box test: the radius inflated by 2^-10 relative and 1e-6
// absolute, squared, rounded up to float32. (Host code.)
inline float bq_box_threshold(float r2) {
  const double r = std::sqrt(static_cast<double>(r2)) * (1.0 + 1.0 / 1024) +
                   1e-6;
  const double t2 = r * r;
  float t = static_cast<float>(t2);
  if (static_cast<double>(t) < t2) t = std::nextafter(t, FLT_MAX);
  return t;
}

// Whether chunk ch may hold a hit, its box read from a row's table of
// nchunks boxes laid out as six arrays of nchunks bounds: xlo, xhi, ylo,
// yhi, zlo, zhi.
PL_HD bool chunk_may_hit(const float* table, int nchunks, int ch, float cx,
                         float cy, float cz, float r2_box) {
  const float box[6] = {table[ch],
                        table[nchunks + ch],
                        table[2 * nchunks + ch],
                        table[3 * nchunks + ch],
                        table[4 * nchunks + ch],
                        table[5 * nchunks + ch]};
  return box_may_hit(box, cx, cy, cz, r2_box);
}

// The point test: c - p per axis, then sq_norm, against r2.
PL_HD bool point_hits(float px, float py, float pz, float cx, float cy,
                      float cz, float r2) {
  return sq_norm(sub_rn(cx, px), sub_rn(cy, py), sub_rn(cz, pz)) < r2;
}

}  // namespace point_logic
