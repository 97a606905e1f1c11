// Host harness of omni_pq_torch/csrc/point_logic.cuh, the index logic of the
// FPS and ball-query CUDA kernels, and of csrc/mlp_logic.cuh, the BN + ReLU
// step and pool of the fused SA-MLP kernels. It builds serial models of the
// kernels' loops from the headers' functions, one lane at a time: FPS's
// per-thread, per-warp and per-slot candidates, the ball query's chunk boxes
// and ascending chunk-skipping query of one centre, and the fused train
// mode's pool from each centre's max and min. The models are this file's
// own (the kernels run the same decisions as warp-wide ballots and
// butterflies); what they share with the kernels is the headers.
// tests/test_torch_port_kernel_logic.py builds it with
//   g++ -O2 -ffp-contract=off -std=c++20 -pthread -shared -fPIC -I omni_pq_torch/csrc
// and holds it against the plain versions and the JAX package's oracles.
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>

#include "mlp_logic.cuh"
#include "point_logic.cuh"
#include "wgmma_logic.cuh"

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

// The fused train mode's pool of `centres` centres of K rows of C channels
// (a row-major (centres * K, C)): each channel's max and min over a centre's
// rows, as the last pass keeps them, then mlp_logic::pool_from_extremes
// with that channel's BN, as the pool launch computes it.
void mlp_pool(const float* a, int centres, int K, int C, const float* mu,
              const float* mul, const float* b, float* out) {
  for (int n = 0; n < centres; ++n)
    for (int c = 0; c < C; ++c) {
      float mx = a[(static_cast<long long>(n) * K) * C + c], mn = mx;
      for (int k = 1; k < K; ++k) {
        const float v = a[(static_cast<long long>(n) * K + k) * C + c];
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
      }
      out[static_cast<long long>(n) * C + c] =
          mlp_logic::pool_from_extremes(mx, mn, mu[c], mul[c], b[c]);
    }
}

// mlp_logic::bn_relu of each of n elements with channel c = i % C's BN
void mlp_bn_relu(const float* a, long long n, int C, const float* mu,
                 const float* mul, const float* b, float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = mlp_logic::bn_relu(a[i], mu[i % C], mul[i % C], b[i % C]);
}

// The bfloat16 mode: mlp_logic::bn_relu_bf16 of each element (a is the
// float32 sum of a product, rounded to bfloat16 inside), and the pool from
// each centre's max and min of af = round_bf16(a) with
// pool_from_extremes_bf16, as the bfloat16 pass kernel and the pool launch
// compute them.
void mlp_bn_relu_bf16(const float* a, long long n, int C, const float* mu,
                      const float* mul, const float* b, float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = mlp_logic::bn_relu_bf16(a[i], mu[i % C], mul[i % C], b[i % C]);
}

void mlp_pool_bf16(const float* a, int centres, int K, int C,
                   const float* mu, const float* mul, const float* b,
                   float* out) {
  for (int n = 0; n < centres; ++n)
    for (int c = 0; c < C; ++c) {
      float mx = mlp_logic::round_bf16(
          a[(static_cast<long long>(n) * K) * C + c]);
      float mn = mx;
      for (int k = 1; k < K; ++k) {
        const float v = mlp_logic::round_bf16(
            a[(static_cast<long long>(n) * K + k) * C + c]);
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
      }
      out[static_cast<long long>(n) * C + c] =
          mlp_logic::pool_from_extremes_bf16(mx, mn, mu[c], mul[c], b[c]);
    }
}

// mlp_logic::round_bf16 of each of n elements
void round_bf16_n(const float* a, long long n, float* out) {
  for (long long i = 0; i < n; ++i) out[i] = mlp_logic::round_bf16(a[i]);
}

// ---- csrc/wgmma_logic.cuh: the bfloat16 fused kernels' layouts and plans

long long wl_packed_index(int n, int k, int cout) {
  return wgmma_logic::packed_weight_index(n, k, cout);
}

long long wl_stage_offset(int kc, int n0, int cout) {
  return wgmma_logic::packed_stage_offset(kc, n0, cout);
}

// the byte wgmma reads for (n, k) of k step s, from the descriptor that
// make_desc builds for a stage at shared address addr: its start, leading
// and stride byte offsets decoded as the hardware reads them
long long wl_desc_byte(unsigned addr, int n, int k, int s) {
  const uint64_t d = wgmma_logic::make_desc(addr) +
                     ((s * 2 * wgmma_logic::kLBO) >> 4);
  const long long start = (d & 0x3FFF) << 4, lbo = ((d >> 16) & 0x3FFF) << 4,
                  sbo = ((d >> 32) & 0x3FFF) << 4;
  if ((d >> 62) != 0) return -1;  // a swizzle mode: not this layout
  return start + (n / 8) * sbo + (k / 8) * lbo + (n % 8) * 16 + (k % 8) * 2;
}

// PTX's m64nN float32 accumulator layout: (row, column) of D register r of
// lane `lane` of warp w (of the warpgroup's 4)
void wl_acc_row_col(int w, int lane, int r, int* out2) {
  out2[0] = 16 * w + lane / 4 + 8 * ((r % 4) / 2);
  out2[1] = 8 * (r / 4) + 2 * (lane % 4) + r % 2;
}

// PTX's register-A fragment of a k step of 16 (bfloat16): (row, k) of half
// `half` of A register `reg`
void wl_afrag_row_k(int w, int lane, int reg, int half, int* out2) {
  out2[0] = 16 * w + lane / 4 + 8 * (reg % 2);
  out2[1] = 8 * (reg / 2) + 2 * (lane % 4) + half;
}

int wl_acc_for_afrag(int s, int reg, int half) {
  return wgmma_logic::acc_for_afrag(s, reg, half);
}

void wl_f32_window(long long row, int cin, int k0, long long* out3) {
  long long begin;
  int bytes, off;
  wgmma_logic::f32_window(row, cin, k0, &begin, &bytes, &off);
  out3[0] = begin;
  out3[1] = bytes;
  out3[2] = off;
}

}  // extern "C"

namespace {

// The pass kernel's epilogue over a 128-row tile af (row-major, n = N * 4
// columns), lane by lane as the 8 consumer warps hold it: each lane's two
// rows g and g + 8 of its columns 8 i + 2 q (+1) (sums a + b, squares
// a*a + b*b, extremes), wgmma_logic::halve8 over the quad column run by 32
// threads in lockstep (a barrier where the card shuffles), each result
// stored at the column halve8_origin gives, then the warps' partials added
// in order, and each segment's warps' extremes combined. s1, s2: n; mx,
// mn: (valid / seg, n).
template <int N>
void tile_reduce(const float* af, int seg, int valid, float* s1, float* s2,
                 float* mx, float* mn) {
  constexpr int n = 4 * N, warps = wgmma_logic::kConsumerWarps;
  std::vector<float> p1(warps * n), p2(warps * n), pmx(warps * n),
      pmn(warps * n);
  float shared[32];
  std::barrier sync(32);
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < 32; ++lane)
    lanes.emplace_back([&, lane] {
      const int g = lane / 4, q = lane % 4;
      auto xchg = [&](float v, int m) {
        shared[lane] = v;
        sync.arrive_and_wait();
        const float r = shared[lane ^ m];
        sync.arrive_and_wait();
        return r;
      };
      auto add = [](float a, float b) { return a + b; };
      auto hi = [](float a, float b) { return fmaxf(a, b); };
      auto lo = [](float a, float b) { return fminf(a, b); };
      for (int w = 0; w < warps; ++w) {
        float v1[N], v2[N], e[4][N / 2];  // e: max lo/hi, min lo/hi
        for (int i = 0; i < n / 8; ++i)
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = 8 * i + 2 * q + c2;
            const float a = af[(16 * w + g) * n + col],
                        b = af[(16 * w + g + 8) * n + col];
            v1[2 * i + c2] = a + b;
            v2[2 * i + c2] = a * a + b * b;
            e[c2][i] = fmaxf(a, b);
            e[2 + c2][i] = fminf(a, b);
          }
        wgmma_logic::halve8<N>(v1, g, add, xchg);
        wgmma_logic::halve8<N>(v2, g, add, xchg);
        for (int x = 0; x < 4; ++x)
          if (x < 2)
            wgmma_logic::halve8<N / 2>(e[x], g, hi, xchg);
          else
            wgmma_logic::halve8<N / 2>(e[x], g, lo, xchg);
        for (int k = 0; k < N / 8; ++k) {
          const int o = wgmma_logic::halve8_origin(k, g, N);
          const int col = 8 * (o / 2) + 2 * q + o % 2;
          p1[w * n + col] = v1[k];
          p2[w * n + col] = v2[k];
        }
        for (int k = 0; k < N / 16; ++k) {
          const int col = 8 * wgmma_logic::halve8_origin(k, g, N / 2) + 2 * q;
          pmx[w * n + col] = e[0][k];
          pmx[w * n + col + 1] = e[1][k];
          pmn[w * n + col] = e[2][k];
          pmn[w * n + col + 1] = e[3][k];
        }
      }
    });
  for (auto& t : lanes) t.join();
  for (int c = 0; c < n; ++c) {
    float a = p1[c], b = p2[c];
    for (int w = 1; w < warps; ++w) {
      a = a + p1[w * n + c];
      b = b + p2[w * n + c];
    }
    s1[c] = a;
    s2[c] = b;
  }
  const int wps = seg / 16;
  for (int sg = 0; sg < valid / seg; ++sg)
    for (int c = 0; c < n; ++c) {
      float a = pmx[sg * wps * n + c], b = pmn[sg * wps * n + c];
      for (int w = 1; w < wps; ++w) {
        a = fmaxf(a, pmx[(sg * wps + w) * n + c]);
        b = fminf(b, pmn[(sg * wps + w) * n + c]);
      }
      mx[sg * n + c] = a;
      mn[sg * n + c] = b;
    }
}

}  // namespace

extern "C" {

// tile_reduce at n = 128 or 256 columns (the pass kernel's items)
void wl_tile_reduce(const float* af, int n, int seg, int valid, float* s1,
                    float* s2, float* mx, float* mn) {
  if (n == 256)
    tile_reduce<64>(af, seg, valid, s1, s2, mx, mn);
  else
    tile_reduce<32>(af, seg, valid, s1, s2, mx, mn);
}

long long wl_pass_smem(int f32_src, int cin) {
  return wgmma_logic::pass_smem_bytes(f32_src != 0, cin);
}

long long wl_chain_smem(int c0) { return wgmma_logic::chain_smem_bytes(c0); }

int wl_chain_stages(int c0) { return wgmma_logic::chain_stages(c0); }

int wl_chain_takes(const int* chans, int L, int K) {
  return wgmma_logic::chain_takes(chans, L, K);
}

int wl_halve8_origin(int k, int g, int N) {
  return wgmma_logic::halve8_origin(k, g, N);
}

// (bfloat16 stage pitch, float32 stage pitch, elements), the shared rows
void wl_pitches(int* out2) {
  out2[0] = wgmma_logic::kPitchBf16;
  out2[1] = wgmma_logic::kPitchF32;
}

}  // extern "C"
