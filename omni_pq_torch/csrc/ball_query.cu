// Fused ball query + relative-xyz grouping (+ feature-row grouping) on
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/ball_query.py::_bq_kernel
// via _bq_pallas (pallas_call at ball_query.py:392), forward only, for the
// entry points `ball_query_group` (emit_values=True), `ball_query` (idx only:
// `grouped` is null) and `ball_query_group_feats` (feat_dim > 0: `features`
// and `out_feats` set). Plain versions beside it:
// omni_pq_torch/ops/ball_query.py::ball_query_group_plain and
// ::ball_query_group_feats_plain, which this kernel equals bitwise.
//
// Semantics: per centre c, the first (by index) <= K points p with
// ((c-p).x^2 + (c-p).y^2) + (c-p).z^2 < r2; idx holds their indices and
// grouped holds p - c. Unfilled slots repeat the first hit; a centre with no
// hit gets index 0 and p[0] - c in every slot (ball_query_gpu.cu:38-45).
// r2 is the float32 rounding of radius*radius taken in double, the value
// both JAX versions compare against. With features, out_feats[c, k] is the
// feature row features[b, idx[c, k]]: a byte copy, so any element type, and
// a no-hit centre gets row 0 like its idx.
//
// What bounds it on the H100: operations for the query (a centre scans its
// row in index order until it has K hits, often the whole row when the ball
// holds fewer than K points: ~9 flops a scanned point), bytes for the
// feature rows (the (B,S,K,C) output is written once; at sa2 that is 512 MiB
// in float32). The simple design below re-reads the points' row from L2 for
// every centre, and each feature row once per slot that names it.
//
// Design: one warp per centre, 32 consecutive points a step. __ballot_sync
// marks the hits and a popc prefix gives each hit its slot, so slots fill in
// index order; the loop stops at K hits. idx and grouped are written in the
// same pass. The distance uses __f*_rn intrinsics so nvcc cannot fuse it
// into FMAs (a fused form moves boundary points). Then, once the K slots are
// final, the warp copies the K feature rows: lanes walk the (slot, vector)
// pairs of the centre's contiguous output block, 16, 8, 4, 2 or 1 bytes a
// lane (the widest that divides the row and both base addresses), so the
// stores of a warp are contiguous; each lane issues 4 loads before its 4
// stores. Offsets are 64-bit. The query-only entry points compile without
// the copy. Later work: stage point tiles in shared memory for a block's
// warps, and skip Morton-ordered chunks whose bounding box misses the ball
// (the TPU kernel's _chunk_tables).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // centres per block

constexpr int kCopyUnroll = 4;  // feature vectors a lane has in flight

// kFeats = false compiles the query alone: no copy code, and its registers
// stay those of the query loop (32), which keeps 8 blocks an SM resident
template <typename V, bool kFeats>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int* __restrict__ idx,
                  float* __restrict__ grouped,
                  const V* __restrict__ features, V* __restrict__ out_feats,
                  int row_vecs, int N, long long centres, int S, int K,
                  float r2) {
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (c >= centres) return;  // the whole warp: one centre a warp
  const long long b = c / S;
  const float* p = xyz + b * N * 3;
  const float cx = new_xyz[3 * c], cy = new_xyz[3 * c + 1],
              cz = new_xyz[3 * c + 2];
  int* out_i = idx + c * K;
  float* out_g = grouped ? grouped + c * K * 3 : nullptr;

  int count = 0;
  int first = 0;  // the first hit; 0 stands in when there is none
  for (int base = 0; base < N && count < K; base += 32) {
    const int n = base + lane;
    bool hit = false;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (n < N) {
      px = p[3 * n];
      py = p[3 * n + 1];
      pz = p[3 * n + 2];
      const float dx = __fsub_rn(cx, px), dy = __fsub_rn(cy, py),
                  dz = __fsub_rn(cz, pz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0) continue;
    if (count == 0) first = base + __ffs(mask) - 1;
    const int slot = count + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < K) {
      out_i[slot] = n;
      if (out_g) {
        out_g[3 * slot] = __fsub_rn(px, cx);
        out_g[3 * slot + 1] = __fsub_rn(py, cy);
        out_g[3 * slot + 2] = __fsub_rn(pz, cz);
      }
    }
    count += __popc(mask);
  }
  if (count < K) {
    const float fx = __fsub_rn(p[3 * first], cx),
                fy = __fsub_rn(p[3 * first + 1], cy),
                fz = __fsub_rn(p[3 * first + 2], cz);
    for (int slot = count + lane; slot < K; slot += 32) {
      out_i[slot] = first;
      if (out_g) {
        out_g[3 * slot] = fx;
        out_g[3 * slot + 1] = fy;
        out_g[3 * slot + 2] = fz;
      }
    }
  }
  if constexpr (kFeats) {
    // every lane's idx stores are visible to the whole warp after this
    __syncwarp();
    // a centre's block (K rows) fits an int; the base offsets need 64 bits
    const V* src = features + b * N * row_vecs;
    V* dst = out_feats + c * K * row_vecs;
    const int total = K * row_vecs;
    for (int e0 = lane; e0 < total; e0 += 32 * kCopyUnroll) {
      // all loads first, so each lane has kCopyUnroll of them in flight
      V v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int e = e0 + 32 * u;
        if (e < total) {
          const int k = e / row_vecs;
          v[u] = src[static_cast<long long>(out_i[k]) * row_vecs +
                     (e - k * row_vecs)];
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int e = e0 + 32 * u;
        if (e < total) dst[e] = v[u];
      }
    }
  }
}

template <typename V, bool kFeats = true>
int launch(const float* xyz, const float* new_xyz, int* idx, float* grouped,
           const void* features, void* out_feats, long long row_bytes,
           int N, long long centres, int S, int K, float r2,
           cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((centres + kWarps - 1) / kWarps);
  ball_query_kernel<V, kFeats><<<blocks, kWarps * 32, 0, stream>>>(
      xyz, new_xyz, idx, grouped, static_cast<const V*>(features),
      static_cast<V*>(out_feats),
      static_cast<int>(row_bytes / static_cast<long long>(sizeof(V))), N,
      centres, S, K, r2);
  return cudaGetLastError();
}

}  // namespace

// features / out_feats: null for the idx(+grouped) entry points; otherwise
// (B,N,row_bytes) and (B,S,K,row_bytes) byte arrays, row_bytes > 0.
extern "C" int ball_query_launch(const float* xyz, const float* new_xyz,
                                 int* idx, float* grouped,
                                 const void* features, void* out_feats,
                                 long long row_bytes, int B, int N, int S,
                                 int K, float r2, cudaStream_t stream) {
  const long long centres = static_cast<long long>(B) * S;
  if (centres == 0) return cudaSuccess;
  if (out_feats == nullptr)
    return launch<uint4, false>(xyz, new_xyz, idx, grouped, nullptr,
                                nullptr, 16, N, centres, S, K, r2, stream);
  // the widest vector that divides the row and both base addresses
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes) |
      reinterpret_cast<uintptr_t>(features) |
      reinterpret_cast<uintptr_t>(out_feats);
  if (align % 16 == 0)
    return launch<uint4>(xyz, new_xyz, idx, grouped, features, out_feats,
                         row_bytes, N, centres, S, K, r2, stream);
  if (align % 8 == 0)
    return launch<uint2>(xyz, new_xyz, idx, grouped, features, out_feats,
                         row_bytes, N, centres, S, K, r2, stream);
  if (align % 4 == 0)
    return launch<unsigned>(xyz, new_xyz, idx, grouped, features, out_feats,
                            row_bytes, N, centres, S, K, r2, stream);
  if (align % 2 == 0)
    return launch<unsigned short>(xyz, new_xyz, idx, grouped, features,
                                  out_feats, row_bytes, N, centres, S, K, r2,
                                  stream);
  return launch<unsigned char>(xyz, new_xyz, idx, grouped, features,
                               out_feats, row_bytes, N, centres, S, K, r2,
                               stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
