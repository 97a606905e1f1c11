// Fused ball query + relative-xyz grouping on Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/ball_query.py::_bq_kernel
// via _bq_pallas (pallas_call at ball_query.py:392), forward only, for the
// entry points `ball_query_group` (emit_values=True) and `ball_query`
// (idx only: `grouped` is null). Plain version beside it:
// omni_pq_torch/ops/ball_query.py::ball_query_group_plain, which this kernel
// equals bitwise.
//
// Semantics: per centre c, the first (by index) <= K points p with
// ((c-p).x^2 + (c-p).y^2) + (c-p).z^2 < r2; idx holds their indices and
// grouped holds p - c. Unfilled slots repeat the first hit; a centre with no
// hit gets index 0 and p[0] - c in every slot (ball_query_gpu.cu:38-45).
// r2 is the float32 rounding of radius*radius taken in double, the value
// both JAX versions compare against.
//
// What bounds it on the H100: operations. A centre scans its row in index
// order until it has K hits, often the whole row when the ball holds fewer
// than K points: ~9 flops a scanned point, while the bytes are a read of the
// row and a write of idx and grouped. The simple design below also re-reads
// the row from L2 for every centre.
//
// Design: one warp per centre, 32 consecutive points a step. __ballot_sync
// marks the hits and a popc prefix gives each hit its slot, so slots fill in
// index order; the loop stops at K hits. idx and grouped are written in the
// same pass. The distance uses __f*_rn intrinsics so nvcc cannot fuse it
// into FMAs (a fused form moves boundary points). Later work: stage point
// tiles in shared memory for a block's warps, and skip Morton-ordered chunks
// whose bounding box misses the ball (the TPU kernel's _chunk_tables).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // centres per block

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int* __restrict__ idx,
                  float* __restrict__ grouped, int N, long long centres,
                  int S, int K, float r2) {
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (c >= centres) return;
  const float* p = xyz + (c / S) * N * 3;
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
}

}  // namespace

extern "C" int ball_query_launch(const float* xyz, const float* new_xyz,
                                 int* idx, float* grouped, int B, int N,
                                 int S, int K, float r2, cudaStream_t stream) {
  const long long centres = static_cast<long long>(B) * S;
  if (centres == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((centres + kWarps - 1) / kWarps);
  ball_query_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      xyz, new_xyz, idx, grouped, N, centres, S, K, r2);
  return cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
