// Furthest point sampling on Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/fps.py::_fps_kernel
// (pallas_call at fps.py:139, entry point `fps`). Plain version beside it:
// omni_pq_torch/ops/reference.py::fps_ref, which this kernel equals bitwise.
//
// Semantics: index 0 first; points with x*x+y*y+z*z <= 1e-3 are never picked
// (their min distance starts at -1 and min() keeps it there); each step
// lowers the running min distance of every point by its squared distance to
// the last pick and takes the largest, lowest index on ties.
//
// What bounds it on the H100: not bytes (12 bytes a point, read once) nor
// operations (~10 flops a point and step) but the chain of npoint-1
// dependent block-wide argmax steps. One block per batch row, so a batch of
// B rows keeps only B of the 132 SMs busy, and each step re-reads the row's
// coordinates from L2 at one SM's rate.
//
// Design: the min-distance row lives in dynamic shared memory (N floats,
// up to ~58k points), so only the coordinates stream from L2 each step. Each
// thread scans its strided points in ascending order, keeping the first
// maximum; a warp-shuffle (max value, min index) reduction and one pass over
// the 32 warp winners give the pick. The distance is ((dx*dx + dy*dy) +
// dz*dz) with __f*_rn intrinsics: nvcc would otherwise contract it into
// FMAs, and a reordered or fused form flips near-ties (fps.py:82-91).
// Later work: spread a row over a thread-block cluster so more SMs share it.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kSkipNormSq = 1e-3f;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// argmax order: the larger value wins, the lower index on ties
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N,
           int npoint) {
  extern __shared__ float mind[];  // N floats: running min distance
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int picked;

  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int n = tid; n < N; n += blockDim.x) {
    mind[n] = sq_norm(p[3 * n], p[3 * n + 1], p[3 * n + 2]) > kSkipNormSq
                  ? 1e10f
                  : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  int last = 0;
  __syncthreads();

  for (int step = 1; step < npoint; ++step) {
    const float cx = p[3 * last], cy = p[3 * last + 1], cz = p[3 * last + 2];
    float bv = -FLT_MAX;
    int bi = INT_MAX;
    for (int n = tid; n < N; n += blockDim.x) {
      const float d = sq_norm(__fsub_rn(p[3 * n], cx),
                              __fsub_rn(p[3 * n + 1], cy),
                              __fsub_rn(p[3 * n + 2], cz));
      const float m = fminf(mind[n], d);
      mind[n] = m;
      if (m > bv) {  // n ascends: strict > keeps this thread's first maximum
        bv = m;
        bi = n;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? warp_v[lane] : -FLT_MAX;
      bi = lane < nwarps ? warp_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        picked = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    last = picked;
  }
}

}  // namespace

extern "C" int fps_launch(const float* xyz, int* out, int B, int N,
                          int npoint, cudaStream_t stream) {
  const int smem = N * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  fps_kernel<<<B, threads, smem, stream>>>(xyz, out, N, npoint);
  return cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
