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
// operations (~10 flops a point and step: 0.2 ms a forward at 67 TFLOP/s)
// but the chain of npoint-1 dependent argmax steps, each a reduction over
// the whole row: its latency, 2047 times at sa1. Measured (H100 80GB HBM3,
// 700 W, scripts/torch_kernel_times.py): 1.42 us a step at sa1 on a 16-CTA
// cluster (2.9 ms at B=16), 0.52-0.59 us on one CTA for rows of up to 2048
// points.
//
// Design: a batch row is split over a thread-block cluster of P CTAs, each
// owning a contiguous slice (point_logic.cuh: fps_plan, fps_slice). P comes
// from the shape: rows of up to 2048 points take one CTA (P = 1, <= 256
// threads, 8 points a thread); larger rows a non-portable cluster of 16
// (16 points a thread, the fewest warps that hold the slice: 160 threads at
// sa1). A cluster that cannot be scheduled is an error
// (cudaOccupancyMaxActiveClusters), never a quiet smaller launch. Each
// thread loads its points once and keeps their coordinates and running min
// distance in registers; no step reads the row from memory again.
// A step: each thread lowers its points' min distance against the last pick
// and keeps its first maximum (ascending index, strict >); a warp-shuffle
// (value, index) butterfly gives each warp's best point, whose lane holds
// its coordinates. Each warp's candidate (value, index, x, y, z) goes into
// a slot of every cluster CTA's shared memory: st.async through DSMEM, which
// counts its bytes on the receiving CTA's mbarrier, so a CTA waits only for
// its own P x warps candidates (P = 1: a plain store and one
// __syncthreads). Two slot banks and two mbarriers alternate by step
// parity: step s+1's stores cannot reach a bank a CTA still merges for step
// s, since they need that CTA's own step-s candidates, sent after its merge
// of step s-1. Every warp of every CTA then merges all slots with the same
// total order (larger value, lower index), so all agree on the pick and
// already hold its coordinates: the next centre. (A barrier.cluster
// arrive.release / wait.acquire a step in place of the mbarriers was
// markedly slower: every CTA then waits for the slowest.) The distance is
// ((dx*dx + dy*dy) + dz*dz) with __f*_rn intrinsics: nvcc would otherwise
// contract it into FMAs, and a reordered or fused form flips near-ties
// (omni_pq_tpu/ops/fps.py:82-91).

#include <cuda_runtime.h>

#include <cstdint>

#include "point_logic.cuh"

using namespace point_logic;

namespace {

constexpr int kMaxSlots = kFpsMaxCluster * (kFpsMaxThreads / 32);
constexpr int kSlotBytes = 20;  // (value, index, x, y) and z
// returned when the cluster of a plan cannot be scheduled, or N too large
constexpr int kErrUnschedulable = 10001;
constexpr int kErrTooLarge = 10002;

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same shared-memory location in cluster CTA `rank`
__device__ __forceinline__ uint32_t remote_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

struct Slots {
  float4 vixy[2][kMaxSlots];  // value, index (its bits), x, y
  float z[2][kMaxSlots];
  unsigned long long full[2];  // mbarrier of each bank (clusters only)
};

// kPpt points a thread in registers; kCluster: the row spans a cluster of
// gridDim-consecutive CTAs (its size from the launch attribute)
template <int kPpt, bool kCluster>
__global__ void __launch_bounds__(kFpsMaxThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N,
           int npoint) {
  __shared__ Slots slots;
  int P = 1, rank = 0;
  if constexpr (kCluster) {
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(P));
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  }
  const int row = blockIdx.x / P;
  const float* p = xyz + static_cast<size_t>(row) * N * 3;
  int* o = out + static_cast<size_t>(row) * npoint;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nslots = P * nwarps;
  const int my_slot = rank * nwarps + warp;

  int begin, end;
  fps_slice(N, P, rank, begin, end);
  float px[kPpt], py[kPpt], pz[kPpt], md[kPpt];
#pragma unroll
  for (int k = 0; k < kPpt; ++k) {
    const int n = begin + tid + k * static_cast<int>(blockDim.x);
    if (n < end) {
      px[k] = p[3 * n];
      py[k] = p[3 * n + 1];
      pz[k] = p[3 * n + 2];
      md[k] = fps_initial_mind(px[k], py[k], pz[k]);
    } else {  // no point: -FLT_MAX never beats the start value
      px[k] = py[k] = pz[k] = 0.f;
      md[k] = -FLT_MAX;
    }
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  float cx = p[0], cy = p[1], cz = p[2];
  if constexpr (kCluster) {
    if (tid == 0) {
      for (int bank = 0; bank < 2; ++bank)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(&slots.full[bank]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every CTA of the cluster runs, its mbarriers set, before any store
    cluster_sync();
  }

  for (int step = 1; step < npoint; ++step) {
    const int par = step & 1;
    float bv = -FLT_MAX, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int k = 0; k < kPpt; ++k) {
      const float d = sq_norm(sub_rn(px[k], cx), sub_rn(py[k], cy),
                              sub_rn(pz[k], cz));
      const float m = fminf(md[k], d);
      md[k] = m;
      if (m > bv) {  // k ascends the index: strict > keeps the first max
        bv = m;
        bi = begin + tid + k * static_cast<int>(blockDim.x);
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    float wv = bv;
    int wi = bi;
    warp_argmax(wv, wi);
    // the warp's best point's coordinates, from the lane that holds it
    const int src = __ffs(__ballot_sync(0xffffffffu, bi == wi)) - 1;
    const float4 cand = make_float4(wv, __int_as_float(wi),
                                    __shfl_sync(0xffffffffu, bx, src),
                                    __shfl_sync(0xffffffffu, by, src));
    const float wz = __shfl_sync(0xffffffffu, bz, src);
    if constexpr (kCluster) {
      const uint32_t full = smem_addr(&slots.full[par]);
      if (tid == 0)  // this step's bytes: one candidate a warp of the cluster
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                full),
            "r"(nslots * kSlotBytes)
            : "memory");
      if (lane < P) {  // lane r sends this warp's candidate to CTA r
        const uint32_t rfull = remote_addr(full, lane);
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
            "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(
                remote_addr(smem_addr(&slots.vixy[par][my_slot]), lane)),
            "r"(__float_as_uint(cand.x)), "r"(__float_as_uint(cand.y)),
            "r"(__float_as_uint(cand.z)), "r"(__float_as_uint(cand.w)),
            "r"(rfull)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];" ::"r"(
                remote_addr(smem_addr(&slots.z[par][my_slot]), lane)),
            "r"(__float_as_uint(wz)), "r"(rfull)
            : "memory");
      }
      // the bank's k-th use (steps par+1, par+3, ...) completes phase k
      asm volatile(
          "{\n.reg .pred done;\nWAIT_%=:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
          "@!done bra WAIT_%=;\n}\n" ::"r"(full),
          "r"(((step - 1) >> 1) & 1)
          : "memory");
    } else {
      if (lane == 0) {
        slots.vixy[par][my_slot] = cand;
        slots.z[par][my_slot] = wz;
      }
      __syncthreads();
    }
    // every warp merges all slots the same way: lanes take slots
    // lane, lane + 32, ..., then the butterfly
    float mv = -FLT_MAX, mx = 0.f, my = 0.f, mz = 0.f;
    int mi = INT_MAX;
    for (int s = lane; s < nslots; s += 32) {
      const float4 t = slots.vixy[par][s];
      const int si = __float_as_int(t.y);
      if (fps_better(t.x, si, mv, mi)) {
        mv = t.x;
        mi = si;
        mx = t.z;
        my = t.w;
        mz = slots.z[par][s];
      }
    }
    float gv = mv;
    int gi = mi;
    warp_argmax(gv, gi);
    const int gsrc = __ffs(__ballot_sync(0xffffffffu, mi == gi)) - 1;
    cx = __shfl_sync(0xffffffffu, mx, gsrc);
    cy = __shfl_sync(0xffffffffu, my, gsrc);
    cz = __shfl_sync(0xffffffffu, mz, gsrc);
    if (rank == 0 && tid == 0) o[step] = gi;
  }
  // no CTA exits while another's store to it may be in flight
  if constexpr (kCluster) cluster_sync();
}

template <int kPpt, bool kCluster>
int launch(const float* xyz, int* out, int B, int N, int npoint,
           const FpsPlan& plan, cudaStream_t stream) {
  auto kernel = fps_kernel<kPpt, kCluster>;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B * plan.cluster));
  config.blockDim = dim3(static_cast<unsigned>(plan.threads));
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    if (plan.cluster > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(plan.cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return kErrUnschedulable;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&config, kernel, xyz, out, N, npoint);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The plan fps_launch takes for N-point rows: {cluster size P, threads a
// CTA, points a thread}.
extern "C" void fps_plan_for(int N, int* plan3) {
  const FpsPlan plan = fps_plan(N);
  plan3[0] = plan.cluster;
  plan3[1] = plan.threads;
  plan3[2] = plan.ppt;
}

// The most points a row may hold: a 16-CTA cluster's registers.
extern "C" int fps_max_points() { return kFpsMaxPoints; }

extern "C" int fps_launch(const float* xyz, int* out, int B, int N,
                          int npoint, cudaStream_t stream) {
  const FpsPlan plan = fps_plan(N);
  if (plan.cluster < 1) return kErrTooLarge;
  if (plan.cluster > 1)
    return launch<kFpsPpt, true>(xyz, out, B, N, npoint, plan, stream);
  return launch<kFpsSmallPpt, false>(xyz, out, B, N, npoint, plan, stream);
}

extern "C" const char* error_string(int code) {
  if (code == kErrUnschedulable)
    return "the FPS kernel's thread-block cluster cannot be scheduled on "
           "this card (cudaOccupancyMaxActiveClusters gave 0)";
  if (code == kErrTooLarge)
    return "the row holds more points than a 16-CTA cluster's registers";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
