// Radius-masked multi-head self-attention, forward only, float32, on
// Hopper (sm_90a): the masked encoder of 3DETR-m (models/three_detr.py).
//
// Replaces: no TPU kernel. The JAX package has no 3DETR and no masked
// attention; this kernel was added with the second architecture so that
// its encoder never materialises the B x H x N x N logits, their softmax or
// a B x N x N mask (1.07 GB each at B=16, N=2048 in float32). Plain version
// beside it: omni_pq_torch/ops/radius_attention.py::radius_attention_plain.
//
// Semantics, per batch row b, head h and query i over the N point tokens:
//   keep(i, j) = ((dx*dx + dy*dy) + dz*dz) < r2, d = xyz[b,i] - xyz[b,j],
//     each product and sum rounded once in float32 (__f*_rn through
//     point_logic.cuh's sq_norm, the plain version's order), r2 the float32
//     square of the radius (ops.reference.radius_sq);
//   out[b, i, h, :] = sum_j softmax_j(q[b,h,i] . k[b,h,j] | keep) v[b,h,j],
// q already scaled by 1/sqrt(head size) (nn.MultiheadAttention's order).
// Every query keeps itself (d = 0), so no row is empty. The output is laid
// out (B, N, H, 64): heads merged, as the output projection reads it.
//
// What bounds it on the H100: its bytes are q, k, v, xyz read once and the
// output written once (134.6 MB at B=16, N=2048: 0.040 ms at 3.35 TB/s);
// over all pairs its operations are 4 * B*H*N*N*64 flops (68.7 GFLOP at
// that shape: 1.03 ms at the 67 TFLOP/s float32 rate, which is what this
// kernel pays, since it computes every pair and masks the logits). The
// masks of a room are sparse (PERF.md §5), so a later kernel that skips
// tiles with no kept pair can go far below that; this one is the dense
// baseline. TF32 or bf16 tensor cores would change the numbers the plain
// version is held to, so the products are float32 FMAs on the CUDA cores.
//
// Design (FlashAttention's forward with an online softmax, in SIMT float32):
// one block of 256 threads takes 64 queries of one (b, h) and walks the
// keys in tiles of 64. Shared memory holds the scaled q tile, the k and v
// tiles, the keys' xyz and the tile's probabilities P (72 KB: two blocks an
// SM). Thread (ty, tx) of a 16 x 16 grid owns queries ty + 16i and, for the
// logits, keys tx + 16j (i, j < 4): the 4 x 4 logits are register-tiled
// outer products over the head size, 8 float4 shared loads for 64 FMAs;
// the rows of q, k and P are padded so that these loads are broadcasts or
// conflict-free. The mask is computed in registers from the queries' and
// keys' xyz; a masked logit becomes -inf. A row's tile maximum is reduced
// over its 16 threads (one half-warp) by shuffles; each thread keeps its
// own partial row sum, rescaled with the running maximum, and adds the 16
// partials at the end. P goes to shared memory and the output tile
// (queries ty + 16i, head columns 4tx..4tx+3) gathers P . V, again 8 float4
// loads for 64 FMAs. Products are explicit __fmaf_rn (the library is built
// with --fmad=false). Nothing but the output reaches device memory.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "point_logic.cuh"

using namespace point_logic;

namespace {

constexpr int kD = 64;         // head size
constexpr int kBQ = 64;        // queries a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kQStride = 68;   // floats a row of the q and k tiles
constexpr int kPStride = 80;   // floats a row of the P tile

struct Smem {
  float q[kBQ * kQStride];
  float k[kBK * kQStride];
  float v[kBK * kD];
  float p[kBQ * kPStride];
  float kxyz[kBK * 3];
};

constexpr int kSmemBytes = sizeof(Smem);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the largest of a value over the 16 lanes of a half-warp
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Copy `rows` rows of 64 floats from a (rows_total, 64) array into a tile
// whose rows are `stride` floats apart, zero past row `valid`.
__device__ __forceinline__ void load_tile(float* tile, int stride,
                                          const float* src, int valid) {
  for (int t = threadIdx.x; t < kBK * (kD / 4); t += kThreads) {
    const int row = t / (kD / 4), c4 = t % (kD / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < valid) x = ld4(src + static_cast<int64_t>(row) * kD + 4 * c4);
    *reinterpret_cast<float4*>(tile + row * stride + 4 * c4) = x;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
radius_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ xyz,
                        float* __restrict__ out, int H, int N, float r2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t head = static_cast<int64_t>(bh) * N * kD;
  const float* pts = xyz + static_cast<int64_t>(b) * N * 3;

  load_tile(s.q, kQStride, q + head + static_cast<int64_t>(q0) * kD,
            N - q0);
  float qx[4], qy[4], qz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const int at = row < N ? row : 0;
    qx[i] = pts[3 * at];
    qy[i] = pts[3 * at + 1];
    qz[i] = pts[3 * at + 2];
  }

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int valid = N - k0 < kBK ? N - k0 : kBK;
    __syncthreads();  // the previous tile's P . V has read k, v and P
    load_tile(s.k, kQStride, k + head + static_cast<int64_t>(k0) * kD,
              valid);
    load_tile(s.v, kD, v + head + static_cast<int64_t>(k0) * kD, valid);
    for (int t = threadIdx.x; t < kBK * 3; t += kThreads)
      s.kxyz[t] = t < valid * 3 ? pts[static_cast<int64_t>(k0) * 3 + t] : 0.f;
    __syncthreads();

    // logits of queries ty + 16i against keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(s.k + (tx + 16 * j) * kQStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = ld4(s.q + (ty + 16 * i) * kQStride + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = __fmaf_rn(qv.x, kv[j].x, sc[i][j]);
          sc[i][j] = __fmaf_rn(qv.y, kv[j].y, sc[i][j]);
          sc[i][j] = __fmaf_rn(qv.z, kv[j].z, sc[i][j]);
          sc[i][j] = __fmaf_rn(qv.w, kv[j].w, sc[i][j]);
        }
      }
    }

    // the mask, from the points
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = tx + 16 * j;
      const float kx = s.kxyz[3 * kj], ky = s.kxyz[3 * kj + 1],
                  kz = s.kxyz[3 * kj + 2];
      const bool in_row = kj < valid;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d2 = sq_norm(sub_rn(qx[i], kx), sub_rn(qy[i], ky),
                                 sub_rn(qz[i], kz));
        if (!(in_row && d2 < r2)) sc[i][j] = -INFINITY;
      }
    }

    // online softmax: the running maximum over the row's half-warp, this
    // thread's partial sums and output columns rescaled to it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // a row with no kept key yet: every p and the scale are exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float scale = expf(__fsub_rn(m[i], m_use));
      m[i] = m_new;
      l[i] = __fmul_rn(l[i], scale);
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] = __fmul_rn(o[i][c], scale);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(sc[i][j], m_use));
        l[i] = __fadd_rn(l[i], p);
        s.p[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // P . V into the output columns 4tx..4tx+3 of queries ty + 16i
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ld4(s.p + (ty + 16 * i) * kPStride + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 vv = ld4(s.v + (kk + c) * kD + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = c == 0 ? pv[i].x : c == 1 ? pv[i].y
                         : c == 2 ? pv[i].z : pv[i].w;
          o[i][0] = __fmaf_rn(pc, vv.x, o[i][0]);
          o[i][1] = __fmaf_rn(pc, vv.y, o[i][1]);
          o[i][2] = __fmaf_rn(pc, vv.z, o[i][2]);
          o[i][3] = __fmaf_rn(pc, vv.w, o[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = half_warp_sum(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row < N) {
      float4 r;
      r.x = __fdiv_rn(o[i][0], sum);
      r.y = __fdiv_rn(o[i][1], sum);
      r.z = __fdiv_rn(o[i][2], sum);
      r.w = __fdiv_rn(o[i][3], sum);
      *reinterpret_cast<float4*>(
          out + ((static_cast<int64_t>(b) * N + row) * H + h) * kD + 4 * tx) =
          r;
    }
  }
}

}  // namespace

// q, k, v: (B, H, N, 64) float32, contiguous, q scaled; xyz: (B, N, 3);
// out: (B, N, H, 64). Returns the launch's cudaError_t.
extern "C" int radius_attention_launch(const float* q, const float* k,
                                       const float* v, const float* xyz,
                                       float* out, int B, int H, int N,
                                       float r2, cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      radius_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  radius_attention_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q, k, v, xyz, out, H, N, r2);
  return cudaGetLastError();
}

// The head size the kernel takes.
extern "C" int radius_attention_head_size() { return kD; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
