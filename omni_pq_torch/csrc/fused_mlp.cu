// Fused SharedMLP (Dense -> BN -> ReLU per layer) + K max-pool on Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/fused_mlp.py::_make_kernel,
// both its train-mode call (pallas_call at fused_mlp.py:237, grid (L+1, T))
// and its eval-mode call (fused_mlp.py:260, grid (T,)), entry point
// `fused_mlp_pool`. Plain version beside it:
// omni_pq_torch/ops/fused_mlp.py::plain_mlp_pool.
//
// Semantics, per layer j on the (rows, C_j) activations of one SA layer
// (rows = B*S*K, K neighbours of a centre in consecutive rows):
//   a = h @ W_j;  h = relu(((a - mu_j) * mul_j) + bias_j)
// with mul_j = rsqrt(var_j + eps) * scale_j computed by the wrapper in
// torch, then out[centre] = max over its K rows of the last layer's h.
// One launch is one pass: it runs layers 0..run_layers-1 and either
//   - stats_layer >= 0: stops after layer stats_layer's product and sums
//     each channel's a and a*a over all rows (a train-mode pass; earlier
//     layers are normalised with their finished batch stats), or
//   - stats_layer < 0: runs the whole chain and writes the pooled output.
// A train-mode call is L+1 passes, as the Pallas grid's phase axis.
//
// What bounds it on the H100: operations. One chain is 2*rows*sum(Cin*Cout)
// float32 flops against a read of the grouped rows and a write of one row
// per centre (~24 flops a byte at sa1, far above the 20 flops a byte of the
// card's float32 ridge), and a train-mode call recomputes the prefix of the
// chain in every pass.
//
// Design: a block takes tiles of M rows (M = the smallest multiple of K that
// is >= 32: whole centres), looping over tiles with a stride of the grid
// size. The tile's input rows go to shared memory row-major; each layer's
// product is a register-tiled SIMT GEMM (8 rows x 4 columns a thread, the
// weight read as float4 from global memory, where it stays in L1/L2), its
// BN + ReLU is applied in registers and the result written to a second
// shared buffer (two buffers ping-pong through the chain), so no (rows, C)
// intermediate reaches device memory. The last layer's max over K is taken
// in registers and shared memory; only C_L floats a centre are written.
// Products sum k ascending, one fma at a time (not cuBLAS's order), so the
// kernel matches the plain version to float32 roundoff; the BN arithmetic is
// spelled with __f*_rn intrinsics to round as the plain version's separate
// ops. Train stats: each block sums its tiles' channels in a fixed order
// into its own partial-sum row; a second kernel adds the rows in block
// order in double and writes mean = S1/N and var = max(0, S2/N - mean^2).
// No atomics, so two runs give bitwise the same stats.
// Later work: wgmma on TF32/bf16 tiles, and a shared-memory weight ring.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;  // rows a thread
constexpr int kTN = 4;  // columns a thread
constexpr int kMaxLayers = 8;
constexpr int kRedFloats = kThreads * kTN;  // one reduction array

struct Layers {
  const float* w[kMaxLayers];  // (C_j, C_{j+1}) row-major
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* bias[kMaxLayers];
  int c[kMaxLayers + 1];
};

__device__ __forceinline__ float bn_relu(float a, float mu, float mul,
                                         float b) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(a, mu), mul), b);
  return fmaxf(y, 0.f);
}

// acc[i][q] += sum_k in[(r0+i)*pitch + k] * w[k*cout + n0 + q], k ascending
__device__ __forceinline__ void product(const float* __restrict__ in,
                                        int pitch, int r0,
                                        const float* __restrict__ w,
                                        int cin, int cout, int n0,
                                        float (&acc)[kTM][kTN]) {
  int k = 0;
  for (; k + 4 <= cin; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[q] = __ldg(reinterpret_cast<const float4*>(
          w + static_cast<size_t>(k + q) * cout + n0));
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4 h =
          *reinterpret_cast<const float4*>(in + (r0 + i) * pitch + k);
      const float hk[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = __fmaf_rn(hk[kk], wv[kk].x, acc[i][0]);
        acc[i][1] = __fmaf_rn(hk[kk], wv[kk].y, acc[i][1]);
        acc[i][2] = __fmaf_rn(hk[kk], wv[kk].z, acc[i][2]);
        acc[i][3] = __fmaf_rn(hk[kk], wv[kk].w, acc[i][3]);
      }
    }
  }
  for (; k < cin; ++k) {
    const float4 wv = __ldg(reinterpret_cast<const float4*>(
        w + static_cast<size_t>(k) * cout + n0));
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float h = in[(r0 + i) * pitch + k];
      acc[i][0] = __fmaf_rn(h, wv.x, acc[i][0]);
      acc[i][1] = __fmaf_rn(h, wv.y, acc[i][1]);
      acc[i][2] = __fmaf_rn(h, wv.z, acc[i][2]);
      acc[i][3] = __fmaf_rn(h, wv.w, acc[i][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const Layers p, int L, long long rows, int K, int M,
                 int pitch0, int pitch1, int run_layers, int stats_layer,
                 float* __restrict__ psum) {
  extern __shared__ float4 smem4[];
  float* const buf0 = reinterpret_cast<float*>(smem4);
  float* const buf1 = buf0 + M * pitch0;
  const int t = threadIdx.x;
  const int RG = M / kTM;       // row groups
  const int CG = kThreads / RG;  // column groups (threads t >= RG*CG idle)
  const int PW = CG * kTN;       // columns a pass, <= 256
  const int rg = t / CG, cg = t - (t / CG) * CG;
  const bool worker = rg < RG;
  const int r0 = rg * kTM;
  const long long ntiles = (rows + M - 1) / M;
  const int c0 = p.c[0];
  const int cstat = stats_layer >= 0 ? p.c[stats_layer + 1] : 0;
  float* const ps = psum ? psum + static_cast<size_t>(blockIdx.x) * 2 * cstat
                         : nullptr;
  for (int c = t; c < 2 * cstat; c += kThreads) ps[c] = 0.f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * M;
    const int valid = static_cast<int>(min(static_cast<long long>(M),
                                           rows - row0));
    __syncthreads();  // the previous tile is done with the buffers
    const float* src = x + row0 * c0;
    for (int e = t; e < M * c0; e += kThreads) {
      const int r = e / c0, k = e - r * c0;
      float v = 0.f;
      if (r < valid) v = src[e];
      buf0[r * pitch0 + k] = v;
    }
    __syncthreads();

    for (int j = 0; j < run_layers; ++j) {
      const bool odd = j & 1;
      const float* in = odd ? buf1 : buf0;
      float* nxt = odd ? buf0 : buf1;
      const int pin = odd ? pitch1 : pitch0, pout = odd ? pitch0 : pitch1;
      const int cin = p.c[j], cout = p.c[j + 1];
      const bool stats = j == stats_layer;
      const bool pool = !stats && j == L - 1;
      float* red1 = nxt;  // the buffer this layer does not read
      float* red2 = nxt + kRedFloats;
      for (int nb = 0; nb < cout; nb += PW) {
        const int n0 = nb + cg * kTN;
        const bool active = worker && n0 < cout;
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int q = 0; q < kTN; ++q) acc[i][q] = 0.f;
        if (active) product(in, pin, r0, p.w[j], cin, cout, n0, acc);

        if (stats) {
          if (active) {
#pragma unroll
            for (int q = 0; q < kTN; ++q) {
              float s1 = 0.f, s2 = 0.f;
#pragma unroll
              for (int i = 0; i < kTM; ++i) {
                if (r0 + i < valid) {
                  s1 = __fadd_rn(s1, acc[i][q]);
                  s2 = __fadd_rn(s2, __fmul_rn(acc[i][q], acc[i][q]));
                }
              }
              red1[rg * PW + cg * kTN + q] = s1;
              red2[rg * PW + cg * kTN + q] = s2;
            }
          }
          __syncthreads();
          if (t < PW && nb + t < cout) {
            float s1 = 0.f, s2 = 0.f;
            for (int g = 0; g < RG; ++g) {
              s1 = __fadd_rn(s1, red1[g * PW + t]);
              s2 = __fadd_rn(s2, red2[g * PW + t]);
            }
            ps[nb + t] = __fadd_rn(ps[nb + t], s1);
            ps[cstat + nb + t] = __fadd_rn(ps[cstat + nb + t], s2);
          }
          __syncthreads();
        } else if (pool) {
          if (active) {
            const float* mu = p.mu[j];
            const float* mul = p.mul[j];
            const float* bias = p.bias[j];
#pragma unroll
            for (int q = 0; q < kTN; ++q) {
              const int n = n0 + q;
              const float m_ = mu[n], s_ = mul[n], b_ = bias[n];
              float best = bn_relu(acc[0][q], m_, s_, b_);
#pragma unroll
              for (int i = 1; i < kTM; ++i)
                best = fmaxf(best, bn_relu(acc[i][q], m_, s_, b_));
              red1[rg * PW + cg * kTN + q] = best;
            }
          }
          __syncthreads();
          const int cpt = M / K, gpc = K / kTM;  // centres, groups a centre
          for (int e = t; e < cpt * PW; e += kThreads) {
            const int c = e / PW, col = e - (e / PW) * PW;
            const int n = nb + col;
            const long long centre = tile * cpt + c;
            if (n < cout && centre * K < rows) {
              float v = red1[(c * gpc) * PW + col];
              for (int g = 1; g < gpc; ++g)
                v = fmaxf(v, red1[(c * gpc + g) * PW + col]);
              out[centre * cout + n] = v;
            }
          }
          __syncthreads();
        } else if (active) {
          const float* mu = p.mu[j];
          const float* mul = p.mul[j];
          const float* bias = p.bias[j];
          float m_[kTN], s_[kTN], b_[kTN];
#pragma unroll
          for (int q = 0; q < kTN; ++q) {
            m_[q] = mu[n0 + q];
            s_[q] = mul[n0 + q];
            b_[q] = bias[n0 + q];
          }
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            float4 h;
            h.x = bn_relu(acc[i][0], m_[0], s_[0], b_[0]);
            h.y = bn_relu(acc[i][1], m_[1], s_[1], b_[1]);
            h.z = bn_relu(acc[i][2], m_[2], s_[2], b_[2]);
            h.w = bn_relu(acc[i][3], m_[3], s_[3], b_[3]);
            *reinterpret_cast<float4*>(nxt + (r0 + i) * pout + n0) = h;
          }
        }
      }
      if (stats) break;
      __syncthreads();  // nxt is complete before the next layer reads it
    }
  }
}

// mean = S1/N, var = max(0, S2/N - mean^2) from the blocks' partial sums,
// added in block order
__global__ void fused_mlp_stats_kernel(const float* __restrict__ psum,
                                       int blocks, int C, double n,
                                       float* __restrict__ mean,
                                       float* __restrict__ var) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s1 = 0.0, s2 = 0.0;
  for (int g = 0; g < blocks; ++g) {
    s1 += psum[static_cast<size_t>(g) * 2 * C + c];
    s2 += psum[static_cast<size_t>(g) * 2 * C + C + c];
  }
  const double m = s1 / n;
  const double v = s2 / n - m * m;
  mean[c] = static_cast<float>(m);
  var[c] = static_cast<float>(v > 0.0 ? v : 0.0);
}

int round4(int c) { return (c + 3) / 4 * 4; }

}  // namespace

// Shared memory a launch needs, in bytes; the wrapper checks it against the
// card's 227 KB before launching.
extern "C" long long fused_mlp_smem_bytes(const int* chans, int L, int K) {
  const int M = (32 + K - 1) / K * K;
  int pitch[2] = {(kRedFloats * 2 + M - 1) / M, (kRedFloats * 2 + M - 1) / M};
  for (int j = 0; j < L; ++j)
    pitch[j & 1] = pitch[j & 1] > chans[j] ? pitch[j & 1] : chans[j];
  pitch[0] = round4(pitch[0]);
  pitch[1] = round4(pitch[1]);
  return 4LL * M * (pitch[0] + pitch[1]);
}

// ptrs: 4*L device pointers, (w, mu, mul, bias) of each layer; mu/mul may be
// null for layers the pass does not normalise. chans: L+1 widths. psum:
// max_blocks x 2 x C_stats floats of scratch; mean/var: C_stats floats.
extern "C" int fused_mlp_launch(const float* x, float* out,
                                const void* const* ptrs, const int* chans,
                                int L, long long rows, int K, int run_layers,
                                int stats_layer, int max_blocks, float* psum,
                                float* mean, float* var, cudaStream_t stream) {
  if (L < 1 || L > kMaxLayers || K < 8 || K % kTM || rows < 1 ||
      run_layers < 1 || run_layers > L || stats_layer >= run_layers ||
      (stats_layer < 0 && (run_layers != L || out == nullptr)) ||
      (stats_layer >= 0 && (!psum || !mean || !var)))
    return cudaErrorInvalidValue;
  Layers p{};
  for (int j = 0; j < L; ++j) {
    p.w[j] = static_cast<const float*>(ptrs[4 * j]);
    p.mu[j] = static_cast<const float*>(ptrs[4 * j + 1]);
    p.mul[j] = static_cast<const float*>(ptrs[4 * j + 2]);
    p.bias[j] = static_cast<const float*>(ptrs[4 * j + 3]);
  }
  for (int j = 0; j <= L; ++j) p.c[j] = chans[j];
  const int M = (32 + K - 1) / K * K;
  if (M / kTM > kThreads) return cudaErrorInvalidValue;
  int pitch[2] = {(kRedFloats * 2 + M - 1) / M, (kRedFloats * 2 + M - 1) / M};
  for (int j = 0; j < L; ++j)
    pitch[j & 1] = pitch[j & 1] > chans[j] ? pitch[j & 1] : chans[j];
  pitch[0] = round4(pitch[0]);
  pitch[1] = round4(pitch[1]);
  const long long smem = 4LL * M * (pitch[0] + pitch[1]);
  if (smem > 232448) return cudaErrorInvalidValue;

  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_mlp_kernel, kThreads, static_cast<size_t>(smem))) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = (rows + M - 1) / M;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > ntiles) grid = ntiles;
  if (grid > max_blocks) grid = max_blocks;

  fused_mlp_kernel<<<static_cast<unsigned>(grid), kThreads,
                     static_cast<size_t>(smem), stream>>>(
      x, out, p, L, rows, K, M, pitch[0], pitch[1], run_layers, stats_layer,
      stats_layer >= 0 ? psum : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (stats_layer >= 0) {
    const int C = chans[stats_layer + 1];
    fused_mlp_stats_kernel<<<(C + 255) / 256, 256, 0, stream>>>(
        psum, static_cast<int>(grid), C, static_cast<double>(rows), mean,
        var);
    err = cudaGetLastError();
  }
  return err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
