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
//   a_{j+1} = h_j @ W_j;  h_{j+1} = relu(((a_{j+1} - mu) * mul) + bias)
// with mul = rsqrt(var + eps) * scale computed by the wrapper in torch, then
// out[centre] = max over its K rows of the last layer's h. The BN + ReLU step
// and the train mode's pool are csrc/mlp_logic.cuh, which the CPU tests
// build too.
//
// What bounds it on the H100: operations. One chain is 2*rows*sum(Cin*Cout)
// float32 flops against a read of the grouped rows and a write of one row
// per centre (~24 flops a byte at sa1, far above the 20 flops a byte of the
// card's float32 ridge). Products sum k ascending, one __fmaf_rn at a time
// (not cuBLAS's order), so the kernels match the plain version to float32
// roundoff; the BN arithmetic rounds as the plain version's separate ops.
//
// Eval mode, one launch (fused_mlp_kernel): a block takes tiles of M rows
// (M = the smallest multiple of K that is >= 32: whole centres), looping
// over tiles with a stride of the grid size. The tile's input rows go to
// shared memory; each layer's product is a register-tiled SIMT GEMM (8 rows
// x 4 columns a thread, the weight read as float4 from global memory, where
// it stays in L1/L2), its BN + ReLU applied in registers and written to a
// second shared buffer (two buffers ping-pong through the chain), so no
// (rows, C) intermediate reaches device memory; the max over K is taken in
// registers and shared memory.
//
// Train mode, 2L+1 launches. The TPU kernel recomputed the chain's prefix in
// every phase (FLOPs were cheap beside its HBM bytes); on this card one
// chain's pre-activations cost little against 3.35 TB/s (sa2 at B=3: a_1
// and a_2 are 101 MB each, ~0.12 ms of HBM against ~0.8 ms of float32
// operations), so the train mode runs the chain once, as L GEMM passes
// (mlp_pass_kernel), each followed by a stats launch (mlp_stats_kernel):
//   pass 0 reads the grouped rows x and writes a_1; pass j (0 < j < L-1)
//   reads a_j, applies layer j's finished BN + ReLU as it loads the A
//   operand, and writes a_{j+1}; every pass writes, for each row tile, the
//   column sums of its product and of its square; the stats launch adds the
//   tiles' sums in tile order in double (no atomics: two runs give the same
//   bits) into mean = S1/N and var = max(0, S2/N - mean^2). Under data
//   parallelism the stats launch writes the layer's sums [S1, S2, N] instead,
//   the wrapper adds them over the ranks, and mlp_stats_finish_kernel turns
//   them into mean and var by the same arithmetic. Where C0 <= 4
//   (sa1: xyz only), pass 0 keeps only the sums and pass 1 recomputes a_1
//   from x as it loads (C0 FMAs an element, the same order as pass 0, so the
//   same bits), which halves sa1's scratch. The last pass writes no a_L but
//   the max and the min of a_L over each centre's rows; a last launch
//   (mlp_pool_kernel) then takes bn_relu of the max where mul >= 0 and of the
//   min where mul < 0 (mlp_logic::pool_from_extremes): bitwise the max of
//   bn_relu over the rows.
// A pass is a tiled SIMT GEMM: 256 threads, a 128 x 128 output tile (whole
// centres: a multiple of K rows, or of a divisor of K above 128), 8 x 8
// accumulators a thread (two 4 x 4 quadrants 64 rows and 64 columns apart,
// so the shared-memory reads of a warp are broadcasts or conflict-free
// float4s, the next k's read while this k's FMAs run), k in chunks of 16
// through two shared-memory stages. The next chunk's W is copied into the
// other stage with cp.async and its A loaded into registers while the
// current chunk is multiplied; A is stored to the stage only then: the BN +
// ReLU of the A operand is applied there, once an element, between the load
// and the store (register staging, since cp.async copies only raw bytes),
// with the layer's BN vectors staged in shared memory once a block.
// The epilogue sums the tile's columns in a fixed order (8 rows a thread,
// then the 16 row groups in order) and takes the extremes over 4-row
// groups, then over a centre's groups, through shared memory.
//
// Eval mode where one tile's chain does not fit in shared memory (large K at
// wide layers, e.g. K >= 120 at sa2's widths): the wrapper runs the pass
// plan instead, with the running statistics as each pass's BN and no stats
// launches (psum null): L passes (no pass 0 where a_1 is recomputed) and the
// pool launch. The bfloat16 compute mode's kernels are in
// csrc/fused_mlp_bf16.cu; the pool launch here serves it too (out_bf16).
//
// Tensor cores are left out on purpose: the function is float32 with TF32
// off, as is the plain version it is held against; TF32 would lose that
// accuracy, and 3xTF32, which keeps it, changes the sums' rounding and what
// the bound counts on top of the schedule. Later work, for both modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_logic.cuh"

namespace {

using mlp_logic::bn_relu;
using mlp_logic::pool_from_extremes;

constexpr int kThreads = 256;
constexpr int kTM = 8;  // rows a thread (eval kernel)
constexpr int kTN = 4;  // columns a thread (eval kernel)
constexpr int kMaxLayers = 8;
constexpr int kRedFloats = kThreads * kTN;  // the eval pool's reduction array

struct Layers {
  const float* w[kMaxLayers];  // (C_j, C_{j+1}) row-major
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* bias[kMaxLayers];
  int c[kMaxLayers + 1];
};

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

// The eval mode: the whole chain on each tile, then the max over K.
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const Layers p, int L, long long rows, int K, int M,
                 int pitch0, int pitch1) {
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

    for (int j = 0; j < L; ++j) {
      const bool odd = j & 1;
      const float* in = odd ? buf1 : buf0;
      float* nxt = odd ? buf0 : buf1;
      const int pin = odd ? pitch1 : pitch0, pout = odd ? pitch0 : pitch1;
      const int cin = p.c[j], cout = p.c[j + 1];
      const bool pool = j == L - 1;
      float* red = nxt;  // the buffer this layer does not read
      for (int nb = 0; nb < cout; nb += PW) {
        const int n0 = nb + cg * kTN;
        const bool active = worker && n0 < cout;
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int q = 0; q < kTN; ++q) acc[i][q] = 0.f;
        if (active) product(in, pin, r0, p.w[j], cin, cout, n0, acc);

        if (pool) {
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
              red[rg * PW + cg * kTN + q] = best;
            }
          }
          __syncthreads();
          const int cpt = M / K, gpc = K / kTM;  // centres, groups a centre
          for (int e = t; e < cpt * PW; e += kThreads) {
            const int c = e / PW, col = e - (e / PW) * PW;
            const int n = nb + col;
            const long long centre = tile * cpt + c;
            if (n < cout && centre * K < rows) {
              float v = red[(c * gpc) * PW + col];
              for (int g = 1; g < gpc; ++g)
                v = fmaxf(v, red[(c * gpc + g) * PW + col]);
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
      __syncthreads();  // nxt is complete before the next layer reads it
    }
  }
}

// ---------------------------------------------------------------- train mode

constexpr int kBM = 128;  // rows of a pass tile (before whole centres)
constexpr int kBN = 128;  // columns of a pass tile
constexpr int kBK = 16;   // k a shared-memory stage
constexpr int kAPitch = kBM + 4;  // the A stage is stored k-major, padded
constexpr int kRingFloats = 2 * kBK * (kAPitch + kBN);
// epilogue: two 16 x kBN sum arrays, two 32 x kBN extreme arrays
constexpr int kEpilogueFloats = 2 * 16 * kBN + 2 * 32 * kBN;
constexpr int kPassSmemBytes =
    4 * (kRingFloats > kEpilogueFloats ? kRingFloats : kEpilogueFloats);
constexpr int kMaxRecomputeC0 = 4;  // pass 1 recomputes a_1 where C0 <= 4

// Where a pass's A operand comes from.
enum Source {
  kRaw,        // x as it is, loaded a float at a time (C0 = 3 + C: no float4)
  kBn,         // a_j, loaded as float4, normalised with layer j's batch stats
  kRecompute,  // a_1 = x @ W_0 recomputed from x (C0 <= 4), then normalised
};

struct PassArgs {
  const float* a;     // the A source: x (rows, c0 or cin) or a_j (rows, cin)
  const float* w0;    // kRecompute: W_0 (c0, cin)
  const float* mu;    // BN of the A operand (cin), kBn and kRecompute
  const float* mul;
  const float* bias;
  const float* w;     // (cin, cout)
  float* a_out;       // (rows, cout) or null
  float* ext_max;     // (rows / seg, cout) or null: the last pass
  float* ext_min;
  float* psum;        // (row tiles, 2, cout): column sums of a and a*a, or
                      // null (eval: no statistics)
  long long rows;
  int c0, cin, cout, tile_rows, seg;
};

// Rows a pass tile holds and rows a max/min segment spans: segments are the
// K rows of a centre (K <= 128) or the largest multiple of 8 up to 128 that
// divides K, and a tile holds whole segments.
void pass_tile(int K, int* tile_rows, int* seg) {
  int s = K;
  if (s > kBM)
    for (s = kBM; K % s; s -= 8) {
    }
  *seg = s;
  *tile_rows = kBM / s * s;
}

// A thread's operands of one k of a stage: its 8 rows of A, 8 columns of W
struct Frag {
  float4 a0, a1, b0, b1;
};

__device__ __forceinline__ Frag load_frag(const float* as, const float* bs,
                                          int kk, int tx, int ty) {
  return {*reinterpret_cast<const float4*>(as + kk * kAPitch + ty * 4),
          *reinterpret_cast<const float4*>(as + kk * kAPitch + 64 + ty * 4),
          *reinterpret_cast<const float4*>(bs + kk * kBN + tx * 4),
          *reinterpret_cast<const float4*>(bs + kk * kBN + 64 + tx * 4)};
}

// acc[i][j] += A[row i][k] * W[k][column j] for one k
__device__ __forceinline__ void fma_frag(const Frag& f, float (&acc)[8][8]) {
  const float ra[8] = {f.a0.x, f.a0.y, f.a0.z, f.a0.w,
                       f.a1.x, f.a1.y, f.a1.z, f.a1.w};
  const float rb[8] = {f.b0.x, f.b0.y, f.b0.z, f.b0.w,
                       f.b1.x, f.b1.y, f.b1.z, f.b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(ra[i], rb[j], acc[i][j]);
}

// 16 bytes from global to shared memory without passing through registers,
// zero-filled where `full` is false (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

template <int kSrc>
__global__ void __launch_bounds__(kThreads, 2)
mlp_pass_kernel(const PassArgs p) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const As = sm;                      // [2][kBK][kAPitch]
  float* const Bs = sm + 2 * kBK * kAPitch;  // [2][kBK][kBN]
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int ntn = (p.cout + kBN - 1) / kBN;
  const long long tile = blockIdx.x / ntn;
  const int n0 = static_cast<int>(blockIdx.x - tile * ntn) * kBN;
  const long long row0 = tile * p.tile_rows;
  const int valid = static_cast<int>(
      min(static_cast<long long>(p.tile_rows), p.rows - row0));
  const int cin = p.cin, cout = p.cout;

  // the A elements this thread stages in registers: 4 consecutive k (from
  // 4 (t%4)) of rows t/4 and t/4 + 64; the W elements it copies with
  // cp.async: two float4s (k f/32, columns 4 (f%32), f = t + 256 i)
  float sa[8];
  const int vr = t >> 2, vk = (t & 3) * 4;
  // the A operand's BN vectors and, when recomputing, W_0: staged once a
  // block, after the ring
  float* const bnv = sm + kPassSmemBytes / 4;
  float* const w0s = bnv + 3 * cin;  // (c0, cin)
  if (kSrc != kRaw) {
    for (int c = t; c < cin; c += kThreads) {
      bnv[c] = p.mu[c];
      bnv[cin + c] = p.mul[c];
      bnv[2 * cin + c] = p.bias[c];
    }
    if (kSrc == kRecompute)
      for (int e = t; e < p.c0 * cin; e += kThreads) w0s[e] = p.w0[e];
    __syncthreads();
  }
  float xr[2][kMaxRecomputeC0];
  if (kSrc == kRecompute) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < kMaxRecomputeC0; ++c)
        xr[i][c] = (vr + 64 * i < valid && c < p.c0)
                       ? __ldg(p.a + (row0 + vr + 64 * i) * p.c0 + c)
                       : 0.f;
  }

  // issue the loads of the stage at k0: A into registers, W into stage nbuf
  auto load = [&](int k0, int nbuf) {
    if (kSrc == kRaw) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = vr + 64 * i, k = k0 + vk;
        const float* src = p.a + (row0 + r) * cin + k;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sa[4 * i + q] = (r < valid && k + q < cin) ? __ldg(src + q) : 0.f;
      }
    } else if (kSrc == kBn) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = vr + 64 * i, k = k0 + vk;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid && k < cin)
          v = __ldg(reinterpret_cast<const float4*>(p.a + (row0 + r) * cin +
                                                    k));
        sa[4 * i] = v.x;
        sa[4 * i + 1] = v.y;
        sa[4 * i + 2] = v.z;
        sa[4 * i + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = t + kThreads * i, k = k0 + (f >> 5), n = n0 + (f & 31) * 4;
      const bool in = k < cin && n < cout;
      cp_async16(Bs + nbuf * kBK * kBN + (f >> 5) * kBN + (f & 31) * 4,
                 in ? p.w + static_cast<size_t>(k) * cout + n : p.w, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // the staged A, normalised, into stage buf (k-major)
  auto store = [&](int buf, int k0) {
    float* const as = As + buf * kBK * kAPitch;
    const int k = k0 + vk;
    float4 m_ = {}, s_ = {}, b_ = {};
    if (kSrc != kRaw && k < cin) {
      m_ = *reinterpret_cast<const float4*>(bnv + k);
      s_ = *reinterpret_cast<const float4*>(bnv + cin + k);
      b_ = *reinterpret_cast<const float4*>(bnv + 2 * cin + k);
    }
    const float mq[4] = {m_.x, m_.y, m_.z, m_.w};
    const float sq[4] = {s_.x, s_.y, s_.z, s_.w};
    const float bq[4] = {b_.x, b_.y, b_.z, b_.w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = vr + 64 * i;
      const bool in = r < valid && k < cin;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = kSrc == kRecompute ? 0.f : sa[4 * i + q];
        if (kSrc == kRecompute && in) {
#pragma unroll
          for (int c = 0; c < kMaxRecomputeC0; ++c)
            if (c < p.c0) v = __fmaf_rn(xr[i][c], w0s[c * cin + k + q], v);
        }
        if (kSrc != kRaw) v = in ? bn_relu(v, mq[q], sq[q], bq[q]) : 0.f;
        as[(vk + q) * kAPitch + r] = v;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (cin + kBK - 1) / kBK;
  load(0, 0);
  store(0, 0);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK, buf ^ 1);
    const float* as = As + buf * kBK * kAPitch;
    const float* bs = Bs + buf * kBK * kBN;
    const int kmax = min(kBK, cin - kt * kBK);
    if (kmax == kBK) {  // the next k's operands load during this k's FMAs
      Frag f = load_frag(as, bs, 0, tx, ty);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const Frag cur = f;
        if (kk + 1 < kBK) f = load_frag(as, bs, kk + 1, tx, ty);
        fma_frag(cur, acc);
      }
    } else {
      for (int kk = 0; kk < kmax; ++kk)
        fma_frag(load_frag(as, bs, kk, tx, ty), acc);
    }
    if (kt + 1 < nk) store(buf ^ 1, (kt + 1) * kBK);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }

  // epilogue. acc[i][j] is row (i < 4 ? 0 : 64) + 4 ty + i % 4 and column
  // (j < 4 ? 0 : 64) + 4 tx + j % 4 of the tile
  bool col_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) col_in[h] = n0 + 64 * h + tx * 4 < cout;
  if (p.a_out) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      if (r >= valid) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (col_in[h])
          *reinterpret_cast<float4*>(p.a_out + (row0 + r) * cout + n0 +
                                     64 * h + tx * 4) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
    }
  }
  float* const red = sm;                 // [2][16][kBN]: sums of a, a*a
  float* const emax = sm + 2 * 16 * kBN;  // [32][kBN]: 4-row group extremes
  float* const emin = emax + 32 * kBN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((i < 4 ? 0 : 64) + ty * 4 + (i & 3) < valid) {
        s1 = __fadd_rn(s1, acc[i][j]);
        s2 = __fadd_rn(s2, __fmul_rn(acc[i][j], acc[i][j]));
      }
    }
    red[ty * kBN + c] = s1;
    red[(16 + ty) * kBN + c] = s2;
    if (p.ext_max) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float mx = acc[4 * g][j], mn = mx;
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          mx = fmaxf(mx, acc[4 * g + q][j]);
          mn = fminf(mn, acc[4 * g + q][j]);
        }
        emax[(16 * g + ty) * kBN + c] = mx;  // rows 4 (16 g + ty) + 0..3
        emin[(16 * g + ty) * kBN + c] = mn;
      }
    }
  }
  __syncthreads();
  {
    const int c = t & (kBN - 1), which = t >> 7;  // a (t < 128) or a*a
    if (p.psum && n0 + c < cout) {
      float s = 0.f;
      for (int g = 0; g < 16; ++g)
        s = __fadd_rn(s, red[(16 * which + g) * kBN + c]);
      p.psum[(tile * 2 + which) * cout + n0 + c] = s;
    }
  }
  if (p.ext_max) {
    const int nseg = valid / p.seg, gps = p.seg / 4;  // 4-row groups a seg
    for (int e = t; e < nseg * kBN; e += kThreads) {
      const int sg = e / kBN, c = e & (kBN - 1);
      if (n0 + c >= cout) continue;
      float mx = emax[sg * gps * kBN + c], mn = emin[sg * gps * kBN + c];
      for (int g = 1; g < gps; ++g) {
        mx = fmaxf(mx, emax[(sg * gps + g) * kBN + c]);
        mn = fminf(mn, emin[(sg * gps + g) * kBN + c]);
      }
      const long long o = (row0 / p.seg + sg) * cout + n0 + c;
      p.ext_max[o] = mx;
      p.ext_min[o] = mn;
    }
  }
}

// mean = S1/N, var = max(0, S2/N - mean^2), in double, rounded to float
__device__ __forceinline__ void finish_stats(double s1, double s2, double n,
                                             float* mean, float* var) {
  const double m = s1 / n;
  const double v = s2 / n - m * m;
  *mean = static_cast<float>(m);
  *var = static_cast<float>(v > 0.0 ? v : 0.0);
}

// The batch stats of a column from the row tiles' column sums: 32 threads
// a column each add a contiguous run of tiles in order, in double, then one
// adds the 32 runs in order. A fixed order: no atomics. With `sums` set,
// the layer's sums are written there instead, [S1 (C), S2 (C), N], for the
// wrapper to add over the ranks before mlp_stats_finish_kernel.
__global__ void __launch_bounds__(1024)
mlp_stats_kernel(const float* __restrict__ psum, long long tiles, int C,
                 double n, float* __restrict__ mean,
                 float* __restrict__ var, double* __restrict__ sums) {
  __shared__ double part[2][32][33];
  const int c = blockIdx.x * 32 + threadIdx.x, y = threadIdx.y;
  const long long per = (tiles + 31) / 32;
  double s1 = 0.0, s2 = 0.0;
  if (c < C) {
    const long long end = min(tiles, (y + 1) * per);
    for (long long g = y * per; g < end; ++g) {
      s1 += psum[(g * 2) * C + c];
      s2 += psum[(g * 2 + 1) * C + c];
    }
  }
  part[0][y][threadIdx.x] = s1;
  part[1][y][threadIdx.x] = s2;
  __syncthreads();
  if (y == 0 && c < C) {
    s1 = 0.0;
    s2 = 0.0;
    for (int g = 0; g < 32; ++g) {
      s1 += part[0][g][threadIdx.x];
      s2 += part[1][g][threadIdx.x];
    }
    if (sums) {
      sums[c] = s1;
      sums[C + c] = s2;
      if (c == 0) sums[2 * C] = n;
    } else {
      finish_stats(s1, s2, n, &mean[c], &var[c]);
    }
  }
}

// mean and var from the sums mlp_stats_kernel wrote (added over the ranks)
__global__ void mlp_stats_finish_kernel(const double* __restrict__ sums,
                                        int C, float* __restrict__ mean,
                                        float* __restrict__ var) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) finish_stats(sums[c], sums[C + c], sums[2 * C], &mean[c],
                          &var[c]);
}

// pooled[centre, c] from the extremes of its nseg segments; kBf16: the
// bfloat16 mode's BN step (extremes of af, output in bfloat16)
template <bool kBf16>
__global__ void mlp_pool_kernel(const float* __restrict__ ext_max,
                                const float* __restrict__ ext_min,
                                long long centres, int nseg, int C,
                                const float* __restrict__ mu,
                                const float* __restrict__ mul,
                                const float* __restrict__ bias,
                                void* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= centres * C) return;
  const long long centre = e / C;
  const int c = static_cast<int>(e - centre * C);
  const long long base = centre * nseg * C + c;
  float mx = ext_max[base], mn = ext_min[base];
  for (int s = 1; s < nseg; ++s) {
    mx = fmaxf(mx, ext_max[base + static_cast<long long>(s) * C]);
    mn = fminf(mn, ext_min[base + static_cast<long long>(s) * C]);
  }
  if (kBf16)
    static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(
        mlp_logic::pool_from_extremes_bf16(mx, mn, mu[c], mul[c], bias[c]));
  else
    static_cast<float*>(out)[e] =
        pool_from_extremes(mx, mn, mu[c], mul[c], bias[c]);
}

int round4(int c) { return (c + 3) / 4 * 4; }

// the eval kernel's shared memory: two activation buffers of M rows, each
// at least as wide as the pool's reduction array
void eval_pitches(const int* chans, int L, int M, int* pitch) {
  pitch[0] = pitch[1] = (kRedFloats + M - 1) / M;
  for (int j = 0; j < L; ++j)
    pitch[j & 1] = pitch[j & 1] > chans[j] ? pitch[j & 1] : chans[j];
  pitch[0] = round4(pitch[0]);
  pitch[1] = round4(pitch[1]);
}

template <int kSrc>
cudaError_t launch_pass(const PassArgs& p, unsigned blocks,
                        cudaStream_t stream) {
  const long long smem =
      kPassSmemBytes + (kSrc == kBn ? 12LL * p.cin : 0) +
      (kSrc == kRecompute ? 4LL * (3 + p.c0) * p.cin : 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_pass_kernel<kSrc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_pass_kernel<kSrc><<<blocks, kThreads, static_cast<size_t>(smem),
                          stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory an eval launch needs, in bytes; the wrapper checks it
// against the card's 227 KB before launching.
extern "C" long long fused_mlp_smem_bytes(const int* chans, int L, int K) {
  const int M = (32 + K - 1) / K * K;
  int pitch[2];
  eval_pitches(chans, L, M, pitch);
  return 4LL * M * (pitch[0] + pitch[1]);
}

// The eval mode. ptrs: 4*L device pointers, (w, mu, mul, bias) of each
// layer; chans: L+1 widths.
extern "C" int fused_mlp_launch(const float* x, float* out,
                                const void* const* ptrs, const int* chans,
                                int L, long long rows, int K,
                                cudaStream_t stream) {
  if (L < 1 || L > kMaxLayers || K < 8 || K % kTM || rows < 1 || !out)
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
  int pitch[2];
  eval_pitches(chans, L, M, pitch);
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

  fused_mlp_kernel<<<static_cast<unsigned>(grid), kThreads,
                     static_cast<size_t>(smem), stream>>>(
      x, out, p, L, rows, K, M, pitch[0], pitch[1]);
  return cudaGetLastError();
}

// The train mode's tiling for K neighbours: out2 = (rows a pass tile, rows
// a max/min segment). The wrapper sizes the column sums (one row a tile)
// and the extremes (one row a segment) from it.
extern "C" int mlp_pass_tile(int K, int* out2) {
  if (K < 8 || K % 8) return cudaErrorInvalidValue;
  pass_tile(K, &out2[0], &out2[1]);
  return cudaSuccess;
}

// One GEMM pass of the train mode: a (rows, cin) A operand times w (cin,
// cout). The A operand is
//   - x itself (mu null, w0 null): pass 0;
//   - bn_relu(a, mu, mul, bias) (w0 null): a_j with layer j's batch stats;
//   - bn_relu(x @ w0, mu, mul, bias) with x (rows, c0), c0 <= 4, w0 (c0,
//     cin): a_1 recomputed from x.
// Writes the product to a_out (if not null), the max and min over each
// segment's rows to ext_max / ext_min (if not null), and each row tile's
// column sums of the product and its square to psum (tiles, 2, cout; if
// not null: eval passes keep no statistics).
extern "C" int mlp_pass_launch(const float* a, const float* w0, int c0,
                               const float* mu, const float* mul,
                               const float* bias, const float* w, int cin,
                               int cout, long long rows, int K, float* a_out,
                               float* ext_max, float* ext_min, float* psum,
                               cudaStream_t stream) {
  PassArgs p{};
  p.a = a;
  p.w0 = w0;
  p.mu = mu;
  p.mul = mul;
  p.bias = bias;
  p.w = w;
  p.a_out = a_out;
  p.ext_max = ext_max;
  p.ext_min = ext_min;
  p.psum = psum;
  p.rows = rows;
  p.c0 = c0;
  p.cin = cin;
  p.cout = cout;
  if (K < 8 || K % 8) return cudaErrorInvalidValue;
  pass_tile(K, &p.tile_rows, &p.seg);
  if (rows < 1 ||
      rows % K || cin < 1 || cout < 4 || cout % 4 || !a || !w ||
      (!ext_max) != (!ext_min) || (mu && (!mul || !bias || cin % 4)) ||
      (w0 && (!mu || c0 < 1 || c0 > kMaxRecomputeC0)) ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(a_out) % 16)
    return cudaErrorInvalidValue;
  const long long tiles = (rows + p.tile_rows - 1) / p.tile_rows;
  const long long blocks = tiles * ((cout + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (w0) return launch_pass<kRecompute>(p, nb, stream);
  if (!mu) return launch_pass<kRaw>(p, nb, stream);
  if (reinterpret_cast<uintptr_t>(a) % 16) return cudaErrorInvalidValue;
  return launch_pass<kBn>(p, nb, stream);
}

// Batch stats of one layer from a pass's column sums over `tiles` row tiles
// of `n` rows in all: mean and var, or (sums set: 2C+1 doubles) the layer's
// sums [S1, S2, n] for mlp_stats_finish_launch.
extern "C" int mlp_stats_launch(const float* psum, long long tiles, int C,
                                long long n, float* mean, float* var,
                                double* sums, cudaStream_t stream) {
  if (tiles < 1 || C < 1 || n < 1 || !psum || (!sums && (!mean || !var)))
    return cudaErrorInvalidValue;
  mlp_stats_kernel<<<(C + 31) / 32, dim3(32, 32), 0, stream>>>(
      psum, tiles, C, static_cast<double>(n), mean, var, sums);
  return cudaGetLastError();
}

// mean and var of one layer from its sums [S1 (C), S2 (C), n] (doubles)
extern "C" int mlp_stats_finish_launch(const double* sums, int C, float* mean,
                                       float* var, cudaStream_t stream) {
  if (C < 1 || !sums || !mean || !var) return cudaErrorInvalidValue;
  mlp_stats_finish_kernel<<<(C + 255) / 256, 256, 0, stream>>>(sums, C, mean,
                                                               var);
  return cudaGetLastError();
}

// The pooled output (centres, C) from the last pass's extremes (centres *
// nseg, C) and the last layer's BN: float32, or bfloat16 with the bfloat16
// mode's BN step when out_bf16 is set.
extern "C" int mlp_pool_launch(const float* ext_max, const float* ext_min,
                               long long centres, int nseg, int C,
                               const float* mu, const float* mul,
                               const float* bias, void* out, int out_bf16,
                               cudaStream_t stream) {
  if (centres < 1 || nseg < 1 || C < 1 || !ext_max || !ext_min || !mu ||
      !mul || !bias || !out)
    return cudaErrorInvalidValue;
  const long long n = centres * C;
  if ((n + 255) / 256 > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (out_bf16)
    mlp_pool_kernel<true><<<blocks, 256, 0, stream>>>(
        ext_max, ext_min, centres, nseg, C, mu, mul, bias, out);
  else
    mlp_pool_kernel<false><<<blocks, 256, 0, stream>>>(
        ext_max, ext_min, centres, nseg, C, mu, mul, bias, out);
  return cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
