// Fused SharedMLP (Dense -> BN -> ReLU per layer) + K max-pool on Hopper
// (sm_90a), bfloat16 compute mode, on the tensor cores.
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/fused_mlp.py::_make_kernel
// under dtype=bfloat16, its eval-mode call (fused_mlp.py:260) and its
// train-mode call (fused_mlp.py:237), entry point `fused_mlp_pool(...,
// dtype=bfloat16)`. Plain version beside it:
// omni_pq_torch/ops/fused_mlp.py::plain_mlp_pool(..., dtype=bfloat16).
//
// Semantics, per layer j (the JAX kernel's, fused_mlp.py:21-26):
//   a   = h_j (bfloat16) @ W_j (bfloat16), summed in float32
//   af  = a rounded to bfloat16, promoted to float32
//   h_{j+1} = relu(round_bf16((af - mu) * mul + bias))   (mlp_logic.cuh)
// with mu / mul the running statistics (eval) or af's batch statistics
// (train, float32 column sums), mul = rsqrt(var + eps) * scale from the
// wrapper; the grouped input is rounded to bfloat16 as it is loaded, the
// weights are cast (and transposed, k padded with zeros) by the wrapper, as
// the JAX package casts them. The products run on the tensor cores:
// mma.sync.m16n8k16 bf16 x bf16 -> f32 through inline PTX, which sums each
// product in its own order, so af matches the plain version (cuBLAS with
// f32 accumulation) except where the order flips a rounding: one bfloat16
// ulp of af, rarely. Everything after the product is the plain version's
// rounding, op by op.
//
// What bounds it on the H100: operations (989 TFLOP/s dense bf16 against
// 3.35 TB/s: one eval chain at sa1-sa4, B=16, is ~0.62 ms of operations and
// far less of bytes). Simple first: mma.sync with padded shared-memory
// tiles, not wgmma/TMA; a fast schedule is later work.
//
// Fragments: within each 16-wide k step the k index is permuted so that a
// thread's two A registers of one row and its two B registers are each one
// 8-byte load (logical k 2q, 2q+1, 2q+8, 2q+9 of thread quad-lane q read
// physical k 4q..4q+3): A and B use the same permutation, so the sum covers
// every k once. Row pitches are 16 mod 64 bfloat16s: the 8-byte loads of a
// half-warp hit 32 distinct banks.
//
// Eval mode, one launch (fused_mlp_bf16_kernel): a block takes tiles of M
// rows (whole centres, at least 64 and at most 128 rows, the most that fit
// in shared memory), the
// chain stays in shared memory as bfloat16 (two ping-pong buffers). A
// layer's output is computed 128 columns at a time: the weights' k runs
// through two shared stages of 64 (cp.async, the next stage's copy in
// flight during this one's products), shared by the 8 warps, each of
// which owns one or two items of 16 rows x 64 columns; the BN + ReLU in
// registers; the last layer's max over each 16-row group is taken with
// shuffles and combined over a centre's groups through shared memory (a
// max of bfloat16 values: exact). Shapes whose tile does not fit in shared
// memory (or needs more than 128 rows) take the pass plan (the wrapper).
//
// Train mode (and eval where the chained tile does not fit): the pass plan
// of csrc/fused_mlp.cu with bfloat16 operands (mlp_pass_bf16_kernel): pass
// j reads the grouped rows (float32, rounded as loaded) or the stored a_j
// (bfloat16: exactly af, so nothing is lost and the scratch halves) with
// layer j's BN + ReLU applied on load, multiplies a 128 x 128 tile on the
// tensor cores (8 warps of 32 x 64, k in stages of 64 through two shared
// stages, the next stage's loads in registers during this one's products),
// rounds the tile to bfloat16 into shared memory, and from there writes
// a_{j+1}, the tile's column sums of af and af^2 in a fixed order (float32,
// for csrc/fused_mlp.cu's stats launch) or, in the last pass, each
// segment's max and min of af (float32 holding bfloat16 values, for the
// pool launch with out_bf16). No recompute of a_1: a second pass would
// have to repeat the first one's instruction sequence to give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mlp_logic.cuh"

namespace {

using mlp_logic::bn_relu_bf16;

constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;
constexpr int kWarpCols = 64;  // eval: output columns a warp item

struct Layers {
  const __nv_bfloat16* wt[kMaxLayers];  // W_j^T (C_{j+1}, kp[j]), k zero-padded
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* bias[kMaxLayers];
  int kp[kMaxLayers];
  int c[kMaxLayers + 1];
};

// d += a (16 x 16, row) * b (16 x 8, col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two floats (each already a bfloat16 value, or rounded here) as the
// 32 bits of a bfloat16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// a pitch (in bfloat16s) of at least n, a multiple of 16, and 16 mod 64
int pitch_of(int n) {
  int p = (n + 15) / 16 * 16;
  return p + (16 - p % 64 + 64) % 64;
}

// ------------------------------------------------------------------ tiles

constexpr int kBM = 128;          // rows of a pass tile (before whole centres)
constexpr int kBN = 128;          // columns of a pass tile
constexpr int kBK = 64;           // k a shared stage
constexpr int kSP = kBK + 16;     // stage pitch (16 mod 64)
constexpr int kStage = kBM * kSP;  // bfloat16s of one A or B stage
constexpr int kEP = kBN + 8;      // epilogue tile pitch
constexpr int kRingBytes = 2 * 2 * kStage * 2;  // 2 stages of A and B
constexpr int kEpilogueBytes = kBM * kEP * 2 + 2 * 2 * kBN * 4;
constexpr int kPassSmemBytes =
    kRingBytes > kEpilogueBytes ? kRingBytes : kEpilogueBytes;

// ------------------------------------------------------------------ eval mode

// 16 bytes from global to shared memory, zero-filled where `full` is false
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

constexpr int kEvalNB = 128;  // a layer's columns a pass over the k stages
constexpr int kEvalMaxRows = 128;  // rows a tile: two items a warp at most

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bf16_kernel(const float* __restrict__ x,
                      __nv_bfloat16* __restrict__ out, const Layers p, int L,
                      long long rows, int K, int M, int pitch0, int pitch1) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* const buf1 = buf0 + M * pitch0;
  __nv_bfloat16* const wst = buf1 + M * pitch1;  // [2][kEvalNB][kSP]
  float* const red = reinterpret_cast<float*>(wst + 2 * kEvalNB * kSP);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const int RG = M / 16;      // 16-row groups of a tile
  const int items = 2 * RG;   // (row group, 64-column half) of a block pass
  const long long ntiles = (rows + M - 1) / M;
  const int c0 = p.c[0], c0p = (c0 + 15) / 16 * 16, CL = p.c[L];
  // this thread's share of a weight stage: 32 consecutive k of W^T row sn
  const int sn = t >> 1, sk = (t & 1) * 32;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * M;
    const int valid = static_cast<int>(min(static_cast<long long>(M),
                                           rows - row0));
    __syncthreads();  // the previous tile is done with the buffers
    const float* src = x + row0 * c0;
    for (int e = t; e < M * c0p; e += kThreads) {
      const int r = e / c0p, k = e - r * c0p;
      const float v = (r < valid && k < c0) ? src[r * c0 + k] : 0.f;
      buf0[r * pitch0 + k] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    for (int j = 0; j < L; ++j) {
      const bool odd = j & 1;
      const __nv_bfloat16* in = odd ? buf1 : buf0;
      __nv_bfloat16* nxt = odd ? buf0 : buf1;
      const int pin = odd ? pitch1 : pitch0, pout = odd ? pitch0 : pitch1;
      const int kin = (p.c[j] + 15) / 16 * 16, cout = p.c[j + 1];
      const int kp = p.kp[j];
      const bool last = j == L - 1;
      const int nkc = (kin + kBK - 1) / kBK;
      const __nv_bfloat16* wt = p.wt[j];
      // W^T rows cb.. cb+127, k from k0, into stage buf
      auto stage = [&](int buf, int cb, int k0) {
        __nv_bfloat16* dst = wst + buf * kEvalNB * kSP + sn * kSP + sk;
        const bool row_in = cb + sn < cout;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = k0 + sk + 8 * v;
          const bool in_ = row_in && k < kp;
          cp_async16(dst + 8 * v,
                     in_ ? wt + static_cast<size_t>(cb + sn) * kp + k : wt,
                     in_);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      };
      for (int cb = 0; cb < cout; cb += kEvalNB) {
        float acc[2][8][4];
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s2][ni][e] = 0.f;
        stage(0, cb, 0);
        for (int kc = 0; kc < nkc; ++kc) {
          if (kc + 1 < nkc) {
            stage((kc + 1) & 1, cb, (kc + 1) * kBK);
            asm volatile("cp.async.wait_group 1;\n" ::);
          } else {
            asm volatile("cp.async.wait_group 0;\n" ::);
          }
          __syncthreads();  // stage kc is in for every thread
          const __nv_bfloat16* ws = wst + (kc & 1) * kEvalNB * kSP;
          const int kmax = min(kBK, kin - kc * kBK);
          for (int kk = 0; kk < kmax; kk += 16) {
#pragma unroll
            for (int s2 = 0; s2 < 2; ++s2) {
              const int it = warp + 8 * s2;
              if (it >= items) break;
              const int rg = it >> 1, half = it & 1;
              const __nv_bfloat16* ap =
                  in + (rg * 16 + g) * pin + kc * kBK + kk + 4 * q;
              const uint2 lo = *reinterpret_cast<const uint2*>(ap);
              const uint2 hi = *reinterpret_cast<const uint2*>(ap + 8 * pin);
#pragma unroll
              for (int ni = 0; ni < 8; ++ni) {
                const uint2 b = *reinterpret_cast<const uint2*>(
                    ws + (half * 64 + ni * 8 + g) * kSP + kk + 4 * q);
                mma_bf16(acc[s2][ni], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
              }
            }
          }
          __syncthreads();  // every warp is done with stage kc
        }
        // acc[s2][ni] = rows (g, g, g+8, g+8) x columns (2q, 2q+1, 2q,
        // 2q+1) of item s2's 16 x 8 block ni
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int it = warp + 8 * s2;
          if (it >= items) break;
          const int rg = it >> 1, n0 = cb + (it & 1) * 64;
          if (n0 >= cout) continue;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int n = n0 + ni * 8 + 2 * q;
            const float m0 = p.mu[j][n], m1 = p.mu[j][n + 1];
            const float s0 = p.mul[j][n], s1 = p.mul[j][n + 1];
            const float b0 = p.bias[j][n], b1 = p.bias[j][n + 1];
            const float h00 = bn_relu_bf16(acc[s2][ni][0], m0, s0, b0);
            const float h01 = bn_relu_bf16(acc[s2][ni][1], m1, s1, b1);
            const float h10 = bn_relu_bf16(acc[s2][ni][2], m0, s0, b0);
            const float h11 = bn_relu_bf16(acc[s2][ni][3], m1, s1, b1);
            if (!last) {
              *reinterpret_cast<uint32_t*>(nxt + (rg * 16 + g) * pout + n) =
                  pack_bf16(h00, h01);
              *reinterpret_cast<uint32_t*>(nxt + (rg * 16 + g + 8) * pout +
                                           n) = pack_bf16(h10, h11);
            } else {  // the max over the group's 16 rows
              float v0 = fmaxf(h00, h10), v1 = fmaxf(h01, h11);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, off));
                v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, off));
              }
              if (g == 0) {
                red[rg * CL + n] = v0;
                red[rg * CL + n + 1] = v1;
              }
            }
          }
        }
      }
      __syncthreads();  // nxt (or red) is complete
      if (last) {
        const int cpt = M / K, gpc = K / 16;  // centres, groups a centre
        for (int e = t; e < cpt * CL; e += kThreads) {
          const int c = e / CL, col = e - (e / CL) * CL;
          const long long centre = tile * cpt + c;
          if (centre * K < rows) {
            float v = red[(c * gpc) * CL + col];
            for (int gg = 1; gg < gpc; ++gg)
              v = fmaxf(v, red[(c * gpc + gg) * CL + col]);
            out[centre * CL + col] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ passes

struct PassArgs {
  const void* a;      // the grouped rows x (rows, cin) float32, or a_j
                      // (rows, cin) bfloat16
  const float* mu;    // BN of the A operand (cin): a_j only
  const float* mul;
  const float* bias;
  const __nv_bfloat16* wt;  // W^T (cout, kp), k zero-padded
  __nv_bfloat16* a_out;     // (rows, cout) or null
  float* ext_max;           // (rows / seg, cout) or null: the last pass
  float* ext_min;
  float* psum;              // (row tiles, 2, cout) or null (eval)
  long long rows;
  int kp, cin, cout, tile_rows, seg;
};

// Rows a pass tile holds and rows a max/min segment spans, for K a multiple
// of 16: a segment is the K rows of a centre (K <= 128) or the largest
// multiple of 16 up to 128 that divides K; a tile holds whole segments.
void pass_tile(int K, int* tile_rows, int* seg) {
  int s = K;
  if (s > kBM)
    for (s = kBM; K % s; s -= 16) {
    }
  *seg = s;
  *tile_rows = kBM / s * s;
}

// kBnSrc: the A operand is a_j (bfloat16) with layer j's BN + ReLU applied
// as it is loaded; otherwise the float32 grouped rows, rounded as loaded.
template <bool kBnSrc>
__global__ void __launch_bounds__(kThreads, 1)
mlp_pass_bf16_kernel(const PassArgs p) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* const sm = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  // [stage][A | B][kBM][kSP]
  float* const bnv = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem_u4) + kPassSmemBytes);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;  // 32-row x 64-column warp tile
  const int ntn = (p.cout + kBN - 1) / kBN;
  const long long tile = blockIdx.x / ntn;
  const int n0 = static_cast<int>(blockIdx.x - tile * ntn) * kBN;
  const long long row0 = tile * p.tile_rows;
  const int valid = static_cast<int>(
      min(static_cast<long long>(p.tile_rows), p.rows - row0));
  const int cin = p.cin, cout = p.cout;

  if (kBnSrc) {
    for (int c = t; c < cin; c += kThreads) {
      bnv[c] = p.mu[c];
      bnv[cin + c] = p.mul[c];
      bnv[2 * cin + c] = p.bias[c];
    }
    __syncthreads();
  }

  // this thread's share of a stage: 32 consecutive k (from ko) of row lr of
  // A and of row (column of the product) lr of W^T
  const int lr = t >> 1, ko = (t & 1) * 32;
  uint32_t ra[16], rb[16];  // the next stage, packed bfloat16 pairs

  auto load = [&](int k0) {
    const int k = k0 + ko;
    if (kBnSrc) {
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.a) +
                                 (row0 + lr) * cin + k;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (lr < valid && k + 8 * v < cin)
          u = __ldg(reinterpret_cast<const uint4*>(src + 8 * v));
        ra[4 * v] = u.x;
        ra[4 * v + 1] = u.y;
        ra[4 * v + 2] = u.z;
        ra[4 * v + 3] = u.w;
      }
    } else {
      const float* src = static_cast<const float*>(p.a) + (row0 + lr) * cin;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k2 = k + 2 * e;
        const bool in_row = lr < valid;
        const float lo = (in_row && k2 < cin) ? __ldg(src + k2) : 0.f;
        const float hi = (in_row && k2 + 1 < cin) ? __ldg(src + k2 + 1) : 0.f;
        ra[e] = pack_bf16(lo, hi);
      }
    }
    const __nv_bfloat16* w = p.wt + static_cast<size_t>(n0 + lr) * p.kp + k;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + lr < cout && k + 8 * v < p.kp)
        u = __ldg(reinterpret_cast<const uint4*>(w + 8 * v));
      rb[4 * v] = u.x;
      rb[4 * v + 1] = u.y;
      rb[4 * v + 2] = u.z;
      rb[4 * v + 3] = u.w;
    }
  };

  // the registers into stage buf, A normalised on the way (a_j source)
  auto store = [&](int buf, int k0) {
    __nv_bfloat16* As = sm + buf * 2 * kStage;
    __nv_bfloat16* Bs = As + kStage;
    if (kBnSrc) {
      const int k = k0 + ko;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = k + 2 * e;
        float lo = 0.f, hi = 0.f;
        if (lr < valid && c < cin) {
          lo = bn_relu_bf16(bf16_lo(ra[e]), bnv[c], bnv[cin + c],
                            bnv[2 * cin + c]);
          hi = bn_relu_bf16(bf16_hi(ra[e]), bnv[c + 1], bnv[cin + c + 1],
                            bnv[2 * cin + c + 1]);
        }
        ra[e] = pack_bf16(lo, hi);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      *reinterpret_cast<uint4*>(As + lr * kSP + ko + 8 * v) =
          make_uint4(ra[4 * v], ra[4 * v + 1], ra[4 * v + 2], ra[4 * v + 3]);
      *reinterpret_cast<uint4*>(Bs + lr * kSP + ko + 8 * v) =
          make_uint4(rb[4 * v], rb[4 * v + 1], rb[4 * v + 2], rb[4 * v + 3]);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = (cin + kBK - 1) / kBK;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);
    const __nv_bfloat16* As = sm + buf * 2 * kStage;
    const __nv_bfloat16* Bs = As + kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint2 lo[2], hi[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* ap = As + (wr * 32 + mi * 16 + g) * kSP + kk +
                                  4 * q;
        lo[mi] = *reinterpret_cast<const uint2*>(ap);
        hi[mi] = *reinterpret_cast<const uint2*>(ap + 8 * kSP);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            Bs + (wc * 64 + ni * 8 + g) * kSP + kk + 4 * q);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_bf16(acc[mi][ni], lo[mi].x, hi[mi].x, lo[mi].y, hi[mi].y, b.x,
                   b.y);
      }
    }
    if (kt + 1 < nk) store(buf ^ 1, (kt + 1) * kBK);
    __syncthreads();
  }

  // epilogue: the tile's af (bfloat16) into shared memory
  __nv_bfloat16* const E = sm;  // [kBM][kEP]
  float* const part = reinterpret_cast<float*>(E + kBM * kEP);  // [2][2][kBN]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int r = wr * 32 + mi * 16 + g, c = wc * 64 + ni * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(E + r * kEP + c) =
          pack_bf16(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<uint32_t*>(E + (r + 8) * kEP + c) =
          pack_bf16(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  if (p.a_out) {  // 16 bytes a thread, a row's 128 columns in 16 of them
    for (int e = t; e < valid * (kBN / 8); e += kThreads) {
      const int r = e / (kBN / 8), c = (e % (kBN / 8)) * 8;
      if (n0 + c < cout)
        *reinterpret_cast<uint4*>(p.a_out + (row0 + r) * cout + n0 + c) =
            *reinterpret_cast<const uint4*>(E + r * kEP + c);
    }
  }
  if (p.psum) {  // column sums of af and af^2: two halves of the rows, then
                 // the halves in order
    const int c = t & (kBN - 1), half = t >> 7;
    const int r_end = min(valid, (half + 1) * (kBM / 2));
    float s1 = 0.f, s2 = 0.f;
    for (int r = half * (kBM / 2); r < r_end; ++r) {
      const float v = __bfloat162float(E[r * kEP + c]);
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
    part[(half * 2) * kBN + c] = s1;
    part[(half * 2 + 1) * kBN + c] = s2;
    __syncthreads();
    if (n0 + c < cout) {
      const int which = half;  // thread half 0 writes the sums, 1 the squares
      p.psum[(tile * 2 + which) * cout + n0 + c] =
          __fadd_rn(part[which * kBN + c], part[(2 + which) * kBN + c]);
    }
  }
  if (p.ext_max) {
    const int nseg = valid / p.seg;
    for (int e = t; e < nseg * kBN; e += kThreads) {
      const int sg = e / kBN, c = e % kBN;
      if (n0 + c >= cout) continue;
      float mx = __bfloat162float(E[sg * p.seg * kEP + c]), mn = mx;
      for (int r = sg * p.seg + 1; r < (sg + 1) * p.seg; ++r) {
        const float v = __bfloat162float(E[r * kEP + c]);
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
      }
      const long long o = (row0 / p.seg + sg) * cout + n0 + c;
      p.ext_max[o] = mx;
      p.ext_min[o] = mn;
    }
  }
}

template <bool kBnSrc>
cudaError_t launch_pass(const PassArgs& p, unsigned blocks,
                        cudaStream_t stream) {
  const long long smem = kPassSmemBytes + (kBnSrc ? 12LL * p.cin : 0);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_pass_bf16_kernel<kBnSrc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_pass_bf16_kernel<kBnSrc>
      <<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

// the eval kernel's shared memory at M rows: the two activation buffers,
// the two weight stages and the pool's group maxima
long long eval_smem_at(int M, const int* pitch, int CL) {
  return 2LL * M * (pitch[0] + pitch[1]) + 2LL * 2 * kEvalNB * kSP +
         4LL * (M / 16) * CL;
}

// the eval kernel's tile rows and shared-memory pitches: M whole centres,
// at least 64 rows; the most rows up to 128 whose tile fits in shared
// memory (a warp's second item doubles the products a weight stage feeds)
void eval_plan(const int* chans, int L, int K, int* M, int* pitch) {
  pitch[0] = pitch[1] = 16;
  for (int j = 0; j < L; ++j) {  // h_0 .. h_{L-1} are stored
    const int p = pitch_of(chans[j]);
    pitch[j & 1] = pitch[j & 1] > p ? pitch[j & 1] : p;
  }
  *M = (64 + K - 1) / K * K;
  for (int m = *M + K; m <= kEvalMaxRows; m += K)
    if (eval_smem_at(m, pitch, chans[L]) <= 232448) *M = m;
}

// the eval kernel's shared memory; a tile above 128 rows (K > 64 and not
// 128) is refused as more than any block may have
long long eval_smem(const int* chans, int L, int K) {
  int M, pitch[2];
  eval_plan(chans, L, K, &M, pitch);
  if (M > kEvalMaxRows) return 1LL << 40;
  return eval_smem_at(M, pitch, chans[L]);
}

}  // namespace

// Shared memory an eval launch needs, in bytes; the wrapper takes the pass
// plan instead where this is above the card's 227 KB.
extern "C" long long fused_mlp_bf16_smem_bytes(const int* chans, int L,
                                               int K) {
  return eval_smem(chans, L, K);
}

// The eval mode. ptrs: 4*L device pointers, (W^T bfloat16, mu, mul, bias) of
// each layer; chans: L+1 widths; kps: each W^T's row stride (a multiple of
// 64, k zero-padded). x is the float32 grouped rows (rows, chans[0]); out
// (rows / K, chans[L]) bfloat16.
extern "C" int fused_mlp_bf16_launch(const float* x, __nv_bfloat16* out,
                                     const void* const* ptrs,
                                     const int* chans, const int* kps, int L,
                                     long long rows, int K,
                                     cudaStream_t stream) {
  if (L < 1 || L > kMaxLayers || K < 16 || K % 16 || rows < 1 ||
      rows % K || !x || !out)
    return cudaErrorInvalidValue;
  Layers p{};
  for (int j = 0; j < L; ++j) {
    p.wt[j] = static_cast<const __nv_bfloat16*>(ptrs[4 * j]);
    p.mu[j] = static_cast<const float*>(ptrs[4 * j + 1]);
    p.mul[j] = static_cast<const float*>(ptrs[4 * j + 2]);
    p.bias[j] = static_cast<const float*>(ptrs[4 * j + 3]);
    p.kp[j] = kps[j];
    if (!p.wt[j] || kps[j] % 8 || kps[j] < (chans[j] + kBK - 1) / kBK * kBK ||
        chans[j + 1] % kWarpCols ||
        reinterpret_cast<uintptr_t>(p.wt[j]) % 16)
      return cudaErrorInvalidValue;
  }
  for (int j = 0; j <= L; ++j) p.c[j] = chans[j];
  int M, pitch[2];
  eval_plan(chans, L, K, &M, pitch);
  const long long smem = eval_smem(chans, L, K);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_mlp_bf16_kernel, kThreads,
           static_cast<size_t>(smem))) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = (rows + M - 1) / M;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (grid > ntiles) grid = ntiles;
  fused_mlp_bf16_kernel<<<static_cast<unsigned>(grid), kThreads,
                          static_cast<size_t>(smem), stream>>>(
      x, out, p, L, rows, K, M, pitch[0], pitch[1]);
  return cudaGetLastError();
}

// The bfloat16 pass plan's tiling for K neighbours: out2 = (rows a pass
// tile, rows a max/min segment).
extern "C" int mlp_pass_bf16_tile(int K, int* out2) {
  if (K < 16 || K % 16) return cudaErrorInvalidValue;
  pass_tile(K, &out2[0], &out2[1]);
  return cudaSuccess;
}

// One bfloat16 GEMM pass: a (rows, cin) A operand times W (given as wt, its
// transpose (cout, kp) in bfloat16 with k zero-padded to kp). The A operand
// is the float32 grouped rows x (a_bf16 = 0, mu null), rounded as loaded, or
// bn_relu_bf16 of the stored a_j (a_bf16 = 1, mu/mul/bias given). Writes the
// product rounded to bfloat16 to a_out (if not null), each segment's max
// and min of it to ext_max / ext_min (if not null), and each row tile's
// column sums of it and its square to psum (tiles, 2, cout; if not null).
extern "C" int mlp_pass_bf16_launch(const void* a, int a_bf16,
                                    const float* mu, const float* mul,
                                    const float* bias,
                                    const __nv_bfloat16* wt, int kp, int cin,
                                    int cout, long long rows, int K,
                                    __nv_bfloat16* a_out, float* ext_max,
                                    float* ext_min, float* psum,
                                    cudaStream_t stream) {
  PassArgs p{};
  p.a = a;
  p.mu = mu;
  p.mul = mul;
  p.bias = bias;
  p.wt = wt;
  p.a_out = a_out;
  p.ext_max = ext_max;
  p.ext_min = ext_min;
  p.psum = psum;
  p.rows = rows;
  p.kp = kp;
  p.cin = cin;
  p.cout = cout;
  if (K < 16 || K % 16) return cudaErrorInvalidValue;
  pass_tile(K, &p.tile_rows, &p.seg);
  const int kin = (cin + kBK - 1) / kBK * kBK;
  if (rows < 1 || rows % K || cin < 1 || cout < 8 || cout % 8 || !a || !wt ||
      kp < kin || kp % 8 || (!ext_max) != (!ext_min) ||
      (a_bf16 && (!mu || !mul || !bias || cin % 8)) || (!a_bf16 && mu) ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(a_out) % 16 ||
      (a_bf16 && reinterpret_cast<uintptr_t>(a) % 16))
    return cudaErrorInvalidValue;
  const long long tiles = (rows + p.tile_rows - 1) / p.tile_rows;
  const long long blocks = tiles * ((cout + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  return a_bf16 ? launch_pass<true>(p, nb, stream)
                : launch_pass<false>(p, nb, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
