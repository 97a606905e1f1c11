// Layout and plan math of the bfloat16 fused SA-MLP kernels
// (csrc/fused_mlp_bf16.cu), as a CPU can run it too.
//
// nvcc compiles this header into the kernels; g++ compiles it into the host
// harness of tests/test_torch_port_kernel_logic.py, which checks the maps
// below against its models of what wgmma reads and writes (the layouts
// stated here), and the plans against the card's 232 448 bytes of shared
// memory a block.
//
// The operands (PTX ISA, wgmma.mma_async m64nNk16 .bf16, B K-major):
// - B is a weight stage in shared memory, N rows (output columns) of 64 k,
//   in the no-swizzle canonical layout: 8 x 8 core matrices (8 rows of 16
//   bytes, 128 contiguous bytes), the core matrix of row group G and k group
//   kg at byte (G * 8 + kg) * 128. The descriptor's leading byte offset
//   (between the two core matrices of a k step, along k) is 128 and its
//   stride byte offset (between row groups) 1024; k step s starts at byte
//   256 s. The wrapper packs each W^T so that every stage is one contiguous
//   block of global memory (one bulk copy): packed_weight_index.
// - A is in registers (the register-A form): warp w of the warpgroup holds
//   rows 16 w .. 16 w + 15; lane (g = lane / 4, q = lane % 4) holds four
//   bfloat16 pairs a k step, reg 0: (row g, k 2q, 2q+1), reg 1: (row g+8,
//   the same k), reg 2: (row g, k 2q+8, 2q+9), reg 3: (row g+8, k 2q+8, 2q+9).
// - D (float32) holds, in register 4 i + r of lane (g, q) of warp w, row
//   16 w + g + 8 (r / 2), column 8 i + 2 q + r % 2. Columns 16 s .. 16 s + 15
//   of D are therefore exactly the A fragment of k step s of the next layer:
//   A reg (reg, half) of step s is D register acc_for_afrag(s, reg, half).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define WL_HD __host__ __device__ __forceinline__
#else
#define WL_HD inline
#endif

namespace wgmma_logic {

constexpr int kStageK = 64;       // k of one weight / activation stage
constexpr int kCoreBytes = 128;   // one 8 x 8 bfloat16 core matrix
constexpr int kLBO = 128;         // bytes between core matrices along k
constexpr int kSBO = 8 * kCoreBytes;  // bytes between 8-row groups
constexpr int kMaxN = 256;        // columns of one wgmma (a chunk)
constexpr int kRowsWG = 64;       // rows of one consumer warpgroup
constexpr int kTileRows = 128;    // rows of a block tile: two warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;     // one producer and two consumer groups
constexpr long long kMaxSmem = 232448;

// activation stages: bfloat16 rows of 64 k at a pitch of 72 (144 bytes:
// the 4-byte fragment loads of a warp, 8 rows x 4 pairs, hit 32 banks);
// float32 rows at 68 floats (272 bytes: a 16-byte aligned window of a
// row's 64 k, which starts up to 3 floats before them)
constexpr int kPitchBf16 = 72;
constexpr int kPitchF32 = 68;
constexpr int kStageABf16 = kTileRows * kPitchBf16 * 2;
constexpr int kStageAF32 = kTileRows * kPitchF32 * 4;
constexpr int kStageB = kMaxN * kStageK * 2;

// element index of W^T (n, k) (W^T: cout rows, kp k zero-padded, kp a
// multiple of 64) in the packed weights: stage kc = k / 64 holds all cout
// rows of its 64 k, row group by row group, in core-matrix order
WL_HD long long packed_weight_index(int n, int k, int cout) {
  const int kc = k / kStageK, kk = k % kStageK;
  return ((static_cast<long long>(kc) * (cout / 8) + n / 8) * 8 + kk / 8) *
             64 +
         (n % 8) * 8 + kk % 8;
}

// first element of the weight stage of rows n0.. and k stage kc
WL_HD long long packed_stage_offset(int kc, int n0, int cout) {
  return static_cast<long long>(kc) * cout * kStageK +
         static_cast<long long>(n0) * kStageK;
}

// the wgmma shared-memory descriptor of a stage at shared address addr
// (16-byte aligned), no swizzle (layout type 0)
WL_HD uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

// the D register that half `half` of A register `reg` of k step s is
WL_HD int acc_for_afrag(int s, int reg, int half) {
  return 8 * s + 4 * (reg / 2) + 2 * (reg % 2) + half;
}

// The window that a float32 row's k0 .. k0+63 (cut at cin) is copied in:
// 16-byte aligned at both ends (a bulk copy's rule), begin byte `*begin`
// relative to the rows' base, `*bytes` long, the row's k0 at float `*off`
// of the window. A tile of rows < 64 k wide is copied whole instead
// (tile_contiguous).
WL_HD void f32_window(long long row, int cin, int k0, long long* begin,
                      int* bytes, int* off) {
  const long long first = (row * cin + k0) * 4;
  const int kend = k0 + kStageK < cin ? k0 + kStageK : cin;
  const long long end = ((row * cin + kend) * 4 + 15) / 16 * 16;
  *begin = first / 16 * 16;
  *bytes = static_cast<int>(end - *begin);
  *off = static_cast<int>((first - *begin) / 4);
}

// float32 rows of at most 64 k are copied as one contiguous block a tile
WL_HD bool tile_contiguous(int cin) { return cin <= kStageK; }

// Reduction over the 8 lanes of a quad column (lane bits 2-4, g = lane / 4)
// by recursive halving: v holds N values a lane (N a multiple of 8); at step
// b the lane keeps the upper half if bit b of g is set, else the lower
// half, and combines it with the partner's (lane ^ (4 << b)) copy of that
// half: op(kept, received). After 3 steps v[0 .. N/8) hold the reductions
// over all 8 lanes of the values at halve8_origin(k, g, N). Each value's
// tree is the butterfly's, ((x0 . x1) . (x2 . x3)) . ((x4 . x5) . (x6 .
// x7)) over g (for a commutative op the same bits on every lane that would
// hold it), with 7 N / 8 exchanges a lane instead of 3 N. xchg(v, mask)
// returns lane ^ mask's v (a shuffle on the card, lockstep threads on the
// host).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int kLen, int kBit, class T, class Op, class X>
WL_HD void halve_step(T* v, int g, Op op, X xchg) {
  const bool up = (g >> kBit) & 1;
#pragma unroll
  for (int k = 0; k < kLen / 2; ++k) {
    const T lo = v[k], hi = v[k + kLen / 2];
    const T got = xchg(up ? lo : hi, 4 << kBit);
    v[k] = op(up ? hi : lo, got);
  }
}

#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int N, class T, class Op, class X>
WL_HD void halve8(T* v, int g, Op op, X xchg) {
  halve_step<N, 0>(v, g, op, xchg);
  halve_step<N / 2, 1>(v, g, op, xchg);
  halve_step<N / 4, 2>(v, g, op, xchg);
}

// the index (of N) whose reduction lane g holds in v[k] after halve8
WL_HD int halve8_origin(int k, int g, int N) {
  return k + N / 8 * (4 * (g & 1) + 2 * ((g >> 1) & 1) + ((g >> 2) & 1));
}

// ------------------------------------------------------------------ plans

// the pass kernel's columns a work item: a wgmma of 256 where the layer is
// wider than 128, else 128
WL_HD int pass_bn(int cout) { return cout > 128 ? 256 : 128; }

// ring stages of the pass kernel: float32 rows (pass 0) or bfloat16 a_j
WL_HD constexpr int pass_stages(bool f32_src) { return f32_src ? 3 : 4; }

// shared memory of a pass launch: the ring (activation and weight stages),
// 16 KB of per-warp column partials for the epilogue, the A operand's BN
// vectors (a_j source: mu, mul, bias of cin channels) and the barriers
WL_HD long long pass_smem_bytes(bool f32_src, int cin) {
  const long long stage = (f32_src ? kStageAF32 : kStageABf16) + kStageB;
  return pass_stages(f32_src) * stage + 2LL * kConsumerWarps * kMaxN * 4 +
         (f32_src ? 0 : 12LL * ((cin + 31) / 32 * 32)) + 128;
}

// the eval chain keeps every layer's BN vectors (mu, mul, bias) in shared
// memory: at most this many channels over all its layers
constexpr int kChainMaxChannels = 1024;
constexpr int kChainMaxStages = 8;

// shared memory of the eval chain besides its ring: the pool's per-warp
// column maxima (two warpgroups, 4 warps, 256 columns of bfloat16), the BN
// vectors and the barriers (8 bytes each, full and empty a stage)
constexpr long long kChainFixedBytes =
    2LL * 4 * kMaxN * 2 + 12LL * kChainMaxChannels + 16LL * kChainMaxStages;

// one stage of the eval chain's ring for layer-0 width c0: the float32 rows
// of layer 0 (a tile's whole contiguous block where c0 <= 64, else a
// 272-byte window a row) beside a weight stage
WL_HD long long chain_stage_bytes(int c0) {
  const long long a = tile_contiguous(c0)
                          ? (kTileRows * 4LL * c0 + 127) / 128 * 128
                          : kStageAF32;
  return a + kStageB;
}

// the stages of the eval chain's ring: as many as fit, at most 8
WL_HD int chain_stages(int c0) {
  const long long n = (kMaxSmem - kChainFixedBytes) / chain_stage_bytes(c0);
  return n < kChainMaxStages ? static_cast<int>(n) : kChainMaxStages;
}

// shared memory of the eval chain
WL_HD long long chain_smem_bytes(int c0) {
  return chain_stages(c0) * chain_stage_bytes(c0) + kChainFixedBytes;
}

// Whether the eval chain takes widths chans[0..L] at K neighbours: a
// warpgroup's 64 rows hold whole centres (K = 16, 32 or 64), every layer's
// width is a multiple of 128, each layer but the last is at most 256 wide,
// so that it stays in registers as the next layer's A operand, and the
// layers' BN vectors fit their shared memory.
WL_HD bool chain_takes(const int* chans, int L, int K) {
  if (L < 1 || L > 8 || !(K == 16 || K == 32 || K == 64) || chans[0] < 1)
    return false;
  int channels = 0;
  for (int j = 1; j <= L; ++j) {
    if (chans[j] < 128 || chans[j] % 128 || (j < L && chans[j] > kMaxN))
      return false;
    channels += chans[j];
  }
  return channels <= kChainMaxChannels && chain_stages(chans[0]) >= 2;
}

}  // namespace wgmma_logic
