// The BN + ReLU step of the fused SA-MLP kernels and the train mode's pool
// from extremes, as a CPU can run them too, in float32 and in the bfloat16
// compute mode.
//
// nvcc compiles this header into csrc/fused_mlp.cu (the eval-mode chained
// kernel, the train mode's GEMM passes and its pool epilogue, float32 and
// bfloat16; csrc/fused_mlp_bf16.cu computes bn_relu_bf16 a bfloat16 pair
// at a time, with the same roundings); g++ compiles
// it into the host harness of tests/test_torch_port_kernel_logic.py
// (tests/torch_kernel_logic_harness.cpp, built with -ffp-contract=off),
// which holds it bitwise against numpy. Under g++ the __f*_rn intrinsics
// become plain float operations, which round the same way when nothing is
// contracted into an FMA.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#define ML_HD __host__ __device__ __forceinline__
#else
#define ML_HD inline
#endif

namespace mlp_logic {

// relu(((a - mu) * mul) + b), each operation rounded once, as the plain
// version's separate tensor ops. The relu returns +0 for every y <= 0 (and
// for NaN), so its result is never -0.
ML_HD float bn_relu(float a, float mu, float mul, float b) {
#ifdef __CUDA_ARCH__
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(a, mu), mul), b);
#else
  const float y = (a - mu) * mul + b;
#endif
  return y > 0.f ? y : 0.f;
}

// max over a centre's rows of bn_relu(a, mu, mul, b), from the max (mx) and
// the min (mn) of its a: every step of bn_relu is monotone in a, so it is
// non-decreasing for mul >= 0 and non-increasing for mul <= 0, and the
// extreme a on the right side gives the largest value bitwise. With mul = +0
// or -0 the value does not depend on a, so either extreme gives it.
ML_HD float pool_from_extremes(float mx, float mn, float mu, float mul,
                               float b) {
  return bn_relu(copysignf(1.f, mul) < 0.f ? mn : mx, mu, mul, b);
}

// x rounded to the nearest bfloat16 (ties to even), as a float: the card's
// __float2bfloat16_rn, spelled on its bits for the host (a NaN stays NaN).
ML_HD float round_bf16(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    u |= 0x00400000u;  // quiet NaN: the payload's top bit survives the cut
  else
    u += 0x7fffu + ((u >> 16) & 1u);
  u &= 0xffff0000u;
  float y;
  std::memcpy(&y, &u, sizeof y);
  return y;
#endif
}

// The bfloat16 compute mode's step (the JAX package's _bn_relu under
// dtype=bfloat16): the product a (float32 sum) rounded to bfloat16 and
// promoted (af), (af - mu) * mul + b in float32 one rounding an op, the
// result rounded to bfloat16, then the relu, which returns +0 for every
// value <= 0 (and for NaN). The result is a bfloat16 value held as a float.
ML_HD float bn_relu_bf16(float a, float mu, float mul, float b) {
  const float af = round_bf16(a);
#ifdef __CUDA_ARCH__
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(af, mu), mul), b);
#else
  const float y = (af - mu) * mul + b;
#endif
  const float h = round_bf16(y);
  return h > 0.f ? h : 0.f;
}

// pool_from_extremes of the bfloat16 mode, from a centre's max and min of
// af: rounding to bfloat16 is monotone too, so the same choice of extreme
// gives the max over the rows bitwise.
ML_HD float pool_from_extremes_bf16(float mx, float mn, float mu, float mul,
                                    float b) {
  return bn_relu_bf16(copysignf(1.f, mul) < 0.f ? mn : mx, mu, mul, b);
}

}  // namespace mlp_logic
