// The BN + ReLU step of the fused SA-MLP kernels and the train mode's pool
// from extremes, as a CPU can run them too.
//
// nvcc compiles this header into csrc/fused_mlp.cu (the eval-mode chained
// kernel, the train mode's GEMM passes and its pool epilogue); g++ compiles
// it into the host harness of tests/test_torch_port_kernel_logic.py
// (tests/torch_kernel_logic_harness.cpp, built with -ffp-contract=off),
// which holds it bitwise against numpy. Under g++ the __f*_rn intrinsics
// become plain float operations, which round the same way when nothing is
// contracted into an FMA.
#pragma once

#include <cmath>

#ifdef __CUDACC__
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

}  // namespace mlp_logic
