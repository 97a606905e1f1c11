// Fused SharedMLP (Dense -> BN -> ReLU per layer) + K max-pool on Hopper
// (sm_90a), bfloat16 compute mode, on the tensor cores through wgmma.
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
//   h_{j+1} = relu(round_bf16((af - mu) * mul + bias))   (mlp_logic.cuh's
//             bn_relu_bf16, computed here a bfloat16 pair at a time)
// with mu / mul the running statistics (eval) or af's batch statistics
// (train, float32 column sums), mul = rsqrt(var + eps) * scale from the
// wrapper; the grouped input is rounded to bfloat16 as it is loaded, the
// weights are cast, transposed, k zero-padded and packed into stages by the
// wrapper (wgmma_logic.cuh::packed_weight_index). The products are
// wgmma.mma_async m64nNk16 bf16 x bf16 -> f32 by inline PTX, which sums each
// product in its own order, so af matches the plain version (cuBLAS with
// f32 accumulation) except where the order flips a rounding: one bfloat16
// ulp of af, rarely. Everything after the product is the plain version's
// rounding, op by op.
//
// What bounds it on the H100: operations (989 TFLOP/s dense bf16 against
// 3.35 TB/s: one eval chain at sa1-sa4, B=16, is ~0.62 ms of operations and
// far less of bytes). The train passes store a_j and read it back, which
// sets a floor of bytes of their own.
//
// Both kernels are warp-specialised and persistent: 384 threads, one block
// an SM walking over work items. Warpgroup 0 is the producer (setmaxnreg
// down to 40, the chain's to 24): it fills a ring of shared-memory stages
// whose copies complete on the stage's `full` mbarrier: the weight stage
// (64 k of up to 256 packed W^T rows, one contiguous cp.async.bulk with its
// bytes expected on the barrier) and, where the A operand comes from
// memory, the tile's 128 rows of that k stage as 16-byte cp.async chunks
// (coalesced; a 16-byte aligned window of each float32 row, or 128 bytes of
// a bfloat16 a_j row; float32 rows of at most 64 k as the tile's whole
// contiguous block), each producer thread arriving once its chunks have
// landed (cp.async.mbarrier.arrive.noinc). Two consumer warpgroups
// (setmaxnreg up to 232, the chain's to 240) own 64 rows each: they wait on
// `full`, build the A operand in registers (rounded to bfloat16, or a_j
// with layer j's BN + ReLU applied), issue wgmma in the register-A form
// against the weight stage, and free a stage on its `empty` mbarrier (one
// arrive a consumer warp) once its products are done; the passes build a
// stage's fragments while the last stage's products run. The producer runs
// up to the ring's depth ahead, over item boundaries, so the next tile's
// loads overlap this tile's last products and epilogue. Each weight stage
// feeds 128 rows: the weights' L2 traffic is that of 128-row tiles
// (removing the weight copies altogether changed the calls' time by about
// 1 %, PERF.md). ptxas runs a kernel's products one at a time (warning
// C7512-C7515) when another instruction may define a product's registers
// while it is in flight or when registers run short; the code paths below
// are split so that it does not (checked in chip_smoke.py's build phase).
//
// Eval mode, one launch (fused_mlp_bf16_kernel): a tile of 128 rows, whole
// centres (K = 16, 32 or 64), goes through the whole chain. Layer j's
// float32 accumulator (at most 256 columns, 128 registers) goes through
// BN + ReLU and the bfloat16 rounding, a bfloat16 pair at a time, and then
// is layer j+1's A operand in registers (the m64nN accumulator's layout is
// the register-A fragment's, wgmma_logic.cuh), so activations never touch
// shared memory; the BN vectors of every layer sit in shared memory. The
// last layer runs in chunks of 256 columns and is max-pooled as it goes, on
// bfloat16 pairs: a lane's two rows, the 8 lanes of a quad column by
// recursive halving (wgmma_logic.cuh::halve8), a centre's warps through
// shared memory. The ring is as deep as shared memory allows (6 stages at
// sa1's 3 input channels, 3 at 259 and more). Shapes the chain does not
// take (wgmma_logic.cuh::chain_takes: a centre above 64 rows, a middle
// layer above 256) take the pass plan (the wrapper).
//
// Train mode (and eval where the chain does not take the shape): the pass
// plan of csrc/fused_mlp.cu with bfloat16 operands (mlp_pass_bf16_kernel):
// pass j reads the grouped rows (float32, rounded as loaded) or the stored
// a_j (bfloat16: exactly af, so nothing is lost and the scratch halves) with
// layer j's BN + ReLU applied on load, multiplies a 128-row x 128- or
// 256-column item, and in its epilogue, from the accumulator registers,
// writes a_{j+1} as bfloat16 (16-byte stores after a transpose within each
// lane quad), the item's column sums of af and af^2 (each lane's two rows,
// the quad column's 8 lanes by recursive halving, then the 8 warps in
// order: a fixed order, so two runs give the same bits) for
// csrc/fused_mlp.cu's stats launch, or, in the last pass, each segment's max
// and min of af (bfloat16 pairs, halved likewise; float32 holding bfloat16
// values) for the pool launch with out_bf16. No recompute of a_1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_logic.cuh"

namespace {

namespace wl = wgmma_logic;

constexpr int kMaxLayers = 8;
// registers a thread of the producer / a consumer warpgroup: the passes'
// split, and the eval chain's, whose consumers hold a 256-column
// accumulator and the next layer's A (192 registers) while products run:
// below 240 ptxas runs its products one at a time (C7512)
constexpr int kPassProducerRegs = 40, kPassConsumerRegs = 232;
constexpr int kChainProducerRegs = 24, kChainConsumerRegs = 240;

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on mbarrier bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on mbarrier bar once this thread's earlier cp.async copies
// have landed (counted in the barrier's arrivals: noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep a register's value where it is across an asynchronous wgmma: the
// compiler may not move its reads or writes over this point
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
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

// elementwise max / min of two bfloat16 pairs (exact)
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bmin2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d (64 x 128, float32) += a (64 x 16, bfloat16 registers) * b (16 x 128,
// the weight stage at descriptor desc); every thread's 64 d registers
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 256, float32) += a (64 x 16, bfloat16 registers) * b (16 x 256,
// the weight stage at descriptor desc); every thread's 128 d registers
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A ring of shared-memory stages: stage i's `full` and `empty` mbarriers,
// 8 bytes apart each, and the stage and phase this thread is at
struct Ring {
  uint32_t full, empty;
  int stages, stage = 0, phase = 0;
  __device__ Ring(uint32_t f, uint32_t e, int s)
      : full(f), empty(e), stages(s) {}
  __device__ uint32_t full_bar() const { return full + 8 * stage; }
  __device__ uint32_t empty_bar() const { return empty + 8 * stage; }
  __device__ void next() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};


// mlp_logic::bn_relu_bf16 of a bfloat16 pair af (columns c, c + 1 of one
// row) as a bfloat16 pair: the BN in float32 one rounding an op, the
// result rounded as a pair, then the ReLU as a bfloat16 max with +0 (a NaN
// gives +0) and the sign bits cleared (-0 gives +0): bitwise bn_relu_bf16
// of each
__device__ __forceinline__ uint32_t bn_relu_packed(uint32_t af, float2 mu,
                                                   float2 mul, float2 b) {
  const float y0 =
      __fadd_rn(__fmul_rn(__fsub_rn(bf16_lo(af), mu.x), mul.x), b.x);
  const float y1 =
      __fadd_rn(__fmul_rn(__fsub_rn(bf16_hi(af), mu.y), mul.y), b.y);
  return bmax2(pack_bf16(y0, y1), 0u) & 0x7fff7fffu;
}

// the same of a pair of float32 accumulators, af rounded as a pair
__device__ __forceinline__ uint32_t bn_relu_pair(float a0, float a1,
                                                 float2 mu, float2 mul,
                                                 float2 b) {
  return bn_relu_packed(pack_bf16(a0, a1), mu, mul, b);
}

// The producer warpgroup's share of a k stage, issued by its 128 threads
// (pt): the weight stage (thread 0: the full barrier's expected bytes, then
// one bulk copy of wbytes from w) and, where a is not null, the 16-byte
// chunks of the tile's rows 0 .. valid-1 at k0 (cp.async, coalesced:
// neighbouring threads copy neighbouring chunks of a row); then every
// thread's arrival once its copies have landed. float32 rows go into a
// 16-byte aligned window of 68 floats a row (f32_window, 16 threads a row,
// the first also the 17th chunk), or, at most 64 k wide, as the tile's
// whole contiguous block; bfloat16 a_j rows into rows of 72 (8 threads a
// row).
__device__ __forceinline__ void produce_stage(
    uint32_t dst, const void* a, bool f32, long long row0, int valid,
    int cin, int k0, const __nv_bfloat16* w, uint32_t wbytes, int pt,
    uint32_t full, int stage_a_bytes) {
  if (pt == 0) {
    mbar_arrive_expect(full, wbytes);
    bulk_copy(dst + stage_a_bytes, w, wbytes, full);
  }
  if (a) {
    if (f32 && wl::tile_contiguous(cin)) {
      const char* src =
          static_cast<const char*>(a) + row0 * cin * 4;
      const int chunks = valid * cin / 4;  // valid is a multiple of 16
      for (int c = pt; c < chunks; c += 128)
        cp_async16(dst + 16 * c, src + 16 * c);
    } else if (f32) {
      const int c = pt & 15;
      for (int r = pt >> 4; r < valid; r += 8) {
        long long begin;
        int bytes, off;
        wl::f32_window(row0 + r, cin, k0, &begin, &bytes, &off);
        const char* src = static_cast<const char*>(a) + begin;
        const uint32_t d = dst + r * wl::kPitchF32 * 4;
        if (16 * c < bytes) cp_async16(d + 16 * c, src + 16 * c);
        if (c == 0 && bytes > 256) cp_async16(d + 256, src + 256);
      }
    } else {
      const int per = min(wl::kStageK, cin - k0) / 8;  // chunks a row
      const int c = pt & 7;
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(a);
      if (c < per)
        for (int r = pt >> 3; r < valid; r += 16)
          cp_async16(dst + r * wl::kPitchBf16 * 2 + 16 * c,
                     src + (row0 + r) * cin + k0 + 8 * c);
    }
  }
  cp_async_arrive(full);
}

// A fragments of the 4 k steps of a float32 activation stage (rows r0 and
// r0 + 8 of the tile: this lane's), each value rounded to bfloat16; rows at
// or past `valid` and k at or past cin read as 0
__device__ __forceinline__ void frags_f32(uint32_t (&fr)[16],
                                          const float* sA, long long row0,
                                          int r0, int valid, int cin, int k0,
                                          int q) {
  const bool whole = wl::tile_contiguous(cin);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool in = r < valid;
    const float* row =
        whole ? sA + r * cin
              : sA + r * wl::kPitchF32 +
                    static_cast<int>(((row0 + r) * cin + k0) & 3);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int k = 16 * s + 8 * hi + 2 * q;
        const float v0 = in && k0 + k < cin ? row[k] : 0.f;
        const float v1 = in && k0 + k + 1 < cin ? row[k + 1] : 0.f;
        fr[4 * s + 2 * hi + h] = pack_bf16(v0, v1);
      }
  }
}

// A fragments of a bfloat16 a_j stage with layer j's BN + ReLU applied
// (bnv: mu, mul, bias of the cin channels, in shared memory), a bfloat16
// pair at a time (bn_relu_packed)
__device__ __forceinline__ void frags_bn(uint32_t (&fr)[16],
                                         const __nv_bfloat16* sA,
                                         const float* bnv, int r0, int valid,
                                         int cin, int k0, int q) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int k = 16 * s + 8 * hi + 2 * q, c = k0 + k;
      const bool col_in = c < cin;  // cin is even: c + 1 < cin too
      float2 mu = make_float2(0.f, 0.f), mul = mu, b = mu;
      if (col_in) {
        mu = *reinterpret_cast<const float2*>(bnv + c);
        mul = *reinterpret_cast<const float2*>(bnv + cin + c);
        b = *reinterpret_cast<const float2*>(bnv + 2 * cin + c);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        uint32_t v = 0u;
        if (r < valid && col_in)
          v = bn_relu_packed(*reinterpret_cast<const uint32_t*>(
                                 sA + r * wl::kPitchBf16 + k),
                             mu, mul, b);
        fr[4 * s + 2 * hi + h] = v;
      }
    }
}

// issue kSteps k steps of 16 of the A fragments fr against the weight
// stage at desc, kN columns, as one committed wgmma group: straight-line
// code between the fence and the commit, so that ptxas keeps the products
// in flight together
template <int kN, int kSteps>
__device__ __forceinline__ void issue_steps(float* acc, uint32_t* fr,
                                            uint64_t desc) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint64_t d = desc + ((s * 2 * wl::kLBO) >> 4);
    if (kN == 256)
      wgmma_rs_n256(acc, fr + 4 * s, d);
    else
      wgmma_rs_n128(acc, fr + 4 * s, d);
  }
  wgmma_commit();
}

// the products of one stage: its k steps up to kmax (< 64 at the padded end
// of a layer)
template <int kN>
__device__ __forceinline__ void issue_stage(float* acc, uint32_t* fr,
                                            uint64_t desc, int kmax) {
  if (kmax >= 64)
    issue_steps<kN, 4>(acc, fr, desc);
  else if (kmax > 32)
    issue_steps<kN, 3>(acc, fr, desc);
  else if (kmax > 16)
    issue_steps<kN, 2>(acc, fr, desc);
  else
    issue_steps<kN, 1>(acc, fr, desc);
}

// every product of this warp done: the accumulators may be read and the
// fragments' registers reused
template <int kN>
__device__ __forceinline__ void finish_products(float* acc) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) pin(acc[i]);
}

__device__ __forceinline__ void pin16(uint32_t* fr) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pin(fr[i]);
}

// a consumer warp is done with the stage whose empty barrier is bar
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <class T>
struct ShflXor {
  __device__ T operator()(T v, int mask) const {
    return __shfl_xor_sync(0xffffffffu, v, mask);
  }
};
struct AddRn {
  __device__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct Max2 {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return bmax2(a, b);
  }
};
struct Min2 {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return bmin2(a, b);
  }
};

// the barriers of a ring of S stages: each full one completed by the
// producer's thread 0 (with the weight copy's bytes) and the 128 producer
// threads' cp.async arrivals, each empty one by the 8 consumer warps; made
// visible to the async proxy before any copy
__device__ __forceinline__ void init_ring(uint64_t* bars, int S) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(bars + s), 1 + 128);
      mbar_init(smem_addr(bars + S + s), wl::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the register split of the warpgroups (each a multiple of 8, 128 x kLow
// + 256 x kHigh within the SM's 65 536)
template <int kLow>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLow));
}
template <int kHigh>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kHigh));
}

// ------------------------------------------------------------------ passes

struct PassArgs {
  const void* a;      // the grouped rows x (rows, cin) float32, or a_j
                      // (rows, cin) bfloat16
  const float* mu;    // BN of the A operand (cin): a_j only
  const float* mul;
  const float* bias;
  const __nv_bfloat16* wt;  // packed W^T (cout rows, kp k)
  __nv_bfloat16* a_out;     // (rows, cout) or null
  float* ext_max;           // (rows / seg, cout) or null: the last pass
  float* ext_min;
  float* psum;              // (row tiles, 2, cout) or null (eval)
  long long rows;
  int cin, cout, tile_rows, seg;
};

// Rows a pass tile holds and rows a max/min segment spans, for K a multiple
// of 16: a segment is the K rows of a centre (K <= 128) or the largest
// multiple of 16 up to 128 that divides K; a tile holds whole segments.
void pass_tile(int K, int* tile_rows, int* seg) {
  int s = K;
  if (s > wl::kTileRows)
    for (s = wl::kTileRows; K % s; s -= 16) {
    }
  *seg = s;
  *tile_rows = wl::kTileRows / s * s;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// kBnSrc: the A operand is a_j (bfloat16) with layer j's BN + ReLU applied
// as it is loaded; otherwise the float32 grouped rows, rounded as loaded.
// kN: the columns of a work item (one wgmma). A work item is a tile of
// tile_rows rows x kN columns; blocks walk over them, the tile's column
// blocks one after another.
template <bool kBnSrc, int kN>
__global__ void __launch_bounds__(wl::kThreads, 1)
mlp_pass_bf16_kernel(const PassArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int S = wl::pass_stages(!kBnSrc);
  constexpr int kStageA = kBnSrc ? wl::kStageABf16 : wl::kStageAF32;
  constexpr int kStage = kStageA + wl::kStageB;
  float* const part = reinterpret_cast<float*>(smem + S * kStage);
  float* const bnv = part + 2 * wl::kConsumerWarps * wl::kMaxN;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      bnv + (kBnSrc ? 3 * ((p.cin + 31) / 32 * 32) : 0));
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int cin = p.cin, cout = p.cout;
  const int ntn = (cout + kN - 1) / kN;
  const long long items = (p.rows + p.tile_rows - 1) / p.tile_rows * ntn;
  const int nk = (cin + wl::kStageK - 1) / wl::kStageK;

  init_ring(bars, S);
  if (kBnSrc)
    for (int c = t; c < cin; c += wl::kThreads) {
      bnv[c] = p.mu[c];
      bnv[cin + c] = p.mul[c];
      bnv[2 * cin + c] = p.bias[c];
    }
  __syncthreads();
  Ring ring(smem_addr(bars), smem_addr(bars + S), S);

  if (warp < 4) {  // the producer warpgroup issues every copy
    producer_regs<kPassProducerRegs>();
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
      const long long tile = item / ntn;
      const int n0 = static_cast<int>(item - tile * ntn) * kN;
      const long long row0 = tile * p.tile_rows;
      const int valid = static_cast<int>(
          min(static_cast<long long>(p.tile_rows), p.rows - row0));
      const uint32_t wbytes = min(kN, cout - n0) * wl::kStageK * 2;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(ring.empty_bar(), ring.phase ^ 1);
        produce_stage(smem_addr(smem + ring.stage * kStage), p.a, !kBnSrc,
                      row0, valid, cin, kc * wl::kStageK,
                      p.wt + wl::packed_stage_offset(kc, n0, cout), wbytes,
                      t, ring.full_bar(), kStageA);
        ring.next();
      }
    }
    return;
  }

  consumer_regs<kPassConsumerRegs>();
  const int cw = warp - 4, ct = t - 128;  // consumer warp and thread
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * cw + g;  // this lane's first tile row
  float acc[kN / 2];
  uint32_t fr0[16], fr1[16];
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long tile = item / ntn;
    const int n0 = static_cast<int>(item - tile * ntn) * kN;
    const long long row0 = tile * p.tile_rows;
    const int valid = static_cast<int>(
        min(static_cast<long long>(p.tile_rows), p.rows - row0));
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
    // the main loop: stage kc's fragments are built and its products
    // issued while stage kc-1's products still run; then kc-1 is freed
    uint32_t prev = 0;
    auto step = [&](uint32_t(&fr)[16], uint32_t(&other)[16], int kc) {
      mbar_wait(ring.full_bar(), ring.phase);
      const unsigned char* st = smem + ring.stage * kStage;
      if (kBnSrc)
        frags_bn(fr, reinterpret_cast<const __nv_bfloat16*>(st), bnv, r0,
                 valid, cin, kc * wl::kStageK, q);
      else
        frags_f32(fr, reinterpret_cast<const float*>(st), row0, r0, valid,
                  cin, kc * wl::kStageK, q);
      issue_stage<kN>(acc, fr, wl::make_desc(smem_addr(st + kStageA)),
                      cin - kc * wl::kStageK);
      wgmma_wait<1>();
      pin16(other);
      if (kc) release(prev, lane);
      prev = ring.empty_bar();
      ring.next();
    };
    for (int kc = 0; kc < nk; kc += 2) {
      step(fr0, fr1, kc);
      if (kc + 1 < nk) step(fr1, fr0, kc + 1);
    }
    finish_products<kN>(acc);
    pin16(fr0);
    pin16(fr1);
    release(prev, lane);

    // af: the product rounded to bfloat16, a pair a register: pk[2 i + h]
    // holds columns 8 i + 2 q, +1 of row r0 + 8 h
    uint32_t pk[kN / 4];
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pk[2 * i + h] = pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);

    if (p.a_out) {  // a_{j+1}: each lane quad transposes 4 column blocks so
                    // that a lane holds 8 columns (16 bytes) of a row
#pragma unroll
      for (int m = 0; m < kN / 32; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t pr[4], o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[i] = pk[2 * (4 * m + i) + h];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t r =
                __shfl_xor_sync(0xffffffffu, pick4(pr, q ^ j), j);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if ((q ^ j) == k) o[k] = r;
          }
          const int row = r0 + 8 * h, col = n0 + 8 * (4 * m + q);
          if (row < valid && col < cout)
            *reinterpret_cast<uint4*>(p.a_out + (row0 + row) * cout + col) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
    }
    float* const pa = part;                             // [8][kMaxN]
    float* const pb = part + wl::kConsumerWarps * wl::kMaxN;
    if (p.psum) {  // column sums of af and af^2: the two rows of a lane,
                   // the 8 lanes of a quad column (halve8), then the warps
                   // in order
      float v[kN / 4];
#pragma unroll
      for (int sq = 0; sq < 2; ++sq) {
#pragma unroll
        for (int i = 0; i < kN / 8; ++i) {
          const float a0 = bf16_lo(pk[2 * i]), b0 = bf16_lo(pk[2 * i + 1]);
          const float a1 = bf16_hi(pk[2 * i]), b1 = bf16_hi(pk[2 * i + 1]);
          v[2 * i] = sq ? __fadd_rn(__fmul_rn(a0, a0), __fmul_rn(b0, b0))
                        : __fadd_rn(a0, b0);
          v[2 * i + 1] = sq ? __fadd_rn(__fmul_rn(a1, a1), __fmul_rn(b1, b1))
                            : __fadd_rn(a1, b1);
        }
        wl::halve8<kN / 4>(v, g, AddRn(), ShflXor<float>());
#pragma unroll
        for (int k = 0; k < kN / 32; ++k) {
          const int e = wl::halve8_origin(k, g, kN / 4);
          (sq ? pb : pa)[cw * wl::kMaxN + 8 * (e / 2) + 2 * q + e % 2] = v[k];
        }
      }
      named_sync(1, 256);
      if (ct < kN && n0 + ct < cout) {
        float s1 = pa[ct], s2 = pb[ct];
        for (int w2 = 1; w2 < wl::kConsumerWarps; ++w2) {
          s1 = __fadd_rn(s1, pa[w2 * wl::kMaxN + ct]);
          s2 = __fadd_rn(s2, pb[w2 * wl::kMaxN + ct]);
        }
        p.psum[(tile * 2) * cout + n0 + ct] = s1;
        p.psum[(tile * 2 + 1) * cout + n0 + ct] = s2;
      }
      named_sync(1, 256);
    }
    if (p.ext_max) {  // each segment's max and min: a warp's 16 rows lie in
                      // one segment; the lanes (halve8 on bfloat16 pairs),
                      // then the segment's warps
      uint32_t mx[kN / 8], mn[kN / 8];
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        mx[i] = bmax2(pk[2 * i], pk[2 * i + 1]);
        mn[i] = bmin2(pk[2 * i], pk[2 * i + 1]);
      }
      wl::halve8<kN / 8>(mx, g, Max2(), ShflXor<uint32_t>());
      wl::halve8<kN / 8>(mn, g, Min2(), ShflXor<uint32_t>());
#pragma unroll
      for (int k = 0; k < kN / 64; ++k) {
        const int col = 8 * wl::halve8_origin(k, g, kN / 8) + 2 * q;
        pa[cw * wl::kMaxN + col] = bf16_lo(mx[k]);
        pa[cw * wl::kMaxN + col + 1] = bf16_hi(mx[k]);
        pb[cw * wl::kMaxN + col] = bf16_lo(mn[k]);
        pb[cw * wl::kMaxN + col + 1] = bf16_hi(mn[k]);
      }
      named_sync(1, 256);
      if (ct < kN && n0 + ct < cout) {
        const int wps = p.seg / 16, nseg = valid / p.seg;
        for (int sg = 0; sg < nseg; ++sg) {
          float mxv = pa[sg * wps * wl::kMaxN + ct];
          float mnv = pb[sg * wps * wl::kMaxN + ct];
          for (int w2 = 1; w2 < wps; ++w2) {
            mxv = fmaxf(mxv, pa[(sg * wps + w2) * wl::kMaxN + ct]);
            mnv = fminf(mnv, pb[(sg * wps + w2) * wl::kMaxN + ct]);
          }
          const long long o = (row0 / p.seg + sg) * cout + n0 + ct;
          p.ext_max[o] = mxv;
          p.ext_min[o] = mnv;
        }
      }
      named_sync(1, 256);
    }
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

template <bool kBnSrc, int kN>
cudaError_t launch_pass(const PassArgs& p, cudaStream_t stream) {
  const long long smem = wl::pass_smem_bytes(!kBnSrc, p.cin);
  if (smem > wl::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_pass_bf16_kernel<kBnSrc, kN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int sms = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(sm_count(&sms));
  if (err != cudaSuccess) return err;
  const long long items = (p.rows + p.tile_rows - 1) / p.tile_rows *
                          ((p.cout + kN - 1) / kN);
  const long long grid = items < sms ? items : sms;
  mlp_pass_bf16_kernel<kBnSrc, kN>
      <<<static_cast<unsigned>(grid), wl::kThreads, static_cast<size_t>(smem),
         stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ eval chain

struct Layers {
  const __nv_bfloat16* wt[kMaxLayers];  // packed W_j^T (C_{j+1} rows)
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* bias[kMaxLayers];
  int c[kMaxLayers + 1];
};

// a chunk width (or a flag) as a type, for the eval chain's generic lambda
template <int N>
struct Cols {
  static constexpr int n = N;
};

// The eval mode's chain over tiles of 128 rows (two warpgroups of 64 rows,
// whole centres of K = 16, 32 or 64 rows): layer 0's A operand from the
// float32 rows in the ring, every later layer's from the previous layer's
// accumulators in registers, the last layer pooled per 256-column chunk.
__global__ void __launch_bounds__(wl::kThreads, 1)
fused_mlp_bf16_kernel(const float* __restrict__ x,
                      __nv_bfloat16* __restrict__ out, const Layers p, int L,
                      long long rows, int K, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kStage = static_cast<int>(wl::chain_stage_bytes(p.c[0]));
  const int kStageA = kStage - wl::kStageB;  // layer 0's float32 rows
  // the last layer's per-warp column maxima, bfloat16 pairs: [2][4][128]
  uint32_t* const pool = reinterpret_cast<uint32_t*>(smem + S * kStage);
  float* const bnv = reinterpret_cast<float*>(pool + 2 * 4 * wl::kMaxN / 2);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(bnv + 3 * wl::kChainMaxChannels);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long tiles = (rows + wl::kTileRows - 1) / wl::kTileRows;
  const int CL = p.c[L];

  init_ring(bars, S);
  // every layer's BN vectors: layer j's (mu, mul, bias) from 3 * (C_1 + ..
  // + C_j), each C_{j+1} long
  for (int j = 0, base = 0; j < L; base += 3 * p.c[j + 1], ++j)
    for (int c = t; c < p.c[j + 1]; c += wl::kThreads) {
      bnv[base + c] = p.mu[j][c];
      bnv[base + p.c[j + 1] + c] = p.mul[j][c];
      bnv[base + 2 * p.c[j + 1] + c] = p.bias[j][c];
    }
  __syncthreads();
  Ring ring(smem_addr(bars), smem_addr(bars + S), S);

  if (warp < 4) {  // the producer warpgroup issues every copy
    producer_regs<kChainProducerRegs>();
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long row0 = tile * wl::kTileRows;
      const int valid = static_cast<int>(
          min(static_cast<long long>(wl::kTileRows), rows - row0));
      for (int j = 0; j < L; ++j) {
        const int cin = p.c[j], cout = p.c[j + 1];
        const int nk = (cin + wl::kStageK - 1) / wl::kStageK;
        for (int cb = 0; cb < cout; cb += wl::kMaxN) {
          const uint32_t wbytes =
              min(wl::kMaxN, cout - cb) * wl::kStageK * 2;
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(ring.empty_bar(), ring.phase ^ 1);
            produce_stage(smem_addr(smem + ring.stage * kStage),
                          j ? nullptr : x, true, row0, valid, cin,
                          kc * wl::kStageK,
                          p.wt[j] + wl::packed_stage_offset(kc, cb, cout),
                          wbytes, t, ring.full_bar(), kStageA);
            ring.next();
          }
        }
      }
    }
    return;
  }

  consumer_regs<kChainConsumerRegs>();
  const int cw = warp - 4, wg = cw >> 2, w = cw & 3;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * cw + g;  // this lane's first tile row
  const int wt = t - 128 - 128 * wg;  // thread of its warpgroup
  uint32_t areg[wl::kMaxN / 4];  // the next layer's A: 16 k steps x 4
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * wl::kTileRows;
    const int valid = static_cast<int>(
        min(static_cast<long long>(wl::kTileRows), rows - row0));
    for (int j = 0, base = 0; j < L; base += 3 * p.c[j + 1], ++j) {
      const int cin = p.c[j], cout = p.c[j + 1];
      const int nk = (cin + wl::kStageK - 1) / wl::kStageK;
      const float* const mu = bnv + base;
      // one chunk of kN = 256 or 128 columns from cb: a code path of its
      // own for each width and for the first layer (A from the float32
      // rows) and the others (A in registers), so that ptxas sees no other
      // instruction define a product's accumulators between its start and
      // end (it would then run every product of the kernel one at a time)
      auto chunk = [&](auto cols, auto first_layer, int cb) {
        constexpr int kN = decltype(cols)::n;
        float acc[kN / 2];
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
        // each stage's products are issued before the previous stage's
        // are waited for and its stage freed
        uint32_t prev = 0;
        if constexpr (decltype(first_layer)::n) {
          // layer 0: the A fragments from the float32 rows, built for each
          // stage and waited for before the next stage's are built (a
          // double buffer here made ptxas run every product of the kernel
          // one at a time)
          for (int kc = 0; kc < nk; ++kc) {
            uint32_t fr[16];
            mbar_wait(ring.full_bar(), ring.phase);
            const unsigned char* st = smem + ring.stage * kStage;
            frags_f32(fr, reinterpret_cast<const float*>(st), row0, r0,
                      valid, cin, kc * wl::kStageK, q);
            issue_stage<kN>(acc, fr, wl::make_desc(smem_addr(st + kStageA)),
                            cin - kc * wl::kStageK);
            wgmma_wait<0>();
            pin16(fr);
            release(ring.empty_bar(), lane);
            ring.next();
          }
        } else {
#pragma unroll
          for (int kc = 0; kc < wl::kMaxN / wl::kStageK; ++kc)
            if (kc < nk) {
              mbar_wait(ring.full_bar(), ring.phase);
              issue_stage<kN>(acc, areg + 16 * kc,
                              wl::make_desc(smem_addr(
                                  smem + ring.stage * kStage + kStageA)),
                              wl::kStageK);
              wgmma_wait<1>();
              if (kc) release(prev, lane);
              prev = ring.empty_bar();
              ring.next();
            }
        }
        finish_products<kN>(acc);
        if constexpr (!decltype(first_layer)::n) {
#pragma unroll
          for (int i = 0; i < wl::kMaxN / 4; ++i) pin(areg[i]);
          release(prev, lane);
        }

        if (j < L - 1) {  // h_{j+1} (one chunk), bfloat16 pairs, is the
                          // next layer's A: register reg of k step s holds
                          // accumulators acc_for_afrag(s, reg, 0 and 1)
#pragma unroll
          for (int s = 0; s < kN / 16; ++s)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {  // columns 16 s + 8 hi + 2 q
              const int col = 16 * s + 8 * hi + 2 * q;
              const float2 m2 = *reinterpret_cast<const float2*>(mu + col);
              const float2 s2 =
                  *reinterpret_cast<const float2*>(mu + cout + col);
              const float2 b2 =
                  *reinterpret_cast<const float2*>(mu + 2 * cout + col);
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // rows g, g + 8
                const int reg = 2 * hi + h;
                areg[4 * s + reg] =
                    bn_relu_pair(acc[wl::acc_for_afrag(s, reg, 0)],
                                 acc[wl::acc_for_afrag(s, reg, 1)], m2, s2, b2);
              }
            }
          return;
        }
        // the last layer: the max over each centre's rows, as bfloat16
        // pairs: a lane's two rows, the 8 lanes of a quad column (halve8),
        // then (K > 16) the centre's warps
        uint32_t m[kN / 8];
#pragma unroll
        for (int i = 0; i < kN / 8; ++i) {
          const int col = cb + 8 * i + 2 * q;
          const float2 m2 = *reinterpret_cast<const float2*>(mu + col);
          const float2 s2 = *reinterpret_cast<const float2*>(mu + cout + col);
          const float2 b2 =
              *reinterpret_cast<const float2*>(mu + 2 * cout + col);
          m[i] = bmax2(
              bn_relu_pair(acc[4 * i], acc[4 * i + 1], m2, s2, b2),
              bn_relu_pair(acc[4 * i + 2], acc[4 * i + 3], m2, s2, b2));
        }
        wl::halve8<kN / 8>(m, g, Max2(), ShflXor<uint32_t>());
#pragma unroll
        for (int k = 0; k < kN / 64; ++k) {
          const int i = wl::halve8_origin(k, g, kN / 8);
          if (K == 16) {  // a centre is a warp's 16 rows
            const long long crow = row0 + 16 * cw;
            if (crow < rows)
              *reinterpret_cast<uint32_t*>(out + crow / 16 * CL + cb + 8 * i +
                                           2 * q) = m[k];
          } else {
            pool[(4 * wg + w) * (wl::kMaxN / 2) + 4 * i + q] = m[k];
          }
        }
        if (K > 16) {  // a centre spans K / 16 warps of the warpgroup
          named_sync(2 + wg, 128);
          const int wpc = K / 16;
          for (int c = 0; c < wl::kRowsWG / K; ++c) {
            const long long crow = row0 + wl::kRowsWG * wg + c * K;
            if (crow >= rows) break;
            for (int pr = wt; pr < kN / 2; pr += 128) {
              uint32_t v = pool[(4 * wg + c * wpc) * (wl::kMaxN / 2) + pr];
              for (int w2 = 1; w2 < wpc; ++w2)
                v = bmax2(v, pool[(4 * wg + c * wpc + w2) * (wl::kMaxN / 2) +
                                  pr]);
              *reinterpret_cast<uint32_t*>(out + crow / K * CL + cb +
                                           2 * pr) = v;
            }
          }
          named_sync(2 + wg, 128);
        }
      };
      for (int cb = 0; cb < cout; cb += wl::kMaxN) {
        if (j == 0 && cout - cb >= 256)
          chunk(Cols<256>(), Cols<1>(), cb);
        else if (j == 0)
          chunk(Cols<128>(), Cols<1>(), cb);
        else if (cout - cb >= 256)
          chunk(Cols<256>(), Cols<0>(), cb);
        else
          chunk(Cols<128>(), Cols<0>(), cb);
      }
    }
  }
}

}  // namespace

// Shared memory an eval launch needs, in bytes, where the chained kernel
// takes the shape (wgmma_logic.cuh::chain_takes); above any block's limit
// (the wrapper then takes the pass plan) where it does not.
extern "C" long long fused_mlp_bf16_smem_bytes(const int* chans, int L,
                                               int K) {
  return wl::chain_takes(chans, L, K) ? wl::chain_smem_bytes(chans[0])
                                      : 1LL << 40;
}

// The eval mode. ptrs: 4*L device pointers, (packed W^T bfloat16, mu, mul,
// bias) of each layer; chans: L+1 widths; kps: each W^T's k (a multiple of
// 64, zero-padded). x is the float32 grouped rows (rows, chans[0]); out
// (rows / K, chans[L]) bfloat16.
extern "C" int fused_mlp_bf16_launch(const float* x, __nv_bfloat16* out,
                                     const void* const* ptrs,
                                     const int* chans, const int* kps, int L,
                                     long long rows, int K,
                                     cudaStream_t stream) {
  if (!wl::chain_takes(chans, L, K) || rows < 1 || rows % K || !x || !out ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorInvalidValue;
  Layers p{};
  for (int j = 0; j < L; ++j) {
    p.wt[j] = static_cast<const __nv_bfloat16*>(ptrs[4 * j]);
    p.mu[j] = static_cast<const float*>(ptrs[4 * j + 1]);
    p.mul[j] = static_cast<const float*>(ptrs[4 * j + 2]);
    p.bias[j] = static_cast<const float*>(ptrs[4 * j + 3]);
    if (!p.wt[j] || !p.mu[j] || !p.mul[j] || !p.bias[j] ||
        kps[j] % wl::kStageK ||
        kps[j] < (chans[j] + wl::kStageK - 1) / wl::kStageK * wl::kStageK ||
        reinterpret_cast<uintptr_t>(p.wt[j]) % 16)
      return cudaErrorInvalidValue;
  }
  for (int j = 0; j <= L; ++j) p.c[j] = chans[j];
  const long long smem = wl::chain_smem_bytes(chans[0]);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int sms = 0;
  if (err == cudaSuccess) err = static_cast<cudaError_t>(sm_count(&sms));
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + wl::kTileRows - 1) / wl::kTileRows;
  const long long grid = tiles < sms ? tiles : sms;
  fused_mlp_bf16_kernel<<<static_cast<unsigned>(grid), wl::kThreads,
                          static_cast<size_t>(smem), stream>>>(
      x, out, p, L, rows, K, wl::chain_stages(chans[0]));
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
// transpose (cout, kp) in bfloat16, k zero-padded to kp, packed by
// wgmma_logic.cuh::packed_weight_index). The A operand is the float32
// grouped rows x (a_bf16 = 0, mu null), rounded as loaded, or bn_relu_bf16
// of the stored a_j (a_bf16 = 1, mu/mul/bias given). Writes the product
// rounded to bfloat16 to a_out (if not null), each segment's max and min of
// it to ext_max / ext_min (if not null), and each row tile's column sums of
// it and its square to psum (tiles, 2, cout; if not null).
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
  p.cin = cin;
  p.cout = cout;
  if (K < 16 || K % 16) return cudaErrorInvalidValue;
  pass_tile(K, &p.tile_rows, &p.seg);
  const int kin = (cin + wl::kStageK - 1) / wl::kStageK * wl::kStageK;
  if (rows < 1 || rows % K || cin < 1 || cout < 8 || cout % 8 || !a || !wt ||
      kp < kin || kp % wl::kStageK || (!ext_max) != (!ext_min) ||
      (a_bf16 && (!mu || !mul || !bias || cin % 8)) || (!a_bf16 && mu) ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(a_out) % 16 ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return cudaErrorInvalidValue;
  const bool wide = wl::pass_bn(cout) == 256;
  if (a_bf16)
    return wide ? launch_pass<true, 256>(p, stream)
                : launch_pass<true, 128>(p, stream);
  return wide ? launch_pass<false, 256>(p, stream)
              : launch_pass<false, 128>(p, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
