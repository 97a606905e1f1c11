// Fused ball query + relative-xyz grouping (+ feature-row grouping) on
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel omni_pq_tpu/ops/ball_query.py::_bq_kernel
// via _bq_pallas (pallas_call at ball_query.py:392), forward only, for the
// entry points `ball_query_group` (emit_values=True), `ball_query` (idx only:
// `grouped` is null) and `ball_query_group_feats` (feat_dim > 0: `features`
// and `out_feats` set). Plain versions beside it:
// omni_pq_torch/ops/ball_query.py::ball_query_group_plain and
// ::ball_query_group_feats_plain, which this kernel equals bitwise.
//
// Semantics: per centre c, the first (by index) <= K points p with
// ((c-p).x^2 + (c-p).y^2) + (c-p).z^2 < r2; idx holds their indices and
// grouped holds p - c. Unfilled slots repeat the first hit; a centre with no
// hit gets index 0 and p[0] - c in every slot (ball_query_gpu.cu:38-45).
// r2 is the float32 rounding of radius*radius taken in double, the value
// both JAX versions compare against. With features, out_feats[c, k] is the
// feature row features[b, idx[c, k]]: a byte copy, so any element type, and
// a no-hit centre gets row 0 like its idx.
//
// What bounds it on the H100: the query's bytes (the points read once, the
// chunk-box table, the (B,S,K) outputs written once: 42 MB at sa1, 0.013
// ms) and its operations (one box test a centre and 32-point chunk, ~9
// flops a point of each chunk it admits up to the K-th hit) are far below
// what a warp's chain of dependent chunk steps takes: the kernel is
// latency-bound, 0.127 ms at sa1 (H100 80GB HBM3, 700 W). The feature rows
// are bytes-bound (the (B,S,K,C) output is written once; at sa2 that is
// 512 MiB in float32).
//
// Design: rows of more than 2048 points (point_logic.cuh: bq_skips_chunks)
// take two kernels in one ball_query_launch. The first writes each 32-point
// chunk's bounding box (one warp a chunk, a shuffle reduction) into a
// scratch table the wrapper allocates: (B, 6, ceil(N/32)) float32, a row's
// six bounds each one array (xlo, xhi, ylo, yhi, zlo, zhi). The query kernel
// runs one block per (16 centres, batch row), so a block serves one row,
// and stages the row's table in shared memory (30 KB at sa1); a table larger
// than a block's shared memory (rows above 309 920 points) is read from
// global memory instead. One warp per centre: lanes test 32 chunk boxes a
// ballot against the ball, in ascending chunk order, and for each chunk
// that may hold a hit, still in ascending order, the warp runs the 32-point
// step: __ballot_sync marks the hits and a popc prefix gives each hit its
// slot, so slots fill in index order; the loop stops at K hits. A skipped
// chunk holds no hit, so the slots are those of a scan of the whole row.
// The box test (box_may_hit) is conservative: each axis' gap from the
// centre to the box is computed with the point test's rounding, so the
// box's rounded d2 is at most any of its points', and its threshold is r2
// inflated by 2^-10 relative and 1e-6 absolute on the radius.
// Morton-ordered clouds (the data's order, so sa1) give small boxes: a ball
// of radius 0.2 admits ~11 of the 1250 chunks, against ~1125 chunk steps of
// a scan. Rows of up to 2048 points (sa2-sa4 and vote aggregation,
// FPS-ordered, where boxes span the room and prune nothing) skip the
// pre-pass and scan every chunk, the loop unrolled 4 times. idx and
// grouped are written in the same pass. The distance uses __f*_rn
// intrinsics so nvcc cannot fuse it into FMAs (a fused form moves boundary
// points). Then, once the K slots are final, the warp copies the K feature
// rows: lanes walk the (slot, vector) pairs of the centre's contiguous
// output block, 16, 8, 4, 2 or 1 bytes a lane (the widest that divides the
// row and both base addresses), so the stores of a warp are contiguous;
// each lane issues 4 loads before its 4 stores. Offsets are 64-bit. The
// query-only entry points compile without the copy. Not done: the TPU
// kernel's Morton sort of the centres, which serves its tile bounding box;
// a warp a centre needs no sorting.

#include <cuda_runtime.h>

#include <cstdint>

#include "point_logic.cuh"

using namespace point_logic;

namespace {

constexpr int kWarps = 16;  // centres per block

constexpr int kCopyUnroll = 4;  // feature vectors a lane has in flight

// dynamic shared memory a block may use on sm_90 (227 KB)
constexpr int kMaxSharedBytes = 232448;

// where the query kernel reads a row's chunk boxes: none (every chunk
// scanned), staged in shared memory, or in global memory
enum class Table { kNone, kShared, kGlobal };

// one warp a 32-point chunk: its min and max per axis into the (B, 6,
// nchunks) table
__global__ void __launch_bounds__(256)
chunk_box_kernel(const float* __restrict__ xyz, float* __restrict__ boxes,
                 int N, int nchunks, long long total) {
  const long long ch = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
  if (ch >= total) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long b = ch / nchunks;
  const int chunk = static_cast<int>(ch - b * nchunks);
  const int n = chunk * kChunk + lane;
  float xlo = FLT_MAX, ylo = FLT_MAX, zlo = FLT_MAX;
  float xhi = -FLT_MAX, yhi = -FLT_MAX, zhi = -FLT_MAX;
  if (n < N) {
    const float* q = xyz + (b * N + n) * 3;
    xlo = xhi = q[0];
    ylo = yhi = q[1];
    zlo = zhi = q[2];
  }
  for (int off = 16; off > 0; off >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, off));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    zlo = fminf(zlo, __shfl_xor_sync(0xffffffffu, zlo, off));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, off));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
    zhi = fmaxf(zhi, __shfl_xor_sync(0xffffffffu, zhi, off));
  }
  // lane j < 6 writes bound j: xlo, xhi, ylo, yhi, zlo, zhi
  const float v = lane == 0   ? xlo
                  : lane == 1 ? xhi
                  : lane == 2 ? ylo
                  : lane == 3 ? yhi
                  : lane == 4 ? zlo
                              : zhi;
  if (lane < 6) boxes[(b * 6 + lane) * nchunks + chunk] = v;
}

// One 32-point step of a centre's query: the points base..base+31 tested,
// the hits' slots assigned in index order by ballot + popc, idx and grouped
// written; count and first (the first hit) carried across steps.
__device__ __forceinline__ void query_chunk(
    const float* __restrict__ p, int N, int base, int lane, float cx,
    float cy, float cz, float r2, int K, int* __restrict__ out_i,
    float* __restrict__ out_g, int& count, int& first) {
  const int n = base + lane;
  bool hit = false;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (n < N) {
    px = p[3 * n];
    py = p[3 * n + 1];
    pz = p[3 * n + 2];
    hit = point_hits(px, py, pz, cx, cy, cz, r2);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (mask == 0) return;
  if (count == 0) first = base + __ffs(mask) - 1;
  const int slot = count + __popc(mask & ((1u << lane) - 1u));
  if (hit && slot < K) {
    out_i[slot] = n;
    if (out_g) {
      out_g[3 * slot] = __fsub_rn(px, cx);
      out_g[3 * slot + 1] = __fsub_rn(py, cy);
      out_g[3 * slot + 2] = __fsub_rn(pz, cz);
    }
  }
  count += __popc(mask);
}

// kFeats = false compiles the query alone: no copy code, which keeps the
// query loop's registers down (the copy cost 8 more and 20 % at sa1).
// kTable: where the chunk boxes are read (rows above kBqScanMaxPoints);
// kNone scans every chunk and reads no table.
template <typename V, bool kFeats, Table kTable>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ boxes,
                  const float* __restrict__ new_xyz, int* __restrict__ idx,
                  float* __restrict__ grouped,
                  const V* __restrict__ features, V* __restrict__ out_feats,
                  int row_vecs, int N, int nchunks, int S, int K, float r2,
                  float r2_box) {
  extern __shared__ float sbox[];
  // blocks are (centre block, batch row) pairs, the centre block fastest
  const int sblocks = (S + kWarps - 1) / kWarps;
  const long long b = blockIdx.x / sblocks;
  // the row's box table: six arrays of nchunks bounds
  const float* table = nullptr;
  if constexpr (kTable == Table::kGlobal) table = boxes + b * 6 * nchunks;
  if constexpr (kTable == Table::kShared) {
    for (int e = threadIdx.x; e < nchunks * 6; e += blockDim.x)
      sbox[e] = boxes[b * 6 * nchunks + e];
    __syncthreads();
    table = sbox;
  }

  const int lane = threadIdx.x & 31;
  const int s = static_cast<int>(blockIdx.x - b * sblocks) * kWarps +
                (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp: one centre a warp
  const long long c = b * S + s;
  const float* p = xyz + b * N * 3;
  const float cx = new_xyz[3 * c], cy = new_xyz[3 * c + 1],
              cz = new_xyz[3 * c + 2];
  int* out_i = idx + c * K;
  float* out_g = grouped ? grouped + c * K * 3 : nullptr;

  int count = 0;
  int first = 0;  // the first hit; 0 stands in when there is none
  if constexpr (kTable != Table::kNone) {
    for (int cb = 0; cb < nchunks && count < K; cb += 32) {
      const int ch = cb + lane;
      const bool may = ch < nchunks && chunk_may_hit(table, nchunks, ch, cx,
                                                     cy, cz, r2_box);
      // the chunks that may hold a hit, in ascending order
      for (unsigned chunks = __ballot_sync(0xffffffffu, may);
           chunks != 0 && count < K; chunks &= chunks - 1)
        query_chunk(p, N, (cb + __ffs(chunks) - 1) * kChunk, lane, cx, cy,
                    cz, r2, K, out_i, out_g, count, first);
    }
  } else {
    // unrolled, the loads of later steps issue early (on the H100 the
    // rolled loop was slower than the earlier whole-row kernel without
    // chunk boxes, the unrolled one faster)
#pragma unroll 4
    for (int base = 0; base < N && count < K; base += kChunk)
      query_chunk(p, N, base, lane, cx, cy, cz, r2, K, out_i, out_g, count,
                  first);
  }
  if (count < K) {
    const float fx = __fsub_rn(p[3 * first], cx),
                fy = __fsub_rn(p[3 * first + 1], cy),
                fz = __fsub_rn(p[3 * first + 2], cz);
    for (int slot = count + lane; slot < K; slot += 32) {
      out_i[slot] = first;
      if (out_g) {
        out_g[3 * slot] = fx;
        out_g[3 * slot + 1] = fy;
        out_g[3 * slot + 2] = fz;
      }
    }
  }
  if constexpr (kFeats) {
    // every lane's idx stores are visible to the whole warp after this
    __syncwarp();
    // a centre's block (K rows) fits an int; the base offsets need 64 bits
    const V* src = features + b * N * row_vecs;
    V* dst = out_feats + c * K * row_vecs;
    const int total = K * row_vecs;
    for (int e0 = lane; e0 < total; e0 += 32 * kCopyUnroll) {
      // all loads first, so each lane has kCopyUnroll of them in flight
      V v[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int e = e0 + 32 * u;
        if (e < total) {
          const int k = e / row_vecs;
          v[u] = src[static_cast<long long>(out_i[k]) * row_vecs +
                     (e - k * row_vecs)];
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int e = e0 + 32 * u;
        if (e < total) dst[e] = v[u];
      }
    }
  }
}

// one call's arguments, as ball_query_launch received them
struct Query {
  const float* xyz;
  const float* new_xyz;
  float* boxes;
  int* idx;
  float* grouped;
  const void* features;
  void* out_feats;
  long long row_bytes;
  int B, N, nchunks, S, K;
  float r2, r2_box;
};

template <typename V, bool kFeats, Table kTable>
int launch_kernel(const Query& q, cudaStream_t stream) {
  auto kernel = ball_query_kernel<V, kFeats, kTable>;
  const int smem = kTable == Table::kShared
                       ? q.nchunks * 6 * static_cast<int>(sizeof(float))
                       : 0;
  if (kTable == Table::kShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      static_cast<long long>((q.S + kWarps - 1) / kWarps) * q.B;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;  // gridDim.x
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      q.xyz, q.boxes, q.new_xyz, q.idx, q.grouped,
      static_cast<const V*>(q.features), static_cast<V*>(q.out_feats),
      static_cast<int>(q.row_bytes / static_cast<long long>(sizeof(V))), q.N,
      q.nchunks, q.S, q.K, q.r2, q.r2_box);
  return cudaGetLastError();
}

template <typename V, bool kFeats = true>
int launch(const Query& q, cudaStream_t stream) {
  if (!bq_skips_chunks(q.N))
    return launch_kernel<V, kFeats, Table::kNone>(q, stream);
  if (q.boxes == nullptr) return cudaErrorInvalidValue;
  // the chunk boxes first; the query reads them from shared memory where
  // the row's table fits there
  const long long chunks = static_cast<long long>(q.B) * q.nchunks;
  chunk_box_kernel<<<static_cast<unsigned>((chunks + 7) / 8), 256, 0,
                     stream>>>(q.xyz, q.boxes, q.N, q.nchunks, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (q.nchunks * 6 * static_cast<long long>(sizeof(float)) <=
      kMaxSharedBytes)
    return launch_kernel<V, kFeats, Table::kShared>(q, stream);
  return launch_kernel<V, kFeats, Table::kGlobal>(q, stream);
}

}  // namespace

// boxes: (B, 6, ceil(N/32)) float32 scratch, written here, for rows above
// ball_query_scan_max_points() points; null for other rows. features /
// out_feats: null for the idx(+grouped) entry points; otherwise
// (B,N,row_bytes) and (B,S,K,row_bytes) byte arrays, row_bytes > 0.
extern "C" int ball_query_launch(const float* xyz, const float* new_xyz,
                                 float* boxes, int* idx, float* grouped,
                                 const void* features, void* out_feats,
                                 long long row_bytes, int B, int N, int S,
                                 int K, float r2, cudaStream_t stream) {
  if (static_cast<long long>(B) * S == 0) return cudaSuccess;
  const Query q = {xyz, new_xyz, boxes, idx, grouped, features, out_feats,
                   row_bytes, B, N, (N + kChunk - 1) / kChunk, S, K, r2,
                   bq_box_threshold(r2)};
  if (out_feats == nullptr) return launch<uint4, false>(q, stream);
  // the widest vector that divides the row and both base addresses
  const unsigned long long align =
      static_cast<unsigned long long>(row_bytes) |
      reinterpret_cast<uintptr_t>(features) |
      reinterpret_cast<uintptr_t>(out_feats);
  if (align % 16 == 0) return launch<uint4>(q, stream);
  if (align % 8 == 0) return launch<uint2>(q, stream);
  if (align % 4 == 0) return launch<unsigned>(q, stream);
  if (align % 2 == 0) return launch<unsigned short>(q, stream);
  return launch<unsigned char>(q, stream);
}

// rows of up to this many points are scanned whole, with no box table
extern "C" int ball_query_scan_max_points() { return kBqScanMaxPoints; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
