// Chunked SpMV kernel for Hopper (sm_90a): K6 and K7 in one kernel, and
// its frontier-predicated form K7p (SpMSpV). Built by
// graphlily_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface; ops/chunked.py binds it with ctypes and holds it
// against its plain PyTorch version.
//
// Replaces the chunked Pallas kernels of graphlily_tpu/ops/spmv_pallas.py:
// K6, the streamed kernel (_spmv_pallas_call:160 -> pallas_call :183), and
// K7, the resident kernel (_spmv_resident_call:294 -> pallas_call :320),
// and K7p, the predicated resident kernel
// (_spmv_resident_predicated_call:335 -> pallas_call :373), by
// chunked_spmv_kernel (K7p through its activity argument). The two TPU
// kernels compute the same y = A (x) x over a ChunkedSpMVLayout
// (io/formatter.py) and differ only in where the TPU keeps x and y; on
// Hopper x and y live in the 50 MB L2 whatever the kernel does.
//
// What it reads. Not the layout's padded (8, 128) chunks: on the
// googleplus SSSP matrix 81% of their slots are padding (fill 0.189). The
// engine derives at init the padding-free form (ops/chunked.chunk_entries):
// each real entry's int8 lane r, int8 row and fp32 value, in chunk-code
// order, grouped into the (chunk, sublane) segments of the layout; a
// segment carries xo = col_tile*1024 + sublane*128 and yo = window*128.
// Entry e of segment g is the product
//   g = val[e] (x) x[xo[g] + r[e]],  folded into y[yo[g] + rows[e]]:
//   MULADD  g = val * x,              y[row] += g
//   ANDOR   g = (val != 0 && x != 0),  y[row] += g  (0/1 counts, clamped
//                                                    to 0/1 by the caller)
//   ADDMIN  g = min(x + val, INF),    y[row] = min(y[row], g)
// y starts at the semiring zero over all nwgrp*1024 rows (the caller fills
// it): that is K7's step-0 fill and what K6's first-visit reset produces.
//
// Bound on the H100: device memory. Per call it reads 6 B per real entry
// and 12 B per segment: 86.8 MB on the googleplus SSSP matrix (13,780,368
// entries, 312,466 segments), against the 439 MB of slots the padded walk
// read; the real-entry bound is 0.0250 ms at 3.35 TB/s. It issues at most
// 345,639 global atomics there (one per block and touched row; 3.5M
// before) and 4,758,428 shared ones. Measured (ab_kernels.py, PERF.md,
// PR 7): ADDMIN 0.0611 ms and MULADD 0.0725 ms, from 0.2628 and 0.2720,
// against cuSPARSE torch.mv's 0.0691 ms for the same MULADD SpMV.
//
// Design. The grid is a table of blocks, each a range of at most
// ENTRIES_PER_BLOCK entries inside one 1024-row window group, so a hub
// group is spread over many blocks and every block's rows fit a 4 KB
// shared tile. A block (1) loads its segments' starts and offsets into
// shared memory, one thread each; (2) gives each thread 8 consecutive
// entries, read with 8-byte and 16-byte vector loads: the thread finds
// their segments with one binary search and a forward walk, gathers x (a
// segment's x is one 512 B sublane of a tile, in L1/L2), sums runs of
// equal rows in registers (a segment's lanes are row-sorted) and folds
// each run into the tile with one shared atomic (add, or the exact float
// min below); (3) adds each touched tile row into y with one global
// atomic. The global atomics drop from one per warp row-run (3.5M on
// googleplus) to one per (block, row). Hopper adds floats into shared
// memory by a compare-and-swap loop, so the register runs matter most to
// MULADD; ANDOR counts in an int tile with native integer atomics. ANDOR
// and ADDMIN are exact in any order, so they are bit-equal to the plain
// version; MULADD's float sums round in the order the atomics land.
//
// Predication (K7p). act[col_tile] flags the column tiles holding an
// entry other than the semiring zero; an inactive tile's products add the
// identity, so its entries are skipped unread (their segments carry
// xo = -1). A block none of whose segments is live exits after reading its
// table entry, its segments' offsets and their activity bytes. Every block
// of the grid is launched, so nothing is read on the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace {

using glt::atomic_min_float;

constexpr int kThreads = 256;
constexpr int kGroupRows = 1024;   // rows of a window group: the y tile
constexpr int kVec = 8;            // consecutive entries per thread

enum Op { kMulAdd = 0, kAndOr = 1, kAddMin = 2 };

template <int kOp>
__device__ __forceinline__ float product(float v, float xv, float zero) {
  if (kOp == kMulAdd) return __fmul_rn(v, xv);       // never fused
  if (kOp == kAndOr) return (v != 0.f && xv != 0.f) ? 1.f : 0.f;
  return fminf(__fadd_rn(v, xv), zero);              // one rounding
}

// The tile: float sums (MULADD), int counts (ANDOR) or float minima
// (ADDMIN, as the int bits atomic_min_float orders), all starting at the
// semiring zero's bits.
template <int kOp>
__device__ __forceinline__ void tile_fold(float* tile, int row, float g,
                                          float zero) {
  if (kOp == kAddMin) {
    if (g < zero) atomic_min_float(tile + row, g);
  } else if (g != 0.f) {
    if (kOp == kAndOr)
      atomicAdd(reinterpret_cast<int*>(tile) + row, static_cast<int>(g));
    else
      atomicAdd(tile + row, g);
  }
}

// One tile row into y. Sums of zero and minima not below the semiring
// zero change nothing and issue no atomic.
template <int kOp>
__device__ __forceinline__ void flush_row(float* y, const float* tile, int i,
                                          float zero) {
  if (kOp == kAddMin) {
    if (tile[i] < zero) atomic_min_float(y + i, tile[i]);
  } else if (kOp == kAndOr) {
    const int c = reinterpret_cast<const int*>(tile)[i];
    if (c != 0) atomicAdd(y + i, static_cast<float>(c));
  } else if (tile[i] != 0.f) {
    atomicAdd(y + i, tile[i]);
  }
}

// Largest j < n with start[j] <= e, given start[0] <= e.
__device__ __forceinline__ int find_segment(const int* start, int n, int e) {
  int lo = 0;
  while (n > 1) {
    const int half = n >> 1;
    if (start[lo + half] <= e) lo += half;
    n -= half;
  }
  return lo;
}

// blocks[b] = (e0, e1, g0, g1): entries [e0, e1) of segments [g0, g1).
template <int kOp>
__global__ void __launch_bounds__(kThreads) chunked_spmv_kernel(
    const int4* __restrict__ blocks, const int* __restrict__ seg_start,
    const int* __restrict__ seg_x, const int* __restrict__ seg_y,
    const int8_t* __restrict__ r, const int8_t* __restrict__ rows,
    const float* __restrict__ vals, const float* __restrict__ x,
    float* __restrict__ y, const uint8_t* __restrict__ act,
    int max_segments, float zero) {
  __shared__ float tile[kGroupRows];
  extern __shared__ int seg[];     // start, x offset, tile row of each
  int* s_start = seg;
  int* s_x = seg + max_segments;
  int* s_y = seg + 2 * max_segments;
  const int4 b = blocks[blockIdx.x];
  const int ns = b.w - b.z;
  const int base = (__ldg(seg_y + b.z) / kGroupRows) * kGroupRows;
  bool live = false;
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    const int xo = seg_x[b.z + i];
    const bool on = act == nullptr || act[xo >> 10] != 0;
    live |= on;
    s_start[i] = i == 0 ? b.x : seg_start[b.z + i];
    s_x[i] = on ? xo : -1;         // an inactive tile's entries: unread
    s_y[i] = seg_y[b.z + i] - base;
  }
  if (act != nullptr && !__syncthreads_or(live)) return;
  for (int i = threadIdx.x; i < kGroupRows; i += kThreads)
    tile[i] = zero;                // 0.f is also the int count 0
  __syncthreads();

  for (int q = (b.x & ~(kVec - 1)) + kVec * threadIdx.x; q < b.y;
       q += kVec * kThreads) {
    int col[kVec], row[kVec];
    bool any = false;
    int j = find_segment(s_start, ns, max(q, b.x));
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int e = q + k;
      col[k] = -1;
      if (e < b.x || e >= b.y) continue;
      while (j + 1 < ns && s_start[j + 1] <= e) ++j;
      col[k] = s_x[j];
      row[k] = s_y[j];
      any |= col[k] >= 0;
    }
    if (!any) continue;            // no live entry: nothing read
    const uint2 rv = *reinterpret_cast<const uint2*>(r + q);
    const uint2 wv = *reinterpret_cast<const uint2*>(rows + q);
    const float4 v0 = *reinterpret_cast<const float4*>(vals + q);
    const float4 v1 = *reinterpret_cast<const float4*>(vals + q + 4);
    const float v[kVec] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (col[k] < 0) continue;
      const int shift = 8 * (k & 3);
      col[k] += static_cast<int>(((k < 4 ? rv.x : rv.y) >> shift) & 127);
      row[k] += static_cast<int>(((k < 4 ? wv.x : wv.y) >> shift) & 127);
    }
    float xv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (col[k] >= 0) xv[k] = __ldg(x + col[k]);
    int cur = -1;
    float acc = zero;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (col[k] < 0) continue;
      const float g = product<kOp>(v[k], xv[k], zero);
      if (row[k] == cur) {
        acc = kOp == kAddMin ? fminf(acc, g) : acc + g;
      } else {
        if (cur >= 0) tile_fold<kOp>(tile, cur, acc, zero);
        cur = row[k];
        acc = g;
      }
    }
    if (cur >= 0) tile_fold<kOp>(tile, cur, acc, zero);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kGroupRows; i += kThreads)
    flush_row<kOp>(y + base, tile, i, zero);
}

template <int kOp>
int launch(const void* blocks, const void* seg_start, const void* seg_x,
           const void* seg_y, const void* r, const void* rows,
           const void* vals, const void* x, void* y, const void* act,
           int nblocks, int max_segments, float zero, cudaStream_t st) {
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(max_segments);
  auto kernel = chunked_spmv_kernel<kOp>;
  if (smem + sizeof(float) * kGroupRows > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nblocks, kThreads, smem, st>>>(
      static_cast<const int4*>(blocks), static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_x), static_cast<const int*>(seg_y),
      static_cast<const int8_t*>(r), static_cast<const int8_t*>(rows),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const uint8_t*>(act), max_segments,
      zero);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* blocks, const void* seg_start, const void* seg_x,
        const void* seg_y, const void* r, const void* rows, const void* vals,
        const void* x, void* y, const void* act, int nblocks,
        int max_segments, int op, float zero, void* cuda_stream) {
  if (op < kMulAdd || op > kAddMin || nblocks < 0 || max_segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0) return static_cast<int>(cudaGetLastError());
  auto fn = op == kMulAdd ? launch<kMulAdd>
      : op == kAndOr ? launch<kAndOr> : launch<kAddMin>;
  return fn(blocks, seg_start, seg_x, seg_y, r, rows, vals, x, y, act,
            nblocks, max_segments, zero,
            static_cast<cudaStream_t>(cuda_stream));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns a CUDA error code (0 = launched). y
// must hold the semiring zero (`zero`) on entry. op: 0 MULADD, 1 ANDOR,
// 2 ADDMIN; any other value returns cudaErrorInvalidValue. max_segments
// is the largest g1 - g0 of the block table (the shared segment table's
// size); r, rows and vals are readable up to a multiple of 8 entries.

extern "C" int glt_chunked_spmv(
    const void* blocks, const void* seg_start, const void* seg_x,
    const void* seg_y, const void* r, const void* rows, const void* vals,
    const void* x, void* y, int nblocks, int max_segments, int op,
    float zero, void* cuda_stream) {
  return run(blocks, seg_start, seg_x, seg_y, r, rows, vals, x, y, nullptr,
             nblocks, max_segments, op, zero, cuda_stream);
}

// K7p: act is the (num_col_tiles,) uint8 column-tile activity.
extern "C" int glt_chunked_spmv_predicated(
    const void* blocks, const void* seg_start, const void* seg_x,
    const void* seg_y, const void* r, const void* rows, const void* vals,
    const void* x, void* y, const void* act, int nblocks, int max_segments,
    int op, float zero, void* cuda_stream) {
  return run(blocks, seg_start, seg_x, seg_y, r, rows, vals, x, y, act,
             nblocks, max_segments, op, zero, cuda_stream);
}
