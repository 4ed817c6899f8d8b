// Tropical (min-plus) SpMV kernels for Hopper (sm_90a): the window split in
// its two deposit formats, K8 (planes) and K9 (triples), and the window
// reduce K10. Built by graphlily_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface; ops/tropical.py binds it with
// ctypes and holds each kernel against its plain PyTorch version.
//
// The engine (graphlily_tpu/ops/tropical_pallas.py:513-564): K4 scatter in
// ADDMIN mode (planar_spmv.cu) writes the region-major flush stream g1 of
// int32 encodings E = INF_BITS - bits(min(val + x, FLOAT_INF)), where 0,
// the encoding of FLOAT_INF, is the identity of max; K8 or K9 redistribute
// g1 into 128-row window-pure chunks of the compact window stream g2; K10
// folds each window chunk into out[window, row] with max. The decode
// y = bits^-1(INF_BITS - out) and the SpMV mask stay torch ops.
//
// The TPU kernels run their grids in order and carry digit accumulators
// from step to step; a flush copies a slot into the window stream and
// zeroes it. CUDA blocks run in no order, so the host resolves the order
// once (io/router_format.deposit_targets with the block map qblk2): every
// split deposit knows the window chunk its slot is flushed into, target2,
// and becomes an independent copy. Deposits of one slot cycle fill
// disjoint lanes and unused lanes stay zero, so K8 and K9 need no slot
// order, no scratch and no atomics, and are bit-equal to their plain
// versions; K10's int32 atomicMax is exact in any order.

#include <cstdint>

#include <cuda_runtime.h>

#include "piece_runs.cuh"
#include "warp_rows.cuh"

namespace {

using glt::Elem;
using glt::locate;
using glt::load_runs;
using glt::Runs;
using glt::warp_max_rows;

constexpr int kChunk = 1024;
constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kWarps = 8;      // split slots (K8, K9) or sublanes (K10)
constexpr int kThreads = 32 * kWarps;

// ---------------------------------------------------------------------------
// K8, split over deposit planes. Replaces _split_call with the body
// _make_split_kernel (graphlily_tpu/ops/tropical_pallas.py:137, :45): for
// split slot (t, j) with w2 > 0, chunk k = w1 & 0xFF and plane p = w1 >> 8,
// every plane entry v < 0 at (s, l) moves g1[in_order[t*kb + k]][s, v & 127]
// to g2[target2[t, j]][s, l]. Read through in_order here, where JAX takes a
// g1-sized copy first (tropical_pallas.py:544-549).
// Bound on the H100: device memory. Every live piece reads its whole 1 KB
// plane (about 35 elements a piece on the pokec stand-in: 29 B of plane per
// element against 8 B of g1 read and g2 written); padding slots cost their
// 8-byte descriptor. The bound in chip_smoke.py counts those bytes.
// Design: one warp per split slot, 8 per block; each lane loads 2 x 16
// bytes of the plane (coalesced, 512 B per warp instruction) and copies its
// taking entries; the g1 reads gather within a 512-byte sublane row.
__global__ void __launch_bounds__(kThreads) split_planes_kernel(
    const int2* __restrict__ rg2, const int8_t* __restrict__ planes2,
    const int* __restrict__ in_order, const int* __restrict__ target2,
    const int* __restrict__ g1, int* __restrict__ g2, int kb, int rstep2,
    int dstep2, int dmax2, long long nslots) {
  const unsigned lane = threadIdx.x & 31;
  const long long gp = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (gp >= nslots) return;                       // whole warp
  const long long t = gp / dstep2;
  const int j = static_cast<int>(gp - t * dstep2);
  const int2 w = rg2[t * rstep2 + j];
  if (w.y <= 0) return;                           // whole warp: padding
  const int* src = g1 + static_cast<long long>(in_order[t * kb + (w.x & 0xFF)])
      * kChunk;
  int* out = g2 + static_cast<long long>(target2[gp]) * kChunk;
  const int8_t* plane = planes2 + (t * dmax2 + (w.x >> 8)) * kChunk;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e0 = half * (kChunk / 2) + static_cast<int>(lane) * 16;
    const int4 v = __ldg(reinterpret_cast<const int4*>(plane + e0));
    const int words[4] = {v.x, v.y, v.z, v.w};
    const int* row = src + (e0 & ~(kLanes - 1));  // 16 bytes in one sublane
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int b = static_cast<int8_t>(words[i >> 2] >> (8 * (i & 3)));
      if (b < 0) out[e0 + i] = __ldg(row + (b & (kLanes - 1)));
    }
  }
}

// ---------------------------------------------------------------------------
// K9, split over triple-run words. Replaces _split_call_triples with the
// body _make_split_kernel_triples (tropical_pallas.py:301, :174): the
// input chunk's sublanes are read through their digit-major sort plane
// xsort2 (int32, one per input chunk), after which each (piece, sublane) is
// one source run onto one destination run, word a0 | d0<<7 | n<<14:
// g2[target2[t, j]][s, d0 + i] = g1[chunk][s, xsort2[t, k][s, (a0 + i) & 127]]
// for i < n.
// Bound on the H100: device memory, 12 B an element (g1 read, g2 written,
// the sort plane's entry read) plus 32 B of words a piece.
// Design: K4's warp-per-piece run walk (piece_runs.cuh): the piece's
// elements, flattened across its 8 runs, 32 a pass.
__global__ void __launch_bounds__(kThreads) split_triples_kernel(
    const int2* __restrict__ rg2, const int* __restrict__ tri2,
    const int* __restrict__ xsort2, const int* __restrict__ in_order,
    const int* __restrict__ target2, const int* __restrict__ g1,
    int* __restrict__ g2, int kb, int rstep2, int dstep2, long long nslots) {
  const unsigned lane = threadIdx.x & 31;
  const long long gp = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (gp >= nslots) return;                       // whole warp
  const long long t = gp / dstep2;
  const int j = static_cast<int>(gp - t * dstep2);
  const int2 w = rg2[t * rstep2 + j];
  if (w.y <= 0) return;                           // whole warp: padding
  const long long pos = t * kb + (w.x & 0xFF);
  const int* src = g1 + static_cast<long long>(in_order[pos]) * kChunk;
  const int* xs = xsort2 + pos * kChunk;
  int* out = g2 + static_cast<long long>(target2[gp]) * kChunk;
  const Runs r = load_runs(tri2 + (t * dstep2 + (w.x >> 8)) * kSub, lane);
  const int n = r.end[kSub - 1];
  for (int base = 0; base < n; base += 32) {
    const int e = base + static_cast<int>(lane);
    const Elem el = locate(r, e);
    if (e < n) {
      const int s0 = el.s * kLanes;
      out[el.dst] = __ldg(src + s0 + (__ldg(xs + s0 + el.src)
                                      & (kLanes - 1)));
    }
  }
}

// ---------------------------------------------------------------------------
// K10, the window reduce. Replaces _window_reduce_call with the body
// _make_window_reduce_kernel (tropical_pallas.py:392, :337): for a window
// chunk c with c_win[c] >= 0, every sorted slot (s, l) holds
// v = g2[c, s, sort2[c, s, l]] of row rowids[c, s, l], and
// out[c_win[c], row] = max(out, v). The Pallas body's segmented max-scan
// and run-end gather (inv2) become a warp fold over the same runs: a
// sublane's sorted slots are row-sorted, so equal rows are adjacent and
// glt::warp_max_rows issues one atomicMax per run. Unoccupied slots hold 0
// with row 127, and 127 is also a real row: they fold into its run
// harmlessly (0 is the identity), and a run whose max is 0 issues nothing.
// Bound on the H100: device memory, 6 B an element (the g2 value, its sort
// and row bytes) plus c_win and out; out (4 B a row: 6.5 MB on the pokec
// stand-in) stays in L2 under the atomics.
// Design: one block per window chunk, warp s on sublane s, 4 passes of 32
// slots; a chunk with c_win < 0 costs one 4-byte read.
__global__ void __launch_bounds__(kThreads) window_reduce_kernel(
    const int* __restrict__ c_win, const int* __restrict__ g2,
    const int8_t* __restrict__ sort2, const int8_t* __restrict__ rowids,
    int* __restrict__ out) {
  const long long c = blockIdx.x;
  const int win = c_win[c];
  if (win < 0) return;                            // whole block
  const long long base = c * kChunk + (threadIdx.x >> 5) * kLanes;
  const int* g = g2 + base;
  int* o = out + static_cast<long long>(win) * kLanes;
#pragma unroll
  for (int q = 0; q < kLanes / 32; ++q) {
    const long long l = base + q * 32 + (threadIdx.x & 31);
    const int v = __ldg(g + (sort2[l] & (kLanes - 1)));
    warp_max_rows(o, static_cast<int>(rowids[l]), v);
  }
}

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched). The
// window stream g2 and out must be zeroed by the caller.

extern "C" int glt_tropical_split(
    const void* rg2, const void* planes2, const void* in_order,
    const void* target2, const void* g1, void* g2, int nsteps2, int kb,
    int rstep2, int dstep2, int dmax2, void* cuda_stream) {
  const long long nslots = static_cast<long long>(nsteps2) * dstep2;
  if (nslots > 0) {
    split_planes_kernel<<<blocks_for(nslots, kWarps), kThreads, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int2*>(rg2), static_cast<const int8_t*>(planes2),
        static_cast<const int*>(in_order), static_cast<const int*>(target2),
        static_cast<const int*>(g1), static_cast<int*>(g2), kb, rstep2,
        dstep2, dmax2, nslots);
  }
  return static_cast<int>(cudaGetLastError());
}

// tri2: (nsteps2, dstep2, 8) int32, piece p's 8 words at [t, p].
extern "C" int glt_tropical_split_triples(
    const void* rg2, const void* tri2, const void* xsort2,
    const void* in_order, const void* target2, const void* g1, void* g2,
    int nsteps2, int kb, int rstep2, int dstep2, void* cuda_stream) {
  const long long nslots = static_cast<long long>(nsteps2) * dstep2;
  if (nslots > 0) {
    split_triples_kernel<<<blocks_for(nslots, kWarps), kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int2*>(rg2), static_cast<const int*>(tri2),
        static_cast<const int*>(xsort2), static_cast<const int*>(in_order),
        static_cast<const int*>(target2), static_cast<const int*>(g1),
        static_cast<int*>(g2), kb, rstep2, dstep2, nslots);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_tropical_window_reduce(
    const void* c_win, const void* g2, const void* sort2, const void* rowids,
    void* out, int nchunks, void* cuda_stream) {
  if (nchunks > 0) {
    window_reduce_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(c_win), static_cast<const int*>(g2),
        static_cast<const int8_t*>(sort2),
        static_cast<const int8_t*>(rowids), static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
