// Segment tables of the derived element forms (ops/router.router_entries),
// shared by the kernels that walk them: K1, K1p, K4 fused and K4p fused
// (router_spmv.cu) and K4 scatter and K4p scatter (planar_spmv.cu). A form
// is a run of elements cut into segments, each with one record
// (first element, x offset, y or stream offset, activity flag), and into
// blocks of consecutive elements, blocks[b] = (e0, e1, g0, g1): elements
// [e0, e1) of segments [g0, g1).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace glt {

// Loads block b's segment records into shared memory, `threads` threads
// striding: s_start (the first clamped to the block's first element),
// s_x (the x offset, or -1 for a segment whose flag is 0 in `act`: its
// elements are not read) and s_out (the y or stream offset). Returns
// whether this thread saw a live segment; the caller synchronises.
__device__ __forceinline__ bool load_segments(
    const int4 b, const int4* __restrict__ deps,
    const uint8_t* __restrict__ act, int threads, int* s_start, int* s_x,
    int* s_out) {
  bool live = false;
  for (int i = threadIdx.x; i < b.w - b.z; i += threads) {
    const int4 d = deps[b.z + i];
    const bool on = act == nullptr || act[d.w] != 0;
    live |= on;
    s_start[i] = i == 0 ? b.x : d.x;
    s_x[i] = on ? d.y : -1;
    s_out[i] = d.z;
  }
  return live;
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

}  // namespace glt
