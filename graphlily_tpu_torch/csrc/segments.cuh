// Segment tables of the derived element forms (ops/router.router_entries),
// shared by the kernels that walk them: K1, K1p, K4 fused and K4p fused
// (router_spmv.cu) and K4 scatter and K4p scatter (planar_spmv.cu). The
// predicated walks load a block's records into three shared arrays
// (load_segments); the unpredicated walk copies them whole, a block ahead
// (stage_records). A form
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

// The same over whole records (first element in .x), given rec[0].x <= e.
__device__ __forceinline__ int find_record(const int4* rec, int n, int e) {
  int lo = 0;
  while (n > 1) {
    const int half = n >> 1;
    if (rec[lo + half].x <= e) lo += half;
    n -= half;
  }
  return lo;
}

// Block b's segment records copied whole into shared memory with 16-byte
// cp.async, `threads` threads striding, as one commit group: the copies
// run on while the caller works; cp_async_wait_all, then a barrier, makes
// them visible. Record i's first element stays unclamped: the block's
// first segment starts at or before b.x, so find_record holds for every
// element of the block.
__device__ __forceinline__ void stage_records(int4* table,
                                              const int4* __restrict__ deps,
                                              const int4 b, int threads) {
  for (int i = threadIdx.x; i < b.w - b.z; i += threads) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(table + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(deps + b.z + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace glt
