// Warp-level helper shared by the router kernels (router_spmv.cu,
// planar_spmv.cu): add one value per lane into y[row] with one float
// atomic per run of equal rows among the warp's lanes.
#pragma once

#include <cuda_runtime.h>

namespace glt {

// row < 0: the lane adds nothing. Runs are found from head flags, so rows
// need not be sorted; when they are (a deposit's elements are row-sorted)
// the heavy rows of a degree-sorted graph cost one atomic per run instead
// of one per element on one address. A zero sum issues no atomic, which
// changes no value. All 32 lanes must call it together.
__device__ __forceinline__ void warp_add_rows(float* __restrict__ yr, int row,
                                              float v) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kAll, row, 1);
  const bool head = lane == 0 || prev != row;
  const unsigned heads = __ballot_sync(kAll, head);
  const int seg = __popc(heads & (kAll >> (31 - lane)));   // run id
  // suffix sums within each run; a run's head ends with the run's total
  for (int off = 1; off < 32; off <<= 1) {
    const float vo = __shfl_down_sync(kAll, v, off);
    const int so = __shfl_down_sync(kAll, seg, off);
    if (lane + off < 32 && so == seg) v += vo;
  }
  if (head && row >= 0 && v != 0.f) atomicAdd(yr + row, v);
}

}  // namespace glt
