// Warp-level helpers shared by the SpMV kernels (router_spmv.cu,
// planar_spmv.cu, chunked_spmv.cu, tropical_spmv.cu): fold one value per
// lane into y[row] with one atomic per run of equal rows among the warp's
// lanes.
#pragma once

#include <cuda_runtime.h>

namespace glt {

struct FoldAdd {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

struct FoldMin {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fminf(a, b);
  }
};

struct FoldMax {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return max(a, b);
  }
};

// Runs are found from head flags, so rows need not be sorted; when they
// are (a deposit's or a chunk sublane's elements are row-sorted) the
// heavy rows of a degree-sorted graph cost one atomic per run instead of
// one per element on one address. Returns the lane's suffix fold within
// its run, so a run's head ends with the run's total; sets `head`. All 32
// lanes must call it together.
template <typename Fold, typename T>
__device__ __forceinline__ T warp_fold_runs(int row, T v, bool& head) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kAll, row, 1);
  head = lane == 0 || prev != row;
  const unsigned heads = __ballot_sync(kAll, head);
  const int seg = __popc(heads & (kAll >> (31 - lane)));   // run id
  for (int off = 1; off < 32; off <<= 1) {
    const T vo = __shfl_down_sync(kAll, v, off);
    const int so = __shfl_down_sync(kAll, seg, off);
    if (lane + off < 32 && so == seg) v = Fold()(v, vo);
  }
  return v;
}

// row < 0: the lane adds nothing. A zero sum issues no atomic, which
// changes no value.
__device__ __forceinline__ void warp_add_rows(float* __restrict__ yr, int row,
                                              float v) {
  bool head;
  v = warp_fold_runs<FoldAdd>(row, v, head);
  if (head && row >= 0 && v != 0.f) atomicAdd(yr + row, v);
}

// Float atomic min, exact for any sign and any order: non-negative floats
// order as signed ints, negative floats order in reverse as unsigned ints,
// and every negative float is above every non-negative one as unsigned.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)          // sign bit clear
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// The tropical twin of warp_add_rows: y[row] = min(y[row], run's min).
// A run whose min is not below `skip` (the initial value of y, the
// semiring zero) issues no atomic, which changes no value.
__device__ __forceinline__ void warp_min_rows(float* __restrict__ yr, int row,
                                              float v, float skip) {
  bool head;
  v = warp_fold_runs<FoldMin>(row, v, head);
  if (head && row >= 0 && v < skip) atomic_min_float(yr + row, v);
}

// The tropical window reduce's fold (tropical_spmv.cu, K10): int32
// encodings, out[row] = max(out[row], run's max), exact in any order. A
// run whose max is 0, the identity (the encoding of FLOAT_INF), issues no
// atomic, which changes no value.
__device__ __forceinline__ void warp_max_rows(int* __restrict__ out, int row,
                                              int v) {
  bool head;
  v = warp_fold_runs<FoldMax>(row, v, head);
  if (head && row >= 0 && v > 0) atomicMax(out + row, v);
}

}  // namespace glt
