// The run walk of a deposit piece in the triple-run word format, shared by
// planar_spmv.cu (K4, whose words come from io/planar_format.
// planes_to_triples) and tropical_spmv.cu (K9, whose words come from
// io/tropical_format.derive_split_triples). A piece has one word per
// sublane s, a0 | d0<<7 | n<<14: it moves source lanes (a0 + i) & 127 of
// sublane s to destination lanes d0 + i, for i < n.
#pragma once

#include <cuda_runtime.h>

namespace glt {

constexpr int kRunSub = 8;

// The 8 runs of one piece, spread over a warp: lane s < 8 decodes sublane
// s's word; every lane keeps the inclusive prefix sums of the run lengths,
// so element e of the piece (0 <= e < end[7], sublane-major) finds its
// sublane with 7 compares.
struct Runs {
  int a0, d0, excl;      // own sublane's run (lanes 0..7)
  int end[kRunSub];      // inclusive prefix of run lengths (all lanes)
};

__device__ __forceinline__ Runs load_runs(const int* __restrict__ words,
                                          unsigned lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const int w = lane < kRunSub ? __ldg(words + lane) : 0;
  Runs r;
  r.a0 = w & 127;
  r.d0 = (w >> 7) & 127;
  const int n = (w >> 14) & 255;
  int incl = n;
#pragma unroll
  for (int off = 1; off < kRunSub; off <<= 1) {
    const int o = __shfl_up_sync(kAll, incl, off);
    if (lane >= static_cast<unsigned>(off)) incl += o;
  }
  r.excl = incl - n;
#pragma unroll
  for (int s = 0; s < kRunSub; ++s) r.end[s] = __shfl_sync(kAll, incl, s);
  return r;
}

struct Elem {
  int s;       // sublane
  int src;     // source lane
  int dst;     // destination element within its 1024-element chunk
};

// Element e of the piece. All 32 lanes must call it together (shuffles);
// the result means nothing for e >= end[7].
__device__ __forceinline__ Elem locate(const Runs& r, int e) {
  constexpr unsigned kAll = 0xffffffffu;
  int s = 0;
#pragma unroll
  for (int q = 0; q < kRunSub - 1; ++q) s += e >= r.end[q];
  const int a0 = __shfl_sync(kAll, r.a0, s);
  const int d0 = __shfl_sync(kAll, r.d0, s);
  const int off = e - __shfl_sync(kAll, r.excl, s);
  return Elem{s, (a0 + off) & 127, s * 128 + d0 + off};
}

}  // namespace glt
