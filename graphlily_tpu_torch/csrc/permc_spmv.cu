// PERM-C phase C for Hopper (sm_90a): K11p, the frontier-predicated
// run-sum reduce of the split branch (SpMSpV). K11 itself, unpredicated,
// is K3's kernel (router_spmv.cu) over the position-keyed rows the planar
// engine derives at init. Built by graphlily_tpu_torch/ops/_build.py with
// nvcc into a shared library with a plain C interface; ops/planar.py binds
// it with ctypes and holds it against its plain PyTorch version.
//
// Replaces the predicated launch (`sm`/`na`, router_pallas.py:839-840,
// :875-876) of _permc_reduce_call with the body _make_permc_reduce_kernel
// and its helpers _permc_prefix and _permc_place (:851, :791, :153, :134).
//
// What it computes. A PERM-C layout (io/permc_format.py) keys phase C by
// DESTINATION lane: in flushed chunk q (c_code[q] >= 0), sublane s, the row
// at lane v = row & 127 owns the accumulator lanes (beg, end] of sublane s,
// beg = c_beg[q, s, v], end = c_end[q, s, v], and sits at hi = c_hi[q, s, v]
// within its region:
//
//   y[c_code[q]*region_rows + hi*128 + v] += sum(stream[q, s, beg+1 .. end])
//
// Unused lanes hold hi = end = beg = 0: an empty run. The TPU kernel gets
// the run sums as prefix differences P[end] - P[beg] of one triangular
// matrix-unit product, which amplifies rounding by up to about 128x; here
// each run is summed directly, in lane order.
//
// Bound on the H100: per live chunk it reads 4 KB of stream and 3 KB of
// int8 keys, plus y once; then the y atomics, about one per row run.
// Design: one block of 128 threads per flushed chunk. A dead chunk
// (c_code < 0, or no live deposit targets it: `live`, built on the device
// by the wrapper, as for K3p) exits after one word. The chunk's 8 x 128
// floats are staged in shared memory with coalesced loads; thread v reads
// its 8 sublanes' keys (coalesced) and sums their runs from shared
// memory. Runs of the same row in different sublanes (same v, same hi)
// are added together first, in sublane order, so a row costs one atomic
// per chunk. The atomics meet in any order: MULADD results vary in the
// last bits from run to run; ANDOR adds 0/1 counts and stays exact. A
// zero sum issues no atomic, which changes no value.
//
// K11 (unpredicated) was also tried as a thread per destination lane over
// the region-group table, the only writer of its rows v mod 128 of a
// shared tile of the region: it lost to K3's kernel over the
// position-keyed rows (PERF.md §6), and was removed.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kThreads = kLanes;   // one thread per destination lane

// K11p: a block per flushed chunk, live ones only.
__global__ void __launch_bounds__(kThreads) permc_reduce_pred_kernel(
    const int* __restrict__ c_code, const float* __restrict__ stream,
    const int8_t* __restrict__ c_hi, const int8_t* __restrict__ c_end,
    const int8_t* __restrict__ c_beg, float* __restrict__ y,
    const uint8_t* __restrict__ live, int region_rows) {
  const long long q = blockIdx.x;
  if (!live[q]) return;                          // whole block
  const int code = c_code[q];
  if (code < 0) return;                          // whole block
  __shared__ float g[kChunk];
  const long long base = q * kChunk;
  const int v = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSub; ++s)
    g[s * kLanes + v] = stream[base + s * kLanes + v];
  __syncthreads();
  int hi[kSub];
  float sum[kSub];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const long long k = base + s * kLanes + v;
    const int end = c_end[k];
    hi[s] = c_hi[k];
    float acc = 0.f;
    for (int p = max(static_cast<int>(c_beg[k]) + 1, 0); p <= end; ++p)
      acc += g[s * kLanes + p];
    sum[s] = acc;
  }
  float* yr = y + static_cast<long long>(code) * region_rows + v;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    float t = sum[s];
#pragma unroll
    for (int u = s + 1; u < kSub; ++u) {
      if (hi[u] == hi[s]) {
        t += sum[u];
        sum[u] = 0.f;
      }
    }
    if (t != 0.f) atomicAdd(yr + hi[s] * kLanes, t);
  }
}

int run_reduce_pred(const void* c_code, const void* stream_in,
                    const void* c_hi, const void* c_end, const void* c_beg,
                    void* y, const void* live, int nchunks, int region_rows,
                    void* cuda_stream) {
  if (nchunks > 0) {
    permc_reduce_pred_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                               static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(c_code), static_cast<const float*>(stream_in),
        static_cast<const int8_t*>(c_hi), static_cast<const int8_t*>(c_end),
        static_cast<const int8_t*>(c_beg), static_cast<float*>(y),
        static_cast<const uint8_t*>(live), region_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched). y
// must be zeroed by the caller. The keys are the layout's dest-lane-keyed
// c_hi, c_end, c_beg, (nchunks, 8, 128) int8; `live` is the (nchunks,)
// uint8 flush-chunk liveness.

extern "C" int glt_permc_reduce_pred(const void* c_code,
                                     const void* stream_in, const void* c_hi,
                                     const void* c_end, const void* c_beg,
                                     void* y, const void* live, int nchunks,
                                     int region_rows, void* cuda_stream) {
  return run_reduce_pred(c_code, stream_in, c_hi, c_end, c_beg, y, live,
                         nchunks, region_rows, cuda_stream);
}
