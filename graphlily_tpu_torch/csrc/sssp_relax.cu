// SSSP's push-step relax on Hopper (sm_90a): the relax that follows each
// SpMSpV. Built by graphlily_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; graphlily_tpu_torch/ops/sssp_relax.py
// binds it with ctypes and holds it against its plain PyTorch version
// (`relax_plain`).
//
// Replaces no TPU kernel. The JAX app's relax (graphlily_tpu/apps/sssp.py,
// `_push` and the push step of its fused loop: `improved = y < dist`, two
// `jnp.where`, `jnp.sum(improved)`) is elementwise code that XLA fuses into
// its loop. In the port it was a chain of torch dispatches whose host cost
// dwarfed their 1-2 us of device work. GraphLily's overlay runs the relax
// as its mode 6, sparse assign with new-frontier generation.
//
// What it computes. Relax (y, distance of n float32, count one int32):
//
//   improved[i] = y[i] < distance[i]          (strict: ties and INF stay)
//   distance[i] = improved[i] ? y[i] : distance[i]
//   y[i]        = improved[i] ? y[i] : inf     (the next frontier, in place)
//   *count     += sum(improved)
//
// Compare and select are exact in float32, so the result is bit-equal to
// the plain version, and the count is an integer sum. The caller zeroes one
// count slot per push step when it builds the query's state, so no push
// step needs a zeroing launch.
//
// Bound on the H100: bytes. Relax reads y and distance and writes both,
// 16 B an entry (4 MB on 262,144 rows, 1.3 us at 3.35 TB/s, mostly from the
// 50 MB L2, where the SpMSpV just wrote y).
// Design: float4 loads and stores with a scalar tail, so any n works (the
// wrapper checks that both vectors are 16-byte aligned). A block walks the
// vectors in block-uniform steps, so every warp reaches each ballot whole;
// a warp counts with ballot/popc, lane 0 keeps the warp's sum, the block
// adds its warps' sums in shared memory and issues one atomic.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 8;   // 8 blocks an SM; larger n loops

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

__device__ __forceinline__ int relax_one(float& y, float& d, float inf) {
  const bool imp = y < d;
  d = imp ? y : d;
  y = imp ? y : inf;
  return imp;
}

__global__ void __launch_bounds__(kThreads) sssp_relax_kernel(
    float* __restrict__ y, float* __restrict__ dist, int* __restrict__ count,
    int n, float inf) {
  const int nvec = n >> 2;
  const int lane = threadIdx.x & 31;
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dist);
  int warp_sum = 0;   // the same in every lane: ballots are warp-wide
  for (int base = blockIdx.x * kThreads; base < nvec;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    int imp[4] = {0, 0, 0, 0};
    if (i < nvec) {
      float4 yv = y4[i];
      float4 dv = d4[i];
      imp[0] = relax_one(yv.x, dv.x, inf);
      imp[1] = relax_one(yv.y, dv.y, inf);
      imp[2] = relax_one(yv.z, dv.z, inf);
      imp[3] = relax_one(yv.w, dv.w, inf);
      d4[i] = dv;
      y4[i] = yv;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      warp_sum += __popc(__ballot_sync(0xffffffffu, imp[k]));
  }
  // the scalar tail (n % 4 entries): warp 0 of block 0, whole
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int j = (nvec << 2) + lane;
    int imp = 0;
    if (j < n) {
      float yv = y[j];
      float dv = dist[j];
      imp = relax_one(yv, dv, inf);
      dist[j] = dv;
      y[j] = yv;
    }
    warp_sum += __popc(__ballot_sync(0xffffffffu, imp));
  }
  __shared__ int sums[kWarps];
  if (lane == 0) sums[threadIdx.x >> 5] = warp_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w];
    if (total) atomicAdd(count, total);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point. It launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched). y
// and distance are n contiguous float32, 16-byte aligned; count one int32.
// `inf` is the tropical zero (semiring.FLOAT_INF).

extern "C" int glt_sssp_relax(void* y, void* dist, void* count, int n,
                              float inf, void* cuda_stream) {
  if (n > 0) {
    sssp_relax_kernel<<<blocks_for(n >> 2), kThreads, 0,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<float*>(y), static_cast<float*>(dist),
        static_cast<int*>(count), n, inf);
  }
  return static_cast<int>(cudaGetLastError());
}
