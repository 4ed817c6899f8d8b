// BFS's level step on Hopper (sm_90a): everything a BFS iteration does
// after its walk, in one pass. Built by graphlily_tpu_torch/ops/_build.py
// with nvcc into a shared library with a plain C interface;
// graphlily_tpu_torch/ops/bfs_step.py binds it with ctypes and holds it
// against its plain PyTorch version (`step_plain`).
//
// Replaces no TPU kernel. The JAX app's iteration (graphlily_tpu/apps/
// bfs.py: the SpMV's ANDOR clamp and WRITE_TO_ZERO mask against the
// distances, then the dense assign WRITE_TO_ONE of it + 1 and, on push
// steps, the frontier's nnz) is elementwise code that XLA fuses into its
// loop. In the port it was about nine torch dispatches a step whose host
// cost dwarfed their device work. GraphLily's overlay runs the mask in
// its SpMV's write-back and the stamp as an assign module.
//
// What it computes. Step (y, distance of n float32, count one int32, the
// level a float): with y the walk's output before its clamp and mask,
//
//   new[i]      = y[i] != 0 && distance[i] == 0   (clamp; unvisited only)
//   y[i]        = new[i] ? 1 : 0                  (the next frontier)
//   distance[i] = new[i] ? level : distance[i]    (the level stamp)
//   *count     += sum(new)
//
// A y that was already clamped and masked gives the same answer, so the
// step takes any engine's output. BFS's values are 0/1 and small whole
// levels, exact in float32: the result is bit-equal to the plain version,
// and the count is an integer sum. The caller zeroes one count slot per
// iteration when it builds the query's state, so no step needs a zeroing
// launch.
//
// Bound on the H100: bytes. The step reads y and distance and writes
// both, 16 B an entry (8.4 MB on 524,288 rows, 2.5 us at 3.35 TB/s,
// mostly from the 50 MB L2, where the walk just wrote y).
// Design: sssp_relax.cu's. float4 loads and stores with a scalar tail, so
// any n works (the wrapper checks that both vectors are 16-byte aligned).
// A block walks the vectors in block-uniform steps, so every warp reaches
// each ballot whole; a warp counts with ballot/popc, lane 0 keeps the
// warp's sum, the block adds its warps' sums in shared memory and issues
// one atomic.

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

__device__ __forceinline__ int step_one(float& y, float& d, float level) {
  const bool fresh = y != 0.0f && d == 0.0f;
  y = fresh ? 1.0f : 0.0f;
  d = fresh ? level : d;
  return fresh;
}

__global__ void __launch_bounds__(kThreads) bfs_step_kernel(
    float* __restrict__ y, float* __restrict__ dist, int* __restrict__ count,
    int n, float level) {
  const int nvec = n >> 2;
  const int lane = threadIdx.x & 31;
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dist);
  int warp_sum = 0;   // the same in every lane: ballots are warp-wide
  for (int base = blockIdx.x * kThreads; base < nvec;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    int fresh[4] = {0, 0, 0, 0};
    if (i < nvec) {
      float4 yv = y4[i];
      float4 dv = d4[i];
      fresh[0] = step_one(yv.x, dv.x, level);
      fresh[1] = step_one(yv.y, dv.y, level);
      fresh[2] = step_one(yv.z, dv.z, level);
      fresh[3] = step_one(yv.w, dv.w, level);
      d4[i] = dv;
      y4[i] = yv;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      warp_sum += __popc(__ballot_sync(0xffffffffu, fresh[k]));
  }
  // the scalar tail (n % 4 entries): warp 0 of block 0, whole
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int j = (nvec << 2) + lane;
    int fresh = 0;
    if (j < n) {
      float yv = y[j];
      float dv = dist[j];
      fresh = step_one(yv, dv, level);
      dist[j] = dv;
      y[j] = yv;
    }
    warp_sum += __popc(__ballot_sync(0xffffffffu, fresh));
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

extern "C" int glt_bfs_step(void* y, void* dist, void* count, int n,
                            float level, void* cuda_stream) {
  if (n > 0) {
    bfs_step_kernel<<<blocks_for(n >> 2), kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<float*>(y), static_cast<float*>(dist),
        static_cast<int*>(count), n, level);
  }
  return static_cast<int>(cudaGetLastError());
}
