// Chunked SpMV kernels for Hopper (sm_90a): K6 and K7 in one kernel, and
// its frontier-predicated form K7p (SpMSpV). Built by
// graphlily_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface; ops/chunked.py binds it with ctypes and holds each
// kernel against its plain PyTorch version.
//
// Replaces the chunked Pallas kernels of graphlily_tpu/ops/spmv_pallas.py:
// K6, the streamed kernel (_spmv_pallas_call:160 -> pallas_call :183), and
// K7, the resident kernel (_spmv_resident_call:294 -> pallas_call :320),
// and K7p, the predicated resident kernel
// (_spmv_resident_predicated_call:335 -> pallas_call :373), by
// chunked_spmv_kernel (K7p through its activity argument).
// The two compute the same y = A (x) x over the same ChunkedSpMVLayout
// (io/formatter.py) and differ only in where the TPU keeps x and y (VMEM
// blocks streamed per chunk, or both resident with 32 chunks a step). On
// Hopper that distinction does not exist: x (0.43 MB on the googleplus
// stand-in) and y live in the 50 MB L2 whatever the kernel does.
//
// What it computes. Chunk c, with code = (wgrp*8 + wsub)*nct + cid, holds
// (8, 128) slots; slot (s, l) is the product
//   g = val[c,s,l] (x) x[cid*1024 + s*128 + r[c,s,l]]
// folded into y[(code / nct)*128 + rows[c,s,l]] (the window wgrp*8+wsub).
//   MULADD  g = val * x,              y[row] += g
//   ANDOR   g = (val != 0 && x != 0),  y[row] += g  (0/1 counts, clamped
//                                                    to 0/1 by the caller)
//   ADDMIN  g = min(x + val, INF),    y[row] = min(y[row], g)
// y starts at the semiring zero over all nwgrp*1024 rows (the caller fills
// it): that is K7's step-0 fill and what K6's first-visit reset produces.
//
// Padding slots (and the filler chunks that repeat the last code) hold
// val = pad_val, r = 0, rows = 0 and must add the identity: 0 * x = 0 for
// finite x, and min(x + INF, INF) = INF for x >= 0. So the tropical kernel
// needs x >= 0, the contract of the JAX engine's tests and of the
// tropical engine.
//
// The ordering hazard. K6 resets an output block when the window group
// changes, which needs chunks grouped by code, and K7 carries y through a
// grid that runs in order. CUDA blocks run in no order, so y is updated
// with atomics, and the kernel gives the same y for any chunk order ("row"
// or "col"): ANDOR adds 0/1 counts and ADDMIN takes minima, both exact in
// any order; MULADD's float sums round in the order the atomics land.
//
// Bound on the H100: device memory, then the instruction issue of the
// warp folds. Per slot it reads 6 B of streams (int8 lane, int8 row, fp32
// value), padding included: 439 MB on the SSSP googleplus layout, whose
// fill is 0.189. The product itself needs only the real entries' 83 MB
// (0.025 ms at 3.35 TB/s): the rest of the gap is the layout's padding.
// The x gather hits a 4 KB tile per chunk in L1/L2, and y's atomics stay
// in L2.
// Design: one block of 8 warps takes kChunksPerBlock consecutive chunks
// (not a window: window 0 of the degree-sorted googleplus graph holds 5.9%
// of all chunks and would serialize behind one SM); warp s walks sublane s
// of each chunk, 32 lanes at a time, with coalesced stream loads. A
// sublane's lanes are row-sorted, so warp_add_rows / warp_min_rows fold
// each row's run into one atomic per warp; sums of zero and minima not
// below INF (padding, unreached vertices) issue none.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace {

using glt::warp_add_rows;
using glt::warp_min_rows;

constexpr int kSub = 8;
constexpr int kLanes = 128;
constexpr int kChunkSlots = kSub * kLanes;
constexpr int kColTile = 1024;
constexpr int kWindow = 128;
constexpr int kThreads = kSub * 32;     // one warp per sublane
constexpr int kChunksPerBlock = 4;

enum Op { kMulAdd = 0, kAndOr = 1, kAddMin = 2 };

// Chunk c's 1024 slots folded into y; warp `sub` walks sublane sub.
template <int kOp>
__device__ __forceinline__ void fold_chunk(
    const int8_t* __restrict__ r, const int8_t* __restrict__ rows,
    const float* __restrict__ vals, const float* __restrict__ x,
    float* __restrict__ y, long long c, int window, int cid, int sub,
    int lane, float zero) {
  const float* xs = x + static_cast<long long>(cid) * kColTile + sub * kLanes;
  float* yr = y + static_cast<long long>(window) * kWindow;
  const long long base = c * kChunkSlots + sub * kLanes + lane;
#pragma unroll
  for (int j = 0; j < kLanes / 32; ++j) {
    const long long e = base + j * 32;
    const float v = vals[e];
    const float xv = __ldg(xs + static_cast<int>(r[e]));
    const int row = static_cast<int>(rows[e]);
    if (kOp == kMulAdd) {
      warp_add_rows(yr, row, __fmul_rn(v, xv));   // never fused
    } else if (kOp == kAndOr) {
      warp_add_rows(yr, row, (v != 0.f && xv != 0.f) ? 1.f : 0.f);
    } else {
      warp_min_rows(yr, row, fminf(__fadd_rn(v, xv), zero), zero);
    }
  }
}

// K6/K7 (act == nullptr) and K7p. The Pallas K7p runs grid step i on chunk
// batch sm[i] (32 chunks of a chunk_order="col" layout, whose step_touch
// row meets an active column tile) and skips steps i >= na. Here the grid
// is the full one, nchunk / 4 blocks, as for K6/K7, so nothing read on the
// host sizes the launch: block b takes chunks 4b..4b+3 and, given `act`,
// skips each chunk whose column tile is inactive (act[code % nct] == 0).
// Those are the chunks of the kept batches' inactive tiles and of the
// dropped batches: an inactive tile's x holds only the semiring zero,
// whose products add the identity, so y is the same as the unpredicated
// kernel's (bit for bit for ANDOR and ADDMIN). Lanes 0-3 of every warp
// read the four codes and activity bytes at once and a ballot names the
// live chunks, so a block of an empty frontier exits after two dependent
// loads.
template <int kOp>
__global__ void __launch_bounds__(kThreads) chunked_spmv_kernel(
    const int* __restrict__ code, const int8_t* __restrict__ r,
    const int8_t* __restrict__ rows, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ y,
    const uint8_t* __restrict__ act, int nchunk, int nct, float zero) {
  const int sub = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunksPerBlock;
  int cd = 0;
  bool on = false;
  if (lane < kChunksPerBlock && c0 + lane < nchunk) {
    cd = code[c0 + lane];
    on = act == nullptr || act[cd % nct] != 0;
  }
  unsigned live = __ballot_sync(0xffffffffu, on);   // same in every warp
  while (live != 0) {
    const int k = __ffs(live) - 1;
    live &= live - 1;
    const int cdk = __shfl_sync(0xffffffffu, cd, k);
    const int window = cdk / nct;
    fold_chunk<kOp>(r, rows, vals, x, y, c0 + k, window, cdk - window * nct,
                    sub, lane, zero);
  }
}

template <int kOp>
void launch(const void* code, const void* r, const void* rows,
            const void* vals, const void* x, void* y, const void* act,
            unsigned nblocks, int nchunk, int nct, float zero,
            cudaStream_t st) {
  chunked_spmv_kernel<kOp><<<nblocks, kThreads, 0, st>>>(
      static_cast<const int*>(code), static_cast<const int8_t*>(r),
      static_cast<const int8_t*>(rows), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const uint8_t*>(act), nchunk, nct, zero);
}

int run(const void* code, const void* r, const void* rows, const void* vals,
        const void* x, void* y, const void* act, int nchunk, int nct, int op,
        float zero, void* cuda_stream) {
  if (op < kMulAdd || op > kAddMin) return static_cast<int>(
      cudaErrorInvalidValue);
  const long long nblocks = (static_cast<long long>(nchunk)
                             + kChunksPerBlock - 1) / kChunksPerBlock;
  if (nblocks > 0) {
    auto st = static_cast<cudaStream_t>(cuda_stream);
    auto fn = op == kMulAdd ? launch<kMulAdd>
        : op == kAndOr ? launch<kAndOr> : launch<kAddMin>;
    fn(code, r, rows, vals, x, y, act, static_cast<unsigned>(nblocks),
       nchunk, nct, zero, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched). y
// must hold the semiring zero (`zero`) on entry. op: 0 MULADD, 1 ANDOR,
// 2 ADDMIN; any other value returns cudaErrorInvalidValue.

extern "C" int glt_chunked_spmv(
    const void* code, const void* r, const void* rows, const void* vals,
    const void* x, void* y, int nchunk, int nct, int op, float zero,
    void* cuda_stream) {
  return run(code, r, rows, vals, x, y, nullptr, nchunk, nct, op, zero,
             cuda_stream);
}

// K7p: act is (nct,) uint8 column-tile activity.
extern "C" int glt_chunked_spmv_predicated(
    const void* code, const void* r, const void* rows, const void* vals,
    const void* x, void* y, const void* act, int nchunk, int nct, int op,
    float zero, void* cuda_stream) {
  return run(code, r, rows, vals, x, y, act, nchunk, nct, op, zero,
             cuda_stream);
}
