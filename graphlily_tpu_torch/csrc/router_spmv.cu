// Roll-router SpMV kernels for Hopper (sm_90a): K1 fused, K2 scatter,
// K3 reduce. Built by graphlily_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface; ops/router.py binds it with
// ctypes and holds each kernel against its plain PyTorch version.
//
// All three read the same RouterSpMVLayout arrays as their Pallas twins in
// graphlily_tpu/ops/router_pallas.py (io/router_format.py documents the
// words). What the TPU kernels do with rolls, one-hot matrix products,
// two accumulator banks and a grid that runs in order, these kernels do
// with plain indexed loads, stores and atomics:
//
//   gathered product  g[c, p] = val[c, p] (x) x[col(c, p)], with
//                     col = a_page[c]*1024 + a_sub[c, p]*128 + a_r[c, p];
//                     for ANDOR g = (val != 0 && x != 0) as 0/1.
//   deposit (t, j)    g[t*cb + k, src + i] -> flush-stream chunk
//                     target[t, j], element dst + i, for i < len.
//   flushed element   (s, p) -> y[c_code[s]*region_rows + c_hi[s, p]*128
//                     + c_lo[s, p]].
//
// The ordering hazard. Pallas runs the grid in order on one core, and the
// TPU kernels lean on it: accumulator slots carry from step to step, a
// flush drains what earlier steps deposited, and the output update has no
// guard. CUDA blocks run at the same time in no order. The host resolves
// the order once, at engine init: target[t, j] is the flush-stream chunk
// of the first flush of the deposit's slot after it in stream order
// (io/router_format.deposit_targets). Every deposit is then an
// independent copy, deposits never overlap (a slot cycle's runs are
// disjoint), so K2 needs no atomics and no state across blocks; K1 and K3
// add into y with float atomics, whose order changes from run to run
// (ANDOR adds 0/1 counts, so it stays exact). Before its atomics each warp
// sums its lanes' runs of equal rows (warp_add_rows).

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_rows.cuh"

namespace {

using glt::warp_add_rows;

constexpr int kChunk = 1024;
constexpr int kThreads = 128;

struct Deposit {
  int dst;   // first element in the flushed chunk
  int src;   // first element in the source A-chunk
  int k;     // A-chunk within the step
  int len;   // elements
};

// Decode one deposit word pair (w2 > 0): w1 = dst | dl<<10 | ds<<17 | k<<20,
// w2 = slot | len<<16; the source offset is (dst - (dl + 128*ds)) mod 1024.
__device__ __forceinline__ Deposit decode_deposit(int w1, int w2) {
  Deposit d;
  d.dst = w1 & 0x3FF;
  const int delta = ((w1 >> 10) & 0x7F) + 128 * ((w1 >> 17) & 0x7);
  d.src = (d.dst - delta) & (kChunk - 1);
  d.k = w1 >> 20;
  d.len = w2 >> 16;
  return d;
}

// Gathered product of stream element e of A-chunk `chunk`.
template <bool kAndOr>
__device__ __forceinline__ float gathered(
    const float* __restrict__ x, const int* __restrict__ a_page,
    const int8_t* __restrict__ a_r, const int8_t* __restrict__ a_sub,
    const float* __restrict__ a_vals, long long chunk, long long e) {
  const float v = a_vals[e];
  const long long col = static_cast<long long>(a_page[chunk]) * kChunk
      + static_cast<int>(a_sub[e]) * 128 + static_cast<int>(a_r[e]);
  const float xv = __ldg(x + col);
  if (kAndOr) return (v != 0.f && xv != 0.f) ? 1.f : 0.f;
  return __fmul_rn(v, xv);   // one rounding, never fused with an add
}

// ---------------------------------------------------------------------------
// K2 scatter. Replaces _router_scatter_call / _make_scatter_kernel(fuse=False)
// (graphlily_tpu/ops/router_pallas.py:368, :166): phases A (gather) and B
// (deposits, flushes) into the (nsteps, f, 8, 128) flush stream.
// Bound on the H100: device memory. Per nnz it reads 6 B of streams (f32
// value, int8 lane, int8 sublane) and writes 4 B of stream, plus the
// zeroing of the stream by the wrapper (4 B per stream slot); x is at most
// 12 MB on every ICCAD graph and is served from the 50 MB L2.
// Design: one block per (step, deposit slot); the block's threads walk the
// deposit's run, so stream reads and writes are contiguous and coalesced,
// and inactive slots exit after reading one 8-byte word.
template <bool kAndOr>
__global__ void __launch_bounds__(kThreads) router_scatter_kernel(
    const int* __restrict__ a_page, const int8_t* __restrict__ a_r,
    const int8_t* __restrict__ a_sub, const float* __restrict__ a_vals,
    const int2* __restrict__ rg, const int* __restrict__ target,
    const float* __restrict__ x, float* __restrict__ stream,
    int cb, int rstep, int dstep) {
  const int t = blockIdx.x / dstep;
  const int j = blockIdx.x - t * dstep;
  const int2 w = rg[static_cast<long long>(t) * rstep + j];
  if (w.y <= 0) return;
  const Deposit d = decode_deposit(w.x, w.y);
  const long long chunk = static_cast<long long>(t) * cb + d.k;
  const long long e0 = chunk * kChunk + d.src;
  float* out = stream
      + static_cast<long long>(target[static_cast<long long>(t) * dstep + j])
      * kChunk + d.dst;
  for (int i = threadIdx.x; i < d.len; i += kThreads)
    out[i] = gathered<kAndOr>(x, a_page, a_r, a_sub, a_vals, chunk, e0 + i);
}

// ---------------------------------------------------------------------------
// K3 reduce. Replaces _router_reduce_call / _make_reduce_kernel with its
// one-hot placement _onehot_place (router_pallas.py:756, :690, :88): each
// flushed element is added into its row. There is no one-hot product on
// Hopper: the add goes straight to y.
// Bound on the H100: the float atomics on y, which stay in L2 (y is at
// most 12 MB on every ICCAD graph), then the stream read (4 B per stream
// slot plus 2 B of int8 hi/lo).
// Design: one block per flushed chunk, coalesced reads; each warp sums
// runs of equal rows before its atomics (warp_add_rows); a zero sum issues
// no atomic, which changes no value.
__global__ void __launch_bounds__(kThreads) router_reduce_kernel(
    const int* __restrict__ c_code, const float* __restrict__ stream,
    const int8_t* __restrict__ c_hi, const int8_t* __restrict__ c_lo,
    float* __restrict__ y, int region_rows) {
  const long long s = blockIdx.x;
  const int code = c_code[s];
  if (code < 0) return;
  float* yr = y + static_cast<long long>(code) * region_rows;
  const long long base = s * kChunk;
  for (int p = threadIdx.x; p < kChunk; p += kThreads)
    warp_add_rows(yr, static_cast<int>(c_hi[base + p]) * 128
                  + static_cast<int>(c_lo[base + p]), stream[base + p]);
}

// ---------------------------------------------------------------------------
// K1 fused. Replaces _router_fused_call / _make_scatter_kernel(fuse=True)
// with _onehot_place (router_pallas.py:419, :166, :88): K2's deposits, but
// each element goes straight to its row of y, so the flush stream never
// reaches device memory.
// Bound on the H100: the y atomics (in L2), then about 8 B of streams per
// nnz from device memory (f32 value, int8 lane and sublane, int8 hi and lo
// at the element's stream position) and the x gather (in L2).
// Design: one block per (step, deposit slot) as in K2; hi/lo are read at
// target*1024 + dst + i, contiguous like the value stream; a deposit's
// elements are row-sorted, so warp_add_rows folds each row's run into one
// atomic per warp; zero sums (ANDOR with x = 0) issue no atomic. The loop
// bound is uniform across the block, so every lane reaches the shuffles.
template <bool kAndOr>
__global__ void __launch_bounds__(kThreads) router_fused_kernel(
    const int* __restrict__ a_page, const int8_t* __restrict__ a_r,
    const int8_t* __restrict__ a_sub, const float* __restrict__ a_vals,
    const int2* __restrict__ rg, const int* __restrict__ target,
    const int* __restrict__ c_code, const int8_t* __restrict__ c_hi,
    const int8_t* __restrict__ c_lo, const float* __restrict__ x,
    float* __restrict__ y, int cb, int rstep, int dstep, int region_rows) {
  const int t = blockIdx.x / dstep;
  const int j = blockIdx.x - t * dstep;
  const int2 w = rg[static_cast<long long>(t) * rstep + j];
  if (w.y <= 0) return;
  const Deposit d = decode_deposit(w.x, w.y);
  const int tgt = target[static_cast<long long>(t) * dstep + j];
  const int code = c_code[tgt];
  if (code < 0) return;
  float* yr = y + static_cast<long long>(code) * region_rows;
  const long long chunk = static_cast<long long>(t) * cb + d.k;
  const long long e0 = chunk * kChunk + d.src;
  const long long p0 = static_cast<long long>(tgt) * kChunk + d.dst;
  for (int base = 0; base < d.len; base += kThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    float g = 0.f;
    int row = -1;
    if (i < d.len) {
      g = gathered<kAndOr>(x, a_page, a_r, a_sub, a_vals, chunk, e0 + i);
      row = static_cast<int>(c_hi[p0 + i]) * 128
          + static_cast<int>(c_lo[p0 + i]);
    }
    warp_add_rows(yr, row, g);
  }
}

template <bool kAndOr>
void launch_scatter(const void* a_page, const void* a_r, const void* a_sub,
                    const void* a_vals, const void* rg, const void* target,
                    const void* x, void* stream_out, unsigned nblocks,
                    int cb, int rstep, int dstep, cudaStream_t st) {
  router_scatter_kernel<kAndOr><<<nblocks, kThreads, 0, st>>>(
      static_cast<const int*>(a_page), static_cast<const int8_t*>(a_r),
      static_cast<const int8_t*>(a_sub), static_cast<const float*>(a_vals),
      static_cast<const int2*>(rg), static_cast<const int*>(target),
      static_cast<const float*>(x), static_cast<float*>(stream_out),
      cb, rstep, dstep);
}

template <bool kAndOr>
void launch_fused(const void* a_page, const void* a_r, const void* a_sub,
                  const void* a_vals, const void* rg, const void* target,
                  const void* c_code, const void* c_hi, const void* c_lo,
                  const void* x, void* y, unsigned nblocks, int cb, int rstep,
                  int dstep, int region_rows, cudaStream_t st) {
  router_fused_kernel<kAndOr><<<nblocks, kThreads, 0, st>>>(
      static_cast<const int*>(a_page), static_cast<const int8_t*>(a_r),
      static_cast<const int8_t*>(a_sub), static_cast<const float*>(a_vals),
      static_cast<const int2*>(rg), static_cast<const int*>(target),
      static_cast<const int*>(c_code), static_cast<const int8_t*>(c_hi),
      static_cast<const int8_t*>(c_lo), static_cast<const float*>(x),
      static_cast<float*>(y), cb, rstep, dstep, region_rows);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// Outputs must be zeroed by the caller.

extern "C" int glt_router_scatter(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* target, const void* x,
    void* stream_out, int nsteps, int cb, int rstep, int dstep, int and_or,
    void* cuda_stream) {
  const long long nblocks = static_cast<long long>(nsteps) * dstep;
  if (nblocks > 0) {
    auto st = static_cast<cudaStream_t>(cuda_stream);
    auto launch = and_or ? launch_scatter<true> : launch_scatter<false>;
    launch(a_page, a_r, a_sub, a_vals, rg, target, x, stream_out,
           static_cast<unsigned>(nblocks), cb, rstep, dstep, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_router_reduce(
    const void* c_code, const void* stream_in, const void* c_hi,
    const void* c_lo, void* y, int nchunks, int region_rows,
    void* cuda_stream) {
  if (nchunks > 0) {
    router_reduce_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                           static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(c_code), static_cast<const float*>(stream_in),
        static_cast<const int8_t*>(c_hi), static_cast<const int8_t*>(c_lo),
        static_cast<float*>(y), region_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_router_fused(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* target,
    const void* c_code, const void* c_hi, const void* c_lo, const void* x,
    void* y, int nsteps, int cb, int rstep, int dstep, int region_rows,
    int and_or, void* cuda_stream) {
  const long long nblocks = static_cast<long long>(nsteps) * dstep;
  if (nblocks > 0) {
    auto st = static_cast<cudaStream_t>(cuda_stream);
    auto launch = and_or ? launch_fused<true> : launch_fused<false>;
    launch(a_page, a_r, a_sub, a_vals, rg, target, c_code, c_hi, c_lo, x, y,
           static_cast<unsigned>(nblocks), cb, rstep, dstep, region_rows, st);
  }
  return static_cast<int>(cudaGetLastError());
}
