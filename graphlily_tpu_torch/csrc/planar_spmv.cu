// Planar-router SpMV kernels for Hopper (sm_90a): K4 scatter, K5 xperm,
// and the frontier-predicated K4p scatter and K4p fused (SpMSpV, the
// `sm`/`na` launches of router_pallas.py:1747-1774). K4 fused runs K1's
// kernel (router_spmv.cu) over a row-sorted element form that the engine
// derives from these arrays at init (ops/planar.py). Built by
// graphlily_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface; ops/planar.py binds it with ctypes and holds each
// kernel against its plain PyTorch version. The split branch reduces K4's
// flush stream with K3 (router_spmv.cu); the tropical engine
// (ops/tropical.py) runs K4 scatter and K4p scatter in ADDMIN mode and
// reduces their int32 stream with K8 or K9 and K10 (tropical_spmv.cu).
//
// All of them read the PlanarSpMVLayout arrays of their Pallas twins in
// graphlily_tpu/ops/router_pallas.py (io/planar_format.py documents the
// words), except the deposit planes: K4 reads each piece's 8 triple-run
// words (io/planar_format.planes_to_triples), 32 B instead of the 1 KB
// (8, 128) int8 plane, which says the same thing losslessly:
//
//   gathered product  g[c, s, l] = val[c, s, l] (x) x[col(c, s, l)] with
//                     r = a_r[c, s, l] and, for the "free" deal,
//                     col = a_page[c]*1024 + a_sub[c, s, r]*128 + r
//                     (a_sub is indexed by the SOURCE lane r, not by l);
//                     for the "bucket" deal the column tiles of x are first
//                     re-laid by K5 and col = a_page[c]*1024 + s*128 + r.
//                     ANDOR: g = (val != 0 && x != 0) as 0/1; ADDMIN:
//                     g = INF_BITS - bits(min(val + x, FLOAT_INF)), int32.
//   deposit piece     rg[t, j] = (w1, w2), w2 > 0: chunk k = w1 & 0xFF,
//   (t, j)            word p = w1 >> 8 (== j). Sublane s's word
//                     a0 | d0<<7 | n<<14 moves g[t*cb + k, s, (a0+i) & 127]
//                     to flush-stream chunk target[t, j], element
//                     s*128 + d0 + i, for i < n.
//   flushed element   (q, p) -> y[c_code[q]*region_rows + c_hi[q, p]*128
//                     + c_lo[q, p]].
//
// Order. The Pallas kernels run the grid in order on one core: slots carry
// from step to step, a flush copies and zeroes its slot. CUDA blocks run in
// no order. As for the roll router, the host resolves the order once at
// engine init (io/router_format.deposit_targets reads the planar
// descriptor words unchanged): target[t, j] is the flush-stream chunk of
// the first flush of the piece's slot after it. Pieces of one slot cycle
// fill disjoint lanes (the packer's per-sublane cursors), and a flush
// zeroes its slot, so every flushed element comes from exactly one piece
// and unused elements stay zero: K4 scatter is a set of independent copies
// into a zeroed stream (no atomics, bit-equal to its plain version), and
// K4p fused adds each product straight into y with float atomics, summed
// first over runs of equal rows within the warp (glt::warp_add_rows; a
// piece's lanes are row-sorted within each sublane). K4p fused gathers
// through one int16 tile column per A slot, derived at engine init
// (ops/planar.tile_columns), instead of the chain a_r -> a_sub -> x.
//
// Predication (kPred; K4p fused always). A planar A-chunk mixes the 8
// pages of its column tile, so activity is per 1024-column tile
// (act[a_page[c]], PlanarSpMV._normalize_act). A piece of an inactive
// tile gathers only the semiring zero's products (for ADDMIN x =
// FLOAT_INF, encoded 0): K4p skips it, so its stream elements stay zero,
// and the split branch's K3p skips the flush chunks no live piece
// targets. The grid is the full one;
// a dead warp exits after its descriptor word and the chunk's tile. K5 is
// unchanged.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "piece_runs.cuh"
#include "warp_rows.cuh"

namespace {

using glt::Elem;
using glt::locate;
using glt::load_runs;
using glt::Runs;
using glt::warp_add_rows;

constexpr int kChunk = 1024;
constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kWarps = 8;                 // deposit pieces per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

// The semiring's (x), numbered as the wrappers pass it (semiring.OpType).
// ADDMIN is the tropical engine's: its product is stored as the exact int32
// encoding of router_pallas.py:_tropical_encode (semiring.tropical_encode),
// E = INF_BITS - bits(min(v + x, FLOAT_INF)), order-reversing on
// non-negative floats with E(FLOAT_INF) = 0. It runs in K4 scatter only:
// K4 fused adds floats into y, and the tropical engine never fuses.
enum class Op { kMulAdd = 0, kAndOr = 1, kAddMin = 2 };

constexpr float kFloatInf = 999999999.0f;     // semiring.FLOAT_INF (1e9f)
constexpr int kInfBits = 0x4E6E6B28;          // its bits, semiring.INF_BITS

// What a stream element holds: float, or the int32 encoding for ADDMIN.
template <Op kOp>
using Stored = typename std::conditional<kOp == Op::kAddMin, int,
                                         float>::type;

template <Op kOp>
__device__ __forceinline__ Stored<kOp> product(float v, float xv) {
  if constexpr (kOp == Op::kAndOr) {
    return (v != 0.f && xv != 0.f) ? 1.f : 0.f;
  } else if constexpr (kOp == Op::kAddMin) {
    // one rounding, as XLA's add; no fast-math anywhere in the build
    const float p = fminf(__fadd_rn(v, xv), kFloatInf);
    return kInfBits - __float_as_int(p);
  } else {
    return __fmul_rn(v, xv);   // one rounding, never fused with an add
  }
}

// Gathered product of A-chunk element (s, src); `chunk` is the element
// offset of the chunk, `page` its column tile.
template <Op kOp, bool kChained>
__device__ __forceinline__ Stored<kOp> gathered(
    const int8_t* __restrict__ a_r, const int8_t* __restrict__ a_sub,
    const float* __restrict__ a_vals, const float* __restrict__ x,
    long long chunk, int page, int s, int src) {
  const long long e = chunk + s * kLanes + src;
  const int r = a_r[e];
  const int sub = kChained ? static_cast<int>(a_sub[chunk + s * kLanes + r])
                           : s;
  const float xv = __ldg(x + static_cast<long long>(page) * kChunk
                         + sub * kLanes + r);
  return product<kOp>(a_vals[e], xv);
}

// ---------------------------------------------------------------------------
// K4 scatter. Replaces _planar_scatter_call with the bodies
// _make_planar_kernel / _make_planar_kernel_looped(fuse=False)
// (graphlily_tpu/ops/router_pallas.py:1398, :981, :1190): phase A (the
// chained or the single gather), phase B (plane deposits into K-rotated
// slots, flush = copy + zero) into the (nsteps, f, 8, 128) flush stream.
// Bound on the H100: the chain of dependent loads per element, lane ->
// source sublane (a_sub) -> x, more than the bytes. Per nnz it reads 5 B
// of A streams (f32 value, int8 lane; "free" adds an int8 a_sub read in
// the same 1 KB chunk) and writes 4 B of stream, plus 32 B of triple
// words per piece; x (6.5 MB on the pokec stand-in, at most 12 MB on
// every ICCAD graph) is served from the 50 MB L2. Measured on the pokec
// stand-in (PERF.md): 0.238 ms, 0.146 ms without the x gather, 0.209 ms
// without the a_sub load, against 0.082 ms for its bytes at 3.35 TB/s;
// the wrapper's zeroing of the stream adds 0.051 ms.
// Design: one warp per deposit piece, 8 pieces per block. A piece holds
// about 180 elements over its 8 sublane runs on the degree-sorted pokec
// stand-in, 22 per run, so the warp walks the piece's elements flattened
// across sublanes (32 per pass, no lane idles on a short run) rather than
// one run at a time; inactive slots cost one 8-byte descriptor read.
// ADDMIN (the tropical pass 1, _planar_scatter_call with op=ADDMIN,
// router_pallas.py:1403-1405) moves the same bytes: its 4-byte elements are
// int32 encodings, and the one float add rounds as XLA's does.
template <Op kOp, bool kChained, bool kPred>
__global__ void __launch_bounds__(kThreads) planar_scatter_kernel(
    const int* __restrict__ a_page, const int8_t* __restrict__ a_r,
    const int8_t* __restrict__ a_sub, const float* __restrict__ a_vals,
    const int2* __restrict__ rg, const int* __restrict__ tri,
    const int* __restrict__ target, const float* __restrict__ x,
    Stored<kOp>* __restrict__ stream, const uint8_t* __restrict__ act,
    int cb, int rstep, int dstep, long long npieces) {
  const unsigned lane = threadIdx.x & 31;
  const long long gp = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (gp >= npieces) return;                     // whole warp
  const long long t = gp / dstep;
  const int j = static_cast<int>(gp - t * dstep);
  const int2 w = rg[t * rstep + j];
  if (w.y <= 0) return;                          // whole warp
  const long long c = t * cb + (w.x & 0xFF);
  const int page = a_page[c];
  if (kPred && !act[page]) return;               // whole warp
  const Runs r = load_runs(tri + (t * dstep + (w.x >> 8)) * kSub, lane);
  const long long chunk = c * kChunk;
  Stored<kOp>* out = stream + static_cast<long long>(target[gp]) * kChunk;
  const int n = r.end[kSub - 1];
  for (int base = 0; base < n; base += 32) {
    const int e = base + static_cast<int>(lane);
    const Elem el = locate(r, e);
    if (e < n)
      out[el.dst] = gathered<kOp, kChained>(a_r, a_sub, a_vals, x, chunk,
                                            page, el.s, el.src);
  }
}

// ---------------------------------------------------------------------------
// K4p fused. Replaces _planar_fused_call with `sm`/`na` and the bodies
// _make_planar_kernel / _make_planar_kernel_looped(fuse=True) and the
// inline one-hot reduce _onehot_place (router_pallas.py:1459 -> pallas_call
// :1509, :1758, :981, :1190, :88): K4 scatter's pieces of active tiles,
// each product going straight to its row of y, so the flush stream never
// reaches device memory. (K4 fused, the unpredicated launch, runs K1's
// kernel over the engine's row-sorted form, PERF.md §6: it reads its
// own 8 bytes an element in order; a row-sorted form would make a dead
// tile's elements unskippable, so K4p keeps the stream-order walk.)
// Bound on the H100: about 7 B of streams per nnz of the active tiles
// (fp32 value, int16 tile column, int8 c_hi and c_lo at the element's
// stream position) plus 32 B of triple words per live piece; x (6.5 MB
// on the pokec stand-in) and y (6.6 MB, the atomics) stay in the 50 MB L2.
// Design: one warp per deposit piece, in stream order, as K4 scatter: the
// pieces of one step read neighbouring runs of the same A-chunks, so the
// A streams are read close to once from device memory. The gather reads
// a_col[c, s, l] = a_sub[c, s, a_r]*128 + a_r ("free", PERM-C) or
// s*128 + a_r ("bucket", over K5's x2), one 2-byte load before x instead
// of two dependent byte loads. hi/lo are read at target*1024 + s*128 +
// d0 + i; warp_add_rows folds each run of equal rows among the warp's
// lanes into one global atomic. The pass bound is uniform across the
// warp, so every lane reaches the shuffles. A dead piece's warp exits
// after its descriptor word and its chunk's tile.
template <Op kOp>
__global__ void __launch_bounds__(kThreads) planar_fused_pred_kernel(
    const int* __restrict__ a_page, const int16_t* __restrict__ a_col,
    const float* __restrict__ a_vals, const int2* __restrict__ rg,
    const int* __restrict__ tri, const int* __restrict__ target,
    const int* __restrict__ c_code, const int8_t* __restrict__ c_hi,
    const int8_t* __restrict__ c_lo, const float* __restrict__ x,
    float* __restrict__ y, const uint8_t* __restrict__ act, int cb,
    int rstep, int dstep, int region_rows, long long npieces) {
  const unsigned lane = threadIdx.x & 31;
  const long long gp = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (gp >= npieces) return;                     // whole warp
  const long long t = gp / dstep;
  const int j = static_cast<int>(gp - t * dstep);
  const int2 w = rg[t * rstep + j];
  if (w.y <= 0) return;                          // whole warp
  const long long c = t * cb + (w.x & 0xFF);
  const int page = a_page[c];
  if (!act[page]) return;                        // whole warp
  const long long tgt = target[gp];
  const int code = c_code[tgt];
  if (code < 0) return;                          // whole warp
  const Runs r = load_runs(tri + (t * dstep + (w.x >> 8)) * kSub, lane);
  const long long chunk = c * kChunk;
  const float* xs = x + static_cast<long long>(page) * kChunk;
  float* yr = y + static_cast<long long>(code) * region_rows;
  const int8_t* hi = c_hi + tgt * kChunk;
  const int8_t* lo = c_lo + tgt * kChunk;
  const int n = r.end[kSub - 1];
  for (int base = 0; base < n; base += 32) {
    const int e = base + static_cast<int>(lane);
    const Elem el = locate(r, e);
    float g = 0.f;
    int row = -1;
    if (e < n) {
      const long long src = chunk + el.s * kLanes + el.src;
      g = product<kOp>(a_vals[src], __ldg(xs + a_col[src]));
      row = static_cast<int>(hi[el.dst]) * kLanes
          + static_cast<int>(lo[el.dst]);
    }
    warp_add_rows(yr, row, g);
  }
}

// ---------------------------------------------------------------------------
// K5 xperm. Replaces _xperm_call / _xperm_call_padded with the body
// _make_xperm_kernel (router_pallas.py:924, :951, :880): the static
// per-tile column re-layout of x for "bucket" layouts,
// x2[t, d, l] = x[t, s, v & 127] where xperm[t, s, d, l] = v < 0, and 0
// where no source plane takes (the last taking plane wins, as in the
// Pallas body's where-chain).
// Bound on the H100: device memory, 8 B of planes and 8 B of x and x2 per
// column (13 MB of planes on the pokec stand-in).
// Design: one thread per output element; the 8 plane bytes it scans sit
// 1 KB apart and neighbouring threads read neighbouring bytes, so every
// load is coalesced; the gathered x values are in the same 4 KB tile.
__global__ void __launch_bounds__(kThreads) planar_xperm_kernel(
    const int8_t* __restrict__ xperm, const float* __restrict__ x,
    float* __restrict__ x2, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
      + threadIdx.x;
  if (i >= n) return;
  const long long t = i / kChunk;
  const int8_t* pv = xperm + t * kSub * kChunk + (i - t * kChunk);
  const float* xt = x + t * kChunk;
  float out = 0.f;
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int v = pv[s * kChunk];
    if (v < 0) out = __ldg(xt + s * kLanes + (v & (kLanes - 1)));
  }
  x2[i] = out;
}

unsigned blocks_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <Op kOp, bool kChained, bool kPred>
void launch_scatter(const void* a_page, const void* a_r, const void* a_sub,
                    const void* a_vals, const void* rg, const void* tri,
                    const void* target, const void* x, void* stream_out,
                    const void* act, long long npieces, int cb, int rstep,
                    int dstep, cudaStream_t st) {
  planar_scatter_kernel<kOp, kChained, kPred>
      <<<blocks_for(npieces, kWarps), kThreads, 0, st>>>(
          static_cast<const int*>(a_page), static_cast<const int8_t*>(a_r),
          static_cast<const int8_t*>(a_sub), static_cast<const float*>(a_vals),
          static_cast<const int2*>(rg), static_cast<const int*>(tri),
          static_cast<const int*>(target), static_cast<const float*>(x),
          static_cast<Stored<kOp>*>(stream_out),
          static_cast<const uint8_t*>(act), cb, rstep, dstep, npieces);
}

template <Op kOp>
void launch_fused_pred(const void* a_page, const void* a_col,
                       const void* a_vals, const void* rg, const void* tri,
                       const void* target, const void* c_code,
                       const void* c_hi, const void* c_lo, const void* x,
                       void* y, const void* act, long long npieces, int cb,
                       int rstep, int dstep, int region_rows,
                       cudaStream_t st) {
  planar_fused_pred_kernel<kOp>
      <<<blocks_for(npieces, kWarps), kThreads, 0, st>>>(
          static_cast<const int*>(a_page), static_cast<const int16_t*>(a_col),
          static_cast<const float*>(a_vals), static_cast<const int2*>(rg),
          static_cast<const int*>(tri), static_cast<const int*>(target),
          static_cast<const int*>(c_code), static_cast<const int8_t*>(c_hi),
          static_cast<const int8_t*>(c_lo), static_cast<const float*>(x),
          static_cast<float*>(y), static_cast<const uint8_t*>(act), cb, rstep,
          dstep, region_rows, npieces);
}

template <Op kOp, bool kPred>
auto scatter_launcher(bool chained) {
  return chained ? launch_scatter<kOp, true, kPred>
                 : launch_scatter<kOp, false, kPred>;
}

template <bool kPred>
int run_scatter(const void* a_page, const void* a_r, const void* a_sub,
                const void* a_vals, const void* rg, const void* tri,
                const void* target, const void* x, void* stream_out,
                const void* act, int nsteps, int cb, int rstep, int dstep,
                int op, void* cuda_stream) {
  if (op < 0 || op > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long npieces = static_cast<long long>(nsteps) * dstep;
  if (npieces > 0) {
    auto st = static_cast<cudaStream_t>(cuda_stream);
    const bool chained = a_sub != nullptr;
    auto launch = op == 2 ? scatter_launcher<Op::kAddMin, kPred>(chained)
        : op == 1 ? scatter_launcher<Op::kAndOr, kPred>(chained)
                  : scatter_launcher<Op::kMulAdd, kPred>(chained);
    launch(a_page, a_r, a_sub, a_vals, rg, tri, target, x, stream_out, act,
           npieces, cb, rstep, dstep, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// Outputs of K4 and K4p must be zeroed by the caller. For K4 scatter a_sub ==
// nullptr selects the "bucket" gather (x is then K5's x2); otherwise the
// chained "free" gather.
// K4 scatter's `op` is semiring.OpType (0 MULADD, 1 ANDOR: a float stream;
// 2 ADDMIN: an int32 stream of encodings); K4p fused takes and_or (0 or 1).

extern "C" int glt_planar_scatter(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* tri, const void* target,
    const void* x, void* stream_out, int nsteps, int cb, int rstep,
    int dstep, int op, void* cuda_stream) {
  return run_scatter<false>(a_page, a_r, a_sub, a_vals, rg, tri, target, x,
                            stream_out, nullptr, nsteps, cb, rstep, dstep,
                            op, cuda_stream);
}

// K4p scatter: act is the (num_col_tiles,) uint8 tile activity.
extern "C" int glt_planar_scatter_pred(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* tri, const void* target,
    const void* x, void* stream_out, const void* act, int nsteps, int cb,
    int rstep, int dstep, int op, void* cuda_stream) {
  return run_scatter<true>(a_page, a_r, a_sub, a_vals, rg, tri, target, x,
                           stream_out, act, nsteps, cb, rstep, dstep, op,
                           cuda_stream);
}

// K4p fused: a_col is the (nsteps*cb*1024,) int16 tile column of every A
// slot (ops/planar.tile_columns), x is K5's x2 for "bucket" layouts, act
// the (num_col_tiles,) uint8 tile activity; and_or 0 MULADD, 1 ANDOR
// (there is no ADDMIN instance).
extern "C" int glt_planar_fused_pred(
    const void* a_page, const void* a_col, const void* a_vals,
    const void* rg, const void* tri, const void* target, const void* c_code,
    const void* c_hi, const void* c_lo, const void* x, void* y,
    const void* act, int nsteps, int cb, int rstep, int dstep,
    int region_rows, int and_or, void* cuda_stream) {
  if (and_or < 0 || and_or > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long npieces = static_cast<long long>(nsteps) * dstep;
  if (npieces > 0) {
    auto launch = and_or ? launch_fused_pred<Op::kAndOr>
                         : launch_fused_pred<Op::kMulAdd>;
    launch(a_page, a_col, a_vals, rg, tri, target, c_code, c_hi, c_lo, x, y,
           act, npieces, cb, rstep, dstep, region_rows,
           static_cast<cudaStream_t>(cuda_stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_planar_xperm(const void* xperm, const void* x, void* x2,
                                int ntiles, void* cuda_stream) {
  const long long n = static_cast<long long>(ntiles) * kChunk;
  if (n > 0) {
    planar_xperm_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int8_t*>(xperm), static_cast<const float*>(x),
        static_cast<float*>(x2), n);
  }
  return static_cast<int>(cudaGetLastError());
}
