// Roll-router SpMV kernels for Hopper (sm_90a): K1 fused, K2 scatter,
// K3 reduce, and their frontier-predicated forms K1p, K2p, K3p (SpMSpV,
// the `sm`/`na` launches of router_pallas.py:459-460, :1947-1963). K1's
// kernel is also K4 fused and K4p fused (the planar engine's row and tile
// forms) and, in ADDMIN mode over the tropical pass 1's row and tile
// forms, the tropical engine's whole SpMV and SpMSpV, whose int32 max is
// K10's window reduce folded into the walk (below). Built
// by graphlily_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface; ops/router.py binds it with ctypes and holds
// each kernel against its plain PyTorch version.
//
// K2 and K3 read the same RouterSpMVLayout arrays as their Pallas twins in
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
// (ANDOR adds 0/1 counts, so it stays exact). Before its atomics K3 sums
// each warp's runs of equal rows (warp_add_rows), K1 each thread's and then
// each warp's. K1 reads a device form derived from these arrays at engine
// init (below), in which every deposit's elements already carry their row.
//
// Predication (kPred). x is zero outside the frontier, so a deposit whose
// A-chunk lies on an inactive 128-column page gathers only zero products.
// The Pallas forms mask such deposits (_predicate_rg) and compact the grid
// to the steps that keep a live deposit or a live flush (_predicate_exact),
// because their flushes run in order. Here no flush order exists: K1p and
// K2p skip the dead deposits (their stream elements stay zero in the
// zeroed stream), and K3p skips the flush-stream chunks that no live
// deposit targets (`live`, built on the device by the wrapper). The grid
// is the full one; a dead K2p block exits after its descriptor word and
// the chunk's page, a dead K1p block after its deposits' records (each
// holds its page's flag). The page of A-chunk c is
// a_page[c]*8 + a_sub[c*1024]: a roll chunk holds one page, so its first
// sublane byte is the page's (router_pallas.py:_chunk_activity).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "segments.cuh"
#include "semiring_product.cuh"
#include "warp_rows.cuh"

namespace {

using glt::Op;
using glt::Stored;
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

// Frontier activity of A-chunk `chunk`: act is per 128-column page.
__device__ __forceinline__ bool chunk_active(
    const uint8_t* __restrict__ act, const int* __restrict__ a_page,
    const int8_t* __restrict__ a_sub, long long chunk) {
  return act[static_cast<long long>(a_page[chunk]) * 8
             + static_cast<int>(a_sub[chunk * kChunk])] != 0;
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
template <bool kAndOr, bool kPred>
__global__ void __launch_bounds__(kThreads) router_scatter_kernel(
    const int* __restrict__ a_page, const int8_t* __restrict__ a_r,
    const int8_t* __restrict__ a_sub, const float* __restrict__ a_vals,
    const int2* __restrict__ rg, const int* __restrict__ target,
    const float* __restrict__ x, float* __restrict__ stream,
    const uint8_t* __restrict__ act, int cb, int rstep, int dstep) {
  const int t = blockIdx.x / dstep;
  const int j = blockIdx.x - t * dstep;
  const int2 w = rg[static_cast<long long>(t) * rstep + j];
  if (w.y <= 0) return;
  const Deposit d = decode_deposit(w.x, w.y);
  const long long chunk = static_cast<long long>(t) * cb + d.k;
  if (kPred && !chunk_active(act, a_page, a_sub, chunk)) return;
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
template <bool kPred>
__global__ void __launch_bounds__(kThreads) router_reduce_kernel(
    const int* __restrict__ c_code, const float* __restrict__ stream,
    const int8_t* __restrict__ c_hi, const int8_t* __restrict__ c_lo,
    float* __restrict__ y, const uint8_t* __restrict__ live,
    int region_rows) {
  const long long s = blockIdx.x;
  if (kPred && !live[s]) return;
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
// reaches device memory. The same kernel is K4 fused: it replaces
// _planar_fused_call (router_pallas.py:1459 -> :1509, and its PERM-C
// instance with `beg`) over the planar engine's form, derived the same way
// from the planar layout's pieces (ops/planar.py; PERF.md §6: 8 B an
// element read in order, 4 B for ANDOR, against the old walk's 7 B of
// streams, 32 B of triple words a piece and one atomic per warp row-run).
// Its segments are windows of 2**14 columns (2**13 for ANDOR), so a
// warp's x gathers (6.5 MB of x on pokec, in L2) stay close together.
//
// What it reads. Not the layout's streams: a deposit's source offset in
// the A stream and its destination offset in the hi/lo stream differ by
// the roll, so no vector load lines up on both, and each element cost five
// scalar loads behind a chain of three dependent descriptor loads. The
// engine derives at init a padding-free form (ops/router.router_entries):
// every element of a live deposit as its f32 value and one word
// col | row << col_bits (the column within its segment's window, the row
// within its region, read once from c_hi/c_lo at the element's flush
// position), and per segment a record (first element, x offset, y offset
// region*region_rows, page activity flag). Element e of segment d is
//   g = val[e] (x) x[xo[d] + (w & mask)],  added into y[yo[d] + (w >> bits)]
// (ANDOR: g = (val != 0 && x != 0) as 0/1, counts clamped by the caller).
// K1 reads the "row" order: each region's elements sorted by row (a
// segment per region and window of 2**col_bits columns, the whole of x on
// the googleplus stand-in), so a row's products meet in one thread's
// registers and across the warp, and y takes about one atomic per (row,
// warp pass). K1p reads the "deposit" order: a segment per deposit, x
// offset its page, so it can skip a dead page's deposits. K4p fused (the
// `sm`/`na` launch of _planar_fused_call, router_pallas.py:1758) reads
// the planar engine's tile form: the "row" order in windows of 1,024
// columns, one column tile each, the planar activity unit, with the tile
// as each segment's flag; the flag is an index into `act` in every form.
// Bound on the H100: device memory, 8 B per element (the bytes
// router_traffic in chip_smoke.py counts for K1), then the y atomics in
// L2 and the x gather (in L2: 430 KB on the googleplus stand-in).
// Design: the grid is a table of blocks of ENTRIES_PER_BLOCK consecutive
// elements. A block loads its segments' records into shared memory, one
// thread each; each thread takes 8 consecutive elements with 16-byte vector
// loads, finds their segments by one binary search and a forward walk,
// gathers x and sums runs of equal rows in registers (a deposit's elements
// are row-sorted too). Its middle runs go to y with one atomic each; its
// first run joins the previous lane's last when their rows match, and the
// lanes' last runs fold across the warp (warp_fold_runs), one atomic per
// run head. A zero sum issues no atomic. ANDOR adds 0/1 counts and stays
// exact; MULADD's float atomics land in any order. Measured (ab_kernels.py,
// PERF.md, PR 8): the row order against the deposit order, block sizes,
// and ablations (plain stores for the atomics, a constant for the x
// gather).
//
// Without values (kVals false, a null `vals`): the ANDOR form of a matrix
// whose stored values are all nonzero (checked at init), 4 B an element.
//
// ADDMIN (the tropical engine, ops/tropical.py): the whole min-plus SpMV,
// in place of the TPU's three passes (K4 scatter ADDMIN -> K8/K9 split ->
// K10 window reduce, tropical_pallas.py:513-564, which exist because the
// matrix unit has no scatter-max and Pallas grids run in order). Each
// product is the exact int32 encoding E = INF_BITS - bits(min(v + x,
// FLOAT_INF)) (semiring_product.cuh, K4 scatter's own definition); a run
// of one row folds with int32 max and reaches the int32 `out` with one
// atomicMax, K10's own reduction (glt::warp_max_rows), exact in any order.
// A run whose max is not above 0, the identity and the encoding of
// FLOAT_INF, issues nothing. So `out` is bit-equal to the three passes'
// on any x, negative ones included. It reads the tropical pass 1's row
// form (K4 fused's) and, predicated, its tile form (K4p fused's).
//
// Predication (K1p, K4p fused). A segment whose flag is inactive (a
// deposit of a dead page, a window of a dead tile) gathers only zeros: its
// record's x offset is set to -1 in shared memory and its elements are not
// read; a block none of whose segments is live exits after its records.
// The full grid is launched, so nothing is read on the host.
constexpr int kVec = 8;            // consecutive elements per thread
constexpr int kFusedThreads = 256;

// One run's total into y. MULADD, ANDOR: a float sum added; a zero sum
// changes nothing and issues no atomic. ADDMIN: an int32 encoding max'd
// into the zeroed out; a total not above 0 changes nothing and issues no
// atomic, as in K10's fold (glt::warp_max_rows).
__device__ __forceinline__ void add_row(float* __restrict__ y, int row,
                                        float v) {
  if (v != 0.f) atomicAdd(y + row, v);
}

__device__ __forceinline__ void add_row(int* __restrict__ y, int row,
                                        int v) {
  if (v > 0) atomicMax(y + row, v);
}

__device__ __forceinline__ float combine(float a, float b) { return a + b; }
__device__ __forceinline__ int combine(int a, int b) { return max(a, b); }

__device__ __forceinline__ float gather_x(const float* __restrict__ x,
                                          int col) {
  return __ldg(x + col);
}

// blocks[b] = (e0, e1, g0, g1): elements [e0, e1) of segments [g0, g1);
// deps[g] = (first element, x offset, y offset, activity flag).
template <Op kOp, bool kVals>
__global__ void __launch_bounds__(kFusedThreads) router_fused_kernel(
    const int4* __restrict__ blocks, const int4* __restrict__ deps,
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ x, Stored<kOp>* __restrict__ y,
    const uint8_t* __restrict__ act, int max_segments, int col_bits) {
  using Acc = Stored<kOp>;
  using Fold = typename std::conditional<kOp == Op::kAddMin, glt::FoldMax,
                                         glt::FoldAdd>::type;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ int seg[];     // start, x offset, y offset of each
  int* s_start = seg;
  int* s_x = seg + max_segments;
  int* s_y = seg + 2 * max_segments;
  const int4 b = blocks[blockIdx.x];
  const int ns = b.w - b.z;
  // an inactive segment's elements: unread
  const bool live = glt::load_segments(b, deps, act, kFusedThreads, s_start,
                                       s_x, s_y);
  if (act != nullptr) {
    if (!__syncthreads_or(live)) return;
  } else {
    __syncthreads();
  }
  const unsigned mask = (1u << col_bits) - 1u;
  const unsigned lane = threadIdx.x & 31;
  // the loop bound is uniform across the block, so every lane reaches the
  // shuffles
  for (int base = b.x & ~(kVec - 1); base < b.y;
       base += kVec * kFusedThreads) {
    const int q = base + kVec * static_cast<int>(threadIdx.x);
    int first_row = -1, last_row = -1;
    Acc first_acc = 0, last_acc = 0;
    if (q < b.y) {
      int col[kVec], row[kVec];
      bool any = false;
      int j = glt::find_segment(s_start, ns, max(q, b.x));
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int e = q + k;
        col[k] = -1;
        if (e < b.x || e >= b.y) continue;
        while (j + 1 < ns && s_start[j + 1] <= e) ++j;
        col[k] = s_x[j];
        row[k] = s_y[j];
        any |= col[k] >= 0;
      }
      if (any) {
        const uint4 w0 = *reinterpret_cast<const uint4*>(idx + q);
        const uint4 w1 = *reinterpret_cast<const uint4*>(idx + q + 4);
        const unsigned w[kVec] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
        float v[kVec];
        if constexpr (kVals) {
          const float4 v0 = *reinterpret_cast<const float4*>(vals + q);
          const float4 v1 = *reinterpret_cast<const float4*>(vals + q + 4);
          v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
          v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
        }
        float xv[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (col[k] < 0) continue;
          col[k] += static_cast<int>(w[k] & mask);
          row[k] += static_cast<int>(w[k] >> col_bits);
          xv[k] = gather_x(x, col[k]);
        }
        int runs = 0;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (col[k] < 0) continue;
          Acc g;
          if constexpr (!kVals)      // every stored value is nonzero
            g = xv[k] != 0.f ? 1.f : 0.f;
          else
            g = glt::product<kOp>(v[k], xv[k]);
          if (row[k] == last_row) {
            last_acc = combine(last_acc, g);
          } else {
            if (runs == 1) {
              first_row = last_row;      // held back for the previous lane
              first_acc = last_acc;
            } else if (runs > 1) {
              add_row(y, last_row, last_acc);
            }
            ++runs;
            last_row = row[k];
            last_acc = g;
          }
        }
      }
    }
    // the first run joins the previous lane's last run when the rows match
    const int prev_last = __shfl_up_sync(kAll, last_row, 1);
    const int next_first = __shfl_down_sync(kAll, first_row, 1);
    const Acc next_acc = __shfl_down_sync(kAll, first_acc, 1);
    if (first_row >= 0 && !(lane > 0 && prev_last == first_row))
      add_row(y, first_row, first_acc);
    if (lane < 31 && next_first >= 0 && next_first == last_row)
      last_acc = combine(last_acc, next_acc);
    bool head;
    const Acc sum = glt::warp_fold_runs<Fold>(last_row, last_acc, head);
    if (head && last_row >= 0) add_row(y, last_row, sum);
  }
}

template <bool kAndOr, bool kPred>
void launch_scatter(const void* a_page, const void* a_r, const void* a_sub,
                    const void* a_vals, const void* rg, const void* target,
                    const void* x, void* stream_out, const void* act,
                    unsigned nblocks, int cb, int rstep, int dstep,
                    cudaStream_t st) {
  router_scatter_kernel<kAndOr, kPred><<<nblocks, kThreads, 0, st>>>(
      static_cast<const int*>(a_page), static_cast<const int8_t*>(a_r),
      static_cast<const int8_t*>(a_sub), static_cast<const float*>(a_vals),
      static_cast<const int2*>(rg), static_cast<const int*>(target),
      static_cast<const float*>(x), static_cast<float*>(stream_out),
      static_cast<const uint8_t*>(act), cb, rstep, dstep);
}

template <bool kPred>
int run_reduce(const void* c_code, const void* stream_in, const void* c_hi,
               const void* c_lo, void* y, const void* live, int nchunks,
               int region_rows, void* cuda_stream) {
  if (nchunks > 0) {
    router_reduce_kernel<kPred><<<static_cast<unsigned>(nchunks), kThreads,
                                  0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int*>(c_code), static_cast<const float*>(stream_in),
        static_cast<const int8_t*>(c_hi), static_cast<const int8_t*>(c_lo),
        static_cast<float*>(y), static_cast<const uint8_t*>(live),
        region_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPred>
int run_scatter(const void* a_page, const void* a_r, const void* a_sub,
                const void* a_vals, const void* rg, const void* target,
                const void* x, void* stream_out, const void* act, int nsteps,
                int cb, int rstep, int dstep, int and_or,
                void* cuda_stream) {
  const long long nblocks = static_cast<long long>(nsteps) * dstep;
  if (nblocks > 0) {
    auto st = static_cast<cudaStream_t>(cuda_stream);
    auto launch = and_or ? launch_scatter<true, kPred>
                         : launch_scatter<false, kPred>;
    launch(a_page, a_r, a_sub, a_vals, rg, target, x, stream_out, act,
           static_cast<unsigned>(nblocks), cb, rstep, dstep, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Op kOp, bool kVals>
int launch_fused(const void* blocks, const void* deps, const void* vals,
                 const void* idx, const void* x, void* y, const void* act,
                 int nblocks, int max_segments, int col_bits,
                 cudaStream_t st) {
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(max_segments);
  auto kernel = router_fused_kernel<kOp, kVals>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nblocks, kFusedThreads, smem, st>>>(
      static_cast<const int4*>(blocks), static_cast<const int4*>(deps),
      static_cast<const float*>(vals), static_cast<const unsigned*>(idx),
      static_cast<const float*>(x), static_cast<Stored<kOp>*>(y),
      static_cast<const uint8_t*>(act), max_segments, col_bits);
  return static_cast<int>(cudaGetLastError());
}

// `op` is semiring.OpType (0 MULADD, 1 ANDOR: a float y; 2 ADDMIN: an
// int32 out of encodings). A null `vals` is the ANDOR form without values
// (op must be 1).
int run_fused(const void* blocks, const void* deps, const void* vals,
              const void* idx, const void* x, void* y, const void* act,
              int nblocks, int max_segments, int col_bits, int op,
              void* cuda_stream) {
  if (op < 0 || op > 2 || nblocks < 0 || max_segments < 0 || col_bits < 1 ||
      col_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  // a form with no elements (an empty matrix) has no block, and its empty
  // value tensor may have a null pointer
  if (nblocks == 0) return static_cast<int>(cudaGetLastError());
  if (vals == nullptr && op != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fn = vals == nullptr ? launch_fused<Op::kAndOr, false>
      : op == 2 ? launch_fused<Op::kAddMin, true>
      : op == 1 ? launch_fused<Op::kAndOr, true>
                : launch_fused<Op::kMulAdd, true>;
  return fn(blocks, deps, vals, idx, x, y, act, nblocks, max_segments,
            col_bits, static_cast<cudaStream_t>(cuda_stream));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// Outputs must be zeroed by the caller. The *_pred forms take `act`, the
// (num_col_tiles*8,) uint8 page activity (K1p, K2p), or `live`, the
// (nsteps*f,) uint8 flush-chunk liveness (K3p).

extern "C" int glt_router_scatter(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* target, const void* x,
    void* stream_out, int nsteps, int cb, int rstep, int dstep, int and_or,
    void* cuda_stream) {
  return run_scatter<false>(a_page, a_r, a_sub, a_vals, rg, target, x,
                            stream_out, nullptr, nsteps, cb, rstep, dstep,
                            and_or, cuda_stream);
}

extern "C" int glt_router_scatter_pred(
    const void* a_page, const void* a_r, const void* a_sub,
    const void* a_vals, const void* rg, const void* target, const void* x,
    void* stream_out, const void* act, int nsteps, int cb, int rstep,
    int dstep, int and_or, void* cuda_stream) {
  return run_scatter<true>(a_page, a_r, a_sub, a_vals, rg, target, x,
                           stream_out, act, nsteps, cb, rstep, dstep, and_or,
                           cuda_stream);
}

extern "C" int glt_router_reduce(
    const void* c_code, const void* stream_in, const void* c_hi,
    const void* c_lo, void* y, int nchunks, int region_rows,
    void* cuda_stream) {
  return run_reduce<false>(c_code, stream_in, c_hi, c_lo, y, nullptr,
                           nchunks, region_rows, cuda_stream);
}

extern "C" int glt_router_reduce_pred(
    const void* c_code, const void* stream_in, const void* c_hi,
    const void* c_lo, void* y, const void* live, int nchunks,
    int region_rows, void* cuda_stream) {
  return run_reduce<true>(c_code, stream_in, c_hi, c_lo, y, live, nchunks,
                          region_rows, cuda_stream);
}

// K1, K4 fused and the tropical walk: `op` is semiring.OpType, as K4
// scatter takes it (0 MULADD, 1 ANDOR: y float32; 2 ADDMIN: y an int32
// out of encodings, zeroed).
extern "C" int glt_router_fused(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* y, int nblocks, int max_segments, int col_bits,
    int op, void* cuda_stream) {
  return run_fused(blocks, deps, vals, idx, x, y, nullptr, nblocks,
                   max_segments, col_bits, op, cuda_stream);
}

// K1p: act is the (num_cols/128,) uint8 page activity; K4p fused and the
// predicated tropical walk: the (num_cols/1024,) uint8 tile activity. Each
// segment's flag indexes it.
extern "C" int glt_router_fused_pred(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* y, const void* act, int nblocks, int max_segments,
    int col_bits, int op, void* cuda_stream) {
  return run_fused(blocks, deps, vals, idx, x, y, act, nblocks,
                   max_segments, col_bits, op, cuda_stream);
}
