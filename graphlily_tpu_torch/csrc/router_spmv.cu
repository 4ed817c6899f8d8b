// Roll-router SpMV kernels for Hopper (sm_90a): K1 fused, K2 scatter,
// K3 reduce, and their frontier-predicated forms K1p, K2p, K3p (SpMSpV,
// the `sm`/`na` launches of router_pallas.py:459-460, :1947-1963). K1's
// kernel is also K4 fused (the planar engine's row form) and K1p's is K4p
// fused (its tile form); in ADDMIN mode over the tropical pass 1's row and
// tile forms they are the tropical engine's whole SpMV and SpMSpV, whose
// int32 max is K10's window reduce folded into the walk (below). Built
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
// (ANDOR adds 0/1 counts, so it stays exact). K1 sums each thread's runs
// of equal rows and then each warp's before its atomics; K3 sums a group
// of one region's flushed chunks in a shared tile first (below), and K3p
// each warp's runs (warp_add_rows). K1 reads a device form derived from
// these arrays at engine init (below), in which every deposit's elements
// already carry their row; K3 reads the region-group table derived there.
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
// Hopper: the sum is taken in shared memory. The same kernel is K11, the
// PERM-C reduce (_permc_reduce_call, router_pallas.py:851 -> :864), over
// the position-keyed rows the planar engine derives from the layout's
// destination-lane keys at init (io/permc_format.permc_stream_rows): it
// beat K11's own redesign, a thread per destination lane summing its runs,
// which read 3 B of keys a slot where this reads 2 (PERF.md §6).
// Bound on the H100: the stream read, 4 B a slot of every flushed chunk
// plus 2 B of int8 hi/lo, and y written once. The per-chunk kernel it
// replaced (one global atomic per warp run of equal rows) issued 20.7M
// float atomics for the pokec stand-in's 30.6M stream elements and read
// at 0.65 TB/s; its atomics as plain stores ran slower still, so the
// scattered y updates, not the atomics' rate, held it (PERF.md §6).
// This one issues about a fifth as many global reductions there, a
// vector reduction or store per nonzero quad of a group's tile.
// Design: one block per group of the region-group table
// (ops/router.reduce_groups): a dynamic shared tile of the region's rows is
// zeroed, then the block walks its chunks, a chunk a pass, 4 consecutive
// slots a thread with 16-byte stream loads and 4-byte hi and lo loads, the
// next chunk's loads issued before this one is summed.
// Runs of equal rows are summed in registers and across the warp
// (tile_add_runs) and added into the tile with one shared atomic a run.
// Then the tile reaches y once per nonzero quad (tile_flush): plain stores
// for a region's only group, else one vector reduction. ANDOR adds 0/1
// counts and stays exact; MULADD's tile sums and the vector reductions of
// a region's groups land in any order. The block walks its chunks in
// sequence: smaller groups (more blocks) ran faster, down to 8 chunks,
// and two chunks a pass no faster than one (PERF.md §6).
constexpr int kReduceThreads = 256;
constexpr int kSlots = 4;          // consecutive slots a thread: a chunk a pass
static_assert(kReduceThreads * kSlots == kChunk, "a chunk a pass");
// Rows of a region: c_hi is one byte (at most 128 x 128 rows, 64 KB of
// tile), and a multiple of 128, so quads of rows never straddle regions.
constexpr int kMaxRegionRows = 16384;

// Zero `rows` floats (a multiple of 4) of the tile with 16-byte stores.
__device__ __forceinline__ void tile_zero(float* tile, int rows) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < rows / 4; i += blockDim.x)
    t4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// After a __syncthreads: the tile into its region of y, a quad of rows a
// thread at a time. The region's only group (`sole`) stores its quads:
// the caller zeroed y and no other block writes the region, so y needs no
// atomic and comes out the same on every run. Otherwise each quad goes to
// y with one vector reduction (atomicAdd on a float4, red.global.add.v4.f32,
// sm_90). An all-zero quad changes nothing and is skipped. The tile holds
// only sums of nonzero run totals, so no -0.f reaches y (the plain
// versions' index_add_ into zeros gives +0.f there too).
__device__ __forceinline__ void tile_flush(const float* tile,
                                           float* __restrict__ yr, int rows,
                                           bool sole) {
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* y4 = reinterpret_cast<float4*>(yr);
  for (int i = threadIdx.x; i < rows / 4; i += blockDim.x) {
    const float4 t = t4[i];
    if (t.x == 0.f && t.y == 0.f && t.z == 0.f && t.w == 0.f) continue;
    if (sole)
      y4[i] = t;
    else
      atomicAdd(y4 + i, t);
  }
}

// A run's total into the tile; a zero sum adds nothing.
__device__ __forceinline__ void tile_add(float* tile, int row, float v) {
  if (v != 0.f) atomicAdd(tile + row, v);
}

// The thread's kN (row, value) pairs, consecutive slots, into the tile
// (K1's fold): runs of equal rows are summed in registers; the middle runs
// go to the tile at once, the first joins the previous lane's last run
// when their rows match, and the lanes' last runs fold across the warp
// (warp_fold_runs), one shared atomic per run head; a warp none of whose
// runs crosses a lane boundary skips the fold. So a hub row that
// fills a sublane costs one shared atomic a warp, not one a slot: Hopper
// adds floats into shared memory by a compare-and-swap loop (PERF.md), which
// serialises on one address. All 32 lanes call it together.
template <int kN>
__device__ __forceinline__ void tile_add_runs(float* tile, const int (&row)[kN],
                                              const float (&v)[kN]) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  int first_row = -1, last_row = row[0];
  float first_acc = 0.f, last_acc = v[0];
  int runs = 1;
#pragma unroll
  for (int k = 1; k < kN; ++k) {
    if (row[k] == last_row) {
      last_acc += v[k];
      continue;
    }
    if (runs == 1) {
      first_row = last_row;            // held back for the previous lane
      first_acc = last_acc;
    } else {
      tile_add(tile, last_row, last_acc);
    }
    ++runs;
    last_row = row[k];
    last_acc = v[k];
  }
  const int prev_last = __shfl_up_sync(kAll, last_row, 1);
  // no run crosses a lane boundary (the hypersparse streams, whose rows
  // seldom repeat): every lane adds its own runs
  const int lead = first_row >= 0 ? first_row : last_row;
  if (!__any_sync(kAll, lane > 0 && prev_last == lead)) {
    if (first_row >= 0) tile_add(tile, first_row, first_acc);
    tile_add(tile, last_row, last_acc);
    return;
  }
  const int next_first = __shfl_down_sync(kAll, first_row, 1);
  const float next_acc = __shfl_down_sync(kAll, first_acc, 1);
  if (first_row >= 0 && !(lane > 0 && prev_last == first_row))
    tile_add(tile, first_row, first_acc);
  if (lane < 31 && next_first >= 0 && next_first == last_row)
    last_acc += next_acc;
  bool head;
  const float sum = glt::warp_fold_runs<glt::FoldAdd>(last_row, last_acc,
                                                      head);
  if (head) tile_add(tile, last_row, sum);
}

// groups[b] = (first position in order, chunks, region, sole).
__global__ void __launch_bounds__(kReduceThreads) router_reduce_kernel(
    const int4* __restrict__ groups, const int* __restrict__ order,
    const float* __restrict__ stream, const int8_t* __restrict__ c_hi,
    const int8_t* __restrict__ c_lo, float* __restrict__ y,
    int region_rows) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int4 g = groups[blockIdx.x];
  tile_zero(tile, region_rows);
  const int p = kSlots * static_cast<int>(threadIdx.x);
  long long at = static_cast<long long>(__ldg(order + g.x)) * kChunk + p;
  float4 v = __ldg(reinterpret_cast<const float4*>(stream + at));
  unsigned hi = __ldg(reinterpret_cast<const unsigned*>(c_hi + at));
  unsigned lo = __ldg(reinterpret_cast<const unsigned*>(c_lo + at));
  __syncthreads();
  for (int k = 0; k < g.y; ++k) {
    const float val[kSlots] = {v.x, v.y, v.z, v.w};
    int row[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      row[j] = static_cast<int>((hi >> (8 * j)) & 0xFFu) * 128
          + static_cast<int>((lo >> (8 * j)) & 0xFFu);
    if (k + 1 < g.y) {              // the next chunk's loads, in flight
      at = static_cast<long long>(__ldg(order + g.x + k + 1)) * kChunk + p;
      v = __ldg(reinterpret_cast<const float4*>(stream + at));
      hi = __ldg(reinterpret_cast<const unsigned*>(c_hi + at));
      lo = __ldg(reinterpret_cast<const unsigned*>(c_lo + at));
    }
    tile_add_runs(tile, row, val);
  }
  __syncthreads();
  tile_flush(tile, y + static_cast<long long>(g.z) * region_rows,
             region_rows, g.w != 0);
}

// K3p: K3 over the live flush chunks only, one block per chunk (the
// predicated launch of _router_reduce_call, router_pallas.py:1962); each
// warp sums runs of equal rows before its global atomics (warp_add_rows).
// A dead chunk's block exits after one byte.
__global__ void __launch_bounds__(kThreads) router_reduce_pred_kernel(
    const int* __restrict__ c_code, const float* __restrict__ stream,
    const int8_t* __restrict__ c_hi, const int8_t* __restrict__ c_lo,
    float* __restrict__ y, const uint8_t* __restrict__ live,
    int region_rows) {
  const long long s = blockIdx.x;
  if (!live[s]) return;
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
// Design: the form is a table of blocks of ENTRIES_PER_BLOCK consecutive
// elements (its rows; also cut at every BLOCK_SEGMENTS-th segment start).
// A row is walked a pass at a time: each of 256 threads takes 8
// consecutive elements with 16-byte vector loads, finds their segments by
// one binary search over the row's records in shared memory and a forward
// walk, gathers x and sums runs of equal rows in registers (a deposit's
// elements are row-sorted too). Its middle runs go to y with one atomic
// each; its first run joins the previous lane's last when their rows
// match, and the lanes' last runs fold across the warp (warp_fold_runs),
// one atomic per run head. A zero sum issues no atomic. ANDOR adds 0/1
// counts and stays exact; MULADD's float atomics land in any order.
// Measured (ab_kernels.py, PERF.md §6): the row order against the deposit
// order, block sizes, and ablations (plain stores for the atomics, a
// constant for the x gather).
//
// Two kernels walk the form; run_fused takes the one the launch asks for,
// by whether `act` is null.
//
// The unpredicated walk (router_fused_kernel: K1, K4 fused and the tropical
// walk) is persistent and software-pipelined. A row lasts two passes, and
// launched a block per row, each block waited in turn for its row's
// record, its segment records and a barrier, then for each pass's stream
// loads, with no stream load in flight while a pass gathered x and folded
// its runs. Here the grid is what the card holds at once (SMs x the blocks
// an SM holds, from cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// each block strides over the table's rows. Before a thread gathers and
// folds its current 8 elements it has issued the 16-byte loads of its
// next 8 (the next pass of the row, or the first pass of the block's next
// row), held in registers: one pass of prefetch, 64 B a thread in flight
// through the gather and the fold, for 7-9 more registers (MULADD and
// ADDMIN 55 -> 64, still 4 blocks an SM; ANDOR without values 48 -> 55, 5
// -> 4 blocks; PERF.md §6). The next row's records are copied
// with cp.async into the other half of a double-buffered shared table
// while the current row's last pass runs, so a row costs one barrier and
// no serial prologue. The prefetch alone moved the walk by -9% to +5%: the
// walk also spent about 70 instructions an element, most of them the
// segment lookup's test and walk for each element, so it is issue-bound as
// much as memory-bound. A thread whose 8 elements lie in one segment (all
// but a few in every row form: segments hold thousands) looks up one
// record for all 8 and tests none. The stream is read evict-first
// (ld.global.cs), so that x and y keep their places in L2 (5-7%). Measured
// against the block-per-row kernel, on the benchmark's graphs: K1 7-16%,
// K4 fused 10-18%, the tropical walk 12% faster. Occupancy bought with
// fewer registers (5 or 6 blocks an SM) spilled and ran up to twice as
// long, two passes a turn in place of the register copy took 80 registers
// and gained nothing, and the stream's loads past L1 lost up to 6%.
//
// The predicated walk (router_fused_pred_kernel: K1p, K4p fused and the
// predicated tropical walk) launches a block per row, whose block exits
// after its records when none of its segments is live (below): a
// persistent walk would step through every dead row in turn.
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
constexpr int kPass = kVec * kFusedThreads;   // elements of a row a pass

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

// A thread's 8 consecutive words and (kVals) values.
template <bool kVals>
struct Stream8 {
  unsigned w[kVec];
  float v[kVec];
};

// kOnce: loads that mark their lines evict-first (ld.global.cs), for a
// stream read once a walk, so that x and y keep their places in L2.
template <bool kVals, bool kOnce>
__device__ __forceinline__ void load_stream(Stream8<kVals>& s,
                                            const unsigned* __restrict__ idx,
                                            const float* __restrict__ vals,
                                            int q) {
  uint4 w0, w1;
  if constexpr (kOnce) {
    w0 = __ldcs(reinterpret_cast<const uint4*>(idx + q));
    w1 = __ldcs(reinterpret_cast<const uint4*>(idx + q + 4));
  } else {
    w0 = *reinterpret_cast<const uint4*>(idx + q);
    w1 = *reinterpret_cast<const uint4*>(idx + q + 4);
  }
  s.w[0] = w0.x; s.w[1] = w0.y; s.w[2] = w0.z; s.w[3] = w0.w;
  s.w[4] = w1.x; s.w[5] = w1.y; s.w[6] = w1.z; s.w[7] = w1.w;
  if constexpr (kVals) {
    float4 v0, v1;
    if constexpr (kOnce) {
      v0 = __ldcs(reinterpret_cast<const float4*>(vals + q));
      v1 = __ldcs(reinterpret_cast<const float4*>(vals + q + 4));
    } else {
      v0 = *reinterpret_cast<const float4*>(vals + q);
      v1 = *reinterpret_cast<const float4*>(vals + q + 4);
    }
    s.v[0] = v0.x; s.v[1] = v0.y; s.v[2] = v0.z; s.v[3] = v0.w;
    s.v[4] = v1.x; s.v[5] = v1.y; s.v[6] = v1.z; s.v[7] = v1.w;
  }
}

// A thread's 8 elements after their segment lookup (col[k] the x offset of
// element k's segment, -1 for an element not walked; row[k] its y offset):
// the word's column and row added, x gathered, the products formed and
// runs of equal rows summed. The middle runs reach y at once; the first
// and the last are left for the fold across lanes (fold_lanes). kAll: every
// element is walked, and no col is read for -1.
template <Op kOp, bool kVals, bool kAll>
__device__ __forceinline__ void walk_vector(
    const float* __restrict__ x, Stored<kOp>* __restrict__ y,
    int (&col)[kVec], int (&row)[kVec], const Stream8<kVals>& s,
    unsigned mask, int col_bits, int& first_row, Stored<kOp>& first_acc,
    int& last_row, Stored<kOp>& last_acc) {
  using Acc = Stored<kOp>;
  float xv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (!kAll && col[k] < 0) continue;
    col[k] += static_cast<int>(s.w[k] & mask);
    row[k] += static_cast<int>(s.w[k] >> col_bits);
    xv[k] = gather_x(x, col[k]);
  }
  int runs = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (!kAll && col[k] < 0) continue;
    Acc g;
    if constexpr (!kVals)      // every stored value is nonzero
      g = xv[k] != 0.f ? 1.f : 0.f;
    else
      g = glt::product<kOp>(s.v[k], xv[k]);
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

// The lanes' first and last runs of a pass: the first joins the previous
// lane's last run when the rows match, and the last runs fold across the
// warp, one atomic per run head. A lane that walked nothing passes rows of
// -1. All 32 lanes call it together.
template <Op kOp>
__device__ __forceinline__ void fold_lanes(Stored<kOp>* __restrict__ y,
                                           int first_row,
                                           Stored<kOp> first_acc,
                                           int last_row,
                                           Stored<kOp> last_acc) {
  using Acc = Stored<kOp>;
  using Fold = typename std::conditional<kOp == Op::kAddMin, glt::FoldMax,
                                         glt::FoldAdd>::type;
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
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

// blocks[b] = (e0, e1, g0, g1): elements [e0, e1) of segments [g0, g1);
// deps[g] = (first element, x offset, y offset, activity flag). The grid
// is at most nblocks; block i walks rows i, i + gridDim.x, ...
template <Op kOp, bool kVals>
__global__ void __launch_bounds__(kFusedThreads) router_fused_kernel(
    const int4* __restrict__ blocks, const int4* __restrict__ deps,
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ x, Stored<kOp>* __restrict__ y, int nblocks,
    int max_segments, int col_bits) {
  using Acc = Stored<kOp>;
  extern __shared__ int4 tables[];   // two tables of max_segments records
  const unsigned mask = (1u << col_bits) - 1u;
  const int t8 = kVec * static_cast<int>(threadIdx.x);
  int at = blockIdx.x;
  int4 b = blocks[at];
  int4* table = tables;
  glt::stage_records(table, deps, b, kFusedThreads);
  int base = b.x & ~(kVec - 1);
  Stream8<kVals> cur, ahead;
  if (base + t8 < b.y) load_stream<kVals, true>(cur, idx, vals, base + t8);
  at += gridDim.x;
  int4 next = at < nblocks ? blocks[at] : b;
  glt::cp_async_wait_all();
  __syncthreads();
  // every bound below is uniform across the block, so every lane reaches
  // the shuffles and the barriers
  for (;;) {
    // the next pass: the row's own, or the first of the block's next row,
    // whose records go to the other table
    int next_base = base + kPass, next_end = b.y;
    const bool last = next_base >= b.y;
    const bool more = !last || at < nblocks;
    if (last && more) {
      next_base = next.x & ~(kVec - 1);
      next_end = next.y;
      glt::stage_records(table == tables ? tables + max_segments : tables,
                         deps, next, kFusedThreads);
    }
    if (more && next_base + t8 < next_end)
      load_stream<kVals, true>(ahead, idx, vals, next_base + t8);
    // this pass, over the loads issued a pass ago
    const int q = base + t8;
    int first_row = -1, last_row = -1;
    Acc first_acc = 0, last_acc = 0;
    if (q < b.y) {
      const int ns = b.w - b.z;
      int col[kVec], row[kVec];
      int j = glt::find_record(table, ns, max(q, b.x));
      const int4 r = table[j];
      const int end = j + 1 < ns ? min(table[j + 1].x, b.y) : b.y;
      if (q >= b.x && q + kVec <= end) {
        // the 8 elements lie in one segment (segments of the row forms
        // hold thousands): one lookup for all, no test an element
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          col[k] = r.y;
          row[k] = r.z;
        }
        walk_vector<kOp, kVals, true>(x, y, col, row, cur, mask, col_bits,
                                      first_row, first_acc, last_row,
                                      last_acc);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int e = q + k;
          col[k] = -1;
          if (e < b.x || e >= b.y) continue;
          while (j + 1 < ns && table[j + 1].x <= e) ++j;
          col[k] = table[j].y;
          row[k] = table[j].z;
        }
        walk_vector<kOp, kVals, false>(x, y, col, row, cur, mask, col_bits,
                                       first_row, first_acc, last_row,
                                       last_acc);
      }
    }
    fold_lanes<kOp>(y, first_row, first_acc, last_row, last_acc);
    if (!more) return;
    if (last) {
      b = next;
      table = table == tables ? tables + max_segments : tables;
      at += gridDim.x;
      if (at < nblocks) next = blocks[at];
      glt::cp_async_wait_all();
      __syncthreads();
    }
    base = next_base;
    cur = ahead;
  }
}

// The predicated walk: a block per row of `blocks`.
template <Op kOp, bool kVals>
__global__ void __launch_bounds__(kFusedThreads) router_fused_pred_kernel(
    const int4* __restrict__ blocks, const int4* __restrict__ deps,
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ x, Stored<kOp>* __restrict__ y,
    const uint8_t* __restrict__ act, int max_segments, int col_bits) {
  using Acc = Stored<kOp>;
  extern __shared__ int seg[];     // start, x offset, y offset of each
  int* s_start = seg;
  int* s_x = seg + max_segments;
  int* s_y = seg + 2 * max_segments;
  const int4 b = blocks[blockIdx.x];
  const int ns = b.w - b.z;
  // an inactive segment's elements: unread
  const bool live = glt::load_segments(b, deps, act, kFusedThreads, s_start,
                                       s_x, s_y);
  if (!__syncthreads_or(live)) return;
  const unsigned mask = (1u << col_bits) - 1u;
  // the loop bound is uniform across the block, so every lane reaches
  // the shuffles
  for (int base = b.x & ~(kVec - 1); base < b.y; base += kPass) {
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
        Stream8<kVals> s;
        load_stream<kVals, false>(s, idx, vals, q);
        walk_vector<kOp, kVals, false>(x, y, col, row, s, mask, col_bits,
                                       first_row, first_acc, last_row,
                                       last_acc);
      }
    }
    fold_lanes<kOp>(y, first_row, first_acc, last_row, last_acc);
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

// Dynamic shared memory above the default 48 KB only after an opt-in,
// which holds for the current card alone (the caller makes the stream's
// card current), so it is made on every such launch, and its refusal is
// returned before the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// K3 (and K11) over `ngroups` groups. An empty table (no flushed chunk)
// launches nothing and reads no pointer.
int run_reduce(const void* groups, const void* order, const void* stream_in,
               const void* c_hi, const void* c_lo, void* y, int ngroups,
               int region_rows, void* cuda_stream) {
  if (ngroups < 0 || region_rows < 128 || region_rows % 128 != 0 ||
      region_rows > kMaxRegionRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups == 0) return static_cast<int>(cudaGetLastError());
  // the tile
  const size_t smem = sizeof(float) * static_cast<size_t>(region_rows);
  const cudaError_t err = allow_smem(router_reduce_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  router_reduce_kernel<<<static_cast<unsigned>(ngroups), kReduceThreads,
                         smem, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int4*>(groups), static_cast<const int*>(order),
      static_cast<const float*>(stream_in), static_cast<const int8_t*>(c_hi),
      static_cast<const int8_t*>(c_lo), static_cast<float*>(y), region_rows);
  return static_cast<int>(cudaGetLastError());
}

int run_reduce_pred(const void* c_code, const void* stream_in,
                    const void* c_hi, const void* c_lo, void* y,
                    const void* live, int nchunks, int region_rows,
                    void* cuda_stream) {
  if (nchunks > 0) {
    router_reduce_pred_kernel<<<static_cast<unsigned>(nchunks), kThreads, 0,
                                static_cast<cudaStream_t>(cuda_stream)>>>(
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

// The unpredicated walk's grid: the blocks the card holds at once, from
// the device's SM count and the kernel's occupancy with `smem` bytes of
// shared table, found on the first launch of each card and table size.
template <Op kOp, bool kVals>
int resident_blocks(size_t smem, int& blocks) {
  struct Plan {
    int device = -1;
    size_t smem = 0;
    int blocks = 0;
  };
  static thread_local Plan plan;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device != plan.device || smem != plan.smem)) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, router_fused_kernel<kOp, kVals>, kFusedThreads, smem);
    if (err == cudaSuccess) plan = Plan{device, smem, sms * per_sm};
  }
  blocks = plan.blocks;
  return static_cast<int>(err);
}

template <Op kOp, bool kVals, bool kPred>
int launch_fused(const void* blocks, const void* deps, const void* vals,
                 const void* idx, const void* x, void* y, const void* act,
                 int nblocks, int max_segments, int col_bits,
                 cudaStream_t st) {
  const auto b = static_cast<const int4*>(blocks);
  const auto d = static_cast<const int4*>(deps);
  const auto v = static_cast<const float*>(vals);
  const auto w = static_cast<const unsigned*>(idx);
  const auto xs = static_cast<const float*>(x);
  const auto out = static_cast<Stored<kOp>*>(y);
  if constexpr (kPred) {
    const size_t smem = 3 * sizeof(int) * static_cast<size_t>(max_segments);
    const cudaError_t err =
        allow_smem(router_fused_pred_kernel<kOp, kVals>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    router_fused_pred_kernel<kOp, kVals><<<nblocks, kFusedThreads, smem,
                                           st>>>(
        b, d, v, w, xs, out, static_cast<const uint8_t*>(act), max_segments,
        col_bits);
  } else {
    // two tables of whole records: the current row's and the next one's
    const size_t smem = 2 * sizeof(int4) * static_cast<size_t>(max_segments);
    const cudaError_t err = allow_smem(router_fused_kernel<kOp, kVals>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int grid = 0;
    const int rc = resident_blocks<kOp, kVals>(smem, grid);
    if (rc != 0) return rc;
    // a table too large for an SM holds no block: the empty grid's launch
    // is refused and its error returned
    router_fused_kernel<kOp, kVals><<<grid < nblocks ? grid : nblocks,
                                      kFusedThreads, smem, st>>>(
        b, d, v, w, xs, out, nblocks, max_segments, col_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kPred>
int dispatch_fused(const void* blocks, const void* deps, const void* vals,
                   const void* idx, const void* x, void* y, const void* act,
                   int nblocks, int max_segments, int col_bits, int op,
                   cudaStream_t st) {
  auto fn = vals == nullptr ? launch_fused<Op::kAndOr, false, kPred>
      : op == 2 ? launch_fused<Op::kAddMin, true, kPred>
      : op == 1 ? launch_fused<Op::kAndOr, true, kPred>
                : launch_fused<Op::kMulAdd, true, kPred>;
  return fn(blocks, deps, vals, idx, x, y, act, nblocks, max_segments,
            col_bits, st);
}

// `op` is semiring.OpType (0 MULADD, 1 ANDOR: a float y; 2 ADDMIN: an
// int32 out of encodings). A null `vals` is the ANDOR form without values
// (op must be 1). A null `act` takes the unpredicated walk.
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
  const auto st = static_cast<cudaStream_t>(cuda_stream);
  return act == nullptr
      ? dispatch_fused<false>(blocks, deps, vals, idx, x, y, act, nblocks,
                              max_segments, col_bits, op, st)
      : dispatch_fused<true>(blocks, deps, vals, idx, x, y, act, nblocks,
                             max_segments, col_bits, op, st);
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

// K3, and K11 over a PERM-C layout's position-keyed c_hi/c_lo: groups and
// order are the engine's region-group table (ops/router.reduce_groups,
// (ngroups, 4) and (nlive,) int32); the stream is 16-byte aligned.
extern "C" int glt_router_reduce(
    const void* groups, const void* order, const void* stream_in,
    const void* c_hi, const void* c_lo, void* y, int ngroups,
    int region_rows, void* cuda_stream) {
  return run_reduce(groups, order, stream_in, c_hi, c_lo, y, ngroups,
                    region_rows, cuda_stream);
}

extern "C" int glt_router_reduce_pred(
    const void* c_code, const void* stream_in, const void* c_hi,
    const void* c_lo, void* y, const void* live, int nchunks,
    int region_rows, void* cuda_stream) {
  return run_reduce_pred(c_code, stream_in, c_hi, c_lo, y, live, nchunks,
                         region_rows, cuda_stream);
}

// K1, K4 fused and the tropical walk, the persistent walk over `nblocks`
// rows: `op` is semiring.OpType, as K4 scatter takes it (0 MULADD, 1
// ANDOR: y float32; 2 ADDMIN: y an int32 out of encodings, zeroed).
extern "C" int glt_router_fused(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* y, int nblocks, int max_segments, int col_bits,
    int op, void* cuda_stream) {
  return run_fused(blocks, deps, vals, idx, x, y, nullptr, nblocks,
                   max_segments, col_bits, op, cuda_stream);
}

// K1p: act is the (num_cols/128,) uint8 page activity; K4p fused and the
// predicated tropical walk: the (num_cols/1024,) uint8 tile activity. Each
// segment's flag indexes it. A block per row.
extern "C" int glt_router_fused_pred(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* y, const void* act, int nblocks, int max_segments,
    int col_bits, int op, void* cuda_stream) {
  return run_fused(blocks, deps, vals, idx, x, y, act, nblocks,
                   max_segments, col_bits, op, cuda_stream);
}
