// Planar-router SpMV kernels for Hopper (sm_90a): K4 scatter and its
// frontier-predicated form K4p scatter (the `sm`/`na` launch of
// router_pallas.py:1765), and K5 xperm. K4 fused and K4p fused run K1's
// kernel (router_spmv.cu) over row-sorted element forms that the engine
// derives from the layout at init (ops/planar.py). Built by
// graphlily_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface; ops/planar.py binds it with ctypes and holds each
// kernel against its plain PyTorch version. The split branch reduces K4's
// flush stream with K3 (router_spmv.cu) or K11 (permc_spmv.cu). K4
// scatter and K4p scatter in ADDMIN mode are pass 1 of the tropical
// engine's three-pass stages (ops/tropical.py: then K8 or K9 and K10,
// tropical_spmv.cu), which no app path launches: its SpMV and SpMSpV run
// K1's kernel in ADDMIN mode over pass 1's row and tile forms.
//
// What K4 computes (the PlanarSpMVLayout arrays of its Pallas twin in
// graphlily_tpu/ops/router_pallas.py; io/planar_format.py documents the
// words):
//
//   gathered product  g[c, s, l] = val[c, s, l] (x) x[col(c, s, l)] with
//                     r = a_r[c, s, l] and, for the "free" deal,
//                     col = a_page[c]*1024 + a_sub[c, s, r]*128 + r;
//                     for the "bucket" deal col indexes K5's re-laid x2,
//                     x2[a_page[c]*1024 + s*128 + r].
//                     ANDOR: g = (val != 0 && x != 0) as 0/1; ADDMIN:
//                     g = INF_BITS - bits(min(val + x, FLOAT_INF)), int32.
//   deposit piece     rg[t, j] = (w1, w2), w2 > 0: chunk k = w1 & 0xFF.
//   (t, j)            Sublane s's triple-run word a0 | d0<<7 | n<<14 moves
//                     g[t*cb + k, s, (a0+i) & 127] to flush-stream chunk
//                     target[t, j], element s*128 + d0 + i, for i < n.
//
// Order. The Pallas kernels run the grid in order on one core: slots carry
// from step to step, a flush copies and zeroes its slot. CUDA blocks run in
// no order. As for the roll router, the host resolves the order once at
// engine init (io/router_format.deposit_targets reads the planar
// descriptor words unchanged): target[t, j] is the flush-stream chunk of
// the first flush of the piece's slot after it. Pieces of one slot cycle
// fill disjoint lanes (the packer's per-sublane cursors), and a flush
// zeroes its slot, so every flushed element comes from exactly one piece
// and unused elements stay zero: K4 scatter is a set of independent stores
// into a zeroed stream, one writer a slot (no atomics, bit-equal to its
// plain version).
//
// What K4 reads. Not the layout: walking a piece's triple-run words
// chains dependent loads (descriptor -> page -> run words -> lane byte ->
// sublane byte -> x). The engine derives at init the store form
// (ops/router.router_entries, order "stream"): every deposited element
// once, in piece order, as its f32 value and one int32 word
// (column within its 1024-column tile | slot within its target flush
// chunk << 10), and one record a piece (first element, x offset
// tile*1024, stream offset target*1024, activity flag: the tile). A
// "bucket" element's x2 slot is resolved to its x column at init
// (PlanarSpMV.x_columns), so K4 no longer needs K5.
//
// Predication (K4p scatter). A planar A-chunk mixes the 8 pages of its
// column tile, so activity is per 1024-column tile (act[tile],
// PlanarSpMV._normalize_act). A piece of an inactive tile gathers only the
// semiring zero's products (for ADDMIN x = FLOAT_INF, encoded 0): K4p skips
// it, so its stream elements stay zero, and the split branch's K3p skips
// the flush chunks no live piece targets. The grid is the full one; a
// block none of whose pieces is live exits after reading its records. K5
// is unchanged.

#include <cstdint>

#include <cuda_runtime.h>

#include "segments.cuh"
#include "semiring_product.cuh"

namespace {

// The semiring's (x) and what a stream element holds (float, or the int32
// encoding for ADDMIN): semiring_product.cuh, shared with K1's kernel.
using glt::Op;
using glt::product;
using glt::Stored;

constexpr int kChunk = 1024;
constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;            // elements per lane and warp pass
constexpr int kZeroChunks = 16;    // flush chunks a zeroing block covers

// ---------------------------------------------------------------------------
// K4 scatter and K4p scatter. Replace _planar_scatter_call with the bodies
// _make_planar_kernel / _make_planar_kernel_looped(fuse=False)
// (graphlily_tpu/ops/router_pallas.py:1398 -> pallas_call :1429, :981,
// :1190), and with `sm`/`na` (:1765): phase A (the gather) and phase B
// (plane deposits into K-rotated slots, flush = copy + zero) into the
// (nsteps, f, 8, 128) flush stream. ADDMIN is the tropical pass 1
// (_planar_scatter_call with op=ADDMIN, router_pallas.py:1403-1405).
// Bound on the H100: device memory, 12 B an element (8 read from the form,
// 4 stored), plus the zeros of the stream's unfilled lanes; x (6.5 MB on
// the pokec stand-in) is read from L2, one 4 KB tile a piece.
// Design: the grid is the form's block table (ENTRIES_PER_BLOCK
// consecutive elements a block). A block loads its pieces' records into
// shared memory; each warp takes 256 consecutive elements a pass, lane l
// the elements l, l + 32, ..., l + 224, so every load of values and words
// and, as a piece's elements run in sublane and lane order, every store
// of one warp instruction covers 32 neighbouring 4-byte slots. Each lane
// finds its first element's piece by a binary search and the rest by a
// forward walk, gathers x and stores each product to its slot: one writer
// a slot, so no atomics and no shuffles. (A first design gave each
// thread 8 consecutive elements with 16-byte loads, as K1 does; its
// stores then spread a warp instruction over 32 sectors and it ran at
// about 1.2 TB/s, PERF.md §6.)
// Zeros. The elements of a flush chunk fill lanes [0, tails[c*8 + s]) of
// each sublane s (the packers' per-sublane cursors; the form checks it at
// init). Unpredicated, the grid's last blocks write the zeros of the other
// lanes, kZeroChunks chunks a block, 16 B a thread and chunk, so the
// wrapper need not zero the whole stream first (the flush stream is 23%
// unfilled lanes on the pokec stand-in; one chunk a block cost more in
// block launches than the lanes' bytes, PERF.md §6). K4p scatter leaves a
// dead piece's lanes alone, so its wrapper zeroes the stream (tails null,
// no zero blocks).
template <Op kOp>
__global__ void __launch_bounds__(kThreads) planar_store_kernel(
    const int4* __restrict__ blocks, const int4* __restrict__ deps,
    const float* __restrict__ vals, const unsigned* __restrict__ idx,
    const float* __restrict__ x, Stored<kOp>* __restrict__ stream,
    const uint8_t* __restrict__ act, const uint8_t* __restrict__ tails,
    int nblocks, int nchunks, int max_segments, int col_bits) {
  if (static_cast<int>(blockIdx.x) >= nblocks) {   // chunks' zeros
    const long long c0 =
        (static_cast<long long>(blockIdx.x) - nblocks) * kZeroChunks;
    const int s = threadIdx.x >> 5;
    const int l = (threadIdx.x & 31) * 4;
    for (long long c = c0; c < c0 + kZeroChunks && c < nchunks; ++c) {
      const int fill = tails[c * kSub + s];
      Stored<kOp>* row = stream + c * kChunk + s * kLanes + l;
      if (l >= fill) {
        *reinterpret_cast<int4*>(row) = make_int4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (l + k >= fill) row[k] = Stored<kOp>(0);
      }
    }
    return;
  }
  extern __shared__ int seg[];     // start, x offset, stream offset of each
  int* s_start = seg;
  int* s_x = seg + max_segments;
  int* s_out = seg + 2 * max_segments;
  const int4 b = blocks[blockIdx.x];
  const int ns = b.w - b.z;
  const bool live = glt::load_segments(b, deps, act, kThreads, s_start, s_x,
                                       s_out);
  if (act != nullptr) {
    if (!__syncthreads_or(live)) return;
  } else {
    __syncthreads();
  }
  const unsigned mask = (1u << col_bits) - 1u;
  const int lane = static_cast<int>(threadIdx.x & 31);
  constexpr int kSpan = 32 * kVec;           // elements of a warp pass
  for (int q = b.x + static_cast<int>(threadIdx.x >> 5) * kSpan + lane;
       q < b.y; q += kWarps * kSpan) {
    int col[kVec], slot[kVec];
    bool any = false;
    int j = glt::find_segment(s_start, ns, q);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int e = q + 32 * k;
      col[k] = -1;
      if (e >= b.y) continue;
      while (j + 1 < ns && s_start[j + 1] <= e) ++j;
      col[k] = s_x[j];
      slot[k] = s_out[j];
      any |= col[k] >= 0;
    }
    if (!any) continue;
    unsigned w[kVec];
    float v[kVec], xv[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (col[k] < 0) continue;
      w[k] = idx[q + 32 * k];
      v[k] = vals[q + 32 * k];
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (col[k] < 0) continue;
      xv[k] = __ldg(x + col[k] + static_cast<int>(w[k] & mask));
      slot[k] += static_cast<int>(w[k] >> col_bits);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (col[k] >= 0) stream[slot[k]] = product<kOp>(v[k], xv[k]);
  }
}

// ---------------------------------------------------------------------------
// K5 xperm. Replaces _xperm_call / _xperm_call_padded with the body
// _make_xperm_kernel (router_pallas.py:924, :951, :880): the static
// per-tile column re-layout of x for "bucket" layouts,
// x2[t, d, l] = x[t, s, v & 127] where xperm[t, s, d, l] = v < 0, and 0
// where no source plane takes (the last taking plane wins, as in the
// Pallas body's where-chain). No app path launches it since K4 fused, K4
// scatter and their predicated forms read x columns resolved at init;
// `PlanarSpMV.xperm` keeps it as the "bucket" layout's x2.
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

template <Op kOp>
int launch_store(const void* blocks, const void* deps, const void* vals,
                 const void* idx, const void* x, void* stream_out,
                 const void* act, const void* tails, int nblocks,
                 int max_segments, int col_bits, int nchunks,
                 cudaStream_t st) {
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(max_segments);
  auto kernel = planar_store_kernel<kOp>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(nblocks)
      + (tails != nullptr ? blocks_for(nchunks, kZeroChunks) : 0u);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int4*>(blocks), static_cast<const int4*>(deps),
      static_cast<const float*>(vals), static_cast<const unsigned*>(idx),
      static_cast<const float*>(x), static_cast<Stored<kOp>*>(stream_out),
      static_cast<const uint8_t*>(act), static_cast<const uint8_t*>(tails),
      nblocks, nchunks, max_segments, col_bits);
  return static_cast<int>(cudaGetLastError());
}

int run_store(const void* blocks, const void* deps, const void* vals,
              const void* idx, const void* x, void* stream_out,
              const void* act, const void* tails, int nblocks,
              int max_segments, int col_bits, int nchunks, int op,
              void* cuda_stream) {
  // a form with no elements (an empty matrix) has no block, and its empty
  // value tensor may have a null pointer
  if (op < 0 || op > 2 || nblocks < 0 || max_segments < 0 || col_bits < 1 ||
      col_bits > 31 || nchunks < 0 || (vals == nullptr && nblocks > 0) ||
      (act != nullptr && tails != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblocks == 0 && (tails == nullptr || nchunks == 0))
    return static_cast<int>(cudaGetLastError());
  auto fn = op == 2 ? launch_store<Op::kAddMin>
      : op == 1 ? launch_store<Op::kAndOr> : launch_store<Op::kMulAdd>;
  return fn(blocks, deps, vals, idx, x, stream_out, act, tails, nblocks,
            max_segments, col_bits, nchunks,
            static_cast<cudaStream_t>(cuda_stream));
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 = launched).
// K4 scatter takes the store form of ops/router.router_entries (order
// "stream"): blocks (nblocks, 4) and deps (segments, 4) int32, vals float32
// and idx int32 in storage padded to a multiple of 8 elements, and its
// tails, the (nchunks*8,) uint8 filled lanes of each (flush chunk,
// sublane), with which it writes every element of the (nchunks, 8, 128)
// stream; with null tails, and always for K4p scatter, the caller zeroes
// the stream. `op` is semiring.OpType (0 MULADD, 1 ANDOR: a float stream;
// 2 ADDMIN: an int32 stream of encodings).

extern "C" int glt_planar_scatter(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* stream_out, const void* tails, int nblocks,
    int max_segments, int col_bits, int nchunks, int op, void* cuda_stream) {
  return run_store(blocks, deps, vals, idx, x, stream_out, nullptr, tails,
                   nblocks, max_segments, col_bits, nchunks, op,
                   cuda_stream);
}

// K4p scatter: act is the (num_col_tiles,) uint8 tile activity, indexed by
// each piece's flag.
extern "C" int glt_planar_scatter_pred(
    const void* blocks, const void* deps, const void* vals, const void* idx,
    const void* x, void* stream_out, const void* act, int nblocks,
    int max_segments, int col_bits, int op, void* cuda_stream) {
  return run_store(blocks, deps, vals, idx, x, stream_out, act, nullptr,
                   nblocks, max_segments, col_bits, 0, op, cuda_stream);
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
