// Native PERM-C element-wise greedy for graphlily_tpu_torch.
//
// The port's copy of graphlily_tpu/native/permc_greedy.cpp: a sequential
// C++ twin of io/permc_format._greedy_permc_py (bit-identical;
// tests/test_torch_permc.py compares every output). The greedy is an
// inherently sequential element loop (per-chunk claims + per-region cycle
// windows with cap-1/contiguous lo ownership) that takes numpy tens of
// microseconds an element, a quarter of an hour for a 30M-edge graph;
// compiled, the same loop takes about a minute. Built with g++ at first use
// by
// graphlily_tpu_torch/native/__init__.py and loaded with ctypes.
//
// Protocol (ctypes, single call):
//   ok = glt_permc_greedy(tile, rho, sig, row, region, lo, n, ntiles,
//                         nregions, depth, chunk_of_or_null, nca_in,
//                         a_chunk, sub_of, cyc_of, pos_of,
//                         fl_chunk, fl_region, fl_cycle,
//                         dr_region, dr_cycle, counts[3])
// counts = {nca, n_flush_events, n_drains}. Flush events are bounded by n
// (one per element's failed first attempt); drains by nregions*depth.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t S = 8, L = 128, CHUNK = 1024;

struct PermcState {
    int64_t nregions, depth;
    // per region: rotating window of `depth` cycles; cycle d (logical)
    // lives at physical slot (base[r] + d) % depth
    std::vector<int32_t> cursor;    // [r][phys][s]
    std::vector<int64_t> lo_owner;  // [r][phys][s][L]
    std::vector<int64_t> last_row;  // [r][phys][s]
    std::vector<int32_t> base;      // [r]
    std::vector<int64_t> cycle;     // [r]

    PermcState(int64_t nr, int64_t dep)
        : nregions(nr), depth(dep),
          cursor(nr * dep * S, 0),
          lo_owner(nr * dep * S * L, -1),
          last_row(nr * dep * S, -1),
          base(nr, 0), cycle(nr, 0) {}

    inline int64_t phys(int64_t r, int64_t d) const {
        return (base[r] + d) % depth;
    }
    inline int32_t& cur(int64_t r, int64_t p, int64_t s) {
        return cursor[(r * depth + p) * S + s];
    }
    inline int64_t& own(int64_t r, int64_t p, int64_t s, int64_t v) {
        return lo_owner[((r * depth + p) * S + s) * L + v];
    }
    inline int64_t& lastr(int64_t r, int64_t p, int64_t s) {
        return last_row[(r * depth + p) * S + s];
    }
};

struct Greedy {
    const int64_t *tile, *rho, *sig, *row, *region, *lo;
    int64_t n, ntiles, nregions, depth;
    int64_t* a_chunk;
    int64_t* sub_of;
    int64_t* cyc_of;
    int64_t* pos_of;
    int64_t *fl_chunk, *fl_region, *fl_cycle;
    int64_t nf = 0;
    PermcState st;
    int8_t claims[S * L];
    int32_t alane[S];
    int64_t next_chunk = 0;

    Greedy(const int64_t** in, int64_t n_, int64_t nt, int64_t nr,
           int64_t dep, int64_t** out)
        : tile(in[0]), rho(in[1]), sig(in[2]), row(in[3]), region(in[4]),
          lo(in[5]), n(n_), ntiles(nt), nregions(nr), depth(dep),
          a_chunk(out[0]), sub_of(out[1]), cyc_of(out[2]), pos_of(out[3]),
          fl_chunk(out[4]), fl_region(out[5]), fl_cycle(out[6]),
          st(nr, dep) {}

    void flush(int64_t r, int64_t ch) {
        fl_chunk[nf] = ch;
        fl_region[nf] = r;
        fl_cycle[nf] = st.cycle[r];
        ++nf;
        // pop logical cycle 0: clear its physical slot, advance the base
        int64_t p0 = st.base[r];
        for (int64_t s = 0; s < S; ++s) {
            st.cur(r, p0, s) = 0;
            st.lastr(r, p0, s) = -1;
        }
        std::memset(&st.lo_owner[(r * depth + p0) * S * L], -1,
                    sizeof(int64_t) * S * L);
        st.base[r] = (int32_t)((p0 + 1) % depth);
        st.cycle[r] += 1;
    }

    // returns true if placed, false -> caller spills the element
    bool place(int64_t i, int64_t ch) {
        const int64_t r = region[i], h = rho[i], g = sig[i], v = lo[i];
        const int64_t rw = row[i];
        for (int attempt = 0; attempt < 2; ++attempt) {
            int64_t best_d = -1, best_s = -1;
            int64_t best_cost = (int64_t)1 << 30;
            bool claim_ok = false;
            for (int64_t s = 0; s < S; ++s) {
                int8_t cl = claims[s * L + h];
                if ((cl != -1 && cl != (int8_t)g) || alane[s] >= L)
                    continue;
                claim_ok = true;
                for (int64_t d = 0; d < depth; ++d) {
                    int64_t p = st.phys(r, d);
                    int32_t cu = st.cur(r, p, s);
                    if (cu >= L) continue;
                    int64_t ow = st.own(r, p, s, v);
                    if (ow == rw) {
                        if (st.lastr(r, p, s) != rw) continue;
                    } else if (ow != -1) {
                        continue;
                    }
                    int64_t cost = d * 1000 + cu;
                    if (cost < best_cost) {
                        best_d = d;
                        best_s = s;
                        best_cost = cost;
                    }
                    break;   // earlier cycle preferred per sublane
                }
            }
            if (best_s >= 0) {
                claims[best_s * L + h] = (int8_t)g;
                alane[best_s] += 1;
                int64_t p = st.phys(r, best_d);
                pos_of[i] = st.cur(r, p, best_s);
                st.cur(r, p, best_s) += 1;
                st.own(r, p, best_s, v) = rw;
                st.lastr(r, p, best_s) = rw;
                a_chunk[i] = ch;
                sub_of[i] = best_s;
                cyc_of[i] = st.cycle[r] + best_d;
                return true;
            }
            if (attempt == 0 && claim_ok) {
                flush(r, ch);
                continue;
            }
            break;
        }
        return false;
    }

    // place one chunk's elements; unplaced indices appended to `spill`
    void place_chunk(int64_t ch, const int64_t* elems, int64_t cnt,
                     std::vector<int64_t>& spill) {
        std::memset(claims, -1, sizeof(claims));
        std::memset(alane, 0, sizeof(alane));
        for (int64_t e = 0; e < cnt; ++e)
            if (!place(elems[e], ch)) spill.push_back(elems[e]);
    }

    // re-windowing rounds over a pending list; chunk ids from `alloc`:
    // sequential (pass 1) or K-per-step spaced (pass-2 residual spills:
    // a spill window touches ~every region, so cb of them in one step
    // blows dstep — see io/permc_format.py)
    int64_t spill_base = 0, spill_cb = 8, spill_k = 1, spill_j = 0;
    bool spaced = false;
    int64_t alloc() {
        if (!spaced) return next_chunk++;
        int64_t j = spill_j++;
        return spill_base + (j / spill_k) * spill_cb + (j % spill_k);
    }
    bool run_rounds(std::vector<int64_t>& pend) {
        int guard = 0;
        while (!pend.empty()) {
            if (++guard >= 64) return false;
            std::vector<int64_t> nxt;
            for (size_t w0 = 0; w0 < pend.size(); w0 += CHUNK) {
                int64_t cnt = std::min((int64_t)(pend.size() - w0), CHUNK);
                place_chunk(alloc(), &pend[w0], cnt, nxt);
            }
            pend.swap(nxt);
        }
        return true;
    }
};

}  // namespace

extern "C" int64_t glt_permc_greedy(
    const int64_t* tile, const int64_t* rho, const int64_t* sig,
    const int64_t* row, const int64_t* region, const int64_t* lo,
    int64_t n, int64_t ntiles, int64_t nregions, int64_t depth,
    const int64_t* chunk_of, int64_t nca_in, int64_t spill_cb,
    int64_t* a_chunk, int64_t* sub_of, int64_t* cyc_of, int64_t* pos_of,
    int64_t* fl_chunk, int64_t* fl_region, int64_t* fl_cycle,
    int64_t* dr_region, int64_t* dr_cycle, int64_t* counts) {
    const int64_t* in[6] = {tile, rho, sig, row, region, lo};
    int64_t* out[7] = {a_chunk, sub_of, cyc_of, pos_of,
                       fl_chunk, fl_region, fl_cycle};
    Greedy gr(in, n, ntiles, nregions, depth, out);

    if (chunk_of) {
        // pass 2: prescribed chunks (stable order within chunk = original
        // index order), residual spills re-window per tile after nca_in
        std::vector<int64_t> cnt((size_t)nca_in + 1, 0);
        int64_t maxid = 0;
        for (int64_t i = 0; i < n; ++i) maxid = std::max(maxid, chunk_of[i]);
        if (maxid >= nca_in) cnt.resize((size_t)maxid + 2, 0);
        for (int64_t i = 0; i < n; ++i) cnt[chunk_of[i] + 1]++;
        for (size_t c = 1; c < cnt.size(); ++c) cnt[c] += cnt[c - 1];
        std::vector<int64_t> order(n);
        {
            std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
            for (int64_t i = 0; i < n; ++i) order[cur[chunk_of[i]]++] = i;
        }
        std::vector<int64_t> spilled;
        int64_t pos = 0;
        while (pos < n) {
            int64_t ch = chunk_of[order[pos]];
            int64_t end = pos;
            while (end < n && chunk_of[order[end]] == ch) ++end;
            gr.place_chunk(ch, &order[pos], end - pos, spilled);
            pos = end;
        }
        gr.spaced = true;
        gr.spill_base = nca_in;
        gr.spill_cb = std::max(spill_cb, (int64_t)1);
        gr.spill_k = std::max((int64_t)1, gr.spill_cb / 8);
        // spilled is in (chunk, index) order; regroup per tile ascending
        // (matches python: sorted element ids are (tile, row, col) order)
        std::sort(spilled.begin(), spilled.end());
        size_t s0 = 0;
        while (s0 < spilled.size()) {
            size_t s1 = s0;
            while (s1 < spilled.size()
                   && tile[spilled[s1]] == tile[spilled[s0]]) ++s1;
            std::vector<int64_t> pend(spilled.begin() + s0,
                                      spilled.begin() + s1);
            if (!gr.run_rounds(pend)) return 0;
            s0 = s1;
        }
    } else {
        // pass 1: per tile, 1024-element rank windows + spill rounds
        std::vector<int64_t> tcnt(ntiles + 1, 0);
        for (int64_t i = 0; i < n; ++i) tcnt[tile[i] + 1]++;
        for (int64_t t = 0; t < ntiles; ++t) tcnt[t + 1] += tcnt[t];
        for (int64_t t = 0; t < ntiles; ++t) {
            std::vector<int64_t> pend;
            pend.reserve(tcnt[t + 1] - tcnt[t]);
            for (int64_t i = tcnt[t]; i < tcnt[t + 1]; ++i) pend.push_back(i);
            if (!gr.run_rounds(pend)) return 0;
        }
    }

    // end drain: remaining window cycles in (region, logical cycle) order
    int64_t ndr = 0;
    for (int64_t r = 0; r < nregions; ++r) {
        for (int64_t d = 0; d < depth; ++d) {
            int64_t p = gr.st.phys(r, d);
            int64_t tot = 0;
            for (int64_t s = 0; s < S; ++s) tot += gr.st.cur(r, p, s);
            if (tot > 0) {
                dr_region[ndr] = r;
                dr_cycle[ndr] = gr.st.cycle[r] + d;
                ++ndr;
            }
        }
    }
    counts[0] = chunk_of
        ? (gr.spill_j ? nca_in + ((gr.spill_j + gr.spill_k - 1) / gr.spill_k)
                            * gr.spill_cb
                      : nca_in)
        : gr.next_chunk;
    counts[1] = gr.nf;
    counts[2] = ndr;
    return 1;
}
