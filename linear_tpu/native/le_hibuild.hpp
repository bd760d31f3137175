// Native HIndex (-i 2) build: __createHsArray + _hsSortX_1 + _createYSA +
// XString fill (reference: src/index_util.cpp:719-818, 432-561, 1166-1447,
// sizing :217-237, hash :971-982). Bit-identical twin of the Python build
// in linear_tpu/index/hindex.py (build_hindex/_finalize) — which is the
// difftested oracle — including its documented reference quirks:
//   - thread-chunk bounds affect sampling (chunk list mirrors
//     _thread_chunks, :740-760);
//   - the N-jump that lands one extra emission past the chunk end;
//   - heads are written one emission late (rewritten with preX) and the
//     final flush stamps the chunk's LAST computed XValue;
//   - countMove <= 2 aborts the last group (head + first body zeroed,
//     empty_dir points at the aborted head, bodies stay unsorted);
//   - build YValues spill into bits 61-62 (unmasked make_hs_body).
#pragma once
#include "le_common.hpp"
#include "le_hash.hpp"

#include <algorithm>
#include <functional>
#include <sys/mman.h>
#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace le {

struct HIndexBuild {
    std::vector<u64> ysa;
    // calloc'd: for multi-GB tables calloc maps FRESH ZERO pages without
    // touching them (an explicit zero pass is page-fault bound); only
    // slots the fill writes ever fault in, empty slots read from the
    // shared zero page
    u64* v1 = nullptr;
    i64* v2 = nullptr;
    i64 nv = 0;
    u64 mask = 0;
    i64 empty_dir = 0;
    ~HIndexBuild() {
        std::free(v1);
        std::free(v2);
    }
};

// kernel-speed page population (MADV_POPULATE_WRITE, Linux 5.14+);
// falls back to a first-touch loop. Handles unaligned starts (glibc's
// mmap'd chunks are offset by the malloc header).
static inline void hb_populate(char* p, i64 bytes) {
    if (bytes <= 0) return;
#ifdef MADV_POPULATE_WRITE
    uintptr_t a0 = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
    uintptr_t a1 = ((uintptr_t)p + (uintptr_t)bytes) & ~(uintptr_t)4095;
    if (a1 > a0 &&
        madvise((void*)a0, (size_t)(a1 - a0), MADV_POPULATE_WRITE) == 0) {
        volatile char* q = p;
        q[0] = 0;                  // unaligned head page (zero memory)
        q[bytes - 1] = 0;          // unaligned tail page
        return;
    }
#endif
    volatile char* q = p;
    for (i64 i = 0; i < bytes; i += 4096) q[i] = 0;
    q[bytes - 1] = 0;
}

static const u64 HB_BIT63 = 1ull << 63;
static const u64 HB_STRAND = 1ull << 40;
static const u64 HB_MASK40 = (1ull << 40) - 1;
static const u64 HB_MASK20 = (1ull << 20) - 1;
static const u64 HB_YFIELD = HB_MASK20 << 41;

static inline u64 hb_make_head(u64 ptr, u64 xval) {
    return ((ptr << 40) + xval) & (HB_BIT63 - 1);
}
static inline u64 hb_make_body(u64 yval, u64 gid, u64 pos, int strand) {
    u64 v = ((yval << 41) | HB_BIT63) + (gid << 30) + pos;
    return strand ? (v | HB_STRAND) : v;
}
static inline u64 hb_body_y(u64 v) { return (v >> 41) & HB_MASK20; }

// hashNext (src/shape_extend.cpp:132-168) split in two: the per-position
// state roll (h/crh/x) and the minimizer X/Y extraction. The extraction
// is a pure function of the rolled state, so the build scan runs it only
// at sampled positions (every `step`-th) plus the chunk's final position
// (whose XValue the flush quirk stamps) — ~8x less minimizer math than
// extracting every position, with identical emissions.
static inline void hb_roll(HashStream& st, const u8* seq, i64 it) {
    int s = st.span;
    int span2 = 2 * s;
    u64 mask = (1ull << (span2 - 2)) - 1;
    u64 v2 = seq[it + s - 1];
    st.h = ((st.h & mask) << 2) + v2;
    st.crh = ((st.crh >> 2) & mask) + ((3 - v2) << (span2 - 2));
    st.x += ((i64)v2 - (i64)st.left) << 1;
    st.left = seq[it];
}

static inline void hb_extract_xy(HashStream& st) {
    int span2 = 2 * st.span, weight2 = 2 * st.weight;
    u64 v = (st.x > 0) ? st.h : st.crh;
    st.strand = (st.x > 0) ? 0 : 1;
    u64 xv = (1ull << span2) - 1;
    int t = 0;
    for (int k = 64 - span2; k <= 64 - weight2; k += 2) {
        u64 v1 = (v << k) >> (64 - weight2);
        if (xv > v1) { xv = v1; t = k; }
    }
    st.xval = xv;
    st.yval = ((v >> (64 - t)) << (64 - t - weight2))
              + (v & ((1ull << (64 - t - weight2)) - 1))
              + ((u64)t << (span2 - weight2 - 1));
}

static inline void hb_next_full(HashStream& st, const u8* seq, i64 it) {
    hb_roll(st, seq, it);
    hb_extract_xy(st);
}

// one thread chunk of __createHsArray (exact port of hindex.py
// _chunk_blocks_scalar, :761-794 incl. the N-jump quirk)
static inline void hb_chunk(const u8* seq, i64 n, i64 start, i64 csize,
                            int span, int weight, i64 step, i64 gid,
                            std::vector<u64>& out) {
    HashStream st(span, weight);
    if (st.init(seq, n, start) < 0) return;
    i64 pre_x = -1;
    u64 last_xval = 0;
    bool dirty = false;  // state rolled since the last X/Y extraction
    i64 k = start;
    i64 end = start + csize;
    while (k < end) {
        if (k + span - 1 < n && seq[k + span - 1] == 4) {
            if (dirty) {  // capture the pre-init position's XValue
                hb_extract_xy(st);
                last_xval = st.xval;
                dirty = false;
            }
            i64 skip = st.init(seq, n, k);
            if (skip < 0) break;
            k += skip;
            if (k > csize - span + 1 + start)
                k = csize - (csize + start) % step + step + start;
        }
        if (k + span - 1 >= n) break;
        hb_roll(st, seq, k);
        bool rolled_dirty = true;
        if (k % step == 0) {
            hb_extract_xy(st);
            rolled_dirty = false;
            last_xval = st.xval;
            if ((i64)st.xval != pre_x) {
                if (!out.empty())
                    out[out.size() - 2] = hb_make_head(2, (u64)pre_x);
                out.push_back(hb_make_head(2, pre_x >= 0 ? (u64)pre_x : 0));
                out.push_back(hb_make_body(st.yval, gid, k, st.strand));
                pre_x = (i64)st.xval;
            }
        }
        dirty = rolled_dirty;
        k++;
    }
    if (dirty) {  // flush stamps the LAST position's XValue (quirk)
        hb_extract_xy(st);
        last_xval = st.xval;
    }
    if (!out.empty()) out[out.size() - 2] = hb_make_head(2, last_xval);
}

// _hsSortX_1 + _createYSA + XString fill (hindex.py _finalize)
static inline void hb_finalize(std::vector<u64>& hs, int weight,
                               i64 blocklimit, double alpha, HIndexBuild& b) {
    double t0_ = omp_get_wtime();
    const bool timing_ = getenv("LE_TIMING") != nullptr;
    auto lap_ = [&](const char* name) {
        if (!timing_) return;
        double t = omp_get_wtime();
        fprintf(stderr, "[hb_finalize] %-10s %7.1f ms\n", name, (t - t0_) * 1e3);
        t0_ = t;
    };
    i64 n = (i64)hs.size() / 2;
    if (n == 0) {
        b.ysa.assign(2, 0);
        b.v1 = (u64*)std::calloc(2, sizeof(u64));
        b.v2 = (i64*)std::calloc(2, sizeof(i64));
        b.nv = 2;
        b.mask = 1;
        b.empty_dir = 0;
        return;
    }
    // stable sort of the node pairs by the low 2*weight bits of the head
    // xval. For the 17-mer HIndex the key is 18 bits, so this is ONE
    // parallel counting sort (the reference's own choice is a parallel
    // LSD radix, src/index_util.cpp:432-561): per-thread histograms over
    // static contiguous chunks, key-major/thread-minor exclusive offsets
    // (stability = chunk order x in-chunk order = global index order),
    // then a scatter that writes hx/bodies DIRECTLY — replacing the
    // comparison sort + gather permute with two streaming passes.
    u64 kmask = (1ull << (2 * weight)) - 1;
    std::vector<u64> hx(n), bodies(n);
    if (2 * weight <= 20) {
        i64 nkeys = 1ll << (2 * weight);
        int nt = 1;
#ifdef _OPENMP
        nt = omp_get_max_threads();
#endif
        std::vector<std::vector<i64>> toff((size_t)nt);
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = 0;
#ifdef _OPENMP
            t = omp_get_thread_num();
#endif
            toff[t].assign(nkeys, 0);
            auto& c = toff[t];
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (i64 i = 0; i < n; i++) c[hs[2 * i] & kmask]++;
        }
        i64 pos = 0;
        for (i64 k = 0; k < nkeys; k++)
            for (int t = 0; t < nt; t++) {
                i64 cnt = toff[t][k];
                toff[t][k] = pos;
                pos += cnt;
            }
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
            int t = 0;
#ifdef _OPENMP
            t = omp_get_thread_num();
#endif
            auto& off = toff[t];
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
            for (i64 i = 0; i < n; i++) {
                i64 p = off[hs[2 * i] & kmask]++;
                hx[p] = hs[2 * i] & HB_MASK40;
                bodies[p] = hs[2 * i + 1];
            }
        }
    } else {  // wider keys: comparator-based stable sort (same permutation)
        std::vector<u64> order(n);
        for (i64 i = 0; i < n; i++) order[i] = (u64)i;
        auto cmp = [&](u64 a, u64 c) {
            return (hs[2 * a] & kmask) < (hs[2 * c] & kmask);
        };
#ifdef _OPENMP
        __gnu_parallel::stable_sort(order.begin(), order.end(), cmp);
#else
        std::stable_sort(order.begin(), order.end(), cmp);
#endif
        for (i64 i = 0; i < n; i++) {
            i64 o = (i64)order[i];
            hx[i] = hs[2 * o] & HB_MASK40;
            bodies[i] = hs[2 * o + 1];
        }
    }
    lap_("ksort");
    // group consecutive equal xvals
    std::vector<i64> grp_start;  // index into bodies
    for (i64 i = 0; i < n; i++)
        if (i == 0 || hx[i] != hx[i - 1]) grp_start.push_back(i);
    i64 n_grp = (i64)grp_start.size();
    grp_start.push_back(n);
    bool abort_last = (n - n_grp) <= 2;
    i64 total_nodes = n_grp + n;
    b.ysa.assign(total_nodes + 2, 0);
    std::vector<i64> grp_head_pos(n_grp);
    {
        i64 pos = 0;
        for (i64 g = 0; g < n_grp; g++) {
            grp_head_pos[g] = pos;
            pos += grp_start[g + 1] - grp_start[g] + 1;
        }
    }
    i64 fill_grps_pre = (abort_last && n_grp >= 1) ? n_grp - 1 : n_grp;
    // per-group descending body sorts are independent (bodies are distinct
    // u64s, so the comparator admits exactly one sorted order). Genomic
    // repeat families make a few GIANT groups (rDNA/IS arrays) that would
    // serialize a per-group loop — those sort with the parallel sort
    // afterwards; the small-group y-field zeroing of the XString fill
    // (only bits 41-60, read by nothing before the fill) is folded in
    // here while the cache lines are hot.
    const i64 HB_BIG = 1 << 16;
#pragma omp parallel for schedule(dynamic, 512)
    for (i64 g = 0; g < n_grp; g++) {
        i64 s0 = grp_start[g], s1 = grp_start[g + 1];
        i64 sz = s1 - s0;
        i64 pos = grp_head_pos[g];
        b.ysa[pos] = hb_make_head((u64)(sz + 1), hx[s0]);
        if (abort_last && g == n_grp - 1) {
            for (i64 j = 0; j < sz; j++) b.ysa[pos + 1 + j] = bodies[s0 + j];
            continue;
        }
        if (sz >= HB_BIG) continue;  // giant groups handled below
        std::sort(bodies.begin() + s0, bodies.begin() + s1,
                  std::greater<u64>());
        if (sz + 1 < blocklimit && g < fill_grps_pre)
            for (i64 j = 0; j < sz; j++)
                b.ysa[pos + 1 + j] = bodies[s0 + j] & ~HB_YFIELD;
        else
            for (i64 j = 0; j < sz; j++) b.ysa[pos + 1 + j] = bodies[s0 + j];
    }
    for (i64 g = 0; g < n_grp; g++) {
        i64 s0 = grp_start[g], s1 = grp_start[g + 1];
        i64 sz = s1 - s0;
        if (sz < HB_BIG || (abort_last && g == n_grp - 1)) continue;
        i64 pos = grp_head_pos[g];
#ifdef _OPENMP
        __gnu_parallel::sort(bodies.begin() + s0, bodies.begin() + s1,
                             std::greater<u64>());
#else
        std::sort(bodies.begin() + s0, bodies.begin() + s1,
                  std::greater<u64>());
#endif
        for (i64 j = 0; j < sz; j++) b.ysa[pos + 1 + j] = bodies[s0 + j];
    }
    lap_("bodysort");
    i64 fill_grps;
    if (abort_last && n_grp >= 1) {
        b.empty_dir = grp_head_pos[n_grp - 1];
        b.ysa[b.empty_dir] = 0;
        b.ysa[b.empty_dir + 1] = 0;
        fill_grps = n_grp - 1;
    } else {
        b.empty_dir = total_nodes;
        fill_grps = n_grp;
    }
    // XString sizing (:1398-1420) — pure counting, safely parallel
    i64 count = 0;
#pragma omp parallel for schedule(dynamic, 4096) reduction(+ : count)
    for (i64 g = 0; g < fill_grps; g++) {
        i64 sz = grp_start[g + 1] - grp_start[g];
        if (sz + 1 < blocklimit) {
            count++;
        } else {
            i64 p = grp_head_pos[g];
            u64 prev = b.ysa[p];
            for (i64 j = p + 1; j < p + 1 + sz; j++) {
                if (hb_body_y(b.ysa[j] ^ prev)) count++;
                prev = b.ysa[j];
            }
            count++;
        }
    }
    lap_("sizing");
    u64 size = 1;
    while ((double)size < count * alpha) size <<= 1;
    b.mask = size - 1;
    // parallel first-touch zeroing: vector::assign's serial memset pays a
    // single-core page-fault storm for the multi-GB table; resize +
    // omp-static zero spreads the faults
    b.v1 = (u64*)std::calloc(size, sizeof(u64));
    b.v2 = (i64*)std::calloc(size, sizeof(i64));
    b.nv = (i64)size;
    // parallel pre-fault: calloc's pages are zero but unmapped; the serial
    // fill would otherwise eat the fault storm one page at a time
#pragma omp parallel for schedule(static)
    for (int h = 0; h < 16; h++) {
        i64 chunk = (i64)(size * sizeof(u64) + 15) / 16;
        hb_populate((char*)b.v1 + h * chunk,
                    std::min(chunk, (i64)(size * sizeof(u64)) - h * chunk));
        hb_populate((char*)b.v2 + h * chunk,
                    std::min(chunk, (i64)(size * sizeof(i64)) - h * chunk));
    }
    lap_("xpopulate");
    auto insert = [&](u64 key, i64 val2, u64 node_type) {
        u64 h1 = wang_hash64(key) & b.mask;
        u64 delta = 0;
        while (b.v1[h1]) {
            h1 = (h1 + delta + 1) & b.mask;
            delta++;
        }
        b.v1[h1] = (key << 2) + node_type;
        b.v2[h1] = val2;
    };
    lap_("xalloc");
    for (i64 g = 0; g < fill_grps; g++) {
        i64 sz = grp_start[g + 1] - grp_start[g];
        i64 p = grp_head_pos[g];
        u64 xval = hx[grp_start[g]];
        if (sz + 1 < blocklimit) {
            // bodies' y-field already zeroed in the bodysort loop
            insert(xval, p + 1, 1);
        } else {
            insert(xval, (i64)((~1u) & 0xFFFFFFFFu), 3);  // virtual head
            u64 prev = b.ysa[p];
            for (i64 j = p + 1; j < p + 1 + sz; j++) {
                u64 cur = b.ysa[j];
                if (hb_body_y(cur ^ prev))
                    insert(xval + ((cur & HB_YFIELD) >> 1), j, 1);
                prev = cur;
            }
        }
    }
}

}  // namespace le
