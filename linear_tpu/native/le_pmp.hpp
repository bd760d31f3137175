// Approximate mapping engine — native twin of linear_tpu/map/pmpfinder.py
// (reference src/pmpfinder.cpp: apxMap :2709, path_dst :1447, window sweeps
// :883-1178, anchor filters :1979-2183, alg-1 listing :2185-2313,
// block machinery :1484-2446, chainAnchorsHits :2448).
#pragma once
#include <omp.h>
#include "le_chain.hpp"
#include "le_feats.hpp"
#include "le_hash.hpp"
#include "le_hindex.hpp"

namespace le {

struct PMPParms {
    i64 thd_alpha = 15;
    i64 gdl_list_n = 20;
    i64 gdl_best_n = 1;
    int cah_score_type = 0;
    double cah_stop_ratio = 0.0;
    double apx_sen = 0.7;
    // device-precomputed seed anchors for the first pass (nullable)
    const u64* seed_anchors = nullptr;
    i64 n_seed = 0;
    bool seed_used = false;

    void toggle(int i) {
        if (i == 0) { thd_alpha = 15; gdl_list_n = 10; gdl_best_n = 999; cah_score_type = 0; }
        else { thd_alpha = 7; gdl_list_n = 20; gdl_best_n = 1; cah_score_type = 1; }
    }
};

// ------------------------------------------------- dense window extension

// previousWindow (src/pmpfinder.cpp:883). Returns new cord (0 on fail);
// *dist_out = accepted window distance.
static inline u64 previous_window(const Feats& f1, const Feats& f2, u64 cord,
                                  i64* dist_out) {
    *dist_out = 0;
    i64 gid = cid(cord);
    int std_ = cstrand(cord);
    i64 x_suf = cx(cord) >> CELL_BIT;
    i64 y_suf = cy(cord) >> CELL_BIT;
    if (y_suf < MED || x_suf < SUP) return 0;
    i64 y = y_suf - MED;
    i64 dmin = (1ll << 32) - 1;
    i64 x_min = 0;
    for (int k = 0; k < SUP - INF; k++) {
        i64 tmp = window_dist_u(f1, f2, y, x_suf - SUP + k);
        if (tmp < dmin) { dmin = tmp; x_min = x_suf - SUP + k; }
    }
    if (dmin > WTHR) return 0;
    u64 new_cord;
    if (x_suf - x_min > MED)
        new_cord = make_cord(gid, (x_suf - MED) << CELL_BIT,
                             (x_suf - x_min - MED + y) << CELL_BIT, std_);
    else
        new_cord = make_cord(gid, x_min << CELL_BIT, y << CELL_BIT, std_);
    *dist_out = dmin;
    return new_cord;
}

// nextWindow (src/pmpfinder.cpp:1079)
static inline u64 next_window(const Feats& f1, const Feats& f2, u64 cord,
                              i64* dist_out) {
    *dist_out = 0;
    i64 gid = cid(cord);
    int std_ = cstrand(cord);
    i64 x_pre = cx(cord) >> CELL_BIT;
    i64 y_pre = cy(cord) >> CELL_BIT;
    if (y_pre + SUP * 2 > f1.n || x_pre + SUP * 2 > f2.n) return 0;
    i64 y = y_pre + MED;
    i64 dmin = (1ll << 32) - 1;
    i64 x_min = 0;
    for (int k = 0; k < SUP - INF; k++) {
        i64 tmp = window_dist_u(f1, f2, y, x_pre + INF + k);
        if (tmp < dmin) { dmin = tmp; x_min = x_pre + INF + k; }
    }
    if (dmin > WTHR) return 0;
    u64 new_cord;
    if (x_min - x_pre > MED)
        new_cord = make_cord(gid, (x_pre + MED) << CELL_BIT,
                             (x_pre + MED - x_min + y) << CELL_BIT, std_);
    else
        new_cord = make_cord(gid, x_min << CELL_BIT, y << CELL_BIT, std_);
    *dist_out = dmin;
    return new_cord;
}

// extendWindow (src/pmpfinder.cpp:1152); cordy_str may be a whole cord value
// (path_dst_2 quirk), hence u64
static inline i64 extend_window(const Feats& f1, const Feats& f2,
                                std::vector<u64>& cords, u64 cordy_str,
                                u64 cordy_end) {
    i64 cords_p_str = (i64)cords.size() - 1;
    i64 n_new = 0;
    i64 d;
    for (;;) {
        u64 nc = previous_window(f1, f2, cords.back(), &d);
        if (nc == 0 || (u64)cy(nc) < cordy_str) break;
        cords.push_back(nc);
        n_new++;
    }
    i64 cords_p_end = (i64)cords.size();
    for (i64 k = cords_p_str; k < (cords_p_str + cords_p_end) / 2; k++) {
        i64 kk = (i64)cords.size() - k + cords_p_str - 1;
        std::swap(cords[k], cords[kk]);
    }
    for (;;) {
        u64 nc = next_window(f1, f2, cords.back(), &d);
        if (nc == 0 || (u64)(cy(nc) + WINDOW) >= cordy_end) break;
        cords.push_back(nc);
        n_new++;
    }
    return n_new;
}

// ---------------------------------------------------------------- path_dst

// path_dst_1 (src/pmpfinder.cpp:1269): alg-1 extension
static inline void path_dst_1(const std::vector<u64>& hits, const Feats* f1,
                              const Feats* const* f2, std::vector<u64>& cords,
                              i64 read_str, i64 read_end, i64 read_len) {
    if (cords.empty()) cords.push_back(FLAG_END);
    i64 it = 1;
    i64 n = (i64)hits.size();
    if (it >= n) {
        cords.back() = set_end(cords.back());
        return;
    }
    cords.push_back(hits[it]);
    it++;
    i64 pre_block_ptr = (i64)cords.size() - 1;
    i64 dist_thd = WTHR;
    for (;;) {
        int std_ = cstrand(cords.back());
        i64 gid = cid(cords.back());
        i64 cordy_str = std_ ? read_len - read_end : read_str;
        i64 cordy_end = std_ ? read_len - read_str - 1 : read_end;
        i64 pre_cord_y = is_end(cords[cords.size() - 2]) ? 0 : cy(cords[cords.size() - 2]) + 1;
        cordy_str = std::max(pre_cord_y, cordy_str);
        extend_window(f1[std_], *f2[gid], cords, (u64)cordy_str, (u64)cordy_end);
        // nextCord (src/pmpfinder.cpp:1218)
        u64 new_cord = 0;
        int f_new_block = 0;
        while (it < n) {
            if (is_end(hits[it - 1])) {
                cords.back() = set_end(cords.back());
                pre_block_ptr = (i64)cords.size();
                f_new_block = 1;
            }
            u64 cand = hits[it];
            it++;
            if (cy(cand) > cy(cords.back()) || f_new_block) {
                i64 dist = window_dist_c(f1[cstrand(cand)], *f2[cid(cand)],
                                         cy(cand) >> CELL_BIT, cx(cand) >> CELL_BIT);
                i64 nyf = cstrand(cand) ? read_len - 1 - cy(cand) : cy(cand);
                if (dist < dist_thd && cy(cand) + WINDOW < read_len &&
                    nyf >= read_str && nyf + WINDOW < read_end) {
                    cords.push_back(cand);
                    new_cord = cand;
                    break;
                }
            }
        }
        if (new_cord == 0) {
            if (f_new_block) {
                cords.back() = set_end(cords.back());
                pre_block_ptr = (i64)cords.size();
            }
            break;
        }
    }
    cords.back() = set_end(cords.back());
    set_max_len(cords, (i64)cords.size() - pre_block_ptr);
    cords.back() = set_end(cords.back());
}

// path_dst_2 (src/pmpfinder.cpp:1309): alg-2 (default) extension, incl. the
// :1366 quirk where cordy_str gets the whole cord value when f_sp_l holds
static inline void path_dst_2(const std::vector<u64>& hits, const Feats* f1,
                              const Feats* const* f2, std::vector<u64>& cords,
                              i64 read_str, i64 read_end, i64 read_len) {
    i64 n = (i64)hits.size();
    if (1 >= n - 1) return;
    if (cords.empty()) cords.push_back(FLAG_END);
    i64 itt = 1, itt_next = 2, itt_first = 1;
    while (itt < n) {
        i64 ready_str = cstrand(hits[itt]) ? read_len - read_end : read_str;
        i64 ready_end = cstrand(hits[itt]) ? read_len - read_str + 1 : read_end;
        i64 da_l;
        if (is_end(hits[itt - 1])) da_l = 0;
        else
            da_l = std::abs((cx(hits[itt]) - cx(hits[itt - 1])) -
                            (cy(hits[itt]) - cy(hits[itt - 1])));
        bool f_sp_l = (da_l > 80) || cstrand(hits[itt] ^ hits[itt - 1]) != 0;
        bool f_sp_r = false;
        bool f_block_end = false;
        for (;;) {
            if (itt_next >= n || is_end(hits[itt_next - 1])) {
                f_block_end = true;
                itt_first = itt_next;
                break;
            }
            i64 da_r = std::abs((cx(hits[itt_next]) - cx(hits[itt_next - 1])) -
                                (cy(hits[itt_next]) - cy(hits[itt_next - 1])));
            f_sp_r = (da_r > 80) || cstrand(hits[itt_next] ^ hits[itt_next - 1]) != 0;
            if ((cy(hits[itt]) + WINDOW < cy(hits[itt_next]) &&
                 cx(hits[itt]) + WINDOW < cx(hits[itt_next])) ||
                f_sp_r)
                break;
            itt_next++;
        }
        bool f_append = false;
        u64 cordy_str = 0, cordy_end = 0;
        if (!f_sp_r && !f_block_end) {
            if (f_sp_l) cordy_str = hits[itt];  // C++ quirk: whole cord value
            else if (is_end(hits[itt - 1])) cordy_str = (u64)ready_str;
            else cordy_str = (u64)cy(cords.back());
            cordy_end = (u64)cy(hits[itt_next]);
            cords.push_back(unset_end(hits[itt]));
            f_append = true;
        } else {
            if (!f_sp_l && cy(hits[itt_next - 1]) >= WINDOW &&
                cx(hits[itt_next - 1]) >= WINDOW) {
                u64 nc = shiftc(hits[itt_next - 1], -WINDOW, -WINDOW);
                cordy_str = is_end(hits[itt - 1]) ? (u64)read_str : (u64)cy(nc);
                cordy_end = (u64)cy(hits[itt_next - 1]);
                cords.push_back(unset_end(nc));
                f_append = true;
            } else {
                f_append = false;
            }
        }
        if (is_end(hits[itt]) || f_block_end) {
            f_block_end = true;
            cordy_end = (u64)ready_end;
        }
        if (f_append)
            extend_window(f1[cstrand(hits[itt])], *f2[cid(hits[itt])], cords,
                          cordy_str, cordy_end);
        if (f_block_end) cords.back() = set_end(cords.back());
        itt_next = f_block_end ? itt_first : itt_next;
        itt = itt_next;
        itt_next++;
    }
}

// _filterHits (src/pmpfinder.cpp:1417)
static inline void filter_hits(std::vector<u64>& hits, const Feats* f1,
                               const Feats* const* f2) {
    i64 ii_move = 0;
    for (i64 i = 1; i < (i64)hits.size(); i++) {
        u64 h = hits[i];
        i64 dist = window_dist_c(f1[cstrand(h)], *f2[cid(h)], cy(h) >> CELL_BIT,
                                 cx(h) >> CELL_BIT);
        if (dist < WTHR_REJ) hits[i - ii_move] = h;
        else ii_move++;
        if (is_end(h)) hits[i - ii_move] = set_end(hits[i - ii_move]);
    }
    hits.resize(hits.size() - ii_move);
}

// path_dst (src/pmpfinder.cpp:1447)
static inline void path_dst(std::vector<u64>& hits, const Feats* f1,
                            const Feats* const* f2, std::vector<u64>& cords,
                            i64 read_str, i64 read_end, i64 read_len,
                            int alg_type) {
    if (hits.size() < 2) return;
    if (alg_type == 1) {
        path_dst_1(hits, f1, f2, cords, read_str, read_end, read_len);
    } else if (alg_type == 2) {
        filter_hits(hits, f1, f2);
        path_dst_2(hits, f1, f2, cords, read_str, read_end, read_len);
    }
}

// ----------------------------------------------------------- anchor filters

// binningFilter (src/pmpfinder.cpp:1979)
static inline void binning_filter(std::vector<u64>& anchors) {
    const i64 thd_accept_bin = 10;
    const i64 bin_size = 30000;
    // counts per 30kb genome-x bin
    std::vector<i64> bins(anchors.size());
    std::vector<std::pair<i64, i64>> cnt;  // sorted assoc (bin, count)
    for (size_t i = 0; i < anchors.size(); i++) bins[i] = cx(anchors[i]) / bin_size;
    std::vector<i64> sorted_bins(bins);
    std::sort(sorted_bins.begin(), sorted_bins.end());
    auto count_of = [&](i64 b) -> i64 {
        auto lo = std::lower_bound(sorted_bins.begin(), sorted_bins.end(), b);
        auto hi = std::upper_bound(sorted_bins.begin(), sorted_bins.end(), b);
        return (i64)(hi - lo);
    };
    size_t ii = 0;
    for (size_t i = 0; i < anchors.size(); i++) {
        if (count_of(bins[i]) > thd_accept_bin) anchors[ii++] = anchors[i];
    }
    if (ii != 0) anchors.resize(ii);
}

// filterAnchorsList (src/pmpfinder.cpp:2019): sorts anchors asc (with
// anchors[0] zeroed) and returns dense [start, end) ranges
static inline void filter_anchors_list(std::vector<u64>& anchors,
                                       i64 thd_anchor_accept_density,
                                       i64 thd_anchor_accept_min,
                                       i64 thd_anchor_err_bit,
                                       std::vector<PII>& out) {
    out.clear();
    if (anchors.size() <= 1) return;
    anchors[0] = 0;
    std::sort(anchors.begin(), anchors.end());
    const i64 thd_1k_bit = 10;
    u64 ak2 = anchors[1];
    i64 block_str = 1;
    i64 count_anchors = 0;
    u64 min_y = ~0ull;
    u64 max_y = 0;
    i64 n = (i64)anchors.size();
    for (i64 i = 1; i < n; i++) {
        u64 a = anchors[i];
        u64 anc_y = a & MASK_Y;
        i64 dy2 = std::abs((i64)anc_y - (i64)(ak2 & MASK_Y));
        bool f_continuous =
            (i64)(((a - ak2) >> 20) & ((1ull << 40) - 1)) < (dy2 >> thd_anchor_err_bit);
        if (f_continuous) {
            if (min_y > anc_y) min_y = anc_y;
            if (max_y < anc_y) max_y = anc_y;
            ak2 = anchors[(block_str + i) >> 1];
            count_anchors++;
        }
        if (!f_continuous || i == n - 1) {
            i64 thd_accept_num = std::max(
                (i64)(((max_y - min_y) * (u64)thd_anchor_accept_density) >> thd_1k_bit),
                thd_anchor_accept_min);
            if (count_anchors > thd_accept_num) out.push_back({block_str, i});
            block_str = i;
            ak2 = a;
            min_y = anc_y;
            max_y = anc_y;
            count_anchors = 1;
        }
    }
}

// filterAnchors1 (src/pmpfinder.cpp:2073) + filterAnchors (:2159)
static inline void filter_anchors(std::vector<u64>& anchors,
                                  i64 thd_anchor_accept_density,
                                  i64 thd_anchor_accept_min,
                                  i64 thd_anchor_err_bit) {
    binning_filter(anchors);
    if (anchors.size() <= 1) return;
    std::vector<PII> ranges;
    filter_anchors_list(anchors, thd_anchor_accept_density, thd_anchor_accept_min,
                        thd_anchor_err_bit, ranges);
    i64 ii = 0;
    for (auto& r : ranges)
        for (i64 j = r.first; j < r.second; j++) anchors[ii++] = anchors[j];
    anchors.resize(ii);
}

// ------------------------------------------------------ alg-1 listing path

// getDAnchorList (src/pmpfinder.cpp:2185)
static inline void get_d_anchor_list(std::vector<u64>& anchors, i64 read_str,
                                     i64 read_end, int shape_len,
                                     std::vector<u64>& out) {
    out.clear();
    const double thd_anchor_accept_dens = 0.001;
    i64 thd_anchor_accept_lens = (i64)(0.01 * (double)(read_end - read_str));
    const double thd_anchor_err = 0.2;
    if (anchors.size() <= 1) return;
    std::sort(anchors.begin(), anchors.end());
    u64 ak2 = anchors[0], ak3 = anchors[0];
    i64 c_b = shape_len;
    i64 sb = 1;
    u64 min_y = ~0ull, max_y = 0;
    i64 n = (i64)anchors.size();
    for (i64 k = 1; k < n; k++) {
        u64 anc_y = anchors[k] & MASK_Y;
        i64 dy2 = std::abs((i64)anc_y - (i64)(ak2 & MASK_Y));
        i64 dy3 = std::abs((i64)anc_y - (i64)(ak3 & MASK_Y));
        bool f_continuous = (double)cx(anchors[k] - ak2) < thd_anchor_err * dy2 ||
                            (double)cx(anchors[k] - ak3) < thd_anchor_err * dy3;
        if (f_continuous) {
            i64 dy = (i64)(anchors[k] & MASK_Y) - (i64)(anchors[k - 1] & MASK_Y);
            c_b += std::min(std::abs(dy), (i64)shape_len);
            ak2 = anchors[(sb + k) >> 1];
            ak3 = anchors[k - ((k - sb) >> 2)];
            if (min_y > anc_y) min_y = anc_y;
            if (max_y < anc_y) max_y = anc_y;
        }
        if (!f_continuous || k == n - 1) {
            if (c_b > thd_anchor_accept_lens &&
                (double)(k - sb) >= (double)(i64)((max_y - min_y) * thd_anchor_accept_dens)) {
                // std::sort asc by y within [sb, k)
                std::sort(anchors.begin() + sb, anchors.begin() + k,
                          [](u64 a, u64 b) { return (a & MASK_Y) < (b & MASK_Y); });
                out.push_back(((u64)c_b << 40) + ((u64)sb << 20) + (u64)k);
            }
            sb = k;
            ak2 = anchors[k];
            ak3 = anchors[k];
            c_b = shape_len;
            min_y = anchors[k] & MASK_Y;
            max_y = anchors[k] & MASK_Y;
        }
    }
}

// getDHitList (src/pmpfinder.cpp:2246)
static inline i64 get_d_hit_list(std::vector<u64>& hits, std::vector<u64>& alist,
                                 const std::vector<u64>& anchors,
                                 const PMPParms& pm) {
    const u64 mask = (1ull << 20) - 1;
    if (alist.empty()) return 0;
    std::sort(alist.begin(), alist.end(), std::greater<u64>());
    i64 tmp = (i64)alist.size() > pm.gdl_list_n ? pm.gdl_list_n : (i64)alist.size();
    i64 record_num = 1;
    for (i64 k = 0; k < tmp; k++) {
        if (record_num > pm.gdl_best_n) break;
        if (alist[0] / 10 < alist[k] && alist[k]) {
            i64 sb = (i64)((alist[k] >> 20) & mask);
            i64 sc = (i64)(alist[k] & mask);
            for (i64 nn = sb; nn < sc; nn++)
                hits.push_back(hit2cord_dstr(anchors[nn]));
            hits.back() = set_end(hits.back());
            record_num++;
        } else {
            break;
        }
    }
    return (i64)(alist[0] >> 40);
}

// ------------------------------------------------------- block machinery

// gather_blocks_ (src/pmpfinder.cpp:1484); end-flag accessors parameterized
// (cords bit 60, tiles bit 63)
static inline void gather_blocks(std::vector<u64>& cords, i64 str_, i64 end_,
                                 i64 read_len, i64 thd_large_gap,
                                 i64 thd_cord_size, bool f_set_end,
                                 std::vector<PII>& str_ends,
                                 std::vector<PII>& str_ends_p,
                                 u64 (*is_end_f)(u64) = is_end,
                                 u64 (*set_end_f)(u64) = set_end) {
    str_ends.clear();
    str_ends_p.clear();
    if ((i64)cords.size() < 2) return;
    i64 d_shift_max = thd_cord_size / 2;
    i64 p_str = str_;
    for (i64 i = str_ + 1; i < end_; i++) {
        if (is_end_f(cords[i - 1]) ||
            !is_consecutive(cords[i - 1], cords[i], thd_large_gap)) {
            i64 d_shift = std::min(read_len - cy(cords[p_str]) - 1, d_shift_max);
            u64 b_str = shiftc(cords[p_str], d_shift, d_shift);
            d_shift = std::min(read_len - cy(cords[i - 1]) - 1, d_shift_max);
            u64 b_end = shiftc(cords[i - 1], d_shift, d_shift);
            str_ends.push_back({(i64)b_str, (i64)b_end});
            str_ends_p.push_back({p_str, i});
            if (f_set_end) cords[i - 1] = set_end_f(cords[i - 1]);
            p_str = i;
        }
    }
    i64 d_shift = std::min(read_len - cy(cords[p_str]) - 1, d_shift_max);
    u64 b_str = shiftc(cords[p_str], d_shift, d_shift);
    d_shift = std::min(read_len - cy(cords.back()) - 1, d_shift_max);
    u64 b_end = shiftc(cords.back(), d_shift, d_shift);
    str_ends.push_back({(i64)b_str, (i64)b_end});
    str_ends_p.push_back({p_str, (i64)cords.size()});
}

// clean_blocks_ (src/pmpfinder.cpp:1537)
static inline void clean_blocks(std::vector<u64>& cords, i64 thd_drop_len,
                                i64 thd_map_error = 50) {
    if (cords.empty()) return;
    i64 ptr = 1, ln = 0;
    for (i64 i = 1; i < (i64)cords.size(); i++) {
        ln++;
        if (!is_end(cords[i - 1])) {
            i64 dx = cx(cords[i]) - cx(cords[ptr - 1]);
            i64 dy = cy(cords[i]) - cy(cords[ptr - 1]);
            if (dx < 0 || dy < 0) {
                if (std::abs(dx) < thd_map_error && std::abs(dy) < thd_map_error) {
                    ln--;
                    ptr--;
                } else {
                    cords[ptr] = cords[i];
                }
            } else {
                cords[ptr] = cords[i];
            }
        } else {
            cords[ptr] = cords[i];
        }
        if (is_end(cords[i])) {
            ptr = ln < thd_drop_len ? ptr - ln : ptr;
            ln = 0;
            cords[ptr] = set_end(cords[ptr]);
        }
        ptr++;
    }
    cords.resize(ptr);
}

// gather_gaps_y_ (src/pmpfinder.cpp:1592); sorts str_ends in place
static inline i64 gather_gaps_y(std::vector<PII>& str_ends, i64 read_len,
                                i64 thd_gap_size, std::vector<PII>& gaps) {
    gaps.clear();
    i64 cord_frt = 0;
    i64 cord_end = read_len - 1;
    i64 gap_lens_sum = 0;
    auto add_gap = [&](i64 a, i64 b) {
        gaps.push_back({a, b});
        i64 g1, g2;
        up_forward_y((u64)a, (u64)b, read_len, &g1, &g2);
        gap_lens_sum += g2 - g1;
    };
    if (str_ends.empty()) {
        add_gap(cord_frt, cord_end);
        return gap_lens_sum;
    }
    auto fwd_y_key = [&](const PII& p) -> i64 {
        return cstrand((u64)p.first) ? read_len - cy((u64)p.second) - 1
                                     : cy((u64)p.first);
    };
    // std::sort (src/pmpfinder.cpp:1610)
    std::sort(str_ends.begin(), str_ends.end(),
              [&](const PII& a, const PII& b) { return fwd_y_key(a) < fwd_y_key(b); });
    int f_cover = 0;
    i64 cordy1 = 0, cordy2 = 0;
    i64 y1a, y1b, y2a, y2b;
    up_forward_y((u64)str_ends[0].first, (u64)str_ends[0].second, read_len, &y1a, &y1b);
    y2a = y1a; y2b = y1b;
    if (y1a > thd_gap_size) {
        cordy2 = y1a & (i64)MASK_Y;
        add_gap(cord_frt, cordy2);
    }
    for (size_t i = 1; i < str_ends.size(); i++) {
        if (!f_cover) {
            up_forward_y((u64)str_ends[i - 1].first, (u64)str_ends[i - 1].second,
                         read_len, &y1a, &y1b);
            cordy1 = y1b & (i64)MASK_Y;
        }
        up_forward_y((u64)str_ends[i].first, (u64)str_ends[i].second, read_len,
                     &y2a, &y2b);
        cordy2 = y2a & (i64)MASK_Y;
        if (y1b > y2b) {
            f_cover = 1;
        } else {
            if (y2a > y1b && y2a - y1b > thd_gap_size) add_gap(cordy1, cordy2);
            f_cover = 0;
        }
    }
    i64 max_y_end = f_cover ? y1b : y2b;
    if (read_len - max_y_end > thd_gap_size) add_gap(max_y_end, cord_end);
    return gap_lens_sum;
}

// preFilterChains2 (src/pmpfinder.cpp:2366)
static inline void pre_filter_chains2(std::vector<u64>& hits,
                                      const std::vector<PII>& str_ends_p,
                                      std::vector<PII>& out) {
    const u64 mask = 1ull << 62;
    std::vector<u64> xycuts;
    std::vector<i64> xy_strs;
    for (auto& p : str_ends_p) {
        xycuts.push_back((u64)p.first);
        xycuts.push_back((u64)(p.second - 1) | mask);
        xy_strs.push_back(p.first);
    }
    // std::sort (src/pmpfinder.cpp:2384)
    std::sort(xycuts.begin(), xycuts.end(), [&](u64 a, u64 b) {
        return cy(hits[a & ~mask]) < cy(hits[b & ~mask]);
    });
    out.clear();
    for (u64 cut : xycuts) {
        i64 cuty = cy(hits[cut & ~mask]);
        for (size_t j = 0; j < xy_strs.size(); j++) {
            if (xy_strs[j] >= (i64)hits.size()) break;
            if (cuty < cy(hits[xy_strs[j]])) continue;
            for (i64 k = xy_strs[j]; k < str_ends_p[j].second; k++) {
                if (cut & mask) {
                    if (cy(hits[k]) == cuty) {
                        i64 lo = xy_strs[j], hi = k + 1;
                        if (lo != hi) { out.push_back({lo, hi}); xy_strs[j] = hi; }
                        break;
                    } else if (cy(hits[k]) > cuty) {
                        i64 lo = xy_strs[j], hi = k;
                        if (lo != hi) { out.push_back({lo, hi}); xy_strs[j] = hi; }
                        break;
                    }
                } else {
                    if (cy(hits[k]) >= cuty) {
                        i64 lo = xy_strs[j], hi = k;
                        if (lo != hi) { out.push_back({lo, hi}); xy_strs[j] = hi; }
                        break;
                    }
                }
            }
        }
    }
    std::stable_sort(out.begin(), out.end(),
                     [](const PII& a, const PII& b) { return a.second < b.second; });
    for (auto& p : out) hits[p.second - 1] = set_end(hits[p.second - 1]);
}

// ------------------------------------------------------ anchors -> hits

// chainAnchorsHits (src/pmpfinder.cpp:2448)
static inline void chain_anchors_hits(std::vector<u64>& anchors,
                                      std::vector<u64>& hits,
                                      std::vector<i64>& hits_score,
                                      const PMPParms& pm) {
    AnchorScoreFn get_score =
        pm.cah_score_type == 0 ? get_apx_chain_score : get_apx_chain_score0;
    (void)get_score;
    // std::sort desc by getAnchorX (src/pmpfinder.cpp:2465)
    std::sort(anchors.begin(), anchors.end(),
              [](u64 a, u64 b) { return anchor_x(a) > anchor_x(b); });
    std::vector<std::vector<u64>> chains;
    std::vector<i64> chains_score;
    ChainScoreParms parms;
    auto ax = [](u64 a) { return anchor_x(a); };
    auto run = [&](auto sf) {
        chain_anchors_base(anchors, 0, (i64)anchors.size(), 20, 300, 50,
                           pm.cah_stop_ratio, 1, 45, sf, parms, ax,
                           chains, &chains_score);
    };
    if (pm.cah_score_type == 0)
        run([](u64 a, u64 b, const ChainScoreParms& p) {
            return get_apx_chain_score(a, b, p);
        });
    else
        run([](u64 a, u64 b, const ChainScoreParms& p) {
            return get_apx_chain_score0(a, b, p);
        });
    for (auto& chain : chains) {
        for (u64 a : chain) hits.push_back(hit2cord_dstr(a));
        hits.back() = set_end(hits.back());
    }
    hits_score.insert(hits_score.end(), chains_score.begin(), chains_score.end());
}

// getAnchorHitsChains (src/pmpfinder.cpp:2506)
static inline void get_anchor_hits_chains(std::vector<u64>& anchors,
                                          std::vector<u64>& hits,
                                          std::vector<i64>& hits_score,
                                          i64 read_len, const PMPParms& pm) {
    const i64 thd_anchor_accept_density = 1;
    const i64 thd_anchor_accept_min = 2;
    const i64 thd_large_gap = 600;
    const i64 thd_anchor_err_bit = 2;
    filter_anchors(anchors, thd_anchor_accept_density, thd_anchor_accept_min,
                   thd_anchor_err_bit);
    hits_score.clear();
    hits_score.push_back(0);
    chain_anchors_hits(anchors, hits, hits_score, pm);
    std::vector<PII> str_ends, str_ends_p;
    gather_blocks(hits, 1, (i64)hits.size(), read_len, thd_large_gap, 0, false,
                  str_ends, str_ends_p);
    std::vector<PII> sp2;
    pre_filter_chains2(hits, str_ends_p, sp2);
    std::vector<i64> sp2_score(sp2.size());
    for (size_t i = 0; i < sp2.size(); i++)
        sp2_score[i] = hits_score[sp2[i].first] - hits_score[sp2[i].second - 1];
    chain_blocks_hits(hits, sp2, sp2_score, read_len);
}

// chainApxCordsBlocks (src/pmpfinder.cpp:1747) alg 2
static inline void chain_apx_cords_blocks(std::vector<u64>& cords,
                                          const std::vector<PII>& str_ends_p,
                                          i64 read_len) {
    if (str_ends_p.empty()) return;
    ChainScoreParms parms;
    chain_blocks_cords(cords, str_ends_p, get_apx_chain_score3, parms, 1, 0,
                       read_len, 16, 2, true, unset_end, set_end);
}

// ------------------------------------------------------------- top level

struct ApxContext {
    const DIndexView* index;
    const Feats* f1;          // [2]: read fwd/rc features
    const Feats* const* f2;   // per-genome features (array of pointers)
    const u8* read;
    i64 read_len;
    const HIndexView* hindex = nullptr;  // -i 2: query this instead of index
};

// mnMapReadList (src/pmpfinder.cpp:2560), DIndex path
// per-process apx sub-phase wall accumulators (ns): 0 seed, 1 chain
// (filter+sort+DP+block chain), 2 extension (path_dst). Read+reset via
// le_apx_stage_ns (lt_engine.cpp); the engine is single-threaded per
// worker process so plain statics are safe.
extern i64 g_apx_ns[3];

static inline void mn_map_read_list(const ApxContext& cx_, std::vector<u64>& anchors,
                                    std::vector<u64>& hits,
                                    std::vector<i64>& hits_score, u64 map_str,
                                    u64 map_end, int alg_type, PMPParms& pm) {
    i64 read_str = cy(map_str);
    i64 read_end = cy(map_end);
    if (pm.seed_anchors != nullptr && !pm.seed_used && read_str == 0 &&
        pm.thd_alpha == 15 && read_end >= cx_.read_len) {
        anchors.insert(anchors.end(), pm.seed_anchors,
                       pm.seed_anchors + pm.n_seed);
        pm.seed_used = true;
    } else if (cx_.hindex != nullptr) {
        query_anchors_h(*cx_.hindex, cx_.read, cx_.read_len, read_str,
                        read_end, pm.thd_alpha, (u64)cxid(map_str),
                        (u64)cxid(map_end), anchors);
    } else {
        double t0 = omp_get_wtime();
        query_anchors(*cx_.index, cx_.read, cx_.read_len, read_str, read_end,
                      pm.thd_alpha, anchors);
        g_apx_ns[0] += (i64)((omp_get_wtime() - t0) * 1e9);
    }
    if (alg_type == 1) {
        std::vector<u64> alist;
        int span_ = cx_.hindex ? cx_.hindex->span : cx_.index->span;
        get_d_anchor_list(anchors, read_str, read_end, span_, alist);
        get_d_hit_list(hits, alist, anchors, pm);
    } else if (alg_type == 2) {
        double t0 = omp_get_wtime();
        get_anchor_hits_chains(anchors, hits, hits_score, cx_.read_len, pm);
        g_apx_ns[1] += (i64)((omp_get_wtime() - t0) * 1e9);
    }
}

// apxMap_ (src/pmpfinder.cpp:2632)
static inline void apx_map_(const ApxContext& cx_, std::vector<u64>& hits,
                            std::vector<u64>& cords, std::vector<i64>& cords_info,
                            u64 map_str, u64 map_end, int alg_type, PMPParms& pm) {
    hits.clear();
    hits.push_back(FLAG_END);
    std::vector<u64> anchors;
    anchors.push_back(0);
    std::vector<i64> hits_score;
    mn_map_read_list(cx_, anchors, hits, hits_score, map_str, map_end, alg_type, pm);
    i64 read_str = cy(map_str);
    i64 read_end = cy(map_end);
    for (i64 i = 1; i < (i64)hits.size(); i++)
        if (is_end(hits[i])) cords_info.push_back(0);
    for (i64 i = 0; i < (i64)cords_info.size(); i++) cords_info[i] = 100 - i;
    double t0 = omp_get_wtime();
    path_dst(hits, cx_.f1, cx_.f2, cords, read_str, read_end, cx_.read_len,
             alg_type);
    g_apx_ns[2] += (i64)((omp_get_wtime() - t0) * 1e9);
}

// Chain-mode apx tail for the DEVICE-EXTENDED path (apxMap
// src/pmpfinder.cpp:2744-2801 minus the re-apx rerun): the device runs
// seeding + _filterHits + path_dst_2 and hands back raw cords; this
// finishes the read. Returns false when the re-apx condition (y-gap cover
// >= 0.7 of the read) holds — the caller must then re-run the FULL host
// apx_map (identical result, the re-apx passes need anchors/hits state).
static inline bool apx_map_device_tail(i64 read_len, std::vector<u64>& cords_str,
                                       std::vector<u64>& cords_end,
                                       std::vector<PII>& apx_gaps) {
    const i64 thd_cord_size = WINDOW;
    const i64 thd_large_gap = 1000;
    i64 thd_drop_len = std::min((i64)2, (i64)(read_len * 0.05 / thd_cord_size));
    std::vector<PII> str_ends, str_ends_p;
    clean_blocks(cords_str, thd_drop_len, 50);
    gather_blocks(cords_str, 1, (i64)cords_str.size(), read_len, thd_large_gap,
                  thd_cord_size, true, str_ends, str_ends_p);
    i64 gap_lens_sum = gather_gaps_y(str_ends, read_len, thd_large_gap, apx_gaps);
    if (read_len > 0 && (double)gap_lens_sum / (double)read_len >= 0.7)
        return false;
    chain_apx_cords_blocks(cords_str, str_ends_p, read_len);
    clean_blocks(cords_str, thd_drop_len, 50);
    // mark main/recd signs; cords_end = cords_str + (96, 96)
    cords_end.assign(cords_str.size(), 0);
    int seg = 0;
    u64 d = shiftc(0, thd_cord_size, thd_cord_size);
    for (size_t i = 0; i < cords_str.size(); i++) {
        u64 c = cords_str[i];
        c = seg ? (c | (1ull << 62)) : (c & ~(1ull << 62));
        c |= 1ull << 63;
        cords_str[i] = c;
        if (is_end(c)) seg = 1 - seg;
        cords_end[i] = c + d;
    }
    return true;
}

// apxMap (src/pmpfinder.cpp:2709). Returns apx_gaps via out param.
static inline void apx_map(const ApxContext& cx_, int f_chain, PMPParms& pm,
                           std::vector<u64>& cords_str, std::vector<u64>& cords_end,
                           std::vector<PII>& apx_gaps, std::vector<i64>& cords_info) {
    i64 read_len = cx_.read_len;
    const i64 thd_cord_size = WINDOW;
    const i64 thd_large_gap = 1000;
    i64 thd_drop_len = std::min((i64)2, (i64)(read_len * 0.05 / thd_cord_size));
    const double thd_reapx_max_gap_ratio = 0.7;
    cords_str.clear();
    cords_info.clear();
    apx_gaps.clear();
    std::vector<u64> hits;
    std::vector<PII> str_ends, str_ends_p;
    if (f_chain) {
        int alg_type = 2;
        u64 map_str = 0;
        u64 map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, read_len & (i64)MASK_Y, 0);
        apx_map_(cx_, hits, cords_str, cords_info, map_str, map_end, alg_type, pm);
        clean_blocks(cords_str, thd_drop_len, 50);
        gather_blocks(cords_str, 1, (i64)cords_str.size(), read_len, thd_large_gap,
                      thd_cord_size, true, str_ends, str_ends_p);
        i64 gap_lens_sum = gather_gaps_y(str_ends, read_len, thd_large_gap, apx_gaps);
        if (read_len > 0 &&
            (double)gap_lens_sum / (double)read_len >= thd_reapx_max_gap_ratio) {
            for (auto& g : apx_gaps) {
                i64 y1, y2;
                up_forward_y((u64)g.first, (u64)g.second, read_len, &y1, &y2);
                pm.toggle(1);
                map_str = (u64)y1;
                map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, y2 & (i64)MASK_Y, 0);
                apx_map_(cx_, hits, cords_str, cords_info, map_str, map_end,
                         alg_type, pm);
                pm.toggle(0);
            }
            gather_blocks(cords_str, 1, (i64)cords_str.size(), read_len,
                          thd_large_gap, thd_cord_size, true, str_ends, str_ends_p);
        }
        chain_apx_cords_blocks(cords_str, str_ends_p, read_len);
        clean_blocks(cords_str, thd_drop_len, 50);
    } else {
        double sen_thr = pm.apx_sen / (double)thd_cord_size;
        int alg_type = 1;
        u64 map_str = 0;
        u64 map_end = make_cord(MAX_CORD_ID, MAX_CORD_X, read_len & (i64)MASK_Y, 0);
        apx_map_(cx_, hits, cords_str, cords_info, map_str, map_end, alg_type, pm);
        if ((double)get_max_len(cords_str) < (double)read_len * sen_thr) {
            cords_str.clear();
            pm.toggle(1);
            apx_map_(cx_, hits, cords_str, cords_info, map_str, map_end, alg_type, pm);
            pm.toggle(0);
        }
        clean_blocks(cords_str, thd_drop_len);
    }
    // mark main/recd signs; cords_end = cords_str + (96, 96)
    cords_end.assign(cords_str.size(), 0);
    int seg = 0;
    u64 d = shiftc(0, thd_cord_size, thd_cord_size);
    for (size_t i = 0; i < cords_str.size(); i++) {
        u64 c = cords_str[i];
        c = seg ? (c | (1ull << 62)) : (c & ~(1ull << 62));  // set_cord_recd
        c |= 1ull << 63;                                     // set_cord_main
        cords_str[i] = c;
        if (is_end(c)) seg = 1 - seg;
        cords_end[i] = c + d;
    }
}

}  // namespace le
