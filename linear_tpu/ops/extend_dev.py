"""Device dense-window extension: _filterHits + path_dst_2 batched.

This is the FLOP-dense half of the apx engine (reference
src/pmpfinder.cpp:1309-1445 path_dst_2/_filterHits and :883-1178
previousWindow/nextWindow/extendWindow): for every accepted hit the engine
sweeps 96-base feature windows left and right, each step evaluating
SUP-INF=3 candidate window distances (2 int96 scripts x 5 six-bit lanes)
and taking the first argmin.  On the host this is the biggest per-read
cost after seeding; on the device the whole batch advances one sweep per
step.

Design:
  - Read features (2-mer/48-base int96 scripts, fwd + revcomp) are computed
    ON DEVICE from the packed read batch (segment sums of one-hot 2-mers —
    elementwise work), so the extension phase reuses the seed phase's h2d
    payload and ships only hits in / cords out.
  - Genome features are uploaded once (device resident, all genomes
    concatenated row-major with per-genome offsets).
  - path_dst_2's data-dependent control flow runs as a batched interpreter:
    one `lax.while_loop` whose body advances every read by one step
    (outer-hit advance, itt_next scan, one previous/nextWindow sweep, or
    block epilogue) selected per read by a phase register.  All arithmetic
    is uint64/int64 with the exact C++ wrap semantics; the device cords are
    bit-identical to the host oracle (tests/test_extend_dev.py) and reads
    that overflow the static buffers fall back to the host engine.

Every shape is static: hits padded to H, cords buffer C, feature rows R.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg
_jaxcfg()

# ApxMapParm2_48 (src/pmpfinder.cpp:211)
WINDOW = 96
CELL_BIT = 4
SUP = 6
MED = 5
INF = 3
WTHR = 36
WTHR_REJ = 50
ABORT_SCORE = 1000
MXU31 = (31 << 24) + (31 << 18) + (31 << 12) + (31 << 6) + 31

MASK_Y = (1 << 20) - 1
FLAG_END = 1 << 60
FLAG_STRAND = 1 << 61

u64 = jnp.uint64
i64 = jnp.int64

# units table (src/pmpfinder.cpp:541)
_INF31 = 31
_UNITS = [
    0, 6, 12, 18, _INF31,
    24, (1 << 8) + 0, (1 << 8) + 6, (1 << 8) + 12, _INF31,
    (1 << 8) + 18, (1 << 8) + 24, (2 << 8) + 0, (2 << 8) + 6, _INF31,
    (2 << 8) + 12, (2 << 8) + 18, (2 << 8) + 24, _INF31, _INF31,
    _INF31, _INF31, _INF31, _INF31, _INF31,
]
_UNIT_INT = np.array([u >> 8 for u in _UNITS], dtype=np.int32)
_UNIT_ADD = ((1 << (np.array([u & 255 for u in _UNITS], dtype=np.int64)))
             & ((1 << 31) - 1)).astype(np.int64)

# ------------------------------------------------------------ cord helpers


def _cy(c):
    return (c & u64(MASK_Y)).astype(i64)


def _cx(c):
    return ((c >> u64(20)) & u64((1 << 30) - 1)).astype(i64)


def _cid(c):
    return ((c >> u64(50)) & u64((1 << 10) - 1)).astype(i64)


def _strand(c):
    return ((c >> u64(61)) & u64(1)).astype(i64)


def _is_end(c):
    return (c & u64(FLAG_END)) != 0


def _make_cord(gid, x, y, std):
    """create_cord (src/cords.cpp:195) in uint64 wrap arithmetic."""
    v = ((gid.astype(i64) << 30) + x).astype(i64)
    return ((v.astype(u64) << u64(20)) + y.astype(u64)
            + (std.astype(u64) << u64(61)))


# ----------------------------------------------------- genome feature pack


class GenomeFeats:
    """Concatenated per-genome feature scripts resident on device."""

    def __init__(self, cat, off, rows):
        self.cat = cat    # (R_total + 8, 3) uint32 (zero-padded tail)
        self.off = off    # (G,) int32 row offsets
        self.rows = rows  # (G,) int32 row counts


def upload_genome_feats(f2_arrays) -> GenomeFeats:
    """f2_arrays: list of (n, 3) int32 numpy arrays (host-built genome
    features, createFeatures2_48 parallel builder)."""
    offs = []
    total = 0
    for a in f2_arrays:
        offs.append(total)
        total += len(a)
    cat = np.zeros((total + 8, 3), dtype=np.uint32)
    for a, o in zip(f2_arrays, offs):
        if len(a):
            cat[o: o + len(a)] = np.ascontiguousarray(a, dtype=np.int32).view(np.uint32)
    return GenomeFeats(
        cat=jnp.asarray(cat),
        off=jnp.asarray(np.array(offs, dtype=np.int32)),
        rows=jnp.asarray(np.array([len(a) for a in f2_arrays], dtype=np.int32)),
    )


# ------------------------------------------------------ device read feats


def _read_feats(seqs, lens, R: int):
    """createFeatures2_48 for a (B, L) int32 batch -> (B, R, 3) uint32.

    Exact vs ops.features.create_features: the phantom 2-mer at the last
    position reads base 'A' (= the zero padding). R = parallel-builder row
    count for L; per-read valid rows = serial count (n_scripts_serial)."""
    B, L = seqs.shape
    b = seqs
    nxt = jnp.concatenate([b[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1)
    ord2 = b * 5 + nxt                                  # (B, L)
    which = jnp.asarray(_UNIT_INT)[ord2]                # (B, L)
    add = jnp.asarray(_UNIT_ADD)[ord2]                  # (B, L) int64
    f = []
    starts = jnp.arange(R, dtype=jnp.int32) * 16
    for t in range(3):
        contrib = jnp.where(which == t, add, 0)
        csum = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int64), jnp.cumsum(contrib, axis=1)], axis=1)
        ft = csum[:, starts + 48] - csum[:, starts]     # (B, R)
        f.append(ft)
    out = jnp.stack(f, axis=-1)                         # (B, R, 3)
    return (out & 0xFFFFFFFF).astype(jnp.uint32)


def _revcomp_batch(seqs, lens):
    """(B, L) codes -> per-read reverse complement, zero padded."""
    B, L = seqs.shape
    j = lens[:, None] - 1 - jnp.arange(L, dtype=jnp.int64)[None, :]
    v = jnp.take_along_axis(seqs, jnp.clip(j, 0, L - 1).astype(jnp.int32), axis=1)
    comp = jnp.asarray(np.array([3, 2, 1, 0, 4], dtype=np.int32))[v]
    return jnp.where(j >= 0, comp, 0)


def _serial_rows(lens):
    """n_scripts_serial (ops/features.py): 1 + max(0, (len-50)>>4); 0 if
    len < 48."""
    n = 1 + jnp.maximum(0, (lens - 50) >> 4)
    return jnp.where(lens < 48, 0, n).astype(jnp.int32)


# --------------------------------------------------------- window distance

_SHIFTS = np.array([24, 18, 12, 6, 0], dtype=np.uint32)


def _sdist(a, b):
    """_scriptDist63_31 over (..., 3) uint32 rows -> (...,) int64."""
    d = a + jnp.uint32(MXU31) - b
    lanes = (d[..., None] >> jnp.asarray(_SHIFTS)) & jnp.uint32(63)
    return jnp.abs(lanes.astype(i64) - 31).sum(axis=(-1, -2))


def _f1_rows(f1, y):
    """Gather rows y (B,) from (B, R, 3) -> (B, 3) uint32 (clipped)."""
    R = f1.shape[1]
    yc = jnp.clip(y, 0, R - 1).astype(jnp.int32)
    return jnp.take_along_axis(f1, yc[:, None, None], axis=1)[:, 0, :]


# ---------------------------------------------------------- filter_hits


def _filter_hits_batch(hits, n, f1f, f1r, n1, gf):
    """_filterHits (src/pmpfinder.cpp:1417) vectorized.

    hits: (B, H) uint64 (slot 0 = FLAG_END header); n: (B,) sizes.
    Returns (new_hits, new_n)."""
    B, H = hits.shape
    pos = jnp.arange(H, dtype=jnp.int32)[None, :]
    in_use = (pos < n[:, None]) & (pos >= 1)
    y = _cy(hits) >> CELL_BIT
    x = _cx(hits) >> CELL_BIT
    gid = _cid(hits)
    std = _strand(hits)
    # window_dist_c: bounds-checked with d=4
    ybase = jnp.where(std == 1, 1, 0)  # select f1 strand row source below
    a1 = jnp.where((std == 1)[:, :, None],
                   _f1_rows_2d(f1r, y), _f1_rows_2d(f1f, y))
    a2 = jnp.where((std == 1)[:, :, None],
                   _f1_rows_2d(f1r, y + 3), _f1_rows_2d(f1f, y + 3))
    del ybase
    goff = gf.off[jnp.clip(gid, 0, gf.off.shape[0] - 1).astype(jnp.int32)].astype(i64)
    n2 = gf.rows[jnp.clip(gid, 0, gf.off.shape[0] - 1).astype(jnp.int32)].astype(i64)
    xg = jnp.clip(goff + x, 0, gf.cat.shape[0] - 4)
    b1 = gf.cat[xg]
    b2 = gf.cat[xg + 3]
    dist = _sdist(a1, b1) + _sdist(a2, b2)
    ok = (y + 4 < n1.astype(i64)[:, None]) & (x + 4 < n2)
    dist = jnp.where(ok, dist, ABORT_SCORE)
    keep = in_use & (dist < WTHR_REJ)
    keep = keep | (pos == 0)  # header always stays
    # target slot of each position: (number kept <= i) - 1
    t = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    # compact kept values in order (stable sort by kept-position key)
    keys = jnp.where(keep, pos, jnp.int32(H))
    keys = jnp.broadcast_to(keys, hits.shape)
    _, sval = jax.lax.sort((keys, hits.astype(i64)), dimension=1, num_keys=1,
                           is_stable=True)
    new_hits = sval.astype(u64)
    # end-flag transfer: dropped (and kept) end flags land on slot t(i)
    endf = (_is_end(hits) & in_use).astype(jnp.int32)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None], (B, H))
    tcl = jnp.clip(t, 0, H - 1)
    flags = jnp.zeros((B, H), jnp.int32).at[rows, tcl].max(
        jnp.where(pos < n[:, None], endf, 0))
    new_hits = jnp.where(flags == 1, new_hits | u64(FLAG_END), new_hits)
    new_n = jnp.sum(keep & (pos < n[:, None]), axis=1).astype(jnp.int32)
    new_n = jnp.where(n == 0, 0, new_n)
    return new_hits, new_n


def _f1_rows_2d(f1, y):
    """Gather rows y (B, H) from (B, R, 3) -> (B, H, 3)."""
    R = f1.shape[1]
    yc = jnp.clip(y, 0, R - 1).astype(jnp.int32)
    return jnp.take_along_axis(f1, yc[:, :, None], axis=1)


# ----------------------------------------------------- path_dst_2 machine

# phases
P_OUTER, P_SCAN, P_DECIDE, P_PREV, P_NEXT, P_EPI, P_DONE = range(7)


def _take_h(hits, idx):
    H = hits.shape[1]
    return jnp.take_along_axis(
        hits, jnp.clip(idx, 0, H - 1).astype(jnp.int32)[:, None], axis=1)[:, 0]


def _take_c(cords, idx):
    C = cords.shape[1]
    return jnp.take_along_axis(
        cords, jnp.clip(idx, 0, C - 1).astype(jnp.int32)[:, None], axis=1)[:, 0]


def _put_c(cords, idx, val, mask):
    C = cords.shape[1]
    rows = jnp.arange(cords.shape[0], dtype=jnp.int32)
    idxc = jnp.clip(idx, 0, C - 1).astype(jnp.int32)
    old = _take_c(cords, idxc)
    return cords.at[rows, idxc].set(jnp.where(mask, val, old))


def _take_i(arr, idx):
    C = arr.shape[1]
    return jnp.take_along_axis(
        arr, jnp.clip(idx, 0, C - 1).astype(jnp.int32)[:, None], axis=1)[:, 0]


def _put_i(arr, idx, val, mask):
    C = arr.shape[1]
    rows = jnp.arange(arr.shape[0], dtype=jnp.int32)
    idxc = jnp.clip(idx, 0, C - 1).astype(jnp.int32)
    old = _take_i(arr, idxc)
    return arr.at[rows, idxc].set(jnp.where(mask, val, old))


@partial(jax.jit, static_argnames=("H", "C", "R", "max_iter"))
def _path_dst_2_batch(hits, n, f1f, f1r, n1, gf_cat, gf_off, gf_rows,
                      read_len, H: int, C: int, R: int, max_iter: int):
    """Batched path_dst_2 (src/pmpfinder.cpp:1309) including the :1366
    whole-cord cordy_str quirk. Returns (cords (B,C) u64, ncords, ovf)."""
    gf = GenomeFeats(gf_cat, gf_off, gf_rows)
    B = hits.shape[0]
    i32z = jnp.zeros((B,), jnp.int32)
    u64z = jnp.zeros((B,), u64)

    start_ok = n > 2  # `if 1 >= n - 1: return` (post-filter size)
    phase0 = jnp.where(start_ok, P_OUTER, P_DONE).astype(jnp.int32)
    cords0 = jnp.zeros((B, C), u64).at[:, 0].set(
        jnp.where(start_ok, u64(FLAG_END), u64(0)))
    ncords0 = jnp.where(start_ok, 1, 0).astype(jnp.int32)

    state0 = dict(
        phase=phase0, itt=i32z + 1, itt_next=i32z + 2, itt_first=i32z + 1,
        fbe=jnp.zeros((B,), bool), fsl=jnp.zeros((B,), bool),
        cys=u64z, cye=u64z, rdy_end=u64z,
        cords=cords0, ncords=ncords0, p_str=i32z,
        ovf=jnp.zeros((B,), bool), it=jnp.int32(0))

    n64 = n.astype(jnp.int32)
    rl = read_len.astype(i64)

    def cond(s):
        return (s["it"] < max_iter) & jnp.any(s["phase"] != P_DONE)

    def body(s):
        """One interpreter step. Phase transitions CHAIN within an
        iteration wherever the consumed registers are provably not stale
        (OUTER->SCAN-step->DECIDE->first-sweep->EPI can all run in one
        pass): every value each later section reads is either unchanged by
        the earlier sections or updated to exactly the value the C++ would
        see. The physical reversal of previousWindow segments is DEFERRED
        to a single post-loop pass (extendWindow's mid-loop reverse only
        affects later steps through cords.back(), which equals the segment
        seed cord cords[p_str] — tracked in the `seed_cord` register)."""
        phase = s["phase"]
        itt, itt_next, itt_first = s["itt"], s["itt_next"], s["itt_first"]
        fbe, fsl, fspr = s["fbe"], s["fsl"], s["fspr"]
        cys, cye, rdy_end = s["cys"], s["cye"], s["rdy_end"]
        cords, ncords, p_str = s["cords"], s["ncords"], s["p_str"]
        seg_end, seed_cord = s["seg_end"], s["seed_cord"]
        ovf = s["ovf"]

        # ---------------- OUTER: per-hit header
        m_outer = phase == P_OUTER
        done_now = m_outer & (itt >= n64)
        h_itt = _take_h(hits, itt)
        h_itt_m1 = _take_h(hits, itt - 1)
        std_itt = _strand(h_itt)
        r_end = jnp.where(std_itt == 1, rl + 1, rl).astype(u64)
        da_l = jnp.abs((_cx(h_itt) - _cx(h_itt_m1)) - (_cy(h_itt) - _cy(h_itt_m1)))
        da_l = jnp.where(_is_end(h_itt_m1), 0, da_l)
        new_fsl = (da_l > 80) | (_strand(h_itt ^ h_itt_m1) != 0)
        o_active = m_outer & ~done_now
        fsl = jnp.where(o_active, new_fsl, fsl)
        fbe = jnp.where(o_active, False, fbe)
        rdy_end = jnp.where(o_active, r_end, rdy_end)
        phase = jnp.where(done_now, P_DONE,
                          jnp.where(o_active, P_SCAN, phase))

        # ---------------- SCAN: one itt_next step (itt/itt_next current)
        m_scan = phase == P_SCAN
        h_in = _take_h(hits, itt_next)
        h_in_m1 = _take_h(hits, itt_next - 1)
        scan_end1 = (itt_next >= n64) | _is_end(h_in_m1)
        da_r = jnp.abs((_cx(h_in) - _cx(h_in_m1)) - (_cy(h_in) - _cy(h_in_m1)))
        f_sp_r = (da_r > 80) | (_strand(h_in ^ h_in_m1) != 0)
        gap_brk = ((_cy(h_itt) + WINDOW < _cy(h_in))
                   & (_cx(h_itt) + WINDOW < _cx(h_in))) | f_sp_r
        c1 = m_scan & scan_end1                      # block end
        c2 = m_scan & ~scan_end1 & gap_brk           # break to DECIDE
        c3 = m_scan & ~scan_end1 & ~gap_brk          # keep scanning
        fbe = jnp.where(c1, True, fbe)
        itt_first = jnp.where(c1, itt_next, itt_first)
        itt_next = jnp.where(c3, itt_next + 1, itt_next)
        phase = jnp.where(c1 | c2, P_DECIDE, phase)
        fspr = jnp.where(c1, False, jnp.where(c2, f_sp_r, fspr))

        # logical last cord slot: with the deferred segment reverse, the
        # PHYSICAL last slot differs from the C++'s logical cords.back()
        # exactly when the latest completed previousWindow segment
        # [p_str, e) reaches the current end (no nextWindow appends): the
        # logical back is then the slot the pending reversal will move to
        # the end — physical p_str + (e-1) - (ncords-1).
        def logical_last_slot(ncords_):
            e = _take_i(seg_end, p_str)
            inseg = (ncords_ - 1 >= p_str) & (ncords_ <= e) & (e > 0)
            return jnp.where(inseg, p_str + (e - 1) - (ncords_ - 1),
                             ncords_ - 1)

        # ---------------- DECIDE (fresh c1/c2 entrants chain in: their
        # itt/itt_next/fbe/fspr/cords are all current)
        m_dec = phase == P_DECIDE
        back = _take_c(cords, logical_last_slot(ncords))
        norm = m_dec & ~fspr & ~fbe
        cys_n = jnp.where(fsl, h_itt,
                          jnp.where(_is_end(h_itt_m1), u64(0),
                                    _cy(back).astype(u64)))
        cye_n = _cy(h_in).astype(u64)
        push_n = h_itt & ~u64(FLAG_END)
        nc_sp = (h_in_m1 - u64(WINDOW << 20) - u64(WINDOW))
        sp_ok = m_dec & (fspr | fbe) & ~fsl \
            & (_cy(h_in_m1) >= WINDOW) & (_cx(h_in_m1) >= WINDOW)
        cys_s = jnp.where(_is_end(h_itt_m1), u64(0), _cy(nc_sp).astype(u64))
        cye_s = _cy(h_in_m1).astype(u64)
        push_s = nc_sp & ~u64(FLAG_END)
        f_append = norm | sp_ok
        cys = jnp.where(norm, cys_n, jnp.where(sp_ok, cys_s, cys))
        cye = jnp.where(norm, cye_n, jnp.where(sp_ok, cye_s, cye))
        push_v = jnp.where(norm, push_n, push_s)
        adj = m_dec & (_is_end(h_itt) | fbe)
        fbe = jnp.where(adj, True, fbe)
        cye = jnp.where(adj, rdy_end, cye)
        can_push = f_append & (ncords < C)
        ovf = ovf | (f_append & (ncords >= C))
        cords = _put_c(cords, ncords, push_v, can_push)
        p_str = jnp.where(can_push, ncords, p_str)
        seed_cord = jnp.where(can_push, push_v, seed_cord)
        ncords = jnp.where(can_push, ncords + 1, ncords)
        dec_no_push = m_dec & ~can_push
        phase = jnp.where(m_dec, jnp.where(can_push, P_PREV,
                                           jnp.int32(P_EPI)), phase)
        phase = jnp.where(ovf, P_DONE, phase)

        # ---------------- PREV / NEXT: one sweep (fresh DECIDE entrants
        # chain in: cords.back() is the cord just pushed).
        # The current walk cord: during PREV, cords.back() (appends run
        # right-to-left, unreversed); at PREV->NEXT the C++ resumes from
        # the segment seed (the reversed segment's back) = seed_cord.
        m_prev = phase == P_PREV
        m_next = phase == P_NEXT
        m_swp = m_prev | m_next
        back2 = _take_c(cords, ncords - 1)
        cur = jnp.where(s["from_seed"], seed_cord, back2)
        gid_c = _cid(cur)
        std_c = _strand(cur)
        xs = _cx(cur) >> CELL_BIT
        ys = _cy(cur) >> CELL_BIT
        goff = gf.off[jnp.clip(gid_c, 0, gf.off.shape[0] - 1).astype(jnp.int32)].astype(i64)
        n2 = gf.rows[jnp.clip(gid_c, 0, gf.off.shape[0] - 1).astype(jnp.int32)].astype(i64)
        y_s = jnp.where(m_prev, ys - MED, ys + MED)
        x0 = jnp.where(m_prev, xs - SUP, xs + INF)
        pre_ok = jnp.where(
            m_prev, (ys >= MED) & (xs >= SUP),
            (ys + SUP * 2 <= n1.astype(i64)) & (xs + SUP * 2 <= n2))
        f1sel_f = _f1_rows(f1f, y_s)
        f1sel_r = _f1_rows(f1r, y_s)
        f1sel3_f = _f1_rows(f1f, y_s + 3)
        f1sel3_r = _f1_rows(f1r, y_s + 3)
        a1 = jnp.where((std_c == 1)[:, None], f1sel_r, f1sel_f)
        a2 = jnp.where((std_c == 1)[:, None], f1sel3_r, f1sel3_f)
        ks = jnp.arange(SUP - INF, dtype=i64)[None, :]
        xg = jnp.clip(goff[:, None] + x0[:, None] + ks, 0, gf.cat.shape[0] - 4)
        dist = _sdist(a1[:, None, :], gf.cat[xg]) + _sdist(a2[:, None, :], gf.cat[xg + 3])
        xr = x0[:, None] + ks
        okw = ((y_s >= 0) & (y_s + 3 < n1.astype(i64)))[:, None] \
            & (xr >= 0) & (xr + 3 < n2[:, None])
        dist = jnp.where(okw, dist, i64(1) << 30)
        dmin = jnp.full((B,), (1 << 32) - 1, i64)
        xmin = jnp.zeros((B,), i64)
        for k in range(SUP - INF):
            better = dist[:, k] < dmin
            dmin = jnp.where(better, dist[:, k], dmin)
            xmin = jnp.where(better, x0 + k, xmin)
        ok_sw = pre_ok & (dmin <= WTHR)
        far_p = (xs - xmin) > MED
        nc_p = jnp.where(
            far_p,
            _make_cord(gid_c, (xs - MED) << CELL_BIT,
                       (xs - xmin - MED + (ys - MED)) << CELL_BIT, std_c),
            _make_cord(gid_c, xmin << CELL_BIT, (ys - MED) << CELL_BIT, std_c))
        far_n = (xmin - xs) > MED
        nc_n = jnp.where(
            far_n,
            _make_cord(gid_c, (xs + MED) << CELL_BIT,
                       (xs + MED - xmin + (ys + MED)) << CELL_BIT, std_c),
            _make_cord(gid_c, xmin << CELL_BIT, (ys + MED) << CELL_BIT, std_c))
        nc = jnp.where(m_prev, nc_p, nc_n)
        nc = jnp.where(ok_sw, nc, u64(0))
        p_stop = m_prev & ((nc == 0) | (_cy(nc).astype(u64) < cys))
        n_stop = m_next & ((nc == 0) | ((_cy(nc) + WINDOW).astype(u64) >= cye))
        go = m_swp & ~p_stop & ~n_stop
        can2 = go & (ncords < C)
        ovf = ovf | (go & (ncords >= C))
        cords = _put_c(cords, ncords, nc, can2)
        ncords = jnp.where(can2, ncords + 1, ncords)
        # PREV->NEXT: record the segment [p_str, ncords) for the deferred
        # reverse (store its end at slot p_str); NEXT resumes from the
        # segment seed cord once (from_seed), then from cords.back()
        seg_end = _put_i(seg_end, p_str, ncords, p_stop)
        # chronological within the iteration: a DECIDE push or any append
        # moves the walk to cords.back(); a PREV stop moves it to the
        # segment seed (the logical back after the deferred reverse)
        from_seed = jnp.where(can_push | go, False, s["from_seed"])
        from_seed = jnp.where(p_stop, True, from_seed)
        phase = jnp.where(p_stop, P_NEXT, phase)
        phase = jnp.where(n_stop, P_EPI, phase)
        phase = jnp.where(ovf, P_DONE, phase)

        # ---------------- EPI (fresh n_stop / dec_no_push entrants chain)
        # The C++ sets the end flag on the LOGICAL cords.back(); with the
        # deferred reverse that is the slot the pending reversal will move
        # to the end (see logical_last_slot).
        m_epi = phase == P_EPI
        flag_slot = logical_last_slot(ncords)
        last = _take_c(cords, flag_slot)
        cords = _put_c(cords, flag_slot, last | u64(FLAG_END),
                       m_epi & fbe & (ncords > 0))
        itt_next = jnp.where(m_epi & fbe, itt_first, itt_next)
        itt = jnp.where(m_epi, itt_next, itt)
        itt_next = jnp.where(m_epi, itt_next + 1, itt_next)
        phase = jnp.where(m_epi, P_OUTER, phase)

        return dict(phase=phase, itt=itt, itt_next=itt_next,
                    itt_first=itt_first, fbe=fbe, fsl=fsl, fspr=fspr,
                    cys=cys, cye=cye, rdy_end=rdy_end, cords=cords,
                    ncords=ncords, p_str=p_str, seg_end=seg_end,
                    seed_cord=seed_cord, from_seed=from_seed, ovf=ovf,
                    it=s["it"] + 1)

    state0["fspr"] = jnp.zeros((B,), bool)
    state0["seg_end"] = jnp.zeros((B, C), jnp.int32)
    state0["seed_cord"] = u64z
    state0["from_seed"] = jnp.zeros((B,), bool)
    out = jax.lax.while_loop(cond, body, state0)
    # deferred segment reversals: seg_end[s] = e marks segment [s, e)
    cords, seg_end, ncords = out["cords"], out["seg_end"], out["ncords"]
    j = jnp.arange(C, dtype=jnp.int32)[None, :]
    has = seg_end > 0
    # segment start covering j: running max of marked starts whose end > j
    startj = jnp.where(has, j, -1)
    startj = jax.lax.associative_scan(jnp.maximum, startj, axis=1)
    endj = jnp.take_along_axis(seg_end, jnp.clip(startj, 0, C - 1), axis=1)
    in_seg = (startj >= 0) & (j < endj)
    src = jnp.where(in_seg, startj + (endj - 1) - j, j)
    cords = jnp.take_along_axis(cords, jnp.clip(src, 0, C - 1), axis=1)
    ovf = out["ovf"] | (out["phase"] != P_DONE)
    return cords, ncords, ovf


@partial(jax.jit, static_argnames=("H", "C", "R", "max_iter"))
def batch_filter_extend_packed(packed, lens, hits, n_hits,
                               gf_cat, gf_off, gf_rows,
                               H: int, C: int, R: int, max_iter: int):
    """Fused device phase: unpack reads -> features (fwd/rc) ->
    _filterHits -> path_dst_2. Returns (cords (B,C) u64 as int64 for
    transfer, ncords (B,) i32, ovf (B,) bool)."""
    b = packed.astype(jnp.int32)
    seqs = jnp.stack([(b >> (2 * i)) & 3 for i in range(4)],
                     axis=-1).reshape(b.shape[0], -1)
    rc = _revcomp_batch(seqs, lens)
    f1f = _read_feats(seqs, lens, R)
    f1r = _read_feats(rc, lens, R)
    n1 = _serial_rows(lens)
    gf = GenomeFeats(gf_cat, gf_off, gf_rows)
    fh, fn = _filter_hits_batch(hits.astype(u64), n_hits, f1f, f1r, n1, gf)
    skip = n_hits < 2  # path_dst precondition on PRE-filter size
    fn = jnp.where(skip, 0, fn)
    cords, ncords, ovf = _path_dst_2_batch(
        fh, fn, f1f, f1r, n1, gf_cat, gf_off, gf_rows, lens,
        H=H, C=C, R=R, max_iter=max_iter)
    return cords.astype(i64), ncords, ovf
