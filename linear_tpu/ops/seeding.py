"""Device seeding: batched rolling hash + index probe + anchor emission.

Design notes:
  - The reference computes per-base rolling hashes sequentially
    (hashInit/hashNexth, src/shape_extend.cpp). Here the recurrence runs as a
    `lax.scan` over positions with the batch dimension vectorized — each scan
    step is one (B,)-wide elementwise op, so a whole read batch advances per
    step. This
    reproduces the C++ statement-for-statement (including N-base carries and
    the read-stream init bias quirks), so device anchors match the host
    oracle bit-for-bit.
  - XValue/YValue minimizer extraction (hashNextX, src/shape_extend.cpp:341)
    is pure elementwise/reduce over the (B, P) sampled positions.
  - The index probe gathers dir[] offsets and up to CAP hs entries per
    sampled position; the y-consistency check ((y1^y2)>>ctz < 4,
    src/pmpfinder.cpp:1893) is computed branchlessly as val < 4*(val&-val).
  - Anchors are emitted in the C++ scan order (position-major, bucket-entry
    order) as int64 packed values identical to the host cord format.

Everything here is jittable with static shapes; reads are padded to the
batch length and masked by their true lengths.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg
_jaxcfg()

SPAN = 21
WEIGHT = 13
THD_ALPHA = 15

class DeviceIndex(NamedTuple):
    """DIndex in device memory: exclusive-prefix dir and packed-u64 hs split
    into (lo, hi) uint32 pairs."""

    dir_start: jnp.ndarray  # int32[4^weight + 1]
    hs_lo: jnp.ndarray      # uint32[n]
    hs_hi: jnp.ndarray      # uint32[n]
    cap: int                # max entries per bucket (<= thd_omit_block)


def bucket_cap(cap: int) -> int:
    """Round a per-bucket entry cap up to a multiple of 32 so kernels
    compiled for one index (cap is a static arg) are reused across thread
    counts / genomes; extra slots are masked by the per-bucket count."""
    return max(-(-cap // 32) * 32, 32)


def upload_index(index) -> DeviceIndex:
    """Host DIndex -> device arrays. cap = max bucket size (buckets larger
    than thd_omit_block were already dropped at build), bucketed by
    bucket_cap for kernel-compile reuse."""
    counts = np.diff(index.dir)
    cap = bucket_cap(int(counts.max()) if len(index.hs) else 1)
    return DeviceIndex(
        # int32 dir: halves the gather traffic of the probe (hs length
        # stays < 2^31 for genomes up to the reference's 2^30-per-seq cap)
        dir_start=jnp.asarray(index.dir, dtype=jnp.int32),
        hs_lo=jnp.asarray((index.hs & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        hs_hi=jnp.asarray((index.hs >> np.uint64(32)).astype(np.uint32)),
        cap=cap,
    )


def _hash_scan_batch(seqs: jnp.ndarray, span: int):
    """Exact LShape state streams for a (B, L) int32 batch.

    Returns (h, crh, x) of shape (B, L): the state AFTER the hashNexth call
    at each position k (valid for k in [span, L - span) as in
    getDIndexMatchAll); earlier entries hold prefix states.
    """
    B, L = seqs.shape
    # hashInit at 0 with N-skip: k0 = first j such that seqs[j:j+span] is N-free
    is_n = (seqs == 4).astype(jnp.int32)
    csum = jnp.cumsum(is_n, axis=1)
    pad = jnp.zeros((B, 1), dtype=jnp.int32)
    csum0 = jnp.concatenate([pad, csum], axis=1)  # (B, L+1)
    n_win = min(span, L)
    win_n = csum0[:, n_win:] - csum0[:, :-n_win] if L >= n_win else jnp.ones((B, 1), jnp.int32)
    ok = win_n == 0  # (B, L - span + 1)
    any_ok = jnp.any(ok, axis=1)
    k0 = jnp.where(any_ok, jnp.argmax(ok, axis=1), 0).astype(jnp.int32)

    # init: pre-roll span-1 bases from k0  (hashInit src/shape_extend.cpp:86)
    idx = k0[:, None] + jnp.arange(span - 1)[None, :]
    init_bases = jnp.take_along_axis(seqs, jnp.minimum(idx, L - 1), axis=1).astype(jnp.uint64)
    coef_f = (jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(span - 2, -1, -1, dtype=jnp.uint64)))
    coef_r = (jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(1, span, dtype=jnp.uint64)))
    h0 = jnp.sum(init_bases * coef_f[None, :], axis=1)
    crh0 = jnp.sum((jnp.uint64(3) - init_bases) * coef_r[None, :], axis=1)
    x0 = (jnp.sum(2 * init_bases.astype(jnp.int64), axis=1)
          - jnp.int64(3) * (span - 1) - jnp.int64(3))
    left0 = jnp.zeros((B,), dtype=jnp.uint64)

    mask = jnp.uint64((1 << (2 * span - 2)) - 1)
    span_m1 = span - 1

    def step(state, k):
        h, crh, x, left = state
        v2 = jax.lax.dynamic_index_in_dim(
            seqs, jnp.minimum(k + span_m1, L - 1), axis=1, keepdims=False
        ).astype(jnp.uint64)
        h = ((h & mask) << jnp.uint64(2)) + v2
        crh = ((crh >> jnp.uint64(2)) & mask) + ((jnp.uint64(3) - v2) << jnp.uint64(2 * span - 2))
        x = x + ((v2.astype(jnp.int64) - left.astype(jnp.int64)) << 1)
        left = jax.lax.dynamic_index_in_dim(
            seqs, jnp.minimum(k, L - 1), axis=1, keepdims=False
        ).astype(jnp.uint64)
        return (h, crh, x, left), (h, crh, x)

    # The C++ rolls from k = read_str + span (getDIndexMatchAll
    # src/pmpfinder.cpp:1874); earlier positions are never visited, so the
    # scan starts there and outputs are indexed by (k - span).
    ks = jnp.arange(span, L, dtype=jnp.int32)
    (_, _, _, _), (hs, crhs, xs) = jax.lax.scan(step, (h0, crh0, x0, left0), ks)
    # scan outputs are (L - span, B); transpose to (B, L - span)
    return hs.T, crhs.T, xs.T


def _minimizer_xy_batch(seqs: jnp.ndarray, j: jnp.ndarray, h: jnp.ndarray,
                        crh: jnp.ndarray, x: jnp.ndarray, span: int, weight: int):
    """Vectorized hashNextX (src/shape_extend.cpp:341) at sampled positions.

    seqs: (B, L); j/h/crh/x: (B, P). Returns (xval, yval, strand): (B, P).
    Out-of-range YValue bases read as 0 ('A'), matching the host oracle.
    """
    B, L = seqs.shape
    span2, weight2 = 2 * span, 2 * weight
    v2 = jnp.where(x > 0, h, crh)
    n_off = span - weight + 1
    mask_w = jnp.uint64((1 << weight2) - 1)
    xval = jnp.full(v2.shape, (1 << span2) - 1, dtype=jnp.uint64)
    t = jnp.zeros(v2.shape, dtype=jnp.int64)
    for idx in range(n_off):
        k = 64 - span2 + 2 * idx
        v1 = (v2 << jnp.uint64(k)) >> jnp.uint64(64 - weight2)
        better = v1 < xval
        xval = jnp.where(better, v1, xval)
        t = jnp.where(better, k, t)
    strand = (x <= 0).astype(jnp.int64)
    joff = (t >> 1) - 32 + span
    fwd_base = j + joff + weight
    rev_base = j + span - joff - weight - 1
    yval = jnp.zeros(v2.shape, dtype=jnp.int64)
    for i in range(4):
        fi = jnp.clip(fwd_base + i, 0, L - 1)
        ri = jnp.clip(rev_base - i, 0, L - 1)
        vf = jnp.where(fwd_base + i < L, jnp.take_along_axis(seqs, fi, axis=1), 0).astype(jnp.int64)
        vr = 3 - jnp.where(rev_base - i >= 0, jnp.take_along_axis(seqs, ri, axis=1), 0).astype(jnp.int64)
        val = jnp.where(strand == 0, vf, vr)
        add = jnp.where((val >= 0) & (val <= 3), val, 0)
        yval = (yval << 2) + add
    return xval.astype(jnp.int64), yval, strand


def _probe_and_anchor(kmat, lens, xval, yval, strand,
                      dir_start, hs_lo, hs_hi, cap: int,
                      in_range, x_base=None, x_hi=None):
    """Shared index probe + val2Anchor tail of the seed kernels
    (getDIndexMatchAll src/pmpfinder.cpp:1882-1911, val2Anchor
    src/index_util.cpp:1509).

    x_base/x_hi: when the k-mer table is SHARDED by xval range, dir_start /
    hs arrays hold only [x_base, x_hi); out-of-range samples are masked so
    a psum across shards reconstructs the replicated result exactly."""
    B, P = kmat.shape
    prev = jnp.concatenate([jnp.zeros((B, 1), dtype=xval.dtype), xval[:, :-1]], axis=1)
    process = (xval != prev) & in_range
    xl = xval
    if x_base is not None:
        process = process & (xval >= x_base) & (xval < x_hi)
        xl = xval - x_base
    # probe: bucket [dir[x], dir[x+1])
    xc = jnp.clip(xl, 0, dir_start.shape[0] - 2)
    lo = dir_start[xc]
    hi = dir_start[xc + 1]
    cnt = jnp.minimum(hi - lo, jnp.int32(cap))
    ent_idx = lo[:, :, None] + jnp.arange(cap, dtype=jnp.int32)[None, None, :]  # (B, P, cap)
    ent_valid = (jnp.arange(cap, dtype=jnp.int32)[None, None, :] < cnt[:, :, None]) & process[:, :, None]
    ent_idx = jnp.clip(ent_idx, 0, hs_lo.shape[0] - 1)
    e_lo = hs_lo[ent_idx].astype(jnp.uint64)
    e_hi = hs_hi[ent_idx].astype(jnp.uint64)
    ent = (e_hi << jnp.uint64(32)) | e_lo                              # (B, P, cap) u64 cords
    hs_y = (ent & jnp.uint64((1 << 20) - 1)).astype(jnp.int64)
    val = hs_y ^ yval[:, :, None]
    # (val >> ctz(val)) < 4  <=>  val < 4 * (val & -val); val==0 accepted
    low = val & (-val)
    y_ok = (val == 0) | (val < (low << 2))
    keep = ent_valid & y_ok
    # val2Anchor (src/index_util.cpp:1509)
    ent_strand = ((ent >> jnp.uint64(61)) & jnp.uint64(1)).astype(jnp.int64)
    same = ent_strand == strand[:, :, None]
    cordy = jnp.where(same, kmat[:, :, None], lens[:, None, None] - 1 - kmat[:, :, None]).astype(jnp.uint64)
    ent_y = ent & jnp.uint64((1 << 20) - 1)
    anc = ent - (cordy << jnp.uint64(20)) + cordy - ent_y
    flag_strand = jnp.uint64(1) << jnp.uint64(61)
    anc = jnp.where(same, anc & ~flag_strand, anc | flag_strand)
    return anc.astype(jnp.int64), keep


@partial(jax.jit, static_argnames=("span", "weight", "thd_alpha", "cap"))
def batch_seed_anchors(seqs: jnp.ndarray, lens: jnp.ndarray,
                       dir_start: jnp.ndarray, hs_lo: jnp.ndarray, hs_hi: jnp.ndarray,
                       span: int = SPAN, weight: int = WEIGHT,
                       thd_alpha: int = THD_ALPHA, cap: int = 32):
    """Batched getDIndexMatchAll (src/pmpfinder.cpp:1856).

    seqs: (B, L) uint8 padded read codes (cast on device — the h2d wire
    format is 1 byte/base); lens: (B,) true lengths.
    Returns (anchors, valid): (B, P, cap) int64 anchors (host cord format)
    and bool mask, in the C++ emission order.
    """
    seqs = seqs.astype(jnp.int32)
    B, L = seqs.shape
    h, crh, x = _hash_scan_batch(seqs, span)  # (B, L - span), indexed by k - span
    # call positions: k in [span, read_end - span), sampled at dt == thd_alpha
    first = span + thd_alpha - 1
    ks = jnp.arange(first, L, thd_alpha, dtype=jnp.int32)  # (P,)
    P = ks.shape[0]
    kmat = jnp.broadcast_to(ks[None, :], (B, P))
    in_range = kmat < (lens[:, None] - span)
    koff = jnp.clip(kmat.astype(jnp.int64) - span, 0, h.shape[1] - 1)
    hj = jnp.take_along_axis(h, koff, axis=1)
    crhj = jnp.take_along_axis(crh, koff, axis=1)
    xj = jnp.take_along_axis(x, koff, axis=1)
    xval, yval, strand = _minimizer_xy_batch(seqs, kmat.astype(jnp.int64), hj, crhj, xj, span, weight)
    # dedup: process iff xval != previous sampled xval (xpre init 0)
    return _probe_and_anchor(kmat.astype(jnp.int64), lens, xval, yval, strand,
                             dir_start, hs_lo, hs_hi, cap, in_range)


def _probe_compact(kmat, lens, xval, yval, strand, dir_start, hs_lo, hs_hi,
                   cap: int, in_range, m_out: int):
    """Compact index probe: instead of materializing (B, P, cap) padded
    bucket slots (cap x wasted gathers), enumerate exactly the probed
    entries. Per position the bucket range [lo, hi) is clipped to cap; a
    per-read exclusive scan of
    the counts assigns m_out output slots, and each slot finds its source
    position with one vectorized searchsorted. Emission order (position-
    major, bucket-entry order) is identical to the padded probe.

    Returns (anchors (B, m_out), keep (B, m_out), probed (B,)): `probed` is
    the pre-y-check entry total — probed > m_out means slots were dropped
    and the caller must fall back to host seeding for that read."""
    B, P = kmat.shape
    prev = jnp.concatenate([jnp.zeros((B, 1), dtype=xval.dtype), xval[:, :-1]],
                           axis=1)
    process = (xval != prev) & in_range
    xc = jnp.clip(xval, 0, dir_start.shape[0] - 2)
    lo = dir_start[xc]
    hi = dir_start[xc + 1]
    cnt = jnp.where(process, jnp.minimum(hi - lo, jnp.int32(cap)),
                    jnp.int32(0))
    off = jnp.cumsum(cnt, axis=1, dtype=jnp.int32)      # inclusive scan
    probed = off[:, -1]
    off_excl = off - cnt
    slots = jnp.arange(m_out, dtype=jnp.int32)
    pos = jax.vmap(lambda o: jnp.searchsorted(o, slots, side="right"))(off)
    pos = jnp.clip(pos, 0, P - 1).astype(jnp.int32)
    take = lambda a: jnp.take_along_axis(a, pos, axis=1)
    ent_idx = take(lo) + (slots[None, :] - take(off_excl))
    valid = slots[None, :] < probed[:, None]
    ent_idx = jnp.clip(ent_idx, 0, hs_lo.shape[0] - 1)
    e_lo = hs_lo[ent_idx].astype(jnp.uint64)
    e_hi = hs_hi[ent_idx].astype(jnp.uint64)
    ent = (e_hi << jnp.uint64(32)) | e_lo               # (B, m_out)
    hs_y = (ent & jnp.uint64((1 << 20) - 1)).astype(jnp.int64)
    val = hs_y ^ take(yval)
    low = val & (-val)
    y_ok = (val == 0) | (val < (low << 2))
    keep = valid & y_ok
    k_s = take(kmat.astype(jnp.int64))
    ent_strand = ((ent >> jnp.uint64(61)) & jnp.uint64(1)).astype(jnp.int64)
    same = ent_strand == take(strand)
    cordy = jnp.where(same, k_s, lens[:, None] - 1 - k_s).astype(jnp.uint64)
    ent_y = ent & jnp.uint64((1 << 20) - 1)
    anc = ent - (cordy << jnp.uint64(20)) + cordy - ent_y
    flag_strand = jnp.uint64(1) << jnp.uint64(61)
    anc = jnp.where(same, anc & ~flag_strand, anc | flag_strand)
    return anc.astype(jnp.int64), keep, probed


def _minimizer_xy_strided(seqs: jnp.ndarray, first: int, P: int,
                          span: int, weight: int, thd_alpha: int,
                          n_mix: int):
    """hashNextX at the arithmetic call grid k = first + thd_alpha*p,
    computed WITHOUT u64 state packs: each of the span-weight+1 minimizer
    candidates is a weight-base (26-bit) pack that fits int32, and every
    base it needs lives on a strided column grid.

    The u64 closed-form path gathers (B, P, span) u64 elements and packs
    them with 64-bit multiply-adds; here the same windows come from `span`
    strided slices (no gather) and int32 shift-adds. Bit-exact vs the u64
    path for regular calls
    (window values < 2^26); the n_mix leading columns that mix in
    hashInit-tail state are spliced from the exact u64 path.

    seqs: (B, L) int32 with >= span + 3 zero columns of right padding
    beyond the last call position. Returns (xval i64, yval i64, strand
    i64, kmat i64): (B, P)."""
    B = seqs.shape[0]
    L = seqs.shape[1]
    n_off = span - weight + 1
    # base columns: cols[j][b, p] = seqs[b, first + thd_alpha*p + j]
    cols = [jax.lax.slice(seqs, (0, first + j),
                          (B, first + j + thd_alpha * (P - 1) + 1),
                          (1, thd_alpha)) for j in range(span)]
    # GC-skew counter x(k) = 2*S(k, k+span) - 3*span + bias (see
    # _closed_form_states): window sum over the span columns + per-read bias
    wsum = cols[0]
    for j in range(1, span):
        wsum = wsum + cols[j]
    head = seqs[:, : 2 * span - 1].astype(jnp.int32)
    bias = 2 * (jnp.sum(head[:, : span - 1], axis=1)
                - jnp.sum(head[:, span: 2 * span - 1], axis=1))
    x = 2 * wsum - 3 * span + bias[:, None]
    strand_f = x > 0
    # forward candidates: hw[idx] = pack(b[k+idx .. k+idx+weight)) MSB-first
    # revcomp candidates: cw[idx] = pack(3-b[k+span-1-idx-t], t=0..weight-1)
    # init above any candidate (all candidates < 2^(2*weight))
    xval = jnp.full((B, P), jnp.int32(1 << (2 * weight)), dtype=jnp.int32)
    tsel = jnp.zeros((B, P), dtype=jnp.int32)
    for idx in range(n_off):
        hw = cols[idx]
        cwv = 3 - cols[span - 1 - idx]
        for t in range(1, weight):
            hw = (hw << 2) + cols[idx + t]
            cwv = (cwv << 2) + (3 - cols[span - 1 - idx - t])
        v1 = jnp.where(strand_f, hw, cwv)
        better = v1 < xval
        xval = jnp.where(better, v1, xval)
        tsel = jnp.where(better, jnp.int32(idx), tsel)
    strand = (~strand_f).astype(jnp.int64)
    ks = jnp.arange(first, first + thd_alpha * P, thd_alpha, dtype=jnp.int64)
    kmat = jnp.broadcast_to(ks[None, :], (B, P))
    # YValue: 4 bases adjacent to the chosen window (joff == idx; see
    # _minimizer_xy_batch — (t>>1) - 32 + span with t = 64-2*span+2*idx
    # reduces to idx)
    joff = tsel.astype(jnp.int64)
    fwd_base = kmat + joff + weight
    rev_base = kmat + span - joff - weight - 1
    yval = jnp.zeros((B, P), dtype=jnp.int64)
    for i in range(4):
        fi = jnp.clip(fwd_base + i, 0, L - 1)
        ri = jnp.clip(rev_base - i, 0, L - 1)
        vf = jnp.where(fwd_base + i < L,
                       jnp.take_along_axis(seqs, fi, axis=1), 0).astype(jnp.int64)
        vr = 3 - jnp.where(rev_base - i >= 0,
                           jnp.take_along_axis(seqs, ri, axis=1), 0).astype(jnp.int64)
        val = jnp.where(strand == 0, vf, vr)
        add = jnp.where((val >= 0) & (val <= 3), val, 0)
        yval = (yval << 2) + add
    xval64 = xval.astype(jnp.int64)
    if n_mix > 0:
        # leading mixed calls (k < 2*span - 1): exact u64 state path on the
        # (B, n_mix) slice only
        kmix = kmat[:, :n_mix]
        hj, crhj, xj = _closed_form_states(seqs, kmix, span, n_mix=n_mix)
        xv_m, yv_m, st_m = _minimizer_xy_batch(seqs, kmix, hj, crhj, xj,
                                               span, weight)
        xval64 = jnp.concatenate([xv_m, xval64[:, n_mix:]], axis=1)
        yval = jnp.concatenate([yv_m, yval[:, n_mix:]], axis=1)
        strand = jnp.concatenate([st_m, strand[:, n_mix:]], axis=1)
    return xval64, yval, strand, kmat


@partial(jax.jit, static_argnames=("span", "weight", "thd_alpha", "cap", "m_out", "packed"))
def batch_seed_anchors_compact(seqs: jnp.ndarray, lens: jnp.ndarray,
                               dir_start: jnp.ndarray, hs_lo: jnp.ndarray,
                               hs_hi: jnp.ndarray, span: int = SPAN,
                               weight: int = WEIGHT, thd_alpha: int = THD_ALPHA,
                               cap: int = 32, m_out: int = 8192,
                               packed: bool = False):
    """Closed-form seeding + compact probe + ordered squeeze, fused in one
    kernel: returns (out (B, m_out) anchors in emission order, kept count,
    probed count). N-free reads only (callers fall back to the scan+padded
    kernel when the batch contains N).

    packed=True: seqs is (B, L//4) uint8 with 4 bases per byte (LSB-first
    2-bit codes) — the h2d wire format is 4x smaller; unpacking is a few
    elementwise ops on device."""
    if packed:
        # (B, L//4) u8 -> (B, L) int32, base i at bits 2*(i%4)
        b = seqs.astype(jnp.int32)
        seqs = jnp.stack([(b >> (2 * i)) & 3 for i in range(4)],
                         axis=-1).reshape(b.shape[0], -1)
    seqs = seqs.astype(jnp.int32)
    B, L = seqs.shape
    first = span + thd_alpha - 1
    P = len(range(first, L, thd_alpha))
    n_mix = int(np.sum(np.arange(first, L, thd_alpha) < 2 * span - 1))
    # zero right-padding so every strided base column is a pure slice; the
    # padded region only feeds columns with in_range == False (masked)
    seqs_p = jnp.pad(seqs, ((0, 0), (0, span + 8)))
    xval, yval, strand, kmat = _minimizer_xy_strided(
        seqs_p, first, P, span, weight, thd_alpha, n_mix)
    in_range = kmat < (lens[:, None] - span)
    anc, keep, probed = _probe_compact(kmat, lens, xval, yval, strand,
                                       dir_start, hs_lo, hs_hi, cap, in_range,
                                       m_out)
    # squeeze out y-rejected entries, preserving emission order
    n = anc.shape[1]
    pos_k = jnp.arange(n, dtype=jnp.int32)[None, :]
    keys = jnp.where(keep, pos_k, jnp.int32(n))
    keys = jnp.broadcast_to(keys, anc.shape)
    _, svals = jax.lax.sort((keys, anc), dimension=1, num_keys=1, is_stable=True)
    count = jnp.sum(keep, axis=1).astype(jnp.int32)
    return svals, count, probed


@partial(jax.jit, static_argnames=("m_out",))
def _compact_anchors(anc: jnp.ndarray, keep: jnp.ndarray, m_out: int):
    """Device stream compaction of (B, P, cap) kept anchors into (B, m_out)
    in emission order (position-major, bucket-entry order) — avoids
    shipping the huge padded tensor to the host. Returns (out, count);
    count > m_out means overflow (caller falls back to host seeding).

    Implemented as one stable key/value `lax.sort` (kept entries keyed by
    flat position, dropped ones pushed past the end) instead of a scatter
    with data-dependent destinations."""
    B = anc.shape[0]
    af = anc.reshape(B, -1)
    kf = keep.reshape(B, -1)
    n = af.shape[1]
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    keys = jnp.where(kf, pos, jnp.int32(n))
    keys = jnp.broadcast_to(keys, af.shape)
    _, svals = jax.lax.sort((keys, af), dimension=1, num_keys=1, is_stable=True)
    out = svals[:, :m_out]
    count = jnp.sum(kf, axis=1).astype(jnp.int32)
    return out, count


@partial(jax.jit, static_argnames=("span", "weight", "thd_alpha", "cap",
                                   "m_out"))
def _seed_superchunk_fused(packed_l: jnp.ndarray, dir_start: jnp.ndarray,
                           hs_lo: jnp.ndarray, hs_hi: jnp.ndarray,
                           span: int, weight: int, thd_alpha: int, cap: int,
                           m_out: int):
    """One superchunk of the block seeding path. packed_l is the wire
    format: (SB, pad/4 + 8) uint8 — 2-bit packed bases with the true read
    length appended as 8 little-endian bytes per row, so the whole
    superchunk moves in ONE h2d. Output fuses (anchors, count, probed)
    into a single (SB, m_out + 1) int64 array (last column =
    count | probed << 32) for ONE d2h: one transfer each way per
    superchunk, whatever the per-transfer latency of the link."""
    pk = packed_l[:, :-8]
    lb = packed_l[:, -8:].astype(jnp.int64)
    shift = jnp.arange(8, dtype=jnp.int64) * 8
    ln = jnp.sum(lb << shift[None, :], axis=1)
    svals, count, probed = batch_seed_anchors_compact(
        pk, ln, dir_start, hs_lo, hs_hi, span=span, weight=weight,
        thd_alpha=thd_alpha, cap=cap, m_out=m_out, packed=True)
    tail = (count.astype(jnp.int64)
            | (probed.astype(jnp.int64) << jnp.int64(32)))
    return jnp.concatenate([svals, tail[:, None]], axis=1)


def pack_superchunk(reads: list, pad_len: int, superchunk: int):
    """Host-side wire pack of <= superchunk reads: (SB, pad/4 + 8) uint8,
    2-bit packed bases + 8 length bytes per row (see
    _seed_superchunk_fused). Reads containing N bases are zeroed on the
    wire and flagged in the returned n_mask — the device result for those
    rows is discarded and the caller host-seeds them (the closed-form
    kernel is exact only for N-free reads). Returns (wire, n_mask).

    Dispatches to the native packer when available (the numpy version
    loops over reads in Python, in the feeder thread)."""
    try:
        from ..map import nengine as NE

        lib = NE.engine_lib()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes as C

        if not getattr(lib, "_pk_configured", False):
            lib.le_pack_superchunk.restype = None
            lib.le_pack_superchunk.argtypes = [
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
                C.c_int64, C.c_int64, C.c_void_p, C.c_void_p]
            lib._pk_configured = True
        n = len(reads)
        pinned = [np.ascontiguousarray(r, dtype=np.uint8) for r in reads]
        ptrs = (C.c_void_p * max(n, 1))(*[r.ctypes.data for r in pinned])
        lens = (C.c_int64 * max(n, 1))(*[len(r) for r in pinned])
        wire = np.empty((superchunk, pad_len // 4 + 8), dtype=np.uint8)
        n_mask = np.empty((superchunk,), dtype=np.uint8)
        lib.le_pack_superchunk(ptrs, lens, n, superchunk, pad_len,
                               wire.ctypes.data, n_mask.ctypes.data)
        return wire, n_mask.astype(bool)
    seqs = np.zeros((superchunk, pad_len), dtype=np.uint8)
    lens = np.zeros((superchunk,), dtype=np.int64)
    n_mask = np.zeros((superchunk,), dtype=bool)
    for i, r in enumerate(reads):
        m = min(len(r), pad_len)
        seqs[i, :m] = r[:m]
        lens[i] = m
        if (r[:m] == 4).any():
            n_mask[i] = True
            seqs[i, :m] = 0
    s4 = seqs.reshape(superchunk, -1, 4).astype(np.uint16)
    packed = (s4[:, :, 0] | (s4[:, :, 1] << 2) | (s4[:, :, 2] << 4)
              | (s4[:, :, 3] << 6)).astype(np.uint8)
    wire = np.concatenate(
        [packed, lens.view(np.uint8).reshape(superchunk, 8)], axis=1)
    return wire, n_mask


def seed_block_dispatch(reads: list, dindex_dev: DeviceIndex, pad_len: int,
                        thd_alpha: int = THD_ALPHA, m_out: int = 128,
                        superchunk: int = 1024):
    """Block-level async seeding: one h2d + one fused kernel + one async
    d2h per `superchunk` reads, everything enqueued before any sync.
    N-containing reads ride the wire zeroed and come back as None from
    seed_block_collect (per-READ host fallback — one such read must not
    drag its whole superchunk onto a slower path). Collect with
    seed_block_collect."""
    n = len(reads)
    wires = []
    for c0 in range(0, n, superchunk):
        w, n_mask = pack_superchunk(reads[c0: c0 + superchunk], pad_len,
                                    superchunk)
        wires.append((min(superchunk, n - c0), w, n_mask))
    out = []
    for n_valid, w, n_mask in wires:
        fused = _seed_superchunk_fused(
            jnp.asarray(w), dindex_dev.dir_start, dindex_dev.hs_lo,
            dindex_dev.hs_hi, SPAN, WEIGHT, thd_alpha, dindex_dev.cap, m_out)
        fused.copy_to_host_async()
        out.append((n_valid, fused, n_mask))
    return out


def dispatch_wire(wire: np.ndarray, dindex_dev: DeviceIndex, m_out: int):
    """Enqueue one packed superchunk (from pack_superchunk) and start its
    async d2h; returns the fused device array handle. Splitting dispatch
    from packing lets callers interleave CPU packing of chunk k+1 with the
    transfer of chunk k (seed_block_dispatch packs everything up front,
    which serializes the packing of every superchunk before the first
    h2d)."""
    fused = _seed_superchunk_fused(
        jnp.asarray(wire), dindex_dev.dir_start, dindex_dev.hs_lo,
        dindex_dev.hs_hi, SPAN, WEIGHT, THD_ALPHA, dindex_dev.cap, m_out)
    fused.copy_to_host_async()
    return fused


def collect_wire(fused, n_valid: int, n_mask: np.ndarray, m_out: int):
    """Sync one dispatch_wire handle. Returns (anchors, overflow): anchors
    is a length-n_valid list of uint64 arrays (None for N-containing reads
    AND for overflowed ones), overflow a bool array marking reads whose
    probe exceeded m_out — distinguishable from the N fallback so callers
    can re-dispatch them at a larger m_out tier instead of host-seeding."""
    arr = np.asarray(fused)
    anc = arr[:, :-1].view(np.uint64)
    count = (arr[:, -1] & 0xFFFFFFFF).astype(np.int64)
    probed = (arr[:, -1] >> 32).astype(np.int64)
    res: list = []
    overflow = np.zeros(n_valid, dtype=bool)
    for i in range(n_valid):
        if n_mask[i]:
            res.append(None)
        elif probed[i] > m_out:
            res.append(None)
            overflow[i] = True
        else:
            res.append(anc[i, : count[i]].copy())
    return res, overflow


def seed_block_collect(dispatched, m_out: int = 128) -> list:
    """Sync phase of seed_block_dispatch: per-read uint64 anchor arrays in
    the C++ emission order (numpy, so worker-pool pickling stays cheap);
    None for N-containing reads and for overflowing reads
    (probed > m_out) — both host-fallback seeded by the caller."""
    res: list = []
    for n_valid, fused, n_mask in dispatched:
        arr = np.asarray(fused)
        anc = arr[:, :-1].view(np.uint64)
        count = (arr[:, -1] & 0xFFFFFFFF).astype(np.int64)
        probed = (arr[:, -1] >> 32).astype(np.int64)
        for i in range(n_valid):
            if n_mask[i] or probed[i] > m_out:
                res.append(None)
            else:
                res.append(anc[i, : count[i]].copy())
    return res


def seed_anchors_dispatch(reads: list, dindex_dev: DeviceIndex, pad_len: int,
                          thd_alpha: int = THD_ALPHA, m_out: int = 1024):
    """Async phase of seed_anchors_batch: enqueue the device work and
    return (comp, count, m_out) device arrays without synchronizing —
    callers dispatch many chunks back-to-back then collect.

    N-free batches ship 2-bit packed (4 bases/byte) and take the fused
    closed-form kernel; N-containing batches take the exact scan kernel."""
    B = len(reads)
    seqs = np.zeros((B, pad_len), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int64)
    for i, r in enumerate(reads):
        n = min(len(r), pad_len)
        seqs[i, :n] = r[:n]
        lens[i] = n
    if not (seqs == 4).any():
        # LSB-first 2-bit pack: base i of each 4-group at bits 2*(i%4)
        s4 = seqs.reshape(B, -1, 4).astype(np.uint16)
        packed = (s4[:, :, 0] | (s4[:, :, 1] << 2) | (s4[:, :, 2] << 4)
                  | (s4[:, :, 3] << 6)).astype(np.uint8)
        comp, count, probed = batch_seed_anchors_compact(
            jnp.asarray(packed), jnp.asarray(lens),
            dindex_dev.dir_start, dindex_dev.hs_lo, dindex_dev.hs_hi,
            thd_alpha=thd_alpha, cap=dindex_dev.cap, m_out=m_out, packed=True)
        # overflow when the probe enumerated more than m_out entries
        count = jnp.where(probed > m_out, jnp.int32(m_out + 1), count)
        return comp, count, m_out
    anc, keep = batch_seed_anchors(
        jnp.asarray(seqs), jnp.asarray(lens),
        dindex_dev.dir_start, dindex_dev.hs_lo, dindex_dev.hs_hi,
        thd_alpha=thd_alpha, cap=dindex_dev.cap,
    )
    comp, count = _compact_anchors(anc, keep, m_out)
    return comp, count, m_out


def seed_anchors_collect(dispatched, n_reads: int) -> list:
    """Sync phase: per-read anchor lists (ints) in the C++ emission order;
    None entries for reads overflowing m_out (host fallback).

    One device_get for (anchors, counts) together: one sync instead of a
    count-then-slice two-step; m_out bounds the transfer."""
    comp, count, m_out = dispatched
    comp, count = jax.device_get((comp, count))
    comp = comp.astype(np.uint64)
    out = []
    for i in range(n_reads):
        if count[i] > m_out:
            out.append(None)
            continue
        out.append(comp[i, : count[i]].tolist())
    return out


def seed_anchors_batch(reads: list, dindex_dev: DeviceIndex, pad_len: int,
                       thd_alpha: int = THD_ALPHA, m_out: int = 8192) -> list:
    """Pad a list of reads, run the device kernel, and return per-read
    anchor lists (ints) in the C++ emission order."""
    return seed_anchors_collect(
        seed_anchors_dispatch(reads, dindex_dev, pad_len, thd_alpha, m_out),
        len(reads))


# ------------------------------------------- closed-form fast path (no N)


def _closed_form_states(seqs: jnp.ndarray, kmat: jnp.ndarray, span: int,
                        n_mix: int | None = None):
    """Hash states at sampled call positions WITHOUT the scan, exact for
    N-free reads with read_str=0 (the production case).

    n_mix: static count of leading kmat columns that can be "mixed" calls
    (k < 2*span - 1); the expensive masked-pack reconstruction only runs on
    that slice (usually 1 column) instead of all P.

    Derivation: after hashInit at 0 the stream rolls from k=span; by call
    k >= 2*span - 1 the state telescopes to the pure window [k, k+span).
    Earlier ("mixed") calls hold (tail of the init window ++ bases
    [2*span - 1 ...]) — also closed-form from the init pack. The GC counter
    x carries the permanent init bias 2*(sum b[0..span-1) - sum
    b[span..2*span-1)) (see ops/hashing.py module notes).
    seqs: (B, L) int32; kmat: (B, P) int64 call positions.
    Returns (h, crh, x) at those positions.
    """
    B, L = seqs.shape
    b64 = seqs.astype(jnp.uint64)
    # window packs at arbitrary positions via gathered bases
    idx = kmat[:, :, None] + jnp.arange(span)[None, None, :]        # (B, P, S)
    gathered = jnp.take_along_axis(
        b64, jnp.clip(idx, 0, L - 1).reshape(B, -1), axis=1
    ).reshape(idx.shape)
    coef_f = (jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(span - 1, -1, -1, dtype=jnp.uint64)))
    coef_r = (jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(span, dtype=jnp.uint64)))
    h_reg = jnp.sum(gathered * coef_f[None, None, :], axis=2)
    crh_reg = jnp.sum((jnp.uint64(3) - gathered) * coef_r[None, None, :], axis=2)
    wsum = jnp.sum(gathered.astype(jnp.int64), axis=2)
    # x bias: 2*(sum b[0..span-1) - sum b[span..2*span-1)); algebra shows
    # x(k) = 2*S(k,k+span) - 3*span + bias holds for mixed calls too (the
    # never-removed init window and the skipped [span-1..2*span-1) region
    # telescope into the bias), so x needs no mixed-case special handling.
    head = b64.astype(jnp.int64)
    bias = 2 * (jnp.sum(head[:, : span - 1], axis=1)
                - jnp.sum(head[:, span: 2 * span - 1], axis=1))
    x = 2 * wsum - 3 * span + bias[:, None]
    # mixed calls: c = k - span in [0, span - 1); the state keeps the last
    # `span` appended symbols where appends are the init tail then
    # b[2*span-1...]; reconstruct directly — but only on the leading n_mix
    # columns that can be mixed (static slice; the rest are regular)
    if n_mix is None:
        n_mix = kmat.shape[1]
    if n_mix == 0:
        return h_reg, crh_reg, x
    kmix = kmat[:, :n_mix]
    c = (kmix - span).astype(jnp.int64)                              # call ordinal
    n_app = jnp.minimum(c + 1, span)                                 # appended count
    n_init = span - n_app                                            # init-tail bases kept
    # init pack P1 = pack(b[span-1-n_init .. span-1)) MSB-first
    i_idx = (span - 1 - n_init)[:, :, None] + jnp.arange(span)[None, None, :]
    i_val = jnp.take_along_axis(b64, jnp.clip(i_idx, 0, L - 1).reshape(B, -1), axis=1).reshape(i_idx.shape)
    i_mask = jnp.arange(span)[None, None, :] < n_init[:, :, None]
    # appended pack P2 = pack(b[2*span-1 .. 2*span-1+n_app)) MSB-first
    a_idx = (2 * span - 1) + jnp.arange(span)[None, None, :] + jnp.zeros_like(n_app)[:, :, None]
    a_val = jnp.take_along_axis(b64, jnp.clip(a_idx, 0, L - 1).reshape(B, -1), axis=1).reshape(a_idx.shape)
    a_mask = jnp.arange(span)[None, None, :] < n_app[:, :, None]

    def pack_msb(vals, mask, comp):
        # shift-accumulate masked MSB-first pack (and LSB pack for crh)
        p_f = jnp.zeros(vals.shape[:2], dtype=jnp.uint64)
        for t in range(span):
            v = jnp.where(mask[:, :, t], vals[:, :, t], 0).astype(jnp.uint64)
            vc = (jnp.uint64(3) - v) if comp else v
            p_f = jnp.where(mask[:, :, t], (p_f << jnp.uint64(2)) + vc, p_f)
        return p_f

    p1_f = pack_msb(i_val, i_mask, False)
    p2_f = pack_msb(a_val, a_mask, False)
    h_mix = (p1_f << (jnp.uint64(2) * n_app.astype(jnp.uint64))) + p2_f
    # crh mixed: LSB-first of complements over the same window sequence
    # crh = sum_{u} (3 - w_u) * 4^u where w_0 is the OLDEST base
    def pack_lsb_from_window(vals1, mask1, vals2, mask2):
        # window = init-tail (oldest) then appended; position u counts from oldest
        p = jnp.zeros(vals1.shape[:2], dtype=jnp.uint64)
        u = jnp.zeros(vals1.shape[:2], dtype=jnp.uint64)
        for t in range(span):
            m = mask1[:, :, t]
            v = (jnp.uint64(3) - vals1[:, :, t].astype(jnp.uint64))
            p = jnp.where(m, p + (v << (jnp.uint64(2) * u)), p)
            u = jnp.where(m, u + 1, u)
        for t in range(span):
            m = mask2[:, :, t]
            v = (jnp.uint64(3) - vals2[:, :, t].astype(jnp.uint64))
            p = jnp.where(m, p + (v << (jnp.uint64(2) * u)), p)
            u = jnp.where(m, u + 1, u)
        return p

    crh_mix = pack_lsb_from_window(i_val, i_mask, a_val, a_mask)
    # x needs no mixed-case handling (bias algebra above); h/crh: splice the
    # mixed leading columns over the regular closed form
    mixed = c < span - 1
    h = jnp.concatenate(
        [jnp.where(mixed, h_mix, h_reg[:, :n_mix]), h_reg[:, n_mix:]], axis=1)
    crh = jnp.concatenate(
        [jnp.where(mixed, crh_mix, crh_reg[:, :n_mix]), crh_reg[:, n_mix:]], axis=1)
    return h, crh, x


@partial(jax.jit, static_argnames=("span", "weight", "thd_alpha", "cap"))
def batch_seed_anchors_fast(seqs: jnp.ndarray, lens: jnp.ndarray,
                            dir_start: jnp.ndarray, hs_lo: jnp.ndarray, hs_hi: jnp.ndarray,
                            span: int = SPAN, weight: int = WEIGHT,
                            thd_alpha: int = THD_ALPHA, cap: int = 32):
    """Closed-form variant of batch_seed_anchors: exact for N-free reads
    (the host wrapper falls back to the scan kernel when a batch contains N
    bases). ~P sampled gathers instead of an L-step scan."""
    seqs = seqs.astype(jnp.int32)
    B, L = seqs.shape
    first = span + thd_alpha - 1
    ks = jnp.arange(first, L, thd_alpha, dtype=jnp.int64)
    P = ks.shape[0]
    kmat = jnp.broadcast_to(ks[None, :], (B, P))
    in_range = kmat < (lens[:, None] - span)
    n_mix = int(np.sum(np.arange(first, L, thd_alpha) < 2 * span - 1))
    hj, crhj, xj = _closed_form_states(seqs, kmat, span, n_mix=n_mix)
    xval, yval, strand = _minimizer_xy_batch(seqs, kmat, hj, crhj, xj, span, weight)
    return _probe_and_anchor(kmat.astype(jnp.int64), lens, xval, yval, strand,
                             dir_start, hs_lo, hs_hi, cap, in_range)
