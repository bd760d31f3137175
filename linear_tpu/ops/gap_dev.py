"""Device gap-interval anchor generation: the 9-mer seeding stage
of mapInterval/mapGeneric as a batched kernel.

Reference: g_mapHs_kmer_ (src/gap_util.cpp:632, double-strand canonical
9-mer stream, genome step 5 / read step 1), g_create_anchors_ (:1596,
sort + xval-group cross product) with direction-0 bounds
(g_mapHs_setAnchors_ :669). SURVEY §7.1 step 6 calls for batching the
gap module's fixed-size work items; this kernel covers the seeding
stage — one dispatch computes the anchor SETS of hundreds of gap
intervals, bit-identical to the host stream (tests/test_gap_dev.py).

Design:
  - the rolling canonical hash telescopes to pure window functions for
    N-free windows (same derivation as ops/seeding): 9 shifted adds per
    position, fully vectorized over (B, L);
  - the group cross product becomes sort + searchsorted + a capped
    per-read-kmer gather (matches per 9-mer within a few-kb window are
    tiny; overflowing items fall back to host);
  - host emission ORDER is reconstructed exactly from a 46-bit
    (val, g_std, g_rel, r_std, r_rel) key per anchor — the host's
    sort-then-walk emits pairs in ascending (g_entry, r_entry) composite
    order, which this key reproduces, so `anchors[argsort(keys)]` equals
    the host list element-for-element.

Not wired into the per-read gap phase: mapGeneric work items
materialize MID-phase (residual holes between tiles the earlier extension
steps just created, le_gap3.hpp addons_1), so consuming device anchors
requires the gap phase to run in bulk-synchronous rounds across a read
batch, with one host-device round trip per round.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg

_jaxcfg()

SHAPE_LEN = 9
GA_MASK1 = (1 << 20) - 1
GA_MASK3 = (1 << 30) - 1
GA_MASK5 = (1 << 31) - 1
GA_ZERO = 1 << 20
LLMIN = -(1 << 62)
LLMAX = 1 << 62


def _stream_vals(seq: jnp.ndarray, span: int = SHAPE_LEN):
    """Canonical 9-mer stream values/strands for every window start of
    (B, L) u8 sequences: val = x<0 ? crh : h (g_mapHs_kmer_)."""
    B, L = seq.shape
    n_pos = L - span + 1
    s64 = seq.astype(jnp.int64)
    h = jnp.zeros((B, n_pos), dtype=jnp.int64)
    crh = jnp.zeros((B, n_pos), dtype=jnp.int64)
    ws = jnp.zeros((B, n_pos), dtype=jnp.int64)
    for o in range(span):
        col = jax.lax.dynamic_slice_in_dim(s64, o, n_pos, axis=1)
        h = h + (col << (2 * (span - 1 - o)))
        crh = crh + ((3 - col) << (2 * o))
        ws = ws + col
    x = 2 * ws - 3 * span
    std = (x < 0).astype(jnp.int64)
    val = jnp.where(std == 1, crh, h) & ((1 << (2 * span)) - 1)
    return val, std


@partial(jax.jit, static_argnames=("g_max", "r_max", "cap", "m_out"))
def _gap_anchors_kernel(gseq, g_n, gpos0, rseq, r_n, rpos0, rvcp,
                        a_lo, a_hi, g_max: int, r_max: int,
                        cap: int, m_out: int):
    B = gseq.shape[0]
    span = SHAPE_LEN
    gval, gstd = _stream_vals(gseq)
    rval, rstd = _stream_vals(rseq)
    # genome samples at rel 4, 9, 14, ... (step 5, count==step emission);
    # read samples at every rel position (step 1)
    g_rel = 4 + 5 * jnp.arange(g_max, dtype=jnp.int64)
    g_ok = g_rel[None, :] < g_n[:, None]
    g_relc = jnp.minimum(g_rel[None, :], jnp.maximum(g_n[:, None] - 1, 0))
    gv = jnp.take_along_axis(gval, g_relc, axis=1)
    gs = jnp.take_along_axis(gstd, g_relc, axis=1)
    r_rel = jnp.arange(r_max, dtype=jnp.int64)
    r_ok = r_rel[None, :] < r_n[:, None]
    r_relc = jnp.minimum(r_rel[None, :], jnp.maximum(r_n[:, None] - 1, 0))
    rv = jnp.take_along_axis(rval, r_relc, axis=1)
    rs = jnp.take_along_axis(rstd, r_relc, axis=1)
    # g_hs composites (g_hs_make: val<<33 | typ<<31 | std<<30 | abs_pos)
    g_ent = ((gv << 33) + (gs << 30) + (gpos0[:, None] + g_relc))
    r_ent = ((rv << 33) + (1 << 31) + (rs << 30) + (rpos0[:, None] + r_relc))
    # sort genome entries (invalid to +inf); group = equal val
    g_sorted = jnp.sort(jnp.where(g_ok, g_ent, jnp.int64(1) << 62), axis=1)
    # per read kmer: genome entries with the same val
    lo = jax.vmap(jnp.searchsorted)(g_sorted, rv << 33)
    hi = jax.vmap(jnp.searchsorted)(g_sorted, (rv + 1) << 33)
    n_match = jnp.where(r_ok, hi - lo, 0)
    # capped gather of matches per read kmer
    idx = lo[:, :, None] + jnp.arange(cap, dtype=lo.dtype)[None, None, :]
    pair_ok = (jnp.arange(cap)[None, None, :] < n_match[:, :, None])
    idxc = jnp.minimum(idx, g_max - 1)
    hs1 = jnp.take_along_axis(g_sorted, idxc.reshape(B, -1), axis=1
                              ).reshape(B, r_max, cap)
    hs2 = r_ent[:, :, None]
    # g_hs_set_anchor (src/gap_util.cpp:548)
    std_ = ((hs1 ^ hs2) >> 30) & 1
    nsg = 2 * std_ - 1
    xx = rvcp[:, None, None] * std_ - nsg * (hs2 & GA_MASK3)
    anchor = (((hs1 + GA_ZERO - xx) & GA_MASK3) << 20) + xx + (std_ << 50)
    # direction-0 bound: anchor_lower <= str_anchor < anchor_upper
    tmp = ((anchor >> 20) & GA_MASK5) - GA_ZERO
    keep = pair_ok & (tmp >= a_lo[:, None, None]) & (tmp < a_hi[:, None, None])
    # reference quirk: the group walk never emits the TRAILING group (no
    # closing boundary follows it, g_create_anchors_ src/gap_util.cpp:1596);
    # the trailing group holds the maximal val present in either stream
    vmax = jnp.maximum(jnp.max(jnp.where(g_ok, gv, -1), axis=1),
                       jnp.max(jnp.where(r_ok, rv, -1), axis=1))
    keep = keep & (rv[:, :, None] < vmax[:, None, None])
    # canonical emission key: (val, g_std, g_rel, r_std, r_rel) — the
    # host's ascending (g_entry, r_entry) pair order within/across groups
    g_rel_of = (hs1 & GA_MASK3) - gpos0[:, None, None]
    key = ((rv[:, :, None] << 28) | (((hs1 >> 30) & 1) << 27)
           | (g_rel_of << 14) | (rs[:, :, None] << 13) | r_relc[:, :, None])
    flat_a = anchor.reshape(B, -1)
    flat_k = jnp.where(keep, key, jnp.int64(1) << 62).reshape(B, -1)
    count = jnp.sum(keep.reshape(B, -1), axis=1).astype(jnp.int32)
    overflow = ((jnp.max(n_match, axis=1) > cap)
                | (count > m_out)
                | (g_n > 5 * g_max + 4) | (r_n > r_max))
    # compact: ascending key order == host emission order
    order = jnp.argsort(flat_k, axis=1)[:, :m_out]
    out_a = jnp.take_along_axis(flat_a, order, axis=1)
    out_k = jnp.take_along_axis(flat_k, order, axis=1)
    return out_a, out_k, count, overflow


def batch_gap_anchors(items, g_max: int = 1024, r_max: int = 4096,
                      cap: int = 16, m_out: int = 2048):
    """items: list of dicts with keys
        gwin  (np.uint8 genome window covering hash positions
               [gs, gs + g_n) plus span-1 tail bases)
        g_n   number of genome hash positions (stop - gs)
        gpos0 absolute genome coordinate of gwin[0]
        rwin / r_n / rpos0   same for the read window (step 1)
        rvcp  read_len - 1
        a_lo, a_hi  direction-0 anchor bounds (LLMIN/LLMAX for mapGeneric)
    Returns per item (anchors_in_host_order | None-if-overflow).
    Windows containing N must be filtered by the caller (host fallback).
    """
    B = len(items)
    GW = 5 * g_max + 4 + SHAPE_LEN - 1
    RW = r_max + SHAPE_LEN - 1
    gseq = np.zeros((B, GW), dtype=np.uint8)
    rseq = np.zeros((B, RW), dtype=np.uint8)
    g_n = np.zeros(B, dtype=np.int64)
    r_n = np.zeros(B, dtype=np.int64)
    gpos0 = np.zeros(B, dtype=np.int64)
    rpos0 = np.zeros(B, dtype=np.int64)
    rvcp = np.zeros(B, dtype=np.int64)
    a_lo = np.zeros(B, dtype=np.int64)
    a_hi = np.zeros(B, dtype=np.int64)
    for i, it in enumerate(items):
        gw = it["gwin"][:GW]
        rw = it["rwin"][:RW]
        gseq[i, : len(gw)] = gw
        rseq[i, : len(rw)] = rw
        g_n[i] = min(it["g_n"], GW - SHAPE_LEN + 1)
        r_n[i] = min(it["r_n"], RW - SHAPE_LEN + 1)
        gpos0[i] = it["gpos0"]
        rpos0[i] = it["rpos0"]
        rvcp[i] = it["rvcp"]
        a_lo[i] = max(it.get("a_lo", LLMIN), -(1 << 40))
        a_hi[i] = min(it.get("a_hi", LLMAX), 1 << 40)
    out_a, out_k, count, overflow = _gap_anchors_kernel(
        jnp.asarray(gseq), jnp.asarray(g_n), jnp.asarray(gpos0),
        jnp.asarray(rseq), jnp.asarray(r_n), jnp.asarray(rpos0),
        jnp.asarray(rvcp), jnp.asarray(a_lo), jnp.asarray(a_hi),
        g_max=g_max, r_max=r_max, cap=cap, m_out=m_out)
    out_a = np.asarray(out_a).view(np.uint64)
    count = np.asarray(count)
    overflow = np.asarray(overflow)
    res = []
    for i, it in enumerate(items):
        if overflow[i] or it["g_n"] > 5 * g_max + 4 or it["r_n"] > r_max:
            res.append(None)
        else:
            res.append(out_a[i, : count[i]].copy())
    return res
