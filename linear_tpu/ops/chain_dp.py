"""Device sparse chaining DP — batched getBestChains.

Design:
  - The pairwise score function (getApxChainScore, cluster_util.cpp:387) has
    no DP dependence, so the full (N, N) score matrix is computed in parallel
    first.
  - The DP recurrence (getBestChains, cluster_util.cpp:53) is a fori_loop
    over anchor index; each step is one masked max over a row — vmapped over
    the read batch, so every step advances B reads at once.
  - The C++ inner loop breaks at the first j (descending) failing both the
    depth and dx-depth conditions; because anchors are sorted descending by
    x, dx is monotone in j and the break is exactly equivalent to a mask.
  - Tie-breaking: the C++ takes `>=` while j decreases, so the smallest j
    among maxima wins; jnp.argmax picks the first (smallest) index — same.

Traceback (traceBackChains0/1) is greedy-sequential and tiny (<= N steps);
it runs on the host from the downloaded DP table, bit-exact.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg
_jaxcfg()

NEG = -(2 ** 31) + 1

MASK_Y = (1 << 20) - 1
MASK_X30 = (1 << 30) - 1
VALUE_MASK_DSTR = ((1 << 60) - 1) | (1 << 61)


def _anchor_x(a):
    """getAnchorX (src/cords.cpp:463) on int64 anchors."""
    new = (a + ((a & MASK_Y) << 20) - (1 << 40)) & VALUE_MASK_DSTR
    return (new >> 20) & MASK_X30


def _anchor_y(a):
    return a & MASK_Y


def _tdiv(a, b):
    """C truncating division on int arrays."""
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.where((a < 0) ^ (b < 0), -q, q)


def _apx_chain_score(a1, a2):
    """getApxChainScore (cluster_util.cpp:387), vectorized; a1/a2 int64."""
    dy = _anchor_y(a1) - _anchor_y(a2)
    dx = _anchor_x(a1) - _anchor_x(a2)
    da = jnp.abs(dx - dy)
    denom = jnp.maximum(jnp.maximum(jnp.abs(dy), jnp.abs(dx)), 50)
    derr = _tdiv(100 * da, denom)
    score_derr = jnp.where(
        derr < 5, 4 * derr,
        jnp.where(derr < 10, 6 * derr - 10, derr * derr - 5 * derr))
    dy15 = _tdiv(dy, 15)
    score_dy = jnp.where(
        dy15 < 150, _tdiv(dy15, 5),
        jnp.where(dy15 < 10000, _tdiv(dy15 * dy15, 200) + 20, 10000))
    score = jnp.where(da < 10, 100 - score_dy, 100 - score_dy - score_derr)
    score = jnp.where(derr >= 100, -1000, score)
    score = jnp.where(dy < 10, -10000, score)
    return score.astype(jnp.int32)


def _apx_chain_score0(a1, a2):
    """getApxChainScore0 (cluster_util.cpp:337), toggle(1) variant."""
    dy = _anchor_y(a1) - _anchor_y(a2)
    dx = _anchor_x(a1) - _anchor_x(a2)
    da = jnp.abs(dx - dy)
    denom = jnp.maximum(jnp.maximum(jnp.abs(dy), jnp.abs(dx)), 50)
    derr = _tdiv(100 * da, denom)
    score = jnp.where(da < 30, 100 - dy, 100 - dy - da)
    score = jnp.where(derr >= 100, -1000, score)
    score = jnp.where(dy < 5, -10000, score)
    return score.astype(jnp.int32)


@partial(jax.jit, static_argnames=("thd_chain_depth", "thd_chain_dx_depth", "score_type"))
def batch_chain_dp(anchors: jnp.ndarray, n_anchors: jnp.ndarray,
                   thd_chain_depth: int = 20, thd_chain_dx_depth: int = 300,
                   score_type: int = 0):
    """Batched getBestChains over (B, N) int64 anchors sorted descending by
    anchor-x, padded; n_anchors: (B,) true counts.

    Returns (p2anchor, score, length): each (B, N) int32, identical to the
    C++ ChainsRecord fields (root_ptr/f_leaf are host-derivable from p2anchor).
    """
    B, N = anchors.shape
    score_fn = _apx_chain_score if score_type == 0 else _apx_chain_score0
    ax = _anchor_x(anchors)
    # (B, N, N) score matrix: s[b, j, i] = score(anchors[j], anchors[i])
    s = score_fn(anchors[:, :, None], anchors[:, None, :])  # j rows, i cols
    jj = jnp.arange(N)
    # eligibility of j for i: j < i and (j >= i-depth or ax[j]-ax[i] < dx_depth)
    elig = (jj[:, None] < jj[None, :]) & (
        (jj[:, None] >= jj[None, :] - thd_chain_depth)
        | ((ax[:, :, None] - ax[:, None, :]) < thd_chain_dx_depth)
    )
    cand = s.astype(jnp.int64)

    def body(i, carry):
        score, p2, length = carry
        row = cand[:, :, i]                       # (B, N): s(j, i)
        ok = elig[:, :, i] & (jj[None, :] < n_anchors[:, None])
        tot = jnp.where(ok & (row > 0), row + score.astype(jnp.int64), jnp.int64(NEG))
        new_max = jnp.max(tot, axis=1)
        max_j = jnp.argmax(tot, axis=1).astype(jnp.int32)
        found = new_max > 0
        si = jnp.where(found, new_max.astype(jnp.int32), 0)
        p2i = jnp.where(found, max_j, -1)
        li = jnp.where(found, jnp.take_along_axis(length, max_j[:, None], axis=1)[:, 0] + 1, 1)
        score = score.at[:, i].set(si)
        p2 = p2.at[:, i].set(p2i)
        length = length.at[:, i].set(li)
        return (score, p2, length)

    score0 = jnp.zeros((B, N), dtype=jnp.int32)
    p20 = jnp.full((B, N), -1, dtype=jnp.int32)
    len0 = jnp.ones((B, N), dtype=jnp.int32)
    score, p2, length = jax.lax.fori_loop(0, N, body, (score0, p20, len0))
    return p2, score, length


# chain_records_from_dp lives in map.chaining (numpy-only) so pipeline
# worker processes can rebuild ChainsRecords without importing jax
from ..map.chaining import chain_records_from_dp  # noqa: F401  (re-export)


@partial(jax.jit, static_argnames=("W", "thd_chain_depth", "thd_chain_dx_depth", "score_type"))
def batch_chain_dp_windowed(anchors: jnp.ndarray, n_anchors: jnp.ndarray, W: int = 64,
                            thd_chain_depth: int = 20, thd_chain_dx_depth: int = 300,
                            score_type: int = 0):
    """Windowed-scan formulation of batch_chain_dp: instead of a fori_loop
    with full-array scatters, precompute the (W, B, N) banded edge scores in
    parallel and scan with a (B, W) ring carry of the last W DP scores —
    every step is a small (B, W) elementwise op.

    Only lookbacks within W are considered; `overflow` flags reads where the
    C++ dx-depth condition could reach beyond W (the caller must fall back
    to the exact host/full DP for those reads). Returns
    (p2anchor, score, length, overflow).
    """
    B, N = anchors.shape
    score_fn = _apx_chain_score if score_type == 0 else _apx_chain_score0
    ax = _anchor_x(anchors)
    jj = jnp.arange(N)
    valid = jj[None, :] < n_anchors[:, None]
    # banded edges via ONE gather: edge[b, i, w] = score(a[b, i-(W-w)], a[b, i])
    d = (W - jnp.arange(W))[None, None, :]                  # lookback distance
    j_idx = jj[None, :, None] - d                           # (1, N, W)
    j_clip = jnp.clip(j_idx, 0, N - 1)
    a_j = jnp.take_along_axis(
        anchors, j_clip.reshape(1, -1).repeat(B, axis=0), axis=1).reshape(B, N, W)
    ax_j = jnp.take_along_axis(
        ax, j_clip.reshape(1, -1).repeat(B, axis=0), axis=1).reshape(B, N, W)
    edge = score_fn(a_j, anchors[:, :, None])               # (B, N, W)
    elig = (j_idx >= 0) & valid[:, :, None] & (
        (j_idx >= (jj[None, :, None] - thd_chain_depth))
        | ((ax_j - ax[:, :, None]) < thd_chain_dx_depth)
    )
    NEGI = jnp.int64(-(1 << 40))

    def step(ring, xs):
        e_i, ok_i = xs                     # (B, W), (B, W)
        tot = jnp.where(ok_i & (e_i > 0), e_i.astype(jnp.int64) + ring[0], NEGI)
        new_max = jnp.max(tot, axis=1)
        arg = jnp.argmax(tot, axis=1)      # smallest w (= smallest j) on ties
        found = new_max > 0
        s_i = jnp.where(found, new_max, 0).astype(jnp.int64)
        scores, lens = ring
        l_j = jnp.take_along_axis(lens, arg[:, None], axis=1)[:, 0]
        l_i = jnp.where(found, l_j + 1, 1)
        scores = jnp.concatenate([scores[:, 1:], s_i[:, None]], axis=1)
        lens = jnp.concatenate([lens[:, 1:], l_i[:, None]], axis=1)
        p2_rel = jnp.where(found, arg, -1).astype(jnp.int32)
        return (scores, lens), (s_i.astype(jnp.int32), l_i.astype(jnp.int32), p2_rel)

    ring0 = (jnp.zeros((B, W), dtype=jnp.int64), jnp.ones((B, W), dtype=jnp.int32))
    xs = (jnp.moveaxis(edge, 1, 0), jnp.moveaxis(elig, 1, 0))  # (N, B, W)
    _, (scores, lens, p2_rel) = jax.lax.scan(step, ring0, xs)
    scores = scores.T      # (B, N)
    lens = lens.T
    p2_rel = p2_rel.T
    # p2 absolute: j = i - (W - w)
    ii = jnp.arange(N)[None, :]
    p2 = jnp.where(p2_rel >= 0, ii - (W - p2_rel), -1).astype(jnp.int32)
    # overflow: some j < i - W could satisfy the dx-depth condition
    ax_far = jnp.pad(ax, ((0, 0), (W + 1, 0)), constant_values=(1 << 40))[:, :N]
    overflow = jnp.any(((ax_far - ax) < thd_chain_dx_depth) & valid & (jj[None, :] > W), axis=1)
    return p2, scores, lens, overflow
