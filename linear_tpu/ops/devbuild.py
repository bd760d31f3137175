"""Device-side DIndex build (SURVEY §7.1.3; reference createDIndex
src/index_util.cpp:1628-1803).

The host build is a scan + counting sort with atomic slot claiming; the
device build replaces every sequential piece with data-parallel ops:

  sample states   window packs gathered at the sampled positions (the
                  build stream telescopes to pure span-windows) + the
                  vectorized minimizer (ops.seeding._minimizer_xy_batch)
  emission rule   "emit iff xval != last-emitted xval or j-gap > max_step"
                  — an associative max-scan over run starts (the closed
                  form derived in ops.hashing.emit_mask_index)
  counting sort   scatter-add histogram -> cumsum -> one jax.lax.sort by
                  (xval, cord); omitted buckets (> thd_omit_block) drop
                  to the tail

Bit-equal to the host build (tests/test_devbuild.py) for N-free genomes;
genomes with N bases fall back to the host build (the reference's N-skip
re-init quirks are scan-order-dependent). The built tables stay in device
memory, ready for the seed kernels (device_build_to_index returns the same
DeviceIndex layout as seeding.upload_index).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg

_jaxcfg()

from ..index.dindex import DEFAULT_MAX_STEP  # noqa: E402
from ..index.dindex import (DEFAULT_MIN_STEP, DEFAULT_OMIT_BLOCK,
                            DEFAULT_SPAN, DEFAULT_WEIGHT, DIndex,
                            thread_blocks)
from . import seeding as SD  # noqa: E402

CONST_ANCHOR_ZERO = 1 << 20


@partial(jax.jit, static_argnames=("span", "weight"))
def _sample_states(genome, j, span: int, weight: int):
    """(xval, yval, strand) at sample positions j of a device genome."""
    L = genome.shape[0]
    g = genome.astype(jnp.uint64)
    idx = j[:, None] + jnp.arange(span)[None, :]
    gat = jnp.take(g, jnp.clip(idx, 0, L - 1).reshape(-1)).reshape(idx.shape)
    coef_f = jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(span - 1, -1, -1, dtype=jnp.uint64))
    coef_r = jnp.uint64(1) << (jnp.uint64(2) * jnp.arange(span, dtype=jnp.uint64))
    h = jnp.sum(gat * coef_f[None, :], axis=1)
    crh = jnp.sum((jnp.uint64(3) - gat) * coef_r[None, :], axis=1)
    x = 2 * jnp.sum(gat.astype(jnp.int64), axis=1) - 3 * span
    xval, yval, strand = SD._minimizer_xy_batch(
        genome[None, :], j[None, :], h[None, :], crh[None, :], x[None, :],
        span, weight)
    return xval[0].astype(jnp.int64), yval[0], strand[0]


@partial(jax.jit, static_argnames=("full", "omit_block", "q"))
def _emit_count_sort(xv, yv, st, jj, gid, block_start, valid,
                     full: int, omit_block: int, q: int):
    """Emission mask + histogram + omit + cumsum + (xval, cord) sort."""
    n = xv.shape[0]
    idxs = jnp.arange(n, dtype=jnp.int64)
    prev = jnp.concatenate([jnp.full((1,), -1, dtype=xv.dtype), xv[:-1]])
    run_start = (xv != prev) | block_start
    start_idx = jax.lax.associative_scan(jnp.maximum,
                                         jnp.where(run_start, idxs, 0))
    emit = (((idxs - start_idx) % q) == 0) & valid
    counts = jnp.zeros((full - 1,), dtype=jnp.int32)
    counts = counts.at[xv].add(jnp.where(emit, 1, 0).astype(jnp.int32),
                               mode="drop")
    omitted = counts > omit_block
    kept_counts = jnp.where(omitted, 0, counts)
    dirp = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(kept_counts, dtype=jnp.int32)])
    cord = (((gid << 30) + (jj + CONST_ANCHOR_ZERO)) << 20) + yv + (st << 61)
    kept = emit & ~omitted[jnp.clip(xv, 0, full - 2)]
    key = jnp.where(kept, xv, jnp.int64(full))
    skey, scord = jax.lax.sort((key, cord), num_keys=2)
    return dirp, scord, kept.sum()


def build_dindex_device(
    seqs: list[np.ndarray],
    span: int = DEFAULT_SPAN,
    weight: int = DEFAULT_WEIGHT,
    min_step: int = DEFAULT_MIN_STEP,
    max_step: int = DEFAULT_MAX_STEP,
    omit_block: int = DEFAULT_OMIT_BLOCK,
    threads_emul: int = 16,
    chunk: int = 1 << 20,
):
    """Device DIndex build. Returns (dir int32 device array, hs u64 device
    array trimmed to n_kept, n_kept). Raises ValueError for genomes with N
    bases (caller falls back to the host build)."""
    full = (1 << (2 * weight)) + 1
    stride = min_step + 1
    q = max_step // stride + 1
    xs, ys, ss, js, gs, bs = [], [], [], [], [], []
    valid: list = []
    for gid, seq in enumerate(seqs):
        if (seq == 4).any():
            raise ValueError("device DIndex build requires an N-free genome")
        g_dev = jax.device_put(jnp.asarray(seq, dtype=jnp.int32))
        for t_str, t_end in thread_blocks(len(seq), span, threads_emul):
            if t_end <= t_str:
                continue
            sample_j = np.arange(t_str + min_step, t_end, stride, dtype=np.int64)
            if len(sample_j) == 0:
                continue
            first = True
            for c0 in range(0, len(sample_j), chunk):
                sj = sample_j[c0: c0 + chunk]
                pad = chunk if len(sample_j) > chunk else len(sj)
                v = np.zeros(pad, dtype=bool)
                v[: len(sj)] = True
                sj_p = np.zeros(pad, dtype=np.int64)
                sj_p[: len(sj)] = sj
                xv, yv, st = _sample_states(g_dev, jnp.asarray(sj_p), span, weight)
                b = np.zeros(pad, dtype=bool)
                b[0] = first
                first = False
                xs.append(xv)
                ys.append(yv)
                ss.append(st)
                js.append(jnp.asarray(sj_p))
                gs.append(jnp.full((pad,), gid, dtype=jnp.int64))
                bs.append(jnp.asarray(b))
                # invalid tail must not join the previous run: mark the
                # first invalid slot as a block start so later blocks
                # restart their runs
                if not v.all():
                    b2 = np.zeros(pad, dtype=bool)
                    b2[len(sj)] = True
                    bs[-1] = jnp.asarray(b | b2)
                xs[-1] = jnp.where(jnp.asarray(v), xs[-1], jnp.int64(full - 2))
                js[-1] = jnp.where(jnp.asarray(v), js[-1], 0)
                vs = jnp.asarray(v)
                ys[-1] = jnp.where(vs, ys[-1], 0)
                ss[-1] = jnp.where(vs, ss[-1], 0)
                gs[-1] = jnp.where(vs, gs[-1], 0)
                valid.append(vs)
    if not xs:
        dirp = jnp.zeros((full,), jnp.int32)
        return dirp, jnp.zeros((0,), jnp.int64), 0
    xv = jnp.concatenate(xs)
    yv = jnp.concatenate(ys)
    st = jnp.concatenate(ss)
    jj = jnp.concatenate(js)
    gid = jnp.concatenate(gs)
    bsv = jnp.concatenate(bs)
    vv = jnp.concatenate(valid)
    dirp, scord, n_kept = _emit_count_sort(xv, yv, st, jj, gid, bsv, vv,
                                           full=full, omit_block=omit_block,
                                           q=q)
    return dirp, scord, int(n_kept)


def device_build_to_index(dirp, scord, n_kept: int) -> "SD.DeviceIndex":
    """Wrap the device build outputs as a seeding.DeviceIndex WITHOUT any
    host round trip of the tables (the 268 MB dir never crosses to the
    host): dir stays as built, hs splits into (lo, hi) uint32 on device.
    Only the bucket cap (one scalar) is fetched."""
    hs = scord[:n_kept].astype(jnp.uint64)
    cap = int(jnp.max(dirp[1:] - dirp[:-1])) if n_kept else 1
    return SD.DeviceIndex(
        dir_start=dirp.astype(jnp.int32),
        hs_lo=(hs & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
        hs_hi=(hs >> jnp.uint64(32)).astype(jnp.uint32),
        cap=SD.bucket_cap(cap),
    )


def build_dindex_device_host(seqs, **kw) -> DIndex:
    """Device build fetched back as a host DIndex (for equality tests and
    as a drop-in for the host builder)."""
    dirp, scord, n_kept = build_dindex_device(seqs, **kw)
    hs = np.asarray(scord[:n_kept]).view(np.uint64)
    return DIndex(span=kw.get("span", DEFAULT_SPAN),
                  weight=kw.get("weight", DEFAULT_WEIGHT),
                  dir=np.asarray(dirp), hs=hs)
