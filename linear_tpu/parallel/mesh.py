"""Multi-chip mapping: reads data-parallel over a device mesh.

The reference is single-node OpenMP (SURVEY §2.3); the scaling axes are:
  - dp: read batches sharded across devices (this module) — the analog of
    the reference's omp-for over reads (src/mapper.cpp:796).
  - ix: the k-mer table sharded by xval range for genomes larger than one
    device's memory, per-shard anchor candidates merged with one psum.

`mapping_step` is the jittable device portion of the per-read pipeline
(seed -> anchors -> sort -> chain DP); under a Mesh it is sharded so each
chip processes its slice of the batch with the index replicated.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxcfg import configure as _jaxcfg
_jaxcfg()
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.chain_dp import batch_chain_dp, batch_chain_dp_windowed, _anchor_x
from ..ops.seeding import batch_seed_anchors, batch_seed_anchors_fast


@partial(jax.jit, static_argnames=("cap", "n_max", "thd_alpha", "fast"))
def mapping_step(seqs: jnp.ndarray, lens: jnp.ndarray,
                 dir_start: jnp.ndarray, hs_lo: jnp.ndarray, hs_hi: jnp.ndarray,
                 cap: int = 8, n_max: int = 256, thd_alpha: int = 15,
                 fast: bool = False):
    """Device mapping step: seed anchors, sort descending by anchor-x, run
    the chaining DP. Returns (anchors_sorted, n_anchors, p2, score, length).
    fast=True uses the closed-form seeding (exact for N-free batches; the
    caller checks for N bases and falls back to the exact scan kernel).
    """
    seeder = batch_seed_anchors_fast if fast else batch_seed_anchors
    anc, keep = seeder(seqs, lens, dir_start, hs_lo, hs_hi,
                       thd_alpha=thd_alpha, cap=cap)
    B = anc.shape[0]
    flat = anc.reshape(B, -1)
    kflat = keep.reshape(B, -1)
    n_anchors = jnp.minimum(jnp.sum(kflat, axis=1), n_max).astype(jnp.int32)
    ax = _anchor_x(flat)
    # invalid anchors sort to the end: key = (-valid, -ax)
    key = jnp.where(kflat, -ax, jnp.int64(1) << 62)
    order = jnp.argsort(key, axis=1)[:, :n_max]
    sorted_anc = jnp.take_along_axis(flat, order, axis=1)
    p2, score, length, overflow = batch_chain_dp_windowed(sorted_anc, n_anchors, W=64)
    return sorted_anc, n_anchors, p2, score, length, overflow


def make_dp_mesh(devices=None, axis: str = "dp") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def gput(arr, sharding):
    """device_put that also works under multi-process jax.distributed: a
    NamedSharding over a multi-host mesh is not fully addressable, so the
    global array is assembled from each process's local shards (every
    process holds the full numpy array; the callback serves its slice)."""
    if jax.process_count() > 1:
        arr = np.asarray(arr)
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])
    return jax.device_put(arr, sharding)


def shard_index_by_xval(index, n_shards: int):
    """Split a host DIndex into n_shards contiguous-xval shards for the
    >HBM-genome axis (SURVEY §2.3 "index sharding"): shard s holds
    dir[x_lo..x_hi] rebased to 0 and the hs slice it points into, padded to
    a common size. Returns (dir_sh, hs_lo_sh, hs_hi_sh, x_base, cap):
    leading dim n_shards, ready for shard_map over an "ix" axis."""
    n_x = index.dir.shape[0] - 1
    bounds = [n_x * s // n_shards for s in range(n_shards + 1)]
    dir_len = max(bounds[s + 1] - bounds[s] for s in range(n_shards)) + 1
    hs_len = max(int(index.dir[bounds[s + 1]] - index.dir[bounds[s]])
                 for s in range(n_shards))
    hs_len = max(hs_len, 1)
    dir_sh = np.zeros((n_shards, dir_len), dtype=np.int64)
    lo_sh = np.zeros((n_shards, hs_len), dtype=np.uint32)
    hi_sh = np.zeros((n_shards, hs_len), dtype=np.uint32)
    x_base = np.zeros((n_shards, 2), dtype=np.int64)
    hs = index.hs
    for s in range(n_shards):
        b0, b1 = bounds[s], bounds[s + 1]
        d = index.dir[b0: b1 + 1] - index.dir[b0]
        dir_sh[s, : len(d)] = d
        dir_sh[s, len(d):] = d[-1]
        sl = hs[index.dir[b0]: index.dir[b1]]
        lo_sh[s, : len(sl)] = (sl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi_sh[s, : len(sl)] = (sl >> np.uint64(32)).astype(np.uint32)
        x_base[s] = (b0, b1)
    from ..ops.seeding import bucket_cap

    counts = np.diff(index.dir)
    cap = bucket_cap(int(counts.max()) if len(hs) else 1)
    return dir_sh, lo_sh, hi_sh, x_base, cap


def index_sharded_seed_step(mesh: Mesh, seqs, lens,
                            dir_sh, hs_lo_sh, hs_hi_sh, x_base,
                            cap: int, axis: str = "ix",
                            span: int = 21, weight: int = 13,
                            thd_alpha: int = 15):
    """Seed anchors with the k-mer table SHARDED across the mesh axis and
    the read batch replicated: every chip probes its xval range, then one
    psum merges the per-shard candidates (each (pos, slot) is
    owned by exactly one shard, so the sum reconstructs the replicated
    kernel's output bit-for-bit). This is the >HBM-genome scaling axis."""
    from functools import partial as _partial


    from ..ops.seeding import _closed_form_states, _minimizer_xy_batch, _probe_and_anchor

    B, L = seqs.shape

    def shard_fn(seqs, lens, dir_s, lo_s, hi_s, xb):
        dir_s, lo_s, hi_s, xb = dir_s[0], lo_s[0], hi_s[0], xb[0]
        first = span + thd_alpha - 1
        ks = jnp.arange(first, L, thd_alpha, dtype=jnp.int64)
        kmat = jnp.broadcast_to(ks[None, :], (B, ks.shape[0]))
        in_range = kmat < (lens[:, None] - span)
        n_mix = int(np.sum(np.arange(first, L, thd_alpha) < 2 * span - 1))
        h, crh, x = _closed_form_states(seqs, kmat, span, n_mix=n_mix)
        xval, yval, strand = _minimizer_xy_batch(seqs, kmat, h, crh, x, span, weight)
        anc, keep = _probe_and_anchor(kmat, lens, xval, yval, strand,
                                      dir_s, lo_s, hi_s, cap, in_range,
                                      x_base=xb[0], x_hi=xb[1])
        anc = jax.lax.psum(jnp.where(keep, anc, 0), axis)
        keep = jax.lax.psum(keep.astype(jnp.int32), axis) > 0
        return anc, keep

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(), P()),
    )
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis, None))
    return fn(gput(seqs, rep), gput(lens, rep),
              gput(dir_sh, shd), gput(hs_lo_sh, shd),
              gput(hs_hi_sh, shd), gput(x_base, shd))


def sharded_mapping_step(mesh: Mesh, seqs, lens, dir_start, hs_lo, hs_hi,
                         cap: int = 8, n_max: int = 256):
    """Run mapping_step with the read batch sharded over the mesh's dp axis
    and the index replicated on every chip (lookup tables ride HBM locally;
    no collectives needed until index sharding lands)."""
    dp = NamedSharding(mesh, P("dp"))
    dp2 = NamedSharding(mesh, P("dp", None))
    rep = NamedSharding(mesh, P())
    seqs = gput(seqs, dp2)
    lens = gput(lens, dp)
    dir_start = gput(dir_start, rep)
    hs_lo = gput(hs_lo, rep)
    hs_hi = gput(hs_hi, rep)
    return mapping_step(seqs, lens, dir_start, hs_lo, hs_hi, cap=cap, n_max=n_max)


# init_distributed moved to linear_tpu.parallel.dist (import-light: it must
# run BEFORE this module's imports initialize the XLA backend); re-exported
# here for compatibility
from .dist import init_distributed  # noqa: E402,F401


def make_grid_mesh(n_dp: int, n_ix: int, devices=None) -> Mesh:
    """2D (dp, ix) mesh: reads sharded over dp, k-mer table sharded over
    ix. dp should ride the outer (host) axis and ix the inner axis so the
    per-read psum merge stays within a host."""
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_dp * n_ix
    arr = np.array(devices[: n_dp * n_ix]).reshape(n_dp, n_ix)
    return Mesh(arr, ("dp", "ix"))


def grid_seed_anchors(mesh: Mesh, seqs, lens, dir_sh, hs_lo_sh, hs_hi_sh,
                      x_base, cap: int,
                      span: int = 21, weight: int = 13, thd_alpha: int = 15):
    """The seed+merge phase of grid_mapping_step alone: returns the
    (B, n_samples, cap) anchor grid + keep mask in EMISSION-SLOT order
    (position-major, bucket-entry order) — the exact per-read host seed
    list is anc[b].reshape(-1)[keep[b].reshape(-1)]. Used by the
    end-to-end 2-process run (tools/e2e_multiproc.py), whose residual
    pipeline consumes the seeds in host emission order."""

    from ..ops.seeding import (_closed_form_states, _minimizer_xy_batch,
                               _probe_and_anchor)

    B, L = seqs.shape
    n_dp = mesh.shape["dp"]
    Bs = B // n_dp

    def shard_fn(seqs, lens, dir_s, lo_s, hi_s, xb):
        dir_s, lo_s, hi_s, xb = dir_s[0], lo_s[0], hi_s[0], xb[0]
        first = span + thd_alpha - 1
        ks = jnp.arange(first, L, thd_alpha, dtype=jnp.int64)
        kmat = jnp.broadcast_to(ks[None, :], (Bs, ks.shape[0]))
        in_range = kmat < (lens[:, None] - span)
        n_mix = int(np.sum(np.arange(first, L, thd_alpha) < 2 * span - 1))
        h, crh, x = _closed_form_states(seqs, kmat, span, n_mix=n_mix)
        xval, yval, strand = _minimizer_xy_batch(seqs, kmat, h, crh, x, span, weight)
        anc, keep = _probe_and_anchor(kmat, lens, xval, yval, strand,
                                      dir_s, lo_s, hi_s, cap, in_range,
                                      x_base=xb[0], x_hi=xb[1])
        anc = jax.lax.psum(jnp.where(keep, anc, 0), "ix")
        keep = jax.lax.psum(keep.astype(jnp.int32), "ix") > 0
        return anc, keep

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P("ix", None), P("ix", None),
                  P("ix", None), P("ix", None)),
        out_specs=(P("dp", None, None), P("dp", None, None)),
    )
    dp2 = NamedSharding(mesh, P("dp", None))
    dp1 = NamedSharding(mesh, P("dp"))
    ix2 = NamedSharding(mesh, P("ix", None))
    return fn(gput(seqs, dp2), gput(lens, dp1),
              gput(dir_sh, ix2), gput(hs_lo_sh, ix2),
              gput(hs_hi_sh, ix2), gput(x_base, ix2))


def grid_mapping_step(mesh: Mesh, seqs, lens, dir_sh, hs_lo_sh, hs_hi_sh,
                      x_base, cap: int, n_max: int = 256,
                      span: int = 21, weight: int = 13, thd_alpha: int = 15):
    """Full device mapping step on a 2D (dp, ix) mesh: each chip probes
    (its read shard x its xval shard), one psum over the ix axis merges the
    per-shard anchors (each (pos, slot) owned by exactly one shard), then
    the descending-anchor-x sort + windowed chain DP run on the merged
    dp-sharded anchors — the all-gather-into-chaining step of SURVEY §2.3.
    The seed+merge phase is explicit shard_map; the sort+chain phase is
    plain jit over dp-sharded arrays (XLA partitions it; the DP kernel's
    internal scan carries don't compose with shard_map's varying-axis
    typing). Bit-identical to mapping_step on one device (asserted by
    tests/test_mesh_shard.py + __graft_entry__.dryrun_multichip)."""

    from ..ops.chain_dp import batch_chain_dp_windowed as _chain
    from ..ops.seeding import (_closed_form_states, _minimizer_xy_batch,
                               _probe_and_anchor)

    B, L = seqs.shape
    n_dp = mesh.shape["dp"]
    Bs = B // n_dp

    def shard_fn(seqs, lens, dir_s, lo_s, hi_s, xb):
        dir_s, lo_s, hi_s, xb = dir_s[0], lo_s[0], hi_s[0], xb[0]
        first = span + thd_alpha - 1
        ks = jnp.arange(first, L, thd_alpha, dtype=jnp.int64)
        kmat = jnp.broadcast_to(ks[None, :], (Bs, ks.shape[0]))
        in_range = kmat < (lens[:, None] - span)
        n_mix = int(np.sum(np.arange(first, L, thd_alpha) < 2 * span - 1))
        h, crh, x = _closed_form_states(seqs, kmat, span, n_mix=n_mix)
        xval, yval, strand = _minimizer_xy_batch(seqs, kmat, h, crh, x, span, weight)
        anc, keep = _probe_and_anchor(kmat, lens, xval, yval, strand,
                                      dir_s, lo_s, hi_s, cap, in_range,
                                      x_base=xb[0], x_hi=xb[1])
        anc = jax.lax.psum(jnp.where(keep, anc, 0), "ix")
        keep = jax.lax.psum(keep.astype(jnp.int32), "ix") > 0
        return anc, keep

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P("ix", None), P("ix", None),
                  P("ix", None), P("ix", None)),
        out_specs=(P("dp", None, None), P("dp", None, None)),
    )
    dp2 = NamedSharding(mesh, P("dp", None))
    dp1 = NamedSharding(mesh, P("dp"))
    ix2 = NamedSharding(mesh, P("ix", None))
    anc, keep = fn(gput(seqs, dp2), gput(lens, dp1),
                   gput(dir_sh, ix2), gput(hs_lo_sh, ix2),
                   gput(hs_hi_sh, ix2), gput(x_base, ix2))

    @partial(jax.jit, static_argnames=("n_max",))
    def sort_chain(anc, keep, n_max):
        B2 = anc.shape[0]
        flat = anc.reshape(B2, -1)
        kflat = keep.reshape(B2, -1)
        n_anchors = jnp.minimum(jnp.sum(kflat, axis=1), n_max).astype(jnp.int32)
        ax = _anchor_x(flat)
        key = jnp.where(kflat, -ax, jnp.int64(1) << 62)
        order = jnp.argsort(key, axis=1)[:, :n_max]
        sorted_anc = jnp.take_along_axis(flat, order, axis=1)
        p2, score, length, overflow = _chain(sorted_anc, n_anchors, W=64)
        return sorted_anc, n_anchors, p2, score, length, overflow

    return sort_chain(anc, keep, n_max)


def sharded_extend_step(mesh: Mesh, packed, lens, hits, n_hits, gf,
                        H: int, C: int, R: int, max_iter: int):
    """Device dense-window extension (_filterHits + path_dst_2,
    ops.extend_dev) with the read batch sharded over dp and the genome
    feature table replicated — completes the seed->chain->extend device
    pipeline on the mesh."""
    from ..ops import extend_dev as ED

    dp2 = NamedSharding(mesh, P("dp", None))
    dp1 = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    return ED.batch_filter_extend_packed(
        gput(packed, dp2), gput(lens, dp1),
        gput(hits, dp2), gput(n_hits, dp1),
        gput(gf.cat, rep), gput(gf.off, rep),
        gput(gf.rows, rep), H=H, C=C, R=R, max_iter=max_iter)
