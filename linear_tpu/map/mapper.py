"""Host mapping orchestration: genomes + reads -> cords -> SAM/APF.

Mirrors the reference's production pipeline path (Mapper::p_calRecords
src/mapper.cpp:404-473 + print path :476-595): per read
  features(fwd, rc) -> apxMap -> [mapGaps] -> cords2BamLink -> fill -> SAM.

This is the exact host oracle; the device pipeline (linear_tpu.ops /
linear_tpu.parallel, `device="accel"`) accelerates the hot stages and must
reproduce these results bit-for-bit on the device/host boundary (cords).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..index import dindex as DI
from ..ops import features as F
from ..utils import seqio
from ..out import bamlink as BL
from ..out.apf import print_cords_apf
from . import pmpfinder as PMP

THD_MIN_READ_LEN = 200  # src/mapper.cpp:430


@dataclass
class MapperConfig:
    """CLI-level options subset (reference Options, src/base.cpp:26-54)."""

    gap_len: int = 1           # -g; 0 disables the gap module
    apx_chain_flag: int = 1    # -c inverse; f_chain
    aln_flag: int = 0          # -a
    output_type: int = 2       # -ot; 1 apf, 2 sam, 4 bam, 8 pbsv-bam
    threads: int = 16          # -t (affects index build block decomposition)
    index_type: int = 1        # -i
    # -p; the reference's EFFECTIVE default is 1 (Options ctor sensitivity(1),
    # src/base.cpp:43; no CLI default registered): thd_DI=80, thd_X=200 and
    # anchor-chain stop-ratio 0 (src/mapper.cpp:181-188)
    preset: int = 1
    read_group: str = ""       # -rg (Options ctor default "", src/base.cpp:47)
    sample_name: str = ""      # -sn
    cmd_line: str = ""
    sequence_sam: int = 0      # -ss
    reform_ccs: int = 0        # -r (functional here; dead-wired in reference)
    f_dup: int = 0             # -dup
    bal_flag: int = 1          # -b; 0 = batch mode (deterministic omp-static
    #                            GapParms partition), 1 = pipeline schedule
    # -f; C++ setFeatureType dispatch (src/pmpfinder.cpp:59-73): 0 -> 1_16,
    # 1 -> 1_32, else 2_48
    feature_t: int = 2

    @property
    def thd_DI(self) -> int:
        return 80 if self.preset == 1 else BL.INF60

    @property
    def thd_X(self) -> int:
        return 200 if self.preset == 1 else BL.INF60

    @property
    def cah_stop_ratio(self) -> float:
        """ChainAnchorsHitsParms.thd_stop_chain_len_ratio: its ctor default
        0.7 survives only for preset 0; presets 1/2 zero it
        (src/mapper.cpp:174-197 — note every preset uses parm0's MapParms;
        the parm1/parm2 definitions are dead)."""
        return 0.7 if self.preset == 0 else 0.0


class Mapper:
    """Holds genomes, features, index; maps read blocks."""

    def __init__(self, genome_paths: List[str], cfg: Optional[MapperConfig] = None,
                 device: str = "host"):
        self.cfg = cfg or MapperConfig()
        self.device = device
        gset = seqio.load_genomes(genome_paths)
        # genome ids are truncated at the first space (src/base.cpp:188-195)
        self.genome_ids = [g.split(" ")[0] for g in gset.ids]
        self.genomes = gset.seqs
        self.genome_lens = [len(s) for s in self.genomes]
        self.f2: List[PMP.Feats] = []
        self.index: Optional[DI.DIndex] = None
        self._dev_index = None
        self._dev_gfeats = None
        # per-emulated-thread PMPParms toggle leak (see PMPParms.did_toggle):
        # True once any earlier read on that thread ran the re-apx/retry
        # path, leaving the persistent parms in toggle(0) state
        self._pmp_toggled: dict = {}
        self._gap_parms = {}
        self._f1_bufs: dict = {}  # per-tid persistent read-feature buffers
        self._nengine = None  # lazy per-process native engine (lt_engine)

    # fixed device batch size: keeps the jitted kernel shapes constant
    # across blocks (one compile per (B, pad) bucket, persistent-cached)
    DEV_BATCH = 256
    # superchunk rows per fused h2d/d2h pair in the block seeding path
    # (see ops.seeding._seed_superchunk_fused)
    SEED_SUPERCHUNK = 1024
    # per-read anchor slots of the fused seed output (measured p100 on the
    # bench corpus is 80; probed > SEED_M_OUT falls back to host seeding)
    SEED_M_OUT = 128
    # hits cap of the device extension phase (one compile per (H, pad))
    EXT_H = 256

    def _device_seed_block(self, reads: "seqio.SeqSet"):
        """Batched device seeding for a read block (exact vs the host
        oracle); returns per-read anchor lists or None entries for reads the
        device path does not cover (too long for the pad bucket)."""
        disp = self._device_seed_dispatch(reads)
        return self._device_seed_finish(reads, disp)

    def _ensure_dev_index(self):
        """Device k-mer tables, created on first use (deliberately AFTER
        the pipeline forks its workers: the JAX backend must not exist in
        the parent at fork time). Two paths:
          - N-free genomes: BUILD the tables on device (ops.devbuild) —
            the genome ships instead of the dense dir table (268 MB for
            weight 13); bit-equal to the host build (tests/test_devbuild.py).
          - otherwise: upload the host-built tables."""
        if self._dev_index is not None:
            return self._dev_index
        from ..ops import seeding as SD

        if not any((s == 4).any() for s in self.genomes):
            from ..ops import devbuild as DB

            dirp, scord, n_kept = DB.build_dindex_device(
                self.genomes, threads_emul=self.cfg.threads)
            self._dev_index = DB.device_build_to_index(dirp, scord, n_kept)
            return self._dev_index
        self._dev_index = SD.upload_index(self.index)
        return self._dev_index

    def _device_seed_dispatch(self, reads: "seqio.SeqSet"):
        """Async phase: enqueue all device work for a block (one h2d + one
        fused kernel/d2h per superchunk) and return a handle; no sync."""
        from ..ops import seeding as SD

        self._ensure_dev_index()
        eligible = [i for i, r in enumerate(reads.seqs)
                    if THD_MIN_READ_LEN < len(r) <= (1 << 17)]
        if not eligible:
            return ("none", eligible, None)
        pad = 1 << max(int(np.ceil(np.log2(max(
            len(reads.seqs[i]) for i in eligible)))), 10)
        block = SD.seed_block_dispatch(
            [reads.seqs[i] for i in eligible], self._dev_index, pad_len=pad,
            m_out=self.SEED_M_OUT, superchunk=self.SEED_SUPERCHUNK)
        return ("block", eligible, block)

    def _device_seed_finish(self, reads: "seqio.SeqSet", disp):
        """Sync phase of _device_seed_dispatch: per-read anchor lists."""
        from ..ops import seeding as SD

        kind, eligible, payload = disp
        out: List = [None] * len(reads.seqs)
        if kind == "none":
            return out
        anchors = SD.seed_block_collect(payload, m_out=self.SEED_M_OUT)
        for i, a in zip(eligible, anchors):
            out[i] = a
        return out

    # second-tier anchor capacity for reads whose probe overflows
    # SEED_M_OUT (23% of the realistic corpus at 128; 1.4% exceed 512 —
    # probed distribution p50=86 p95=423 max=1275). The tier-2 superchunk
    # is 4x smaller: at m_out=512 a full-width chunk's fused d2h would be
    # 4.2 MB of mostly padding
    SEED_M_OUT2 = 512
    SEED_SUPERCHUNK2 = 256

    def _device_seed_stream2(self, reads: "seqio.SeqSet"):
        """Incremental device seeding with m_out tiering: yields
        (idx_list, anchors_list) batches as each superchunk's results land.
        idx are read indices within `reads`; anchors entries are uint64
        arrays or None (N bases / overflowed both tiers -> host seeding).
        Reads never yielded (ineligible) are the caller's to host-seed; a
        device failure raises. Packing of chunk k+1 overlaps the transfer
        of chunk k; tier-2 redispatch (m_out=512) runs after the base pass
        so late pipeline tasks still benefit from it."""
        from ..ops import seeding as SD

        self._ensure_dev_index()
        eligible = [i for i, r in enumerate(reads.seqs)
                    if THD_MIN_READ_LEN < len(r) <= (1 << 17)]
        if not eligible:
            return
        pad = 1 << max(int(np.ceil(np.log2(max(
            len(reads.seqs[i]) for i in eligible)))), 10)
        SC = self.SEED_SUPERCHUNK
        SC2 = self.SEED_SUPERCHUNK2
        pending = []  # (handle, idxs, n_mask, m_out)

        def dispatch(idxs, m_out, rows):
            w, n_mask = SD.pack_superchunk(
                [reads.seqs[i] for i in idxs], pad, rows)
            h = SD.dispatch_wire(w, self._dev_index, m_out)
            pending.append((h, idxs, n_mask, m_out))

        for c0 in range(0, len(eligible), SC):
            dispatch(eligible[c0: c0 + SC], self.SEED_M_OUT, SC)
        n_base = len(pending)
        retry: List[int] = []
        k = 0
        while k < len(pending):
            h, idxs, n_mask, m_out = pending[k]
            k += 1
            anchors, overflow = SD.collect_wire(h, len(idxs), n_mask, m_out)
            if m_out == self.SEED_M_OUT:
                # queue tier-2 for overflowed reads; dispatch when a full
                # superchunk accumulates or once the base pass is collected
                keep_i, keep_a = [], []
                for i, a, ov in zip(idxs, anchors, overflow):
                    if ov:
                        retry.append(i)
                    else:
                        keep_i.append(i)
                        keep_a.append(a)
                while len(retry) >= SC2 or (retry and k >= n_base):
                    dispatch(retry[:SC2], self.SEED_M_OUT2, SC2)
                    del retry[:SC2]
                if keep_i:
                    yield keep_i, keep_a
            else:
                yield idxs, anchors

    def _device_extend_block(self, reads: "seqio.SeqSet", hits_list: List):
        """Batched device _filterHits + path_dst_2 (ops.extend_dev) for a
        read block: ships hits in / cords out; returns per-read uint64
        cords arrays, or None entries for reads the device does not cover
        (N bases, too long, hits overflow) — the caller falls back to the
        full host engine for those."""
        import jax.numpy as jnp

        from ..ops import extend_dev as ED

        if self._dev_gfeats is None:
            self._dev_gfeats = ED.upload_genome_feats([f.arr for f in self.f2])
        gf = self._dev_gfeats
        out: List = [None] * len(reads.seqs)
        eligible = [i for i, r in enumerate(reads.seqs)
                    if (hits_list[i] is not None
                        and THD_MIN_READ_LEN < len(r) <= (1 << 17)
                        and len(hits_list[i]) <= self.EXT_H
                        and not (r == 4).any())]
        pending = []
        for c0 in range(0, len(eligible), self.DEV_BATCH):
            chunk = eligible[c0: c0 + self.DEV_BATCH]
            pad = 1 << max(int(np.ceil(np.log2(max(len(reads.seqs[i]) for i in chunk)))), 10)
            B = self.DEV_BATCH
            H = self.EXT_H
            C = H + pad // 32
            R = ((pad - 48) >> 4) + 1
            seqs = np.zeros((B, pad), dtype=np.uint8)
            lens = np.zeros((B,), dtype=np.int64)
            hitm = np.zeros((B, H), dtype=np.uint64)
            hitn = np.zeros((B,), dtype=np.int32)
            for k, i in enumerate(chunk):
                r = reads.seqs[i]
                seqs[k, : len(r)] = r
                lens[k] = len(r)
                h = hits_list[i]
                hitm[k, : len(h)] = h
                hitn[k] = len(h)
            s4 = seqs.reshape(B, -1, 4).astype(np.uint16)
            packed = (s4[:, :, 0] | (s4[:, :, 1] << 2) | (s4[:, :, 2] << 4)
                      | (s4[:, :, 3] << 6)).astype(np.uint8)
            res = ED.batch_filter_extend_packed(
                jnp.asarray(packed), jnp.asarray(lens),
                jnp.asarray(hitm.view(np.int64)), jnp.asarray(hitn),
                gf.cat, gf.off, gf.rows,
                H=H, C=C, R=R, max_iter=4 * H + 2 * C + 16)
            pending.append((chunk, res))
        import jax

        for chunk, (cords, ncords, ovf) in pending:
            cords, ncords, ovf = jax.device_get((cords, ncords, ovf))
            cords = cords.view(np.uint64)
            for k, i in enumerate(chunk):
                if ovf[k]:
                    continue
                out[i] = cords[k, : ncords[k]].copy()
        return out

    def _device_chain_block(self, seeded: List, raw: bool = False):
        """Batched device chaining DP (ops.chain_dp) for the main apx pass.

        For each device-seeded read, replays the host pre-chain pipeline
        (filterAnchors + descending anchor-x sort, src/pmpfinder.cpp:2506,
        :2448) and runs the windowed getBestChains scan on device. Returns
        per-read (sorted_anchors, ChainsRecord list) or None (host DP);
        with raw=True returns pickling-friendly (anchors, p2, score, length)
        numpy tuples instead (for the process-pool pipeline)."""
        import jax.numpy as jnp

        from ..ops import chain_dp as CDP
        from ..utils.cordscalar import anchor_x
        from . import pmpfinder as PMP

        out: List = [None] * len(seeded)
        pre: List = []
        idxs: List[int] = []
        for i, seeds in enumerate(seeded):
            if seeds is None:
                continue
            anchors = [0]
            anchors.extend(int(a) for a in seeds)
            PMP.filter_anchors(anchors, 1, 2, 2)
            # must match the host's std::sort-exact permutation (PMP.CXS)
            anchors = PMP.CXS.std_sort(anchors, [anchor_x(a) for a in anchors], desc=True)
            if len(anchors) < 2 or len(anchors) > 8192:
                # < 2: chainAnchorsBase early-outs; > 8192: host DP
                continue
            pre.append(anchors)
            idxs.append(i)
        if not pre:
            return out
        N = max(len(a) for a in pre)
        N = max(1 << int(np.ceil(np.log2(N))), 64)
        # fixed (DEV_BATCH, pow2-N) kernel shapes: one compile per bucket,
        # bounded edge-tensor memory
        n_pre = len(pre)
        B = -(-n_pre // self.DEV_BATCH) * self.DEV_BATCH
        arr = np.zeros((B, N), dtype=np.int64)
        cnt = np.zeros((B,), dtype=np.int32)
        for r, a in enumerate(pre):
            arr[r, : len(a)] = a
            cnt[r] = len(a)
        p2s, scores, lengths, overflows = [], [], [], []
        pending = []
        for c0 in range(0, B, self.DEV_BATCH):
            ccnt = cnt[c0: c0 + self.DEV_BATCH]
            res = CDP.batch_chain_dp_windowed(
                jnp.asarray(arr[c0: c0 + self.DEV_BATCH]),
                jnp.asarray(ccnt), W=64, score_type=0)
            # slice to the used column prefix (smaller d2h) but defer the
            # sync until every chunk is enqueued
            m = max(int(ccnt.max()), 1)
            pending.append((res[0][:, :m], res[1][:, :m], res[2][:, :m], res[3]))
        for rp2, rsc, rln, rov in pending:
            p2s.append(np.asarray(rp2))
            scores.append(np.asarray(rsc))
            lengths.append(np.asarray(rln))
            overflows.append(np.asarray(rov))
        overflow = np.concatenate(overflows)[:n_pre]
        for r, i in enumerate(idxs):
            if overflow[r]:
                continue
            n = int(cnt[r])
            ci, ri = divmod(r, self.DEV_BATCH)
            p2r, scr, lnr = p2s[ci][ri], scores[ci][ri], lengths[ci][ri]
            if raw:
                out[i] = (pre[r], p2r[:n].copy(), scr[:n].copy(), lnr[:n].copy())
            else:
                out[i] = (pre[r], CDP.chain_records_from_dp(p2r, scr, lnr, n))
        return out

    def create_features(self) -> None:
        from . import nengine as NE

        PMP.set_feature_type(self.cfg.feature_t)
        if self.cfg.feature_t == 0:
            arrs = [F.create_features_1_16_parallel(s, self.cfg.threads)
                    for s in self.genomes]
        elif self.cfg.feature_t == 1:
            arrs = [F.create_features_1_32_parallel(s, self.cfg.threads)
                    for s in self.genomes]
        else:
            arrs = None
            if NE.enabled():
                arrs = [NE.build_features_native(s, self.cfg.threads)
                        for s in self.genomes]
                if any(a is None for a in arrs):
                    arrs = None
            if arrs is None:
                arrs = [F.create_features_genome(s, self.cfg.threads)
                        for s in self.genomes]
        if self.cfg.feature_t != 2:
            from ..utils.dbg import dbg_s, enabled as _dbg_on

            if _dbg_on():
                for a in arrs:
                    dbg_s("GFEA", a)
        self.f2 = [PMP.Feats(a) for a in arrs]

    def create_index(self) -> None:
        from . import nengine as NE

        if self.cfg.index_type == 3:
            from ..index import sindex as SI

            self.index = SI.build_sindex(self.genomes,
                                         threads_emul=self.cfg.threads)
            return
        if self.cfg.index_type == 2:
            from ..index import hindex as HI

            if NE.enabled():
                nat = NE.build_hindex_native(
                    self.genomes, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                    HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA,
                    self.cfg.threads)
                if nat is not None:
                    self.index = nat
                    return
            self.index = HI.build_hindex(self.genomes,
                                         threads_emul=self.cfg.threads)
            return
        if NE.enabled():
            nat = NE.build_dindex_native(
                self.genomes, DI.DEFAULT_SPAN, DI.DEFAULT_WEIGHT,
                DI.DEFAULT_MIN_STEP, DI.DEFAULT_MAX_STEP,
                DI.DEFAULT_OMIT_BLOCK, self.cfg.threads)
            if nat is not None:
                dirp, hs, nz = nat
                self.index = DI.DIndex(span=DI.DEFAULT_SPAN,
                                       weight=DI.DEFAULT_WEIGHT,
                                       dir=dirp, hs=hs, nz=nz)
                return
        self.index = DI.build_dindex(self.genomes, threads_emul=self.cfg.threads)

    def prepare(self) -> None:
        if not self.f2:
            self.create_features()
        if self.index is None:
            self.create_index()

    def warmup(self, pad: int = 8192, n_buckets=(64, 128, 256, 512, 1024)) -> None:
        """Compile the device kernels at the PRODUCTION shapes (one-time per
        machine; results live in the persistent XLA cache): the fused
        superchunk seed kernel at (SEED_SUPERCHUNK, pad, SEED_M_OUT) — the
        exact shape _device_seed_block runs — plus the chain DP pow2-N
        buckets so no compile lands inside a timed mapping run."""
        import jax
        import jax.numpy as jnp

        from ..ops import chain_dp as CDP
        from ..ops import seeding as SD

        self._ensure_dev_index()
        reads = [np.zeros(pad, dtype=np.uint8)] * self.SEED_SUPERCHUNK
        disp = SD.seed_block_dispatch(reads, self._dev_index, pad_len=pad,
                                      m_out=self.SEED_M_OUT,
                                      superchunk=self.SEED_SUPERCHUNK)
        SD.seed_block_collect(disp, m_out=self.SEED_M_OUT)
        # tier-2 overflow redispatch shape (see _device_seed_stream2)
        w2, nm2 = SD.pack_superchunk(reads[: self.SEED_SUPERCHUNK2], pad,
                                     self.SEED_SUPERCHUNK2)
        h2 = SD.dispatch_wire(w2, self._dev_index, self.SEED_M_OUT2)
        SD.collect_wire(h2, self.SEED_SUPERCHUNK2, nm2, self.SEED_M_OUT2)
        cnt = jnp.zeros((self.DEV_BATCH,), dtype=jnp.int32)
        outs = []
        for n in n_buckets:
            arr = jnp.zeros((self.DEV_BATCH, n), dtype=jnp.int64)
            outs.append(CDP.batch_chain_dp_windowed(arr, cnt, W=64, score_type=0))
        jax.block_until_ready(outs)

    def gap_parms(self, tid: int = 0):
        """The per-emulated-thread persistent GapParms (reference: per-THREAD
        gap_parms_set[thread_id], src/mapper.cpp:233-237, passed by reference
        into mapGaps). The reference NEVER resets it between reads, and
        mapExtend/mapExtends permanently mutate thd_cts_major_limit,
        thd_ctfas2_connect_*, direction, f_gmsa_direction
        (src/gap_util.cpp:4046-4054,4089-4092) — later reads see the leaked
        values, so a fresh GapParms per read diverges from the reference.

        Thread structure: with -b 0 (batch mode) the reference partitions
        each 50k block into `threads` contiguous static-omp chunks, one
        GapParms per thread persisting across blocks — fully deterministic
        and emulated here via `tid`. With -b 1 (default pipeline) the
        task->thread assignment races: on this corpus size the observed
        common schedule is one compute task holding all reads (tid 0), which
        the default path emulates; the reference's own -b 1 multi-thread
        output is scheduling-dependent (two stable outcomes observed on a
        2-core host), so exact parity there is only defined per-schedule."""
        if tid not in self._gap_parms:
            from . import gap as GAP

            # gap_len -> thd_gap_len_min mapping (src/mapper.cpp:209-232):
            # 1 -> 50 (default), 2..9 -> 10, >=10 -> gap_len
            g = self.cfg.gap_len
            thd = 50 if g == 1 else (10 if g < 10 else g)
            self._gap_parms[tid] = GAP.GapParms(thd_gap_len_min=thd, f_dup=self.cfg.f_dup)
        return self._gap_parms[tid]

    def reset_gap_parms(self) -> None:
        """Start fresh emulated compute threads (see gap_parms)."""
        self._gap_parms = {}
        self._pmp_toggled = {}
        self._f1_bufs = {}
        if self._nengine is not None:
            self._nengine.reset()

    # ------------------------------------------------------ native engine

    def use_native(self) -> bool:
        """Whether the native engine will serve this config (cheap check —
        usable before/without instantiating it)."""
        from . import nengine as NE

        return (NE.enabled() and not self.cfg.aln_flag
                and self.cfg.index_type in (1, 2) and self.cfg.feature_t == 2)

    def native_engine(self):
        """The per-process native engine (lt_engine), or None. Created
        lazily so forked pipeline workers each get their own instance state
        (the backing genome/feature/index arrays are shared copy-on-write).

        The native engine covers the production config; flags it does not
        implement fall back to the exact Python path."""
        if self._nengine is not None:
            return self._nengine
        from . import nengine as NE

        if (not NE.enabled() or self.cfg.aln_flag or self.index is None
                or self.cfg.index_type not in (1, 2) or self.cfg.feature_t != 2):
            return None
        g = self.cfg.gap_len
        gap_min = 0 if not g else (50 if g == 1 else (10 if g < 10 else g))
        self._nengine = NE.NativeEngine(
            self.genomes, [f.arr for f in self.f2], self.index,
            self.genome_ids, thd_DI=self.cfg.thd_DI, thd_X=self.cfg.thd_X,
            gap_len_min=gap_min, f_dup=self.cfg.f_dup,
            f_chain=self.cfg.apx_chain_flag,
            sequence_sam=self.cfg.sequence_sam,
            reform_ccs=self.cfg.reform_ccs,
            cah_stop_ratio=self.cfg.cah_stop_ratio)
        return self._nengine

    def native_map_read(self, read, rid: str, seeds=None, tid: int = 0,
                        collect_bam: bool = False, collect_cords: bool = True):
        """One read through the native engine: returns (cords_str list,
        cords_end list, sam text, bam_lines). collect_cords=False skips the
        u64->Python-int conversion (SAM-only callers)."""
        import numpy as np  # noqa: F811

        ne = self._nengine
        s = None
        if seeds is not None:
            s = np.asarray(seeds, dtype=np.uint64)
        cs, ce, sam = ne.map_read(read, rid, seeds=s, tid=tid)
        if not (collect_cords or collect_bam):
            return [], [], sam, []
        cs_l = [int(c) for c in cs]
        ce_l = [int(c) for c in ce]
        bam_lines = []
        if collect_bam:
            _, bam_lines = self.read_output(read, rid, cs_l, ce_l,
                                            collect_bam=True)
        if not collect_cords:
            return [], [], sam, bam_lines
        return cs_l, ce_l, sam, bam_lines

    @staticmethod
    def static_chunk_tids(n: int, threads: int) -> List[int]:
        """Per-read thread ids of the reference's `#pragma omp for` static
        partition in map_ (src/mapper.cpp:796-810): contiguous chunks of
        size n//threads, the first n%threads chunks one longer."""
        size2 = n // threads
        r = n - size2 * threads
        tids = []
        for t in range(threads):
            tids.extend([t] * (size2 + 1 if t < r else size2))
        return tids

    def map_read(self, read: np.ndarray, seed_anchors=None, chain_pre=None,
                 tid: int = 0):
        """Per-read body of p_calRecords. Returns (cords_str, cords_end,
        cords_info)."""
        cords_str, cords_end, cords_info, rc, f1 = PMP.run_serial(self.map_read_gen(
            read, seed_anchors=seed_anchors, chain_pre=chain_pre, tid=tid))
        self.gap_phase(read, rc, cords_str, cords_end, f1, tid=tid)
        return cords_str, cords_end, cords_info

    def map_read_gen(self, read: np.ndarray, seed_anchors=None, chain_pre=None,
                     tid: int = 0):
        """Generator form of the apx phase: yields window-sweep requests (see
        pmpfinder.run_serial / run_lockstep); the lockstep driver batches
        the dense-extension sweeps of many reads into single numpy passes.

        The gap phase is NOT part of the generator: it mutates the shared
        per-worker GapParms, so it must run in strict read order (gap_phase),
        not in lockstep completion order.

        PMPParms persistence: the reference's per-thread PMPParms starts in
        ctor state and stays in toggle(0) state once any read on the thread
        ran a re-apx/retry (see PMPParms.did_toggle) — the two differ only
        in the alg-1 gdl_* fields, so the alg-2 lockstep path is unaffected
        by modeling it as a per-read init + a flag carried in read order."""
        if len(read) <= THD_MIN_READ_LEN:
            return [], [], [], None, None
        rc = seqio.revcomp(read)
        if self.cfg.feature_t != 2:
            # persistent per-thread feature buffers (stale-tail semantics,
            # see PMP.FeatBuf)
            st = self._f1_bufs.setdefault(tid, [PMP.FeatBuf(), PMP.FeatBuf()])
            vf, nf = F.feats1_parts(read, self.cfg.feature_t)
            vr, nr = F.feats1_parts(rc, self.cfg.feature_t)
            f1 = [st[0].update(vf, nf), st[1].update(vr, nr)]
            from ..utils.dbg import dbg_s, enabled as _dbg_on

            if _dbg_on():
                dbg_s("RFEA", f1[0].arr[: f1[0].n_len])
                dbg_s("RFEB", f1[1].arr[: f1[1].n_len])
        else:
            f1 = [
                PMP.Feats(F.create_features_serial(read)),
                PMP.Feats(F.create_features_serial(rc)),
            ]
        pm = PMP.PMPParms(seed_anchors=seed_anchors, chain_pre=chain_pre,
                          cah_stop_ratio=self.cfg.cah_stop_ratio)
        if self._pmp_toggled.get(tid):
            pm.toggle(0)
        cords_str, cords_end, apx_gaps, cords_info = yield from PMP.apx_map(
            self.index, read, f1, self.f2, f_chain=self.cfg.apx_chain_flag, pm=pm
        )
        if pm.did_toggle:
            self._pmp_toggled[tid] = True
        return cords_str, cords_end, cords_info, rc, f1

    def gap_phase(self, read, rc, cords_str, cords_end, f1, tid: int = 0) -> None:
        """mapGaps + reformCords for one read (in read order). apx_gaps is
        an output parameter of mapGaps (recomputed there, src/gap.cpp:437),
        so a fresh list is passed."""
        if not self.cfg.gap_len or rc is None:
            return
        from . import gap as GAP

        GAP.map_gaps(
            self.genomes, read, rc, cords_str, cords_end, [], f1, self.f2,
            self.gap_parms(tid),
        )
        PMP._dbg("GAPF", cords_str)
        PMP._dbg("GAPE", cords_end)
        GAP.reform_cords(cords_str, cords_end)
        PMP._dbg("REFC", cords_str)

    def map_block(self, reads: seqio.SeqSet, collect_bam: bool = False):
        """Map a block of reads; returns (all_cords_str, all_cords_end,
        sam_text[, bam_lines])."""
        from ..out import bam as BAM

        all_str: List[List[int]] = []
        all_end: List[List[int]] = []
        sam_parts: List[str] = []
        bam_lines: List[dict] = []
        self._f1_bufs = {}
        ne = self.native_engine()
        if (self.device == "accel" and self.cfg.index_type == 1
                and self.cfg.feature_t == 2):
            pre = self._device_seed_block(reads)
            chain_pre = (self._device_chain_block(pre)
                         if ne is None else [None] * len(reads.seqs))
        else:
            pre = [None] * len(reads.seqs)
            chain_pre = [None] * len(reads.seqs)
        if self.cfg.bal_flag == 0:
            tids = self.static_chunk_tids(len(reads.seqs), self.cfg.threads)
        else:
            tids = [0] * len(reads.seqs)
        if ne is not None:
            dev_cords = [None] * len(reads.seqs)
            if (self.device == "accel" and self.cfg.index_type == 1
                    and self.cfg.feature_t == 2 and self.cfg.apx_chain_flag):
                # phase B (host C++): first-pass apx to pre-filter hits;
                # phase C (device): _filterHits + path_dst_2 extension
                hits_list: List = []
                for read, seeds in zip(reads.seqs, pre):
                    if len(read) <= THD_MIN_READ_LEN:
                        hits_list.append(None)
                        continue
                    s = np.asarray(seeds, dtype=np.uint64) if seeds is not None else None
                    hits_list.append(ne.apx_hits(read, seeds=s))
                dev_cords = self._device_extend_block(reads, hits_list)
            for rid, read, tid, seeds, dc in zip(reads.ids, reads.seqs, tids,
                                                 pre, dev_cords):
                res = None
                if dc is not None:
                    # phase D: apx tail + gap + output; None = re-apx path
                    res = ne.apx_finish(read, rid, dc, tid=tid)
                if res is not None:
                    cs, ce, sam = res
                    cords_str = [int(c) for c in cs]
                    cords_end = [int(c) for c in ce]
                    bl = []
                    if collect_bam:
                        _, bl = self.read_output(read, rid, cords_str,
                                                 cords_end, collect_bam=True)
                else:
                    cords_str, cords_end, sam, bl = self.native_map_read(
                        read, rid, seeds=seeds, tid=tid, collect_bam=collect_bam)
                all_str.append(cords_str)
                all_end.append(cords_end)
                sam_parts.append(sam)
                bam_lines.extend(bl)
            if collect_bam:
                return all_str, all_end, "".join(sam_parts), bam_lines
            return all_str, all_end, "".join(sam_parts)
        gens = [
            self.map_read_gen(read, seed_anchors=seeded, chain_pre=chained, tid=tid)
            for read, seeded, chained, tid in zip(reads.seqs, pre, chain_pre, tids)
        ]
        if self.cfg.apx_chain_flag:
            mapped = PMP.run_lockstep(gens)
        else:
            # alg-1 (-c 0) consumes the PMPParms gdl_* state the re-apx
            # retry leaks across reads (PMPParms.did_toggle): strict read
            # order required, so no lockstep batching
            mapped = [PMP.run_serial(g) for g in gens]
        for (rid, read), tid, (cords_str, cords_end, cords_info, rc, f1) in zip(
                zip(reads.ids, reads.seqs), tids, mapped):
            # gap phase in strict read order: it mutates the shared
            # per-thread GapParms exactly like the reference's (see gap_parms)
            self.gap_phase(read, rc, cords_str, cords_end, f1, tid=tid)
            all_str.append(cords_str)
            all_end.append(cords_end)
            sam, bl = self.read_output(read, rid, cords_str, cords_end,
                                       collect_bam=collect_bam)
            sam_parts.append(sam)
            bam_lines.extend(bl)
        if collect_bam:
            return all_str, all_end, "".join(sam_parts), bam_lines
        return all_str, all_end, "".join(sam_parts)

    def read_output(self, read: np.ndarray, rid: str,
                    cords_str: List[int], cords_end: List[int],
                    collect_bam: bool = False):
        """Output synthesis for one read: cords -> CIGAR* -> SAM text (and
        optional binary BAM lines). Mirrors the print side of p_calRecords
        (src/mapper.cpp:452-473, f_io.cpp)."""
        from ..out import bam as BAM

        if self.cfg.aln_flag:
            # -a: base-level banded alignment of the cords windows (real
            # =/X/I/D CIGARs; map/align.py) instead of the virtual-
            # alignment rectangles
            from . import align as AL

            records = AL.align_cords(
                self.genomes, read, seqio.revcomp(read),
                cords_str, cords_end, band=100)
        else:
            records = BL.cords2bamlink(
                cords_str, cords_end, len(read),
                thd_large_X=8000, thd_DI=self.cfg.thd_DI, thd_X=self.cfg.thd_X,
            )
        if self.cfg.reform_ccs:
            BL.reform_ccs_bams(records)
        BL.fill_bam_records(records, self.genome_ids, rid)
        if self.cfg.sequence_sam and records:
            BL.synth_seq(records, self.genomes, read, seqio.revcomp(read))
        sam = "".join(line + "\n" for line in BL.sam_lines(records))
        bam_lines = BAM.records_to_bam_lines(records) if collect_bam else []
        return sam, bam_lines

    def sam_header(self) -> str:
        return BL.sam_header(
            self.genome_ids, self.genome_lens,
            self.cfg.read_group, self.cfg.sample_name, self.cfg.cmd_line,
        )

    def apf_block(self, cords_set: List[List[int]], reads: seqio.SeqSet) -> str:
        return print_cords_apf(
            cords_set, self.genome_lens, self.genome_ids,
            [len(s) for s in reads.seqs], reads.ids,
        )
