"""3-stage pipelined mapping — the analog of the reference's parallel_io
scheduler (src/parallel_io.cpp, process3 src/linear.cpp:67-95).

Reference design: ring buffers + a global CAS lock hand out fetch / compute
/ print roles to OpenMP threads (1 fetcher, 1 printer, N computers, in-order
drain). Here the same three stages map onto one host process and a pool:

  Stage F (feeder thread)   stream read blocks from disk; with
                            device="accel", upload them and run the batched
                            device seeding (JAX releases the GIL during
                            device compute/transfer, so this overlaps
                            stage C).
  Stage C (process pool)    per-read host residual: window extension, gap
                            resolution, cords->CIGAR SAM synthesis. Workers
                            are forked AFTER the index/features are built and
                            share them copy-on-write.
  Stage P (main thread)     in-order drain and file emission (mirrors
                            p_PrintResults ordering, src/parallel_io.cpp:522).

The pool is forked before the JAX backend starts (PipelineMapper refuses
otherwise): a child forked from a process that holds a device client
inherits its threads and handles in an undefined state. Workers never
start JAX; the index reaches them copy-on-write through the fork.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from ..utils import seqio

_WORKER_MAPPER = None  # set in children via fork


def _init_worker(mapper):
    global _WORKER_MAPPER
    _WORKER_MAPPER = mapper


_RANGE_FH: dict = {}  # per-worker open file handles for range tasks


def _task_reads(reads, rids):
    """Materialize a task's reads: either the pickled (seqs, ids) pair or
    a ("range", path, b0, b1, n) byte-range spec the worker re-reads
    directly from the source file (drops the dominant task-IPC payload;
    parse is byte-identical to the feeder's, tests/test_native_io.py)."""
    if not (isinstance(reads, tuple) and reads and reads[0] == "range"):
        return reads, rids
    _, path, b0, b1, _n = reads
    fh = _RANGE_FH.get(path)
    if fh is None:
        fh = open(path, "rb")
        _RANGE_FH[path] = fh
    ids, seqs = seqio.parse_records_range(path, b0, b1, fh=fh)
    return seqs, ids


def _map_chunk(task):
    """Worker: full residual for a CHUNK of reads (lockstep-batched window
    sweeps across the chunk) -> list of (cords_str, cords_end, sam, bam).
    With collect_cords False the cords lists come back empty — the Python
    int lists dominate the result-pickle cost and SAM-only consumers
    (the bench, CLI without APF) never read them."""
    from ..map.chaining import chain_records_from_dp
    from ..map.pmpfinder import run_lockstep

    reads, rids, seeds, chain_raws, collect_bam, collect_cords, persist = task
    reads, rids = _task_reads(reads, rids)
    m = _WORKER_MAPPER
    # State model (see Mapper.gap_parms): the reference's GapParms/PMPParms
    # are per COMPUTE THREAD and persist across tasks, blocks AND input
    # files. With ONE worker that schedule is deterministic, and the single
    # worker process reproduces it by never resetting (persist=True). With
    # several workers the reference's own task->thread assignment races;
    # fresh parms per task reproduces its observed split-schedule outcome.
    if not persist:
        m.reset_gap_parms()
    ne = m.native_engine()
    if ne is not None:
        if not (collect_bam or collect_cords):
            # SAM-only: one ctypes crossing for the whole chunk
            sam = ne.map_block(reads, rids, seeds_list=seeds)
            return [([], [], sam, [])]
        out = []
        for read, rid, s in zip(reads, rids, seeds):
            cs, ce, sam, bl = m.native_map_read(read, rid, seeds=s,
                                                collect_bam=collect_bam,
                                                collect_cords=collect_cords)
            out.append((cs, ce, sam, bl))
        return out
    gens = []
    for read, s, craw in zip(reads, seeds, chain_raws):
        chain_pre = None
        if craw is not None:
            anchors, p2, score, length = craw
            chain_pre = (anchors, chain_records_from_dp(p2, score, length, len(anchors)))
        gens.append(m.map_read_gen(read, seed_anchors=s, chain_pre=chain_pre))
    mapped = run_lockstep(gens)
    out = []
    for read, rid, (cords_str, cords_end, cords_info, rc, f1) in zip(reads, rids, mapped):
        # gap phase in read order within the chunk (shared GapParms state,
        # see Mapper.gap_parms)
        m.gap_phase(read, rc, cords_str, cords_end, f1)
        sam, bam_lines = m.read_output(read, rid, cords_str, cords_end,
                                       collect_bam=collect_bam)
        if not collect_cords:
            cords_str, cords_end = [], []
        out.append((cords_str, cords_end, sam, bam_lines))
    return out


@dataclass
class BlockResult:
    block: "seqio.SeqSet"
    cords_str: List[List[int]]
    cords_end: List[List[int]]
    sam: str
    bam_lines: List
    n_reads: int = 0  # read count (block may be an unparsed placeholder)

    @property
    def n(self) -> int:
        return self.n_reads or len(self.block.seqs)


class PipeCounters:
    """Live per-stage counters — the analog of the reference's pipeline
    dashboard (P_Tasks::printRunningInfos, src/parallel_io.cpp:69-97):
    reads fetched (stage F), seeds ready (device feeder), residuals
    computed (stage C) and blocks emitted (stage P), each with a running
    rate. `seeds_used` counts the reads handed to a worker with device
    anchors (a task ships unseeded when the pool runs hungry). Rendered on
    stderr by a monitor thread when enabled (LINEAR_TPU_DASH=1 forces on,
    =0 forces off; default: stderr isatty).
    Counter updates are plain int += under the GIL (single writer per
    field)."""

    def __init__(self, enabled: Optional[bool] = None, interval: float = 0.5):
        import sys
        import time

        if enabled is None:
            env = os.environ.get("LINEAR_TPU_DASH")
            if env is not None:
                enabled = env != "0"
            else:
                enabled = sys.stderr.isatty()
        self.enabled = enabled
        self.interval = interval
        self.t0 = time.time()
        self.fetched = 0    # reads read from disk
        self.seeded = 0     # reads whose device seeds landed
        self.seeds_used = 0  # reads shipped to a worker with device seeds
        self.computed = 0   # reads through the worker residual
        self.emitted = 0    # reads drained in order
        self._stop = False
        self._th = None
        self._last_lines = 0

    def start(self):
        if not self.enabled:
            return self
        self._th = threading.Thread(target=self._loop, daemon=True)
        self._th.start()
        return self

    def stop(self):
        self._stop = True
        if self._th is not None:
            self._th.join()
            self._render(final=True)

    def _loop(self):
        import time

        while not self._stop:
            self._render()
            time.sleep(self.interval)

    def _render(self, final: bool = False):
        import sys
        import time

        el = max(time.time() - self.t0, 1e-9)
        up = f"\x1b[{self._last_lines}A" if self._last_lines else ""
        rows = [("I/O::in", self.fetched), ("Seeded", self.seeded),
                ("Compute", self.computed), ("Processed", self.emitted)]
        out = up + "".join(
            f"\x1b[2K  {name}:\t{cnt}\ttime:{el:.2f}[s]\t"
            f"speed:{cnt / el:.2f}[reads/s]\n" for name, cnt in rows)
        sys.stderr.write(out)
        sys.stderr.flush()
        self._last_lines = len(rows)
        if final:
            self._last_lines = 0


class _SeedCollector(threading.Thread):
    """Runs Mapper._device_seed_stream2 in the background, marking reads
    FINAL (seeded, or definitively host-seeded) as device results land.
    The feeder never blocks on this thread: a task whose span is not final
    ships unseeded when the worker pool runs hungry (the output is the same
    either way). A device exception is kept in `error` and re-raised by
    the feeder, so a device failure fails the run."""

    def __init__(self, mapper, block, counters):
        super().__init__(daemon=True)
        from ..map.mapper import THD_MIN_READ_LEN

        n = len(block.seqs)
        self.final = np.zeros(n, dtype=bool)
        self.seeds: List = [None] * n
        self.error: Optional[BaseException] = None
        self.mapper = mapper
        self.block = block
        self.c = counters
        # ineligible reads are final from the start (never yielded)
        for i, r in enumerate(block.seqs):
            if not (THD_MIN_READ_LEN < len(r) <= (1 << 17)):
                self.final[i] = True

    def run(self):
        try:
            for idxs, anchors in self.mapper._device_seed_stream2(self.block):
                n_got = 0
                for i, a in zip(idxs, anchors):
                    self.seeds[i] = a
                    self.final[i] = True
                    if a is not None:
                        n_got += 1
                self.c.seeded += n_got
        except Exception as e:  # re-raised by the feeder thread
            self.error = e
        finally:
            self.final[:] = True

    def span_final(self, i: int, j: int) -> bool:
        return bool(self.final[i:j].all())


def _join_collector(coll: Optional[_SeedCollector]) -> None:
    """Wait for a block's device seeding and re-raise its failure."""
    if coll is None:
        return
    coll.join()
    if coll.error is not None:
        raise coll.error


class PipelineMapper:
    """Drives Mapper over one read file with the 3-stage pipeline."""

    def __init__(self, mapper, n_workers: Optional[int] = None, depth: int = 2,
                 csize_workers: Optional[int] = None):
        self.mapper = mapper
        # one worker more than cores: workers stall on result pickling /
        # task IPC often enough that mild oversubscription pays on small
        # hosts
        self.n_workers = n_workers or (max(os.cpu_count() or 1, 1) + 1)
        # task boundaries (hence the fresh-GapParms-per-task schedule that
        # gap-phase output depends on) derive from csize_workers — callers
        # pass the REQUESTED -t so the same command yields the same output
        # on hosts with different core counts; only the actual pool size
        # above is clamped to the machine
        self.csize_workers = csize_workers or self.n_workers
        self.depth = depth
        # totals over every run() of this pipeline (see PipeCounters)
        self.fetched = self.seeded = self.seeds_used = 0
        from jax._src import xla_bridge

        if xla_bridge.backends_are_initialized():
            raise RuntimeError(
                "PipelineMapper forks its worker pool and must be created "
                "before the first JAX call of the process")
        # the children inherit the mapper copy-on-write, so it must be fully
        # prepared (features + index) before the fork; prepare() is
        # host-only, so the fork still happens before any device work
        mapper.prepare()
        ctx = mp.get_context("fork")
        self.pool = ctx.Pool(self.n_workers, initializer=_init_worker,
                             initargs=(mapper,))

    def close(self) -> None:
        self.pool.close()
        self.pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, read_path: str, collect_bam: bool = False,
            collect_cords: bool = True) -> Iterator[BlockResult]:
        """Yields per-block results in input order.

        Task boundaries (csize) are fixed by the block size alone, so the
        emulated -b 1 schedule (fresh GapParms per task, see Mapper
        .gap_parms) is unchanged by the streaming below; only WHEN a task
        is handed to the pool changes. With device seeding the feeder
        dispatches every superchunk's device work up front and emits each
        task to the worker pool as soon as its seed span has landed — the
        device transfers overlap the workers' residual compute instead of
        serializing in front of it. A device failure raises here."""
        m = self.mapper
        pool = self.pool
        q: "queue.Queue" = queue.Queue(maxsize=64)
        END_BLOCK = object()
        c = PipeCounters().start()

        def feeder():
            import time as _time

            emitted = 0  # reads handed to the pool so far (all blocks)
            try:
                # byte offsets let workers re-read their chunk from the
                # file instead of receiving the reads pickled (None for
                # gzipped input -> fall back to pickling)
                offs = seqio.scan_record_offsets(read_path)
                # SAM-only host runs never need the reads materialized in
                # THIS process at all: blocks become offset ranges and the
                # feeder skips the fasta parse entirely (APF/device paths
                # still parse)
                need_parse = (collect_cords or m.device == "accel"
                              or offs is None)

                def blocks_iter():
                    if need_parse:
                        for b in seqio.read_blocks(read_path):
                            yield b, len(b.seqs)
                    else:
                        for s0 in range(0, len(offs) - 1, 50000):
                            yield seqio.SeqSet(), min(50000, len(offs) - 1 - s0)

                g0 = 0  # global record index of the current block start
                coll = None  # the previous block's _SeedCollector
                for block, n in blocks_iter():
                    c.fetched += n
                    csize = max(1, -(-n // (4 * self.csize_workers)))
                    spans = [(i, min(i + csize, n)) for i in range(0, n, csize)]

                    persist = self.n_workers == 1

                    def emit(ti, seeds, chain_raw):
                        nonlocal emitted
                        i, j = spans[ti]
                        c.seeds_used += sum(s is not None for s in seeds[i:j])
                        if offs is not None:
                            payload = ("range", read_path,
                                       int(offs[g0 + i]), int(offs[g0 + j]),
                                       j - i)
                            rid_payload = None
                        else:
                            payload = block.seqs[i:j]
                            rid_payload = block.ids[i:j]
                        q.put((payload, rid_payload, seeds[i:j],
                               chain_raw[i:j], collect_bam, collect_cords,
                               persist))
                        emitted += j - i

                    # device seeding serves ONLY the DIndex/2_48 config (the
                    # kernels are DIndex-only); use_native() also admits
                    # -i 2, where injecting DIndex anchors into the HIndex
                    # engine would be silently wrong (mirrors map_block's
                    # gate, map/mapper.py:607)
                    f_dev_seed = (m.cfg.index_type == 1 and m.cfg.feature_t == 2)
                    if m.device == "accel" and f_dev_seed and m.use_native():
                        # OPPORTUNISTIC seeding: a collector thread fills
                        # seeds as device superchunks land; tasks ship
                        # seeded when their span is final, and UNSEEDED the
                        # moment the pool would otherwise go idle (output
                        # is identical either way — seeds only skip the
                        # native engine's own seeding). Back-pressure
                        # target: keep ~(n_workers+1) tasks in flight.
                        _join_collector(coll)
                        coll = _SeedCollector(m, block, c)
                        coll.start()
                        none = [None] * n
                        hunger = csize * (self.n_workers + 1)
                        for ti in range(len(spans)):
                            i, j = spans[ti]
                            while (not coll.span_final(i, j)
                                   and emitted - c.computed >= hunger):
                                _time.sleep(0.002)
                            if coll.error is not None:
                                raise coll.error
                            if coll.span_final(i, j):
                                emit(ti, coll.seeds, none)
                            else:
                                emit(ti, none, none)
                    elif m.device == "accel" and f_dev_seed:
                        seeds = m._device_seed_block(block)
                        c.seeded += sum(s is not None for s in seeds)
                        chain_raw = m._device_chain_block(seeds, raw=True)
                        for ti in range(len(spans)):
                            emit(ti, seeds, chain_raw)
                    else:
                        none = [None] * n
                        for ti in range(len(spans)):
                            emit(ti, none, none)
                    q.put((END_BLOCK, block, len(spans), n))
                    g0 += n
                # the last block's device work may still be landing (its
                # tasks can have shipped unseeded); its failure is a
                # failure of the run all the same
                _join_collector(coll)
                q.put(None)
            except BaseException as e:  # surface in main thread
                q.put(e)

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        try:
            yield from self._drain(q, pool, END_BLOCK, c)
        finally:
            c.stop()
            self.fetched += c.fetched
            self.seeded += c.seeded
            self.seeds_used += c.seeds_used
        th.join()

    def _drain(self, q, pool, END_BLOCK, c):
        pending: List = []  # AsyncResults of the current block, in order
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if isinstance(item, tuple) and item and item[0] is END_BLOCK:
                _, block, n_tasks, n_reads = item
                results = [r for ar in pending for r in ar.get()]
                pending = []
                cs = [r[0] for r in results]
                ce = [r[1] for r in results]
                sam = "".join(r[2] for r in results)
                bam: List = []
                for r in results:
                    bam.extend(r[3])
                c.emitted += n_reads
                yield BlockResult(block, cs, ce, sam, bam, n_reads=n_reads)
                continue
            p0 = item[0]
            n_task_reads = (p0[4] if isinstance(p0, tuple) and p0
                            and p0[0] == "range" else len(p0))
            pending.append(pool.apply_async(
                _map_chunk, (item,),
                callback=lambda res, k=n_task_reads: setattr(
                    c, "computed", c.computed + k)))
