"""2-process END-TO-END map->SAM with ordered cross-process merge.

Extends tools/dryrun_multiproc.py (grid seed step only) to the full
pipeline: two jax.distributed processes each own half the reads (dp
axis), seed them on the (dp=2, ix=4) virtual-device grid mesh with the
k-mer table xval-sharded (linear_tpu.parallel.mesh), run the native
per-read residual (chain/extend/gap/SAM) on their half, and then merge
the SAM output IN INPUT ORDER across the process boundary with a
process_allgather — the distributed analog of the reference's in-order
printer drain (p_PrintResults, src/parallel_io.cpp:522-569).

Output contract: the merged 2-process SAM is BYTE-IDENTICAL to a
single-process run over the same task schedule. Tasks are fixed 8-read
chunks with fresh per-task GapParms (the multi-worker -b 1 schedule), so
task results are process-placement-invariant — the same invariance the
reference's own racy task->thread assignment relies on.

Usage: python tools/e2e_multiproc.py   ->  "E2E MULTIPROC OK" + exit 0.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_PROC = 2
LOCAL_DEV = 4
N_IX = 4
N_READS = 64
TASK = 8
PAD = 4096
GENOME_LEN = 200000


def make_world():
    from linear_tpu.utils import seqio

    rng = np.random.default_rng(20260821)
    genome = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    reads, ids = [], []
    for i in range(N_READS):
        ln = int(rng.integers(1200, 3500))
        pos = int(rng.integers(0, GENOME_LEN - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.06
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        kind = i % 4
        if kind == 1:
            r = seqio.revcomp(r)
        elif kind == 2:  # deletion SV (drives the gap module)
            mid = len(r) // 2
            r = np.concatenate([r[:mid], r[mid + 400:]])
        elif kind == 3:  # insertion SV
            mid = len(r) // 2
            ins = rng.integers(0, 4, 300).astype(np.uint8)
            r = np.concatenate([r[:mid], ins, r[mid:]])
        reads.append(r)
        ids.append(f"read{i} sim")
    return genome, reads, ids


def build_mapper(genome):
    from linear_tpu.map.mapper import Mapper, MapperConfig
    from linear_tpu.utils import seqio as _s

    tmp = tempfile.mkdtemp(prefix="lt_e2e_")
    g_fa = os.path.join(tmp, "g.fa")
    _s.write_fasta(g_fa, ["chrE2E"], [genome])
    m = Mapper([g_fa], MapperConfig(gap_len=50, threads=4))
    m.prepare()
    return m


def map_tasks(m, reads, ids, task_ids, seeds=None):
    """Map the given task indices (fresh GapParms per task — the
    multi-worker schedule); returns {task_id: sam_text}."""
    out = {}
    ne = m.native_engine()  # instantiate lazily (None -> Python oracle)
    for ti in task_ids:
        lo, hi = ti * TASK, min((ti + 1) * TASK, len(reads))
        m.reset_gap_parms()
        parts = []
        for i in range(lo, hi):
            s = None if seeds is None else seeds[i]
            if ne is not None:
                _, _, sam, _ = m.native_map_read(
                    reads[i], ids[i], seeds=s, tid=0, collect_cords=False)
            else:
                cs, ce, _ = m.map_read(reads[i], seed_anchors=s, tid=0)
                sam, _ = m.read_output(reads[i], ids[i], cs, ce)
            parts.append(sam)
        out[ti] = "".join(parts)
    return out


def child() -> None:
    from linear_tpu.parallel.dist import init_distributed

    pid = init_distributed()
    import jax
    from jax.experimental import multihost_utils

    from linear_tpu.parallel import mesh as MS

    assert jax.process_count() == N_PROC
    genome, reads, ids = make_world()
    m = build_mapper(genome)

    # ---- distributed seed phase: dp-sharded reads x ix-sharded table ----
    B = ((N_READS + N_PROC - 1) // N_PROC) * N_PROC
    seqs = np.zeros((B, PAD), dtype=np.int32)
    lens = np.zeros((B,), dtype=np.int64)
    for i, r in enumerate(reads):
        n = min(len(r), PAD)
        seqs[i, :n] = r[:n]
        lens[i] = n
    dir_sh, lo_sh, hi_sh, x_base, cap = MS.shard_index_by_xval(m.index, N_IX)
    mesh = MS.make_grid_mesh(n_dp=N_PROC, n_ix=N_IX)
    anc, keep = MS.grid_seed_anchors(mesh, seqs, lens, dir_sh, lo_sh, hi_sh,
                                     x_base, cap)
    # gather the (emission-slot-ordered) anchor grid; valid prefixes are
    # the exact host emission order (position-major, bucket-entry order)
    anc_g = np.asarray(multihost_utils.process_allgather(anc, tiled=True))
    keep_g = np.asarray(multihost_utils.process_allgather(keep, tiled=True))
    seeds = []
    for i in range(N_READS):
        if (reads[i] == 4).any() or len(reads[i]) > PAD:
            seeds.append(None)  # host-seeded fallback (N / oversize)
        else:
            flat = anc_g[i].reshape(-1)
            kf = keep_g[i].reshape(-1)
            seeds.append(flat[kf].astype(np.uint64))

    # ---- per-process residual over its HALF of the task list ----
    n_tasks = (N_READS + TASK - 1) // TASK
    mine = [ti for ti in range(n_tasks) if ti % N_PROC == pid]
    sams = map_tasks(m, reads, ids, mine, seeds=seeds)

    # ---- ordered cross-process merge (p_PrintResults analog) ----
    # exchange per-task SAM bytes: pad to the global max task size
    payload = [sams.get(ti, "").encode() for ti in range(n_tasks)]
    max_len = max(len(p) for p in payload)
    max_len = int(np.asarray(multihost_utils.process_allgather(
        np.asarray([max_len]), tiled=True)).max())
    buf = np.zeros((n_tasks, max_len + 1), dtype=np.uint8)
    for ti, p in enumerate(payload):
        buf[ti, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        buf[ti, max_len] = len(p) % 256  # low byte as checksum aid
    lens_arr = np.asarray([len(p) for p in payload], dtype=np.int64)
    all_buf = np.asarray(multihost_utils.process_allgather(buf))
    all_lens = np.asarray(multihost_utils.process_allgather(lens_arr))
    merged = []
    for ti in range(n_tasks):
        owner = ti % N_PROC
        ln = int(all_lens[owner, ti])
        merged.append(all_buf[owner, ti, :ln].tobytes())
    merged_sam = m.sam_header().encode() + b"".join(merged)

    # ---- verify against the single-process run of the same schedule ----
    expected = m.sam_header().encode() + "".join(
        map_tasks(m, reads, ids, range(n_tasks))[ti]
        for ti in range(n_tasks)).encode()
    assert merged_sam == expected, (
        f"proc {pid}: merged 2-process SAM != single-process SAM")
    n_seeded = sum(1 for s in seeds if s is not None)
    print(f"[proc {pid}] e2e map->SAM over 2 processes byte-identical "
          f"({N_READS} reads, {n_seeded} grid-seeded, {n_tasks} tasks)",
          flush=True)


def parent() -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_base = dict(os.environ)
    env_base.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={LOCAL_DEV}",
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(N_PROC),
    })
    tmp = tempfile.mkdtemp(prefix="lt_e2e_mp_")
    procs = []
    for pid in range(N_PROC):
        env = dict(env_base)
        env["JAX_PROCESS_ID"] = str(pid)
        log = open(os.path.join(tmp, f"child{pid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child"],
            env=env, cwd=ROOT, stdout=log, stderr=log), log))
    rcs = []
    for p, log in procs:
        rcs.append(p.wait(timeout=900))
        log.close()
    for pid in range(N_PROC):
        for line in open(os.path.join(tmp, f"child{pid}.log")):
            if "WARNING" not in line:
                sys.stderr.write(f"[child{pid}] {line}")
    assert rcs == [0] * N_PROC, f"child exit codes {rcs} (logs in {tmp})"
    print("E2E MULTIPROC OK: 2-process map->SAM with ordered merge "
          "byte-identical to single-process")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child()
    else:
        parent()
