"""2-process jax.distributed dry run: the multi-HOST path, for real.

The single-process dryrun (__graft_entry__.dryrun_multichip) validates the
sharded kernels on a virtual 8-device CPU mesh; this tool additionally
exercises the process boundary the reference never had (SURVEY §2.3 —
"cross-device collectives: absent in the reference"): it launches TWO
OS processes, each owning 4 virtual CPU devices, wires them with
jax.distributed (linear_tpu.parallel.mesh.init_distributed), builds the
global (dp=2, ix=4) grid mesh with dp across the process (DCN) boundary,
runs grid_mapping_step — xval-sharded k-mer table, psum anchor merge,
dp-sharded chain DP — and asserts the gathered result is BIT-IDENTICAL
to the single-device mapping_step reference computed by the parent.

Usage:  python tools/dryrun_multiproc.py            (parent / orchestrator)
        exit 0 + "MULTIPROC OK" on success.
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
B, PAD = 8, 2048
GENOME_LEN = 30000
N_IX = 4


def make_world():
    from linear_tpu.index import dindex as DI

    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    idx = DI.build_dindex([genome], threads_emul=4)
    seqs = np.zeros((B, PAD), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int64)
    for i in range(B):
        pos = int(rng.integers(0, GENOME_LEN - 1500))
        r = genome[pos: pos + 1500].copy()
        sub = rng.random(len(r)) < 0.08
        r[sub] = (r[sub] + 1) % 4
        seqs[i, : len(r)] = r
        lens[i] = len(r)
    return idx, seqs, lens


def child(expected_npz: str) -> None:
    # initialize the process group BEFORE any linear_tpu.ops import touches
    # the XLA backend (see linear_tpu/parallel/dist.py)
    from linear_tpu.parallel.dist import init_distributed

    pid = init_distributed()
    import jax

    from linear_tpu.parallel import mesh as MS
    assert jax.process_count() == N_PROC, jax.process_count()
    assert len(jax.devices()) == N_PROC * LOCAL_DEV, len(jax.devices())
    idx, seqs, lens = make_world()
    dir_sh, lo_sh, hi_sh, x_base, cap = MS.shard_index_by_xval(idx, N_IX)
    mesh = MS.make_grid_mesh(n_dp=N_PROC, n_ix=N_IX)
    out = MS.grid_mapping_step(mesh, seqs, lens, dir_sh, lo_sh, hi_sh,
                               x_base, cap, n_max=128)
    from jax.experimental import multihost_utils

    got = [np.asarray(multihost_utils.process_allgather(o, tiled=True))
           for o in out]
    exp = np.load(expected_npz)
    names = ["anc", "n", "p2", "score", "length", "overflow"]
    gd = dict(zip(names, got))
    # per-read VALID prefixes must match bit-for-bit; the padded tail holds
    # sort-order-dependent garbage in the single-device reference (invalid
    # slots are keyed out, not zeroed) and zeros after the grid psum
    assert np.array_equal(gd["n"], exp["n"]), f"process {pid}: n diverges"
    assert np.array_equal(gd["overflow"], exp["overflow"]), \
        f"process {pid}: overflow diverges"
    for b in range(gd["n"].shape[0]):
        k = int(gd["n"][b])
        for name in ("anc", "p2", "score", "length"):
            assert np.array_equal(gd[name][b][:k], exp[name][b][:k]), \
                f"process {pid}: {name}[{b}][:{k}] diverges"
    print(f"[proc {pid}] grid step over 2 processes bit-identical", flush=True)


def parent() -> None:
    # reference result on plain single-process devices (any count)
    import jax

    from linear_tpu.ops.seeding import upload_index
    from linear_tpu.parallel import mesh as MS

    idx, seqs, lens = make_world()
    di = upload_index(idx)
    out = MS.mapping_step(jax.numpy.asarray(seqs.astype(np.int32)),
                          jax.numpy.asarray(lens), di.dir_start, di.hs_lo,
                          di.hs_hi, cap=di.cap, n_max=128, fast=True)
    names = ["anc", "n", "p2", "score", "length", "overflow"]
    tmp = tempfile.mkdtemp(prefix="lt_mp_")
    npz = os.path.join(tmp, "expected.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in zip(names, out)})

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_base = dict(os.environ)
    env_base.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count="
                     f"{LOCAL_DEV}",
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "JAX_NUM_PROCESSES": str(N_PROC),
    })
    procs = []
    for pid in range(N_PROC):
        env = dict(env_base)
        env["JAX_PROCESS_ID"] = str(pid)
        log = open(os.path.join(tmp, f"child{pid}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", npz],
            env=env, cwd=ROOT, stdout=log, stderr=log), log))
    rcs = []
    for p, log in procs:
        rcs.append(p.wait(timeout=600))
        log.close()
    for pid in range(N_PROC):
        for line in open(os.path.join(tmp, f"child{pid}.log")):
            if "WARNING" not in line:
                sys.stderr.write(f"[child{pid}] {line}")
    assert rcs == [0] * N_PROC, f"child exit codes {rcs}"
    print("MULTIPROC OK: 2-process jax.distributed grid step bit-identical "
          "to single-device reference")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2])
    else:
        parent()
