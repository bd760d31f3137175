"""Smoke test of the mapper's device path on one NVIDIA GPU.

    python chip_smoke.py

Data: BASELINE.json config 1 at its own scale, from bench.make_data(): a
4.6 Mb realistic-repeat genome with N-gaps, 10,240 CLR-like 7 kb reads at
about 10% error, seed 42; defaults -i 1 -f 2 -g on, SAM output.

Phases, each in a child process of its own, so that one JAX process at a
time holds the card (this parent never starts JAX):
  0  probe: the JAX platform; fails unless it is "gpu". The card's name and
     power limit as nvidia-smi reports them.
  1  main path: `filter --device accel -b 1 -ot 2` through cli.main (the
     served PipelineMapper path), in two processes: the first fills the
     persistent compile cache (cold, unless it had entries), the second
     finds it warm. The device must seed reads.
  2  plain reference: the same command with --device host; its SAM must be
     byte-identical to phase 1's.
  3  kernels against their references at real widths. Every result is
     integer and compared exactly: the workload has no floating-point
     matrix product, so TF32 does not arise.
     - fused seeder (Mapper._device_seed_block, pad 8192, superchunk 1024,
       m_out 128; and the 128/512 tiered stream): anchors equal
       DI.query_anchors on a 512-read sample, the native engine's hits
       from device seeds equal those from its own seeding, and the count
       of device-seeded reads equals EXPECT_SEEDED (a property of the
       data, obtained with the same code on the CPU backend);
     - -b 0 map_block with device seed + extension: SAM equals the host
       engine's on one 2,048-read block;
     - chain DP (_device_chain_block) equals map/chaining.get_best_chains;
     - device DIndex build on an N-free 4.6 Mb genome: tables bit-equal to
       the native build;
     - exact scan seeder on reads with N bases, and the gap-interval
       anchor kernel: equal to their host references.
Per-phase times, the device-seeded share and peak_bytes_in_use are printed
as each phase ends. The last line of stdout is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failed phase
exits non-zero without it.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (fails where the rest of the repo is missing)
from linear_tpu.utils import seqio  # noqa: E402

OUT = os.path.join(ROOT, ".bench_cache", "smoke")  # the phases' SAM files
# device-seeded reads of the bench corpus (10,240 reads): at m_out 128
# alone, and with the 512 tier for the overflow; counted with
# Mapper._device_seed_block / _device_seed_stream2 on the CPU backend
EXPECT_SEEDED = {"m_out_128": 7862, "tiered": 10040}
N_BLOCK = 2048  # the -b 0 / chain DP block
N_SAMPLE = 512  # reads checked against DI.query_anchors


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def say(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------- children


def _device():
    from linear_tpu.utils.jaxcfg import accel_device

    return accel_device()


def _peak(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def phase_probe(args) -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _cli(argv):
    """cli.main in this process; returns (rc, seconds, captured stderr)."""
    from linear_tpu import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(argv)
    dt = time.time() - t0
    err = buf.getvalue()
    sys.stderr.write(err)
    return rc, dt, err


def _cli_times(err: str) -> dict:
    prep = float(re.search(r"--Index created Elapsed time\[s\] ([\d.]+)", err)[1])
    last = re.findall(r"Processed:(\d+)\s+time:([\d.]+)", err)[-1]
    n, t_map = int(last[0]), float(last[1])
    return {"prep_s": prep, "map_s": t_map, "reads": n,
            "reads_per_s": n / t_map}


def phase_main(args) -> dict:
    from jax._src import xla_bridge

    device = args.device
    out = os.path.join(OUT, args.tag)
    rc, dt, err = _cli(["filter", args.reads, args.genome, "--device", device,
                        "-b", "1", "-ot", "2", "-o", out])
    check(rc == 0, f"cli.main --device {device} returned {rc}")
    res = {"wall_s": dt, "sam": out + ".sam", **_cli_times(err)}
    if device == "accel":
        m = re.search(r"--Device  (\S+) seeded (\d+) of (\d+) reads "
                      r"\((\d+) shipped", err)
        check(m is not None, "no --Device seeded line on stderr")
        res.update(platform=m[1], seeded=int(m[2]), fetched=int(m[3]),
                   seeds_used=int(m[4]))
        res["peak_bytes_in_use"] = _peak(_device())
    else:
        res["jax_started"] = xla_bridge.backends_are_initialized()
    return res


def _timed(f, *a, **kw):
    import jax

    t0 = time.time()
    r = jax.block_until_ready(f(*a, **kw))
    return r, time.time() - t0


def phase_kernels(args) -> dict:
    import jax
    import jax.numpy as jnp

    from linear_tpu.index import dindex as DI
    from linear_tpu.map import chaining as CH
    from linear_tpu.map import nengine as NE
    from linear_tpu.map.mapper import Mapper, MapperConfig
    from linear_tpu.ops import chain_dp as CDP
    from linear_tpu.ops import devbuild as DB
    from linear_tpu.ops import extend_dev as ED
    from linear_tpu.ops import gap_dev as GD
    from linear_tpu.ops import seeding as SD
    from linear_tpu.utils.cordscalar import anchor_x
    from linear_tpu.utils.simdata import make_genomic_genome

    res: dict = {}
    m = Mapper([args.genome], MapperConfig(), device="accel")
    m.prepare()
    ne = m.native_engine()
    check(ne is not None, "native engine unavailable")
    dev = _device()
    block = next(seqio.read_blocks(args.reads))
    n_reads = len(block.seqs)

    # --- fused seeder, m_out 128 (the first call compiles)
    t0 = time.time()
    m._ensure_dev_index()
    jax.block_until_ready(m._dev_index.dir_start)
    res["index_upload_s"] = time.time() - t0
    t0 = time.time()
    seeds = m._device_seed_block(block)
    res["seed_block_first_s"] = time.time() - t0
    t0 = time.time()
    seeds = m._device_seed_block(block)
    res["seed_block_s"] = time.time() - t0
    n128 = sum(s is not None for s in seeds)
    res["seeded_m_out_128"] = n128
    check(n128 == EXPECT_SEEDED["m_out_128"],
          f"device-seeded reads at m_out 128: {n128} != "
          f"{EXPECT_SEEDED['m_out_128']}")
    # kernel alone on one device-resident 1024-read superchunk
    pad = 8192
    wire, _ = SD.pack_superchunk(block.seqs[:m.SEED_SUPERCHUNK], pad,
                                 m.SEED_SUPERCHUNK)
    wd = jnp.asarray(wire)
    di = m._dev_index
    kargs = (wd, di.dir_start, di.hs_lo, di.hs_hi, SD.SPAN, SD.WEIGHT,
             SD.THD_ALPHA, di.cap, m.SEED_M_OUT)
    _timed(SD._seed_superchunk_fused, *kargs)
    reps = [_timed(SD._seed_superchunk_fused, *kargs)[1] for _ in range(5)]
    res["seed_kernel_1024_ms"] = 1e3 * float(np.median(reps))

    # --- tiered stream (128, then 512 for the overflow)
    for key in ("seed_stream_tiered_first_s", "seed_stream_tiered_s"):
        t0 = time.time()
        tiered = {}
        for idxs, anc in m._device_seed_stream2(block):
            tiered.update(zip(idxs, anc))
        res[key] = time.time() - t0
    n_t = sum(a is not None for a in tiered.values())
    res["seeded_tiered"] = n_t
    check(n_t == EXPECT_SEEDED["tiered"],
          f"device-seeded reads, tiered: {n_t} != {EXPECT_SEEDED['tiered']}")
    for i, a in enumerate(seeds):
        if a is not None:
            check(np.array_equal(tiered[i], a), f"read {i}: tier paths differ")
    # vs the host oracle on a sample, vs the native engine's own seeding
    sample = [i for i in range(n_reads) if tiered.get(i) is not None]
    sample = sample[::len(sample) // N_SAMPLE][:N_SAMPLE]
    check(len(sample) == N_SAMPLE, "seed sample too small")
    for i in sample:
        r = block.seqs[i]
        host = DI.query_anchors(m.index, r, 0, len(r), thd_alpha=15)
        check([int(v) for v in tiered[i]] == [int(v) for v in host],
              f"read {i}: device anchors != DI.query_anchors")
    res["oracle_sample_reads"] = len(sample)
    t0 = time.time()
    for i, a in tiered.items():
        if a is None:
            continue
        r = block.seqs[i]
        check(np.array_equal(ne.apx_hits(r, seeds=None), ne.apx_hits(r, seeds=a)),
              f"read {i}: native hits from device seeds differ")
    res["native_hits_checked_s"] = time.time() - t0

    # --- -b 0 map_block: device seed + extension vs host, one block
    sub = seqio.SeqSet(ids=block.ids[:N_BLOCK], seqs=block.seqs[:N_BLOCK])
    mh = Mapper([args.genome], MapperConfig(), device="host")
    mh.index, mh.f2 = m.index, m.f2
    t0 = time.time()
    _, _, sam_h = mh.map_block(sub)
    res["map_block_host_s"] = time.time() - t0
    m.reset_gap_parms()
    t0 = time.time()
    _, _, sam_a = m.map_block(sub)
    res["map_block_accel_first_s"] = time.time() - t0
    m.reset_gap_parms()
    t0 = time.time()
    _, _, sam_a = m.map_block(sub)
    res["map_block_accel_s"] = time.time() - t0
    check(sam_a == sam_h, "-b 0 map_block: accel SAM != host SAM")
    # extension kernel alone, one DEV_BATCH chunk, and its cost per loop
    # iteration (every read still runs for small max_iter)
    pre = m._device_seed_block(sub)
    hits = [ne.apx_hits(r, seeds=s) for r, s in zip(sub.seqs, pre)]
    t0 = time.time()
    ext = m._device_extend_block(sub, hits)
    res["extend_block_s"] = time.time() - t0
    res["extend_covered"] = sum(c is not None for c in ext)
    B, H = m.DEV_BATCH, m.EXT_H
    C, R = H + pad // 32, ((pad - 48) >> 4) + 1
    seqs = np.zeros((B, pad), np.uint8)
    lens = np.zeros((B,), np.int64)
    hitm = np.zeros((B, H), np.uint64)
    hitn = np.zeros((B,), np.int32)
    k = 0
    for r, h in zip(sub.seqs, hits):
        if k == B:
            break
        if h is None or len(h) > H or len(r) > pad:
            continue
        seqs[k, :len(r)], lens[k] = r, len(r)
        hitm[k, :len(h)], hitn[k] = h, len(h)
        k += 1
    s4 = seqs.reshape(B, -1, 4).astype(np.uint16)
    packed = (s4[:, :, 0] | (s4[:, :, 1] << 2) | (s4[:, :, 2] << 4)
              | (s4[:, :, 3] << 6)).astype(np.uint8)
    eargs = (jnp.asarray(packed), jnp.asarray(lens),
             jnp.asarray(hitm.view(np.int64)), jnp.asarray(hitn),
             m._dev_gfeats.cat, m._dev_gfeats.off, m._dev_gfeats.rows)
    full = 4 * H + 2 * C + 16
    for it in (full, 32, 96):
        f = ED.batch_filter_extend_packed
        _, tc = _timed(f, *eargs, H=H, C=C, R=R, max_iter=it)
        reps = [_timed(f, *eargs, H=H, C=C, R=R, max_iter=it)[1]
                for _ in range(3)]
        res[f"extend_256_iter{it}_compile_s"] = tc
        res[f"extend_256_iter{it}_ms"] = 1e3 * float(np.median(reps))
    res["extend_us_per_iter"] = 1e3 * (res["extend_256_iter96_ms"]
                                       - res["extend_256_iter32_ms"]) / 64

    # --- chain DP vs map/chaining.get_best_chains on the same block
    t0 = time.time()
    chained = m._device_chain_block([tiered.get(i) for i in range(len(sub.seqs))])
    res["chain_block_s"] = time.time() - t0
    n_ch = 0
    for c in chained:
        if c is None:
            continue
        anchors, recs = c
        n = len(anchors)
        host = CH.get_best_chains(np.array(anchors, dtype=np.uint64), 0, n,
                                  20, 300, CH.get_apx_chain_score,
                                  CH.ChainScoreParms(), anchor_x)
        for a, b in zip(host[:n], recs[:n]):
            check((a.p2anchor, a.score, a.length, a.root_ptr, a.f_leaf)
                  == (b.p2anchor, b.score, b.length, b.root_ptr, b.f_leaf),
                  "chain DP record != get_best_chains")
        n_ch += 1
    res["chain_reads_checked"] = n_ch
    check(n_ch >= N_BLOCK // 2, "too few reads chained on the device")
    # kernel alone per pow2-N bucket at DEV_BATCH: cost per scan step
    cnt = jnp.full((B,), 0, jnp.int32)
    for n in (64, 1024):
        arr = jnp.zeros((B, n), jnp.int64)
        _timed(CDP.batch_chain_dp_windowed, arr, cnt, W=64, score_type=0)
        reps = [_timed(CDP.batch_chain_dp_windowed, arr, cnt, W=64,
                       score_type=0)[1] for _ in range(5)]
        res[f"chain_dp_256x{n}_ms"] = 1e3 * float(np.median(reps))
    res["chain_dp_us_per_step"] = 1e3 * (res["chain_dp_256x1024_ms"]
                                         - res["chain_dp_256x64_ms"]) / 960

    # --- device DIndex build on an N-free genome of the same size
    rng = np.random.default_rng(bench.SEED)
    g = make_genomic_genome(rng, bench.GENOME_LEN)
    g = np.where(g == 4, np.arange(len(g)) % 4, g).astype(np.uint8)
    t0 = time.time()
    nat = NE.build_dindex_native([g], DI.DEFAULT_SPAN, DI.DEFAULT_WEIGHT,
                                 DI.DEFAULT_MIN_STEP, DI.DEFAULT_MAX_STEP,
                                 DI.DEFAULT_OMIT_BLOCK, 16)
    res["dindex_native_build_s"] = time.time() - t0
    check(nat is not None, "native DIndex build unavailable")
    for key in ("devbuild_first_s", "devbuild_s"):
        t0 = time.time()
        dbi = DB.build_dindex_device_host([g], threads_emul=16)
        res[key] = time.time() - t0
    check(np.array_equal(np.asarray(dbi.dir, np.int64),
                         np.asarray(nat[0], np.int64)), "devbuild dir differs")
    check(np.array_equal(dbi.hs, nat[1]), "devbuild hs differs")
    res["devbuild_hs_entries"] = int(len(dbi.hs))

    # --- exact scan seeder on reads with N bases
    n_reads_n = [r for r in block.seqs if (r == 4).any()][:64]
    check(len(n_reads_n) > 0, "no read with N bases")
    t0 = time.time()
    got = SD.seed_anchors_batch(n_reads_n, m._dev_index, pad_len=pad)
    res["scan_seeder_first_s"] = time.time() - t0
    t0 = time.time()
    got = SD.seed_anchors_batch(n_reads_n, m._dev_index, pad_len=pad)
    res["scan_seeder_s"] = time.time() - t0
    n_ok = 0
    for r, a in zip(n_reads_n, got):
        if a is None:
            continue
        host = DI.query_anchors(m.index, r, 0, len(r), thd_alpha=15)
        check(a == [int(v) for v in host], "scan seeder != DI.query_anchors")
        n_ok += 1
    res["scan_seeder_reads_checked"] = n_ok
    check(n_ok > 0, "scan seeder covered no read")

    # --- gap-interval anchor kernel vs the gap module's host stream
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_gap_dev import make_item, oracle_anchors

    # an i.i.d. genome: repeats of the bench genome overflow the kernel's
    # per-9-mer match cap (those items go to the host by design)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    items, want = [], []
    while len(items) < 128:
        gs = int(rng.integers(0, len(genome) - 5000))
        read = genome[gs: gs + 2300].copy()
        read[rng.random(len(read)) < 0.08] += 1
        read %= 4
        items.append(make_item(genome, read, gs, gs + 2000, 0, 2000))
        want.append(oracle_anchors(genome, read, gs, gs + 2000, 0, 2000,
                                   GD.LLMIN, GD.LLMAX))
    t0 = time.time()
    gotg = GD.batch_gap_anchors(items)
    res["gap_kernel_first_s"] = time.time() - t0
    t0 = time.time()
    gotg = GD.batch_gap_anchors(items)
    res["gap_kernel_s"] = time.time() - t0
    n_ok = 0
    for a, b in zip(gotg, want):
        if a is not None:
            check(np.array_equal(a, b), "gap anchors != host stream")
            n_ok += 1
    res["gap_items_checked"] = n_ok
    check(n_ok >= 100, "gap kernel covered too few items")

    res["peak_bytes_in_use"] = _peak(dev)
    return res


PHASES = {"probe": phase_probe, "main": phase_main, "kernels": phase_kernels}


def child(phase: str, *extra) -> dict:
    """Run one phase in a fresh interpreter; its stdout is relayed. Unless
    the caller chose the platform, JAX is asked for CUDA: it then neither
    falls back to the CPU nor probes for other platforms."""
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cuda")
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase, *extra]
    t0 = time.time()
    p = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, text=True)
    res = None
    for line in p.stdout.splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[7:])
        else:
            say(line)
    if p.returncode != 0 or res is None:
        raise Failed(f"phase {phase} {' '.join(extra)} failed "
                     f"(exit {p.returncode})")
    res["process_s"] = time.time() - t0
    return res


def cache_entries() -> int:
    from linear_tpu.utils.jaxcfg import cache_dir

    d = cache_dir()
    return len(os.listdir(d)) if os.path.isdir(d) else 0


def show(name: str, res: dict) -> None:
    say(f"{name}: " + json.dumps(res, sort_keys=True))


def orchestrate() -> int:
    probe = child("probe")
    show("phase 0 probe", probe)
    if probe["platform"] != "gpu":
        say(f"FAIL: JAX platform is {probe['platform']}, not gpu")
        return 1
    say("card (nvidia-smi name, power.limit):")
    say(bench.nvidia_smi() or "not available")
    os.makedirs(OUT, exist_ok=True)
    # the native engine serves every per-read stage: built with g++ from
    # the tracked sources on first use
    from linear_tpu.map import nengine as NE
    from linear_tpu.native import load

    t0 = time.time()
    check(NE.engine_lib() is not None and load("lt_seqio") is not None,
          "native engine did not build")
    say(f"native build: {time.time() - t0:.3f} s")
    t0 = time.time()
    g_fa, r_fa, _ = bench.make_data()
    say(f"data: {time.time() - t0:.3f} s ({r_fa})")
    data = ["--genome", g_fa, "--reads", r_fa]
    n_cache = cache_entries()
    cold = child("main", "--device", "accel", "--tag", "accel_first", *data)
    cold["cache_entries_before"] = n_cache
    show("phase 1 main path, first process (cold unless the compile cache "
         "had entries before)", cold)
    warm = child("main", "--device", "accel", "--tag", "accel_second", *data)
    show("phase 1 main path, second process (warm compile cache)", warm)
    host = child("main", "--device", "host", "--tag", "host", *data)
    show("phase 2 plain reference (--device host)", host)
    sam = open(cold["sam"], "rb").read()
    check(cold["platform"] == "gpu", "phase 1 ran on " + cold["platform"])
    check(cold["seeded"] > 0 and warm["seeded"] > 0, "device seeded no read")
    check(open(warm["sam"], "rb").read() == sam, "second SAM != first SAM")
    check(open(host["sam"], "rb").read() == sam,
          "phase 1 SAM != phase 2 SAM")
    check(not host["jax_started"], "the host run started JAX")
    say(f"phase 1/2: SAM byte-identical ({len(sam)} bytes); device seeded "
        f"{warm['seeded']} of {warm['fetched']} reads "
        f"({warm['seeds_used']} shipped with device seeds); map reads/s "
        f"accel {warm['reads_per_s']:.1f} host {host['reads_per_s']:.1f}; "
        f"cli.main wall s accel first {cold['wall_s']:.3f} second "
        f"{warm['wall_s']:.3f} host {host['wall_s']:.3f}")
    kern = child("kernels", *data)
    show("phase 3 kernels", kern)
    say(f"phase 3: all kernels equal their references; peak_bytes_in_use "
        f"{kern['peak_bytes_in_use']}")
    print(json.dumps({"ok": True, "device": {
        "platform": probe["platform"], "kind": probe["kind"],
        "count": probe["count"]}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=sorted(PHASES))
    ap.add_argument("--device", default="accel")
    ap.add_argument("--tag", default="")
    ap.add_argument("--genome")
    ap.add_argument("--reads")
    args = ap.parse_args()
    try:
        if args.phase:
            print("RESULT " + json.dumps(PHASES[args.phase](args)), flush=True)
            return 0
        return orchestrate()
    except Failed as e:
        say(f"FAIL: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
