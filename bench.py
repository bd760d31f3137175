"""Benchmark: END-TO-END mapping throughput vs the reference binary.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Workload (BASELINE.json config 1 analog): synthetic 4.6 Mb genome + 10240
simulated PacBio-CLR-like reads (~7 kb, ~10% err) — config 1's read count,
large enough that both sides' prep amortizes and the pipeline reaches
steady state. Both sides run the SAME
files end to end — genome load + feature/index build + mapping + SAM output:

  baseline   the reference binary (.ref_build/linear, cmake build of
             /root/reference) with -t <ncpu>, total wall clock. Measured on
             this machine and cached in .bench_cache/baseline_v2.json.
  ours       linear_tpu's production pipeline: feeder + forked worker pool
             running the native per-read engine, with the seed stage
             dispatched between the device kernel (--device accel) and the
             native engine by measured rate (outputs identical either way).
             XLA compiles are excluded by a small warm-up file (persistent
             compilation cache); everything else, index build included, is
             in the timed region.

The JSON line names the device the run used (JAX platform, device kind,
device count, and nvidia-smi's name and power limit where there is one).
A device failure fails the run; so does a JAX CPU backend unless
JAX_PLATFORMS=cpu asks for it.

Output parity between the two sides is enforced by tests/difftest.py, so
this measures identical work.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_cache")
GENOME_LEN = 4_600_000
N_READS = 10240
N_WARM = 2048
READ_LEN = 7000
SEED = 42
REF_FALLBACK_READS_PER_S = 1955.62  # reference README human run (BASELINE.md)


def mutate(seq, rng, sub=0.04, ins=0.03, dele=0.03):
    """CLR-like errors: step k draws r[k]; a substitution or a match copies
    seq[i] (changed or not) and advances i, an insertion emits a random
    base without advancing, a deletion advances without emitting. The walk
    is evaluated for all steps at once."""
    n = len(seq)
    r = rng.random(n * 2)
    reps = 1
    while True:  # the draws wrap around r when the walk outlasts them
        x = np.tile(r, reps)
        adv = ~((x >= sub) & (x < sub + ins))
        i = np.cumsum(adv) - adv  # seq index before each step
        k_end = int(np.searchsorted(i, n))
        if k_end < len(x) or n == 0:
            break
        reps += 1
    x, i = x[:k_end], i[:k_end]
    k = np.arange(k_end)
    s = seq[np.minimum(i, max(n - 1, 0))].astype(np.int64)
    ins_base = (r[(k + 8) % len(r)] * 4).astype(np.int64) & 3
    val = np.where(x < sub, (s + 1) % 4, np.where(x < sub + ins, ins_base, s))
    keep = ~((x >= sub + ins) & (x < sub + ins + dele))
    return val[keep].astype(np.uint8)


def make_data():
    from linear_tpu.utils import seqio

    os.makedirs(CACHE, exist_ok=True)
    g_fa = os.path.join(CACHE, "bench_gen_g.fa")
    r_fa = os.path.join(CACHE, f"bench_gen_r{N_READS}.fa")
    w_fa = os.path.join(CACHE, f"bench_gen_w{N_WARM}.fa")
    if not (os.path.exists(g_fa) and os.path.exists(r_fa) and os.path.exists(w_fa)):
        from linear_tpu.utils.simdata import make_genomic_genome

        rng = np.random.default_rng(SEED)
        # realistic bacterial repeat structure (BASELINE config 1 stand-in:
        # real E. coli is unfetchable in the zero-egress environment):
        # rDNA arrays, IS families, REP palindromes, assembly-gap N runs
        genome = make_genomic_genome(rng, GENOME_LEN)
        reads = []
        for i in range(N_READS + N_WARM):
            while True:
                pos = int(rng.integers(0, GENOME_LEN - READ_LEN))
                seg = genome[pos: pos + READ_LEN]
                # resample reads falling mostly inside an assembly N-gap
                if (seg == 4).sum() < READ_LEN // 2:
                    break
            r = mutate(seg, rng)
            if i % 3 == 2:
                r = seqio.revcomp(r)
            reads.append(r)
        seqio.write_fasta(g_fa, ["U00096.3 synthetic"], [genome])
        seqio.write_fasta(r_fa, [f"read{i} sim" for i in range(N_READS)],
                          reads[:N_READS])
        seqio.write_fasta(w_fa, [f"warm{i} sim" for i in range(N_WARM)],
                          reads[N_READS:])
    return g_fa, r_fa, w_fa


def measure_baseline(g_fa: str, r_fa: str) -> float:
    """reads/s of the reference binary, measured FRESH each bench run (the
    shared host's throughput varies run to run — a cached number from a
    quieter hour would skew vs_baseline in either direction). Best of 2."""
    cache_f = os.path.join(CACHE, f"baseline_v3_{N_READS}.json")
    ref_bin = os.path.join(ROOT, ".ref_build", "linear")
    if not os.path.exists(ref_bin):
        if os.path.exists(cache_f):
            return json.load(open(cache_f))["reads_per_s"]
        return REF_FALLBACK_READS_PER_S
    out_prefix = os.path.join(CACHE, "ref_bench")
    nt = str(os.cpu_count() or 16)
    wall = None
    for _ in range(2):
        t0 = time.time()
        subprocess.run(
            [ref_bin, "filter", r_fa, g_fa, "-t", nt, "-o", out_prefix, "-ot", "2"],
            check=True, capture_output=True, cwd=CACHE,
        )
        w = time.time() - t0
        wall = w if wall is None else min(wall, w)
    rps = N_READS / wall
    json.dump({"reads_per_s": rps, "wall_s": wall, "n_reads": N_READS,
               "threads": nt,
               "note": "reference binary, end-to-end wall incl. load+index"},
              open(cache_f, "w"))
    return rps


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them, or ""
    where there is no nvidia-smi."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip()


def main():
    g_fa, r_fa, w_fa = make_data()
    baseline = measure_baseline(g_fa, r_fa)
    stages = {}

    from linear_tpu.map.mapper import Mapper, MapperConfig
    from linear_tpu.parallel.pipeline import PipelineMapper
    from linear_tpu.utils import seqio
    from linear_tpu.utils.jaxcfg import accel_device

    # one-time native toolchain build (g++ of lt_engine/lt_seqio), excluded
    # from the timed region exactly like the XLA compile cache: both are
    # per-machine artifacts, not per-run work
    from linear_tpu.map import nengine as NE
    from linear_tpu.native import load as _load_native

    NE.engine_lib()
    _load_native("lt_seqio")

    # both runs' pipelines (prepare = features + DIndex build, then the
    # fork of the worker pool) are built before the first JAX call
    t0 = time.time()
    mapper = Mapper([g_fa], MapperConfig(), device="accel")
    pipe = PipelineMapper(mapper)
    t_prep = time.time() - t0
    # best of 2 (mirrors the baseline's best-of-2): a fresh prep + map pass
    # — same work end to end, guards both sides against transient host noise
    t0 = time.time()
    mapper2 = Mapper([g_fa], MapperConfig(), device="accel")
    pipe2 = PipelineMapper(mapper2)
    t_prep2 = time.time() - t0

    import jax

    dev = accel_device()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": nvidia_smi()}

    # warm-up: compile the device kernels (persistent XLA cache) and run a
    # separate small file through the pipeline
    mapper.warmup()

    # device calibration (production dispatch decision): measure the
    # ACTUAL pipeline warm on the warm file with the device seed feeder on
    # and off, and keep the faster mode. Outputs are identical either way;
    # the runs double as pipeline warm-up (untimed, like the XLA compile
    # cache).
    if mapper.use_native():
        wblock = next(seqio.read_blocks(w_fa))
        nw = len(wblock.seqs)
        ne = mapper.native_engine()
        seeds = mapper._device_seed_block(wblock)
        tc = time.time()
        for r, rid, s in zip(wblock.seqs, wblock.ids, seeds):
            s = np.asarray(s, dtype=np.uint64) if s is not None else None
            ne.map_read(r, rid, seeds=s, do_output=False)
        stages["host_seeded_reads_per_s_per_core"] = round(
            nw / (time.time() - tc), 1)
        rates = {}
        for leg in ("accel", "host"):
            mapper.device = leg
            for _ in pipe.run(w_fa, collect_cords=False):  # warm
                pass
            tc = time.time()
            n = 0
            for br in pipe.run(w_fa, collect_cords=False):
                n += br.n
            rates[leg] = n / (time.time() - tc)
        mapper.device = "accel" if rates["accel"] > rates["host"] else "host"
        stages["pipe_accel_reads_per_s"] = round(rates["accel"], 1)
        stages["pipe_host_reads_per_s"] = round(rates["host"], 1)
        stages["n_workers"] = pipe.n_workers
        stages["device_dispatch"] = mapper.device
    else:
        for _ in pipe.run(w_fa):
            pass

    sam_out = os.path.join(CACHE, "bench.sam")

    def timed_run(mapper, pipe):
        t1 = time.time()
        n = 0
        with open(sam_out, "w") as f:
            f.write(mapper.sam_header())
            for br in pipe.run(r_fa, collect_cords=False):
                f.write(br.sam)
                n += br.n
        return n, time.time() - t1

    n, t_map = timed_run(mapper, pipe)
    pipe.close()

    mapper2.device = mapper.device
    for _ in pipe2.run(w_fa, collect_cords=False):
        pass
    n2, t_map2 = timed_run(mapper2, pipe2)
    pipe2.close()
    if t_prep2 + t_map2 < t_prep + t_map:
        t_prep, t_map, n = t_prep2, t_map2, n2

    wall = t_prep + t_map
    rps = n / wall
    stages["prep_s"] = round(t_prep, 3)
    stages["map_s"] = round(t_map, 3)
    stages["map_reads_per_s"] = round(n / t_map, 1)
    # per-stage detail to stderr (tools/profile_stages.py gives the full
    # warm per-stage profile incl. the device extension phase)
    print("stages: " + json.dumps(stages), file=sys.stderr)
    print(json.dumps({
        "metric": "end_to_end_reads_per_s",
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / baseline, 4),
        "device": device,
        "stages": stages,
    }))


if __name__ == "__main__":
    main()
