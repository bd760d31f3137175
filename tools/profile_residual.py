"""Profile the host residual (post device seed+chain): lockstep extension,
gap phase, output synthesis.
Usage: python tools/profile_residual.py [n] [host|accel]"""
import cProfile
import io
import pstats
import sys
import time

sys.path.insert(0, ".")
import numpy as np

from linear_tpu.map.mapper import Mapper, MapperConfig
from linear_tpu.map.pmpfinder import run_lockstep
from linear_tpu.utils import seqio

N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
DEV = sys.argv[2] if len(sys.argv) > 2 else "host"

g_fa = ".bench_cache/bench_gen_g.fa"
r_fa = ".bench_cache/bench_gen_r10240.fa"

t0 = time.time()
mapper = Mapper([g_fa], MapperConfig(), device=DEV)
mapper.prepare()
print(f"prepare: {time.time()-t0:.2f}s", file=sys.stderr)

block = next(seqio.read_blocks(r_fa))
reads = block.seqs[:N]
rids = block.ids[:N]

if DEV == "accel":
    sub = seqio.SeqSet(ids=rids, seqs=reads)
    t0 = time.time()
    seeds = mapper._device_seed_block(sub)
    chain_pre = mapper._device_chain_block(seeds)
    print(f"device seed+chain: {time.time()-t0:.2f}s", file=sys.stderr)
else:
    seeds = [None] * N
    chain_pre = [None] * N


def residual():
    mapper.reset_gap_parms()
    gens = [mapper.map_read_gen(r, seed_anchors=s, chain_pre=c)
            for r, s, c in zip(reads, seeds, chain_pre)]
    t0 = time.time()
    mapped = run_lockstep(gens)
    t_apx = time.time() - t0
    t0 = time.time()
    for read, (cs, cen, ci, rc, f1) in zip(reads, mapped):
        mapper.gap_phase(read, rc, cs, cen, f1)
    t_gap = time.time() - t0
    t0 = time.time()
    for read, rid, (cs, cen, ci, rc, f1) in zip(reads, rids, mapped):
        mapper.read_output(read, rid, cs, cen)
    t_out = time.time() - t0
    print(f"apx(lockstep): {t_apx:.2f}s  gap: {t_gap:.2f}s  out: {t_out:.2f}s",
          file=sys.stderr)


pr = cProfile.Profile()
pr.enable()
residual()
pr.disable()
s = io.StringIO()
ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
ps.print_stats(45)
print(s.getvalue())
