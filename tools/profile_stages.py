"""Per-stage warm throughput profile of the production pipeline.

Measures, on the bench corpus (.bench_cache), warm rates for:
  dev_seed       device block seeding (fused superchunks)   (reads/s)
  dev_extend     device _filterHits+path_dst_2              (reads/s)
  host_*         native engine stages, ONE core             (reads/s)
  host per-phase features/apx/gap/output split              (us/read)
  index builds   DIndex native + HIndex native              (s)

The device stages also report the achieved wire bandwidth of the seed
path (h2d pad/4 + 8 bytes/read, d2h (m_out+1)*8 bytes/read). No roofline
share is printed: that needs a peak table keyed by device kind.

Usage: python tools/profile_stages.py [n_reads] [--json]
"""
import ctypes as C
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from linear_tpu.map.mapper import Mapper, MapperConfig
from linear_tpu.utils import seqio
from linear_tpu.utils.jaxcfg import accel_device

N = 1024
for a in sys.argv[1:]:
    if a.isdigit():
        N = int(a)
AS_JSON = "--json" in sys.argv

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".bench_cache")
g_fa = os.path.join(CACHE, "bench_gen_g.fa")
r_fa = None
for cand in os.listdir(CACHE) if os.path.isdir(CACHE) else []:
    if cand.startswith("bench_gen_r"):
        r_fa = os.path.join(CACHE, cand)
if r_fa is None:
    print("run bench.py once to generate the corpus", file=sys.stderr)
    sys.exit(1)

out = {"n_reads": N}

# --- index build times
t0 = time.time()
mapper = Mapper([g_fa], MapperConfig(), device="accel")
mapper.prepare()
out["prep_s"] = round(time.time() - t0, 3)
dev = accel_device()
out["device"] = f"{dev.platform} {dev.device_kind}"
from linear_tpu.index import hindex as HI
from linear_tpu.map import nengine as NE

t0 = time.time()
hi = NE.build_hindex_native(mapper.genomes, HI.DEFAULT_SPAN, HI.DEFAULT_STEP,
                            HI.DEFAULT_BLOCKLIMIT, HI.DEFAULT_ALPHA, 16)
out["hindex_native_build_s"] = round(time.time() - t0, 3)

ne = mapper.native_engine()
block = next(seqio.read_blocks(r_fa))
sub = seqio.SeqSet(ids=block.ids[:N], seqs=block.seqs[:N])
mapper.warmup()


def rate(f, warm=1, reps=2):
    for _ in range(warm):
        f()
    t0 = time.time()
    for _ in range(reps):
        f()
    return N * reps / (time.time() - t0)


# --- device seeding (fused superchunk path; includes all transfers)
out["dev_seed_reads_per_s"] = round(rate(lambda: mapper._device_seed_block(sub)), 1)
seeds = mapper._device_seed_block(sub)
out["dev_seed_fallback_frac"] = round(
    sum(s is None for s in seeds) / N, 3)

# wire bytes per read of the seed path at the bench pad
pad = 8192
h2d_bytes = pad // 4 + 8
d2h_bytes = (mapper.SEED_M_OUT + 1) * 8
wire = out["dev_seed_reads_per_s"] * (h2d_bytes + d2h_bytes)
out["dev_seed_wire_MBps"] = round(wire / 1e6, 1)

# --- host apx_hits from device seeds (one core)
def hits_pass():
    return [ne.apx_hits(r, seeds=np.asarray(s, dtype=np.uint64)
                        if s is not None else None)
            for r, s in zip(sub.seqs, seeds)]


out["host_hits_reads_per_s"] = round(rate(hits_pass), 1)
hits_list = hits_pass()

# --- device extension
out["dev_extend_reads_per_s"] = round(
    rate(lambda: mapper._device_extend_block(sub, hits_list)), 1)
dev_cords = mapper._device_extend_block(sub, hits_list)
out["dev_extend_coverage"] = round(
    sum(c is not None for c in dev_cords) / N, 3)

# --- host finish (apx tail + gap + output) from device cords
def finish_pass():
    ne.reset()
    k = 0
    for r, rid, dc, s in zip(sub.seqs, sub.ids, dev_cords, seeds):
        res = ne.apx_finish(r, rid, dc, tid=0) if dc is not None else None
        if res is None:
            ne.map_read(r, rid, seeds=np.asarray(s, dtype=np.uint64)
                        if s is not None else None, tid=0)
            k += 1
    return k


n_fallback = finish_pass()
out["host_finish_reads_per_s"] = round(rate(finish_pass), 1)
out["finish_fallback_reads"] = n_fallback


# --- host full map_read (native engine does its own seeding) + phase split
def full_pass():
    ne.reset()
    for r, rid in zip(sub.seqs, sub.ids):
        ne.map_read(r, rid, tid=0)


lib = ne._lib
lib.le_stage_ns.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
buf = (C.c_int64 * 4)()
full_pass()
lib.le_stage_ns(ne._h, buf)  # clear
out["host_full_reads_per_s"] = round(rate(full_pass), 1)
lib.le_stage_ns(ne._h, buf)
# rate() ran 3 passes (1 warm + 2 timed) since the clear
for k, nm in enumerate(["features", "apx", "gap", "output"]):
    out[f"host_{nm}_us_per_read"] = round(buf[k] / 1e3 / (3 * N), 1)


# --- host full map_read with device seeds
def full_seeded_pass():
    ne.reset()
    for r, rid, s in zip(sub.seqs, sub.ids, seeds):
        ne.map_read(r, rid, seeds=np.asarray(s, dtype=np.uint64)
                    if s is not None else None, tid=0)


out["host_full_seeded_reads_per_s"] = round(rate(full_seeded_pass), 1)

if AS_JSON:
    print(json.dumps(out))
else:
    for k, v in out.items():
        print(f"{k:>28}: {v}")
