"""PipelineMapper (feeder thread + worker pool + ordered drain) must emit
exactly what the serial block loop emits, in the same order.

PipelineMapper forks its pool and refuses to do so once a JAX backend
exists, which another test in this process may already have started; so
every pipeline run here is a fresh Python process (through the CLI entry
point or a short script), on the CPU backend."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from linear_tpu.map.mapper import Mapper, MapperConfig
from linear_tpu.utils import seqio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(code: str, timeout: int = 600, **env_extra) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter from the repo root on the CPU
    backend."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def run_cli(args, pre: str = "", timeout: int = 600):
    """`linear_tpu filter` through cli.main in a fresh process; `pre` runs
    first (e.g. to shrink a class constant)."""
    code = (f"{pre}\nimport sys\nfrom linear_tpu import cli\n"
            f"sys.exit(cli.main({json.dumps(['filter'] + list(args))}))")
    r = run_py(code, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 60000).astype(np.uint8)
    g_fa = str(d / "g.fa")
    seqio.write_fasta(g_fa, ["chr1 test"], [genome])
    reads = []
    for i in range(24):
        pos = int(rng.integers(0, 55000))
        r = genome[pos: pos + 2500].copy()
        sub = rng.random(len(r)) < 0.05
        r[sub] = (r[sub] + 1) % 4
        if i % 3 == 2:
            r = seqio.revcomp(r)
        reads.append(r)
    r_fa = str(d / "r.fa")
    seqio.write_fasta(r_fa, [f"read{i}" for i in range(len(reads))], reads)
    # the serial block loop (host engine) is the reference output
    m = Mapper([g_fa], MapperConfig(threads=4))
    m.prepare()
    sam, apf = [m.sam_header()], []
    for block in seqio.read_blocks(r_fa):
        cs, _, s = m.map_block(block)
        sam.append(s)
        apf.append(m.apf_block(cs, block))
    return d, g_fa, r_fa, "".join(sam), "".join(apf)


def test_pipeline_matches_serial(world):
    d, g_fa, r_fa, sam, apf = world
    out = str(d / "host3")
    run_cli([r_fa, g_fa, "-t", "4", "-ot", "3", "-o", out])
    assert open(out + ".sam").read() == sam
    assert open(out + ".apf").read() == apf


def test_pipeline_device_streaming_matches_serial(world):
    """--device accel pipeline (streaming superchunk seed feeder) must equal
    the host serial output bit for bit, with the device seeding reads;
    exercises the task-emission-as-seeds-land path with a small superchunk
    so several superchunks and task spans interleave."""
    d, g_fa, r_fa, sam, _ = world
    out = str(d / "accel")
    r = run_cli([r_fa, g_fa, "-t", "4", "-o", out, "--device", "accel"],
                pre="from linear_tpu.map.mapper import Mapper\n"
                    "Mapper.SEED_SUPERCHUNK = 8")
    assert open(out + ".sam").read() == sam
    m = re.search(r"--Device  cpu seeded (\d+) of (\d+) reads", r.stderr)
    assert m, r.stderr[-2000:]
    assert int(m.group(2)) == 24
    assert int(m.group(1)) > 0


def test_pipeline_sam_only_batched_path(world):
    """SAM-only output (no APF) routes chunks through the single-crossing
    native map_block; SAM must equal the per-read path byte for byte."""
    d, g_fa, r_fa, sam, _ = world
    out = str(d / "host2")
    run_cli([r_fa, g_fa, "-t", "4", "-ot", "2", "-o", out])
    assert open(out + ".sam").read() == sam


def test_pipeline_refuses_fork_after_jax(world):
    """A normal construction forks with no JAX backend and leaves none;
    once the backend exists, construction raises."""
    _, g_fa, _, _, _ = world
    r = run_py(f"""
from jax._src import xla_bridge
from linear_tpu.map.mapper import Mapper, MapperConfig
from linear_tpu.parallel.pipeline import PipelineMapper
m = Mapper([{g_fa!r}], MapperConfig(threads=4))
PipelineMapper(m, n_workers=2).close()
assert not xla_bridge.backends_are_initialized()
import jax
jax.devices()
try:
    PipelineMapper(m, n_workers=2)
except RuntimeError as e:
    print("REFUSED", e)
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REFUSED" in r.stdout


def test_device_failure_fails_run(world):
    """A device-side exception in the seed stream must fail
    PipelineMapper.run, not turn silently into host seeding."""
    _, g_fa, r_fa, _, _ = world
    r = run_py(f"""
from linear_tpu.map.mapper import Mapper, MapperConfig
from linear_tpu.parallel.pipeline import PipelineMapper

def boom(self, reads):
    raise RuntimeError("device boom")

m = Mapper([{g_fa!r}], MapperConfig(threads=4), device="accel")
pipe = PipelineMapper(m, n_workers=2)
Mapper._device_seed_stream2 = boom
try:
    for _ in pipe.run({r_fa!r}):
        pass
except RuntimeError as e:
    print("RAISED", e)
pipe.close()
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RAISED device boom" in r.stdout
