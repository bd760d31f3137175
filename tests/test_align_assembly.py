"""The -a base-level alignment path (map/align.py): banded DP traceback
equivalence and end-to-end record assembly validated by the CIGAR replay
audit (the reference's own correctness oracle for this layer,
src/test_units.cpp:14-164; its -a path is CLI-dead so no binary difftest
exists — see map/align.py docstring)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from linear_tpu.map import align as AL
from linear_tpu.map.align import (align_cords, banded_align_cigar,
                                  banded_align_cigar_fast)
from linear_tpu.utils import seqio

from cigar_audit import audit_sam_line


@pytest.mark.parametrize("seed,n,m", [(1, 180, 200), (2, 400, 380),
                                      (3, 64, 300), (4, 513, 512)])
def test_fast_traceback_matches_oracle(seed, n, m):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 4, m).astype(np.uint8)
    q = r[: n].copy() if n <= m else np.concatenate(
        [r, rng.integers(0, 4, n - m).astype(np.uint8)])
    sub = rng.random(len(q)) < 0.1
    q[sub] = (q[sub] + 1) % 4
    s1, c1, qs1, rs1 = banded_align_cigar_fast(q, r, W=64)
    s2, c2, qs2, rs2 = banded_align_cigar(q, r, W=64)
    assert s1 == s2
    # the oracle returns a packed string; compare op streams
    import re

    c2_ops = [(int(a), b) for a, b in re.findall(r"(\d+)([=XID])", c2)]
    assert c1 == c2_ops
    assert (qs1, rs1) == (qs2, rs2)


def _mutate(seq, rng, err=0.1):
    out = []
    for c in seq:
        x = rng.random()
        if x < err * 0.4:
            out.append(int(rng.integers(0, 4)))
        elif x < err * 0.7:
            out.append(int(rng.integers(0, 4)))
            out.append(int(c))
        elif x < err:
            continue
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def test_cigar_traceback_consistent():
    """Reference traceback: score equals the cell-by-cell oracle; the CIGAR
    replays to exactly that score over the reported spans."""
    import re as _re

    rng = np.random.default_rng(23)
    for trial in range(6):
        base = rng.integers(0, 4, int(rng.integers(60, 300))).astype(np.uint8)
        q = _mutate(base, rng)
        r = base
        score, cig, (q0, q1), (r0, r1) = banded_align_cigar(q, r, W=64)
        assert score == AL.banded_align_oracle(q, r, W=64)
        i, j, s = q0, r0, 0
        for cnt, op in _re.findall(r"(\d+)([=XID])", cig):
            cnt = int(cnt)
            if op in "=X":
                for _ in range(cnt):
                    s += AL.S_MATCH if q[i] == r[j] else AL.S_MISMATCH
                    assert (q[i] == r[j]) == (op == "="), (i, j, op)
                    i += 1
                    j += 1
            elif op == "I":
                s += AL.S_GAP * cnt
                i += cnt
            else:
                s += AL.S_GAP * cnt
                j += cnt
        assert (i, j) == (q1, r1)
        assert s == score, (s, score)


def _simulate(rng, genome, n_reads):
    reads = []
    for i in range(n_reads):
        ln = int(rng.integers(1500, 4000))
        pos = int(rng.integers(0, len(genome) - ln))
        r = genome[pos: pos + ln].copy()
        sub = rng.random(ln) < 0.06
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        if i % 3 == 1:
            r = seqio.revcomp(r)
        elif i % 3 == 2:  # deletion SV
            mid = ln // 2
            r = np.concatenate([r[:mid], r[mid + 300:]])
        reads.append(r)
    return reads


def test_align_path_end_to_end(tmp_path):
    from linear_tpu.map.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(99)
    genome = rng.integers(0, 4, 150000).astype(np.uint8)
    g_fa = str(tmp_path / "g.fa")
    seqio.write_fasta(g_fa, ["chrA"], [genome])
    reads = _simulate(rng, genome, 24)
    m = Mapper([g_fa], MapperConfig(gap_len=50, threads=1, aln_flag=1))
    m.prepare()
    genomes = {"chrA": genome}
    n_lines = 0
    tot_match = tot_mis = 0
    for i, r in enumerate(reads):
        cs, ce, info = m.map_read(r)
        sam, _ = m.read_output(r, f"read{i}", cs, ce)
        for line in sam.splitlines():
            nm, nx, _ = audit_sam_line(line, genomes, r, seqio.revcomp(r))
            tot_match += nm
            tot_mis += nx
            n_lines += 1
    assert n_lines >= 20  # nearly every read yields a record
    # REAL base-level alignment: '=' ops must agree with the genome at a
    # rate the apx path's cell-rounded diagonals cannot reach
    rate = tot_match / max(tot_match + tot_mis, 1)
    assert rate > 0.995, f"'=' agreement {rate:.4f}"


def test_align_vs_apx_positions(tmp_path):
    """-a records land on the same loci the virtual-alignment path maps
    to (the alignment refines CIGARs, not placement)."""
    from linear_tpu.map.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 120000).astype(np.uint8)
    g_fa = str(tmp_path / "g.fa")
    seqio.write_fasta(g_fa, ["chrA"], [genome])
    reads = _simulate(rng, genome, 12)
    m1 = Mapper([g_fa], MapperConfig(gap_len=0, threads=1, aln_flag=1))
    m1.prepare()
    m0 = Mapper([g_fa], MapperConfig(gap_len=0, threads=1))
    m0.prepare()
    for i, r in enumerate(reads):
        cs, ce, _ = m0.map_read(r)
        sam0, _ = m0.read_output(r, f"read{i}", cs, ce)
        cs1, ce1, _ = m1.map_read(r)
        sam1, _ = m1.read_output(r, f"read{i}", cs1, ce1)
        pos0 = [int(l.split("\t")[3]) for l in sam0.splitlines()]
        pos1 = [int(l.split("\t")[3]) for l in sam1.splitlines()]
        if not pos0:
            continue
        assert pos1, f"read{i}: apx maps but -a emits nothing"
        assert abs(pos0[0] - pos1[0]) < 200, (pos0, pos1)
