"""Device kernel tests (virtual CPU devices): bit-exactness vs host oracle."""
import numpy as np
import pytest

from linear_tpu.index import dindex as DI
from linear_tpu.map import chaining as CH
from linear_tpu.ops import chain_dp as CD
from linear_tpu.ops import seeding as SD
from linear_tpu.utils import seqio
from linear_tpu.utils.cordscalar import anchor_x


@pytest.fixture(scope="module")
def small_world():
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 30000).astype(np.uint8)
    idx = DI.build_dindex([genome], threads_emul=4)
    dev = SD.upload_index(idx)
    return rng, genome, idx, dev


def _mutate(seq, rng):
    out = []
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < 0.04:
            out.append((int(seq[i]) + 1) % 4); i += 1
        elif r < 0.06:
            out.append(int(rng.integers(0, 4)))
        elif r < 0.08:
            i += 1
        else:
            out.append(int(seq[i])); i += 1
    return np.array(out, dtype=np.uint8)


def test_device_seeding_matches_host(small_world):
    rng, genome, idx, dev = small_world
    reads = []
    for i in range(4):
        pos = int(rng.integers(0, 25000))
        r = _mutate(genome[pos:pos + 2500], rng)
        if i % 2:
            r = seqio.revcomp(r)
        if i == 3:  # N bases flow through the scan exactly
            r = r.copy()
            r[100:103] = 4
        reads.append(r)
    got = SD.seed_anchors_batch(reads, dev, pad_len=4096)
    for i, r in enumerate(reads):
        host = [int(v) for v in DI.query_anchors(idx, r, 0, len(r), thd_alpha=15)]
        assert got[i] == host, f"read {i}"


def test_block_seeding_matches_host(small_world):
    """The fused superchunk block path (strided minimizer + single-array
    wire formats): exact vs the host oracle across superchunk boundaries,
    short/long reads, and m_out overflow fallback."""
    rng, genome, idx, dev = small_world
    reads = []
    for i in range(11):
        ln = int(rng.integers(300, 3000))
        pos = int(rng.integers(0, 30000 - ln))
        r = _mutate(genome[pos:pos + ln], rng)
        if i % 2:
            r = seqio.revcomp(r)
        reads.append(r)
    disp = SD.seed_block_dispatch(reads, dev, pad_len=4096, m_out=128,
                                  superchunk=4)
    got = SD.seed_block_collect(disp, m_out=128)
    assert len(got) == len(reads)
    for i, r in enumerate(reads):
        host = [int(v) for v in DI.query_anchors(idx, r, 0, len(r), thd_alpha=15)]
        if got[i] is None:  # probed > m_out: declared fallback is legal
            continue
        assert [int(v) for v in got[i]] == host, f"read {i}"
    # m_out=8 must either overflow (None) or still be exact
    disp = SD.seed_block_dispatch(reads, dev, pad_len=4096, m_out=8,
                                  superchunk=4)
    got8 = SD.seed_block_collect(disp, m_out=8)
    for i, r in enumerate(reads):
        host = [int(v) for v in DI.query_anchors(idx, r, 0, len(r), thd_alpha=15)]
        if got8[i] is not None:
            assert [int(v) for v in got8[i]] == host, f"read {i} (m_out=8)"
        else:
            assert len(host) >= 0  # overflow fallback path
    # N-containing reads fall back per-read (None), without dragging the
    # rest of their superchunk off the device path
    rn = reads[0].copy()
    rn[50] = 4
    disp = SD.seed_block_dispatch([rn, reads[1]], dev, pad_len=4096,
                                  superchunk=4)
    gotn = SD.seed_block_collect(disp, m_out=128)
    assert gotn[0] is None
    host1 = [int(v) for v in DI.query_anchors(idx, reads[1], 0, len(reads[1]),
                                              thd_alpha=15)]
    assert gotn[1] is not None and [int(v) for v in gotn[1]] == host1


def test_mapper_seed_block_paths(small_world, tmp_path):
    """Mapper._device_seed_block: block path (N-free) and per-chunk scan
    fallback (N bases) both match the host oracle per read."""
    rng, genome, idx, dev = small_world
    from linear_tpu.map.mapper import Mapper, MapperConfig

    seqio.write_fasta(str(tmp_path / "g.fa"), ["chrH x"], [genome])
    m = Mapper([str(tmp_path / "g.fa")], MapperConfig(threads=4), device="accel")
    m.index = idx
    for with_n in (False, True):
        reads = seqio.SeqSet()
        for i in range(5):
            ln = int(rng.integers(150, 2500))  # includes <= THD_MIN_READ_LEN
            pos = int(rng.integers(0, 30000 - ln))
            r = _mutate(genome[pos:pos + ln], rng)
            if with_n and i == 2:
                r = r.copy()
                r[10:12] = 4
            reads.ids.append(f"r{i} t")
            reads.seqs.append(r)
        got = m._device_seed_block(reads)
        for i, r in enumerate(reads.seqs):
            if len(r) <= 200:
                assert got[i] is None
                continue
            if got[i] is None:
                continue
            host = [int(v) for v in DI.query_anchors(idx, r, 0, len(r), thd_alpha=15)]
            assert [int(v) for v in got[i]] == host, f"read {i} with_n={with_n}"


def test_device_chain_dp_matches_host():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    B, N = 4, 64
    pad = np.zeros((B, N), dtype=np.int64)
    counts = []
    per_read = []
    for b in range(B):
        n = int(rng.integers(8, N))
        ys = np.sort(rng.integers(0, 4000, n))
        anc = [(((123000 + int(rng.integers(-150, 150)) + (1 << 20)) << 20) + int(y)
                + (int(rng.integers(0, 2)) << 61)) for y in ys]
        anc.sort(key=anchor_x, reverse=True)
        pad[b, :n] = anc
        counts.append(n)
        per_read.append(anc)
    p2, sc, ln = CD.batch_chain_dp(jnp.asarray(pad), jnp.asarray(np.array(counts)))
    p2, sc, ln = np.asarray(p2), np.asarray(sc), np.asarray(ln)
    for b in range(B):
        n = counts[b]
        recs = CH.get_best_chains(
            np.array(per_read[b], dtype=np.uint64), 0, n, 20, 300,
            CH.get_apx_chain_score, CH.ChainScoreParms(), anchor_x)
        dev = CD.chain_records_from_dp(p2[b], sc[b], ln[b], n)
        for i in range(n):
            assert (recs[i].p2anchor, recs[i].score, recs[i].length,
                    recs[i].root_ptr, recs[i].f_leaf) == (
                dev[i].p2anchor, dev[i].score, dev[i].length,
                dev[i].root_ptr, dev[i].f_leaf), (b, i)


def test_windowed_dp_matches_full():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    B, N = 4, 96
    pad = np.zeros((B, N), dtype=np.int64)
    counts = []
    for b in range(B):
        n = int(rng.integers(8, N))
        ys = np.sort(rng.integers(0, 4000, n))
        anc = [(((123000 + int(rng.integers(-150, 150)) + (1 << 20)) << 20) + int(y)
                + (int(rng.integers(0, 2)) << 61)) for y in ys]
        anc.sort(key=anchor_x, reverse=True)
        pad[b, :n] = anc
        counts.append(n)
    na = jnp.asarray(np.array(counts))
    p2a, sa, la = CD.batch_chain_dp(jnp.asarray(pad), na)
    p2b, sb, lb, ov = CD.batch_chain_dp_windowed(jnp.asarray(pad), na, W=64)
    p2a, sa, la, p2b, sb, lb, ov = map(np.asarray, (p2a, sa, la, p2b, sb, lb, ov))
    for b in range(B):
        if ov[b]:
            continue
        n = counts[b]
        assert np.array_equal(p2a[b][:n], p2b[b][:n])
        assert np.array_equal(sa[b][:n], sb[b][:n])
        assert np.array_equal(la[b][:n], lb[b][:n])


def test_hybrid_mapper_equals_host(small_world, tmp_path):
    rng, genome, idx, dev = small_world
    from linear_tpu.map.mapper import Mapper, MapperConfig

    seqio.write_fasta(str(tmp_path / "g.fa"), ["chrH x"], [genome])
    reads = seqio.SeqSet()
    for i in range(3):
        pos = int(rng.integers(0, 25000))
        r = _mutate(genome[pos:pos + 2000], rng)
        if i % 2:
            r = seqio.revcomp(r)
        reads.ids.append(f"r{i} t")
        reads.seqs.append(r)
    mh = Mapper([str(tmp_path / "g.fa")], MapperConfig(gap_len=50, threads=4), device="host")
    mt = Mapper([str(tmp_path / "g.fa")], MapperConfig(gap_len=50, threads=4), device="accel")
    mh.prepare()
    mt.index = mh.index
    mt.f2 = mh.f2
    _, _, sam_h = mh.map_block(reads)
    _, _, sam_t = mt.map_block(reads)
    assert sam_h == sam_t
