"""Sequence I/O: fasta/fastq(.gz) readers and Dna5 <-> u8 encoding.

Mirrors the reference's SeqAn-based record loading (reference:
src/base.cpp:131 loadRecords; Dna5 ordValue encoding A=0 C=1 G=2 T=3 N=4).
All sequences are numpy uint8 code arrays on the host; the device pipeline
consumes padded batches of these.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import numpy as np

# Dna5 ordValue table: everything not ACGTacgt maps to N(4),
# matching SeqAn's Dna5 conversion used by the reference.
_CODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)
# complement: A<->T C<->G, N->N  (reference: src/base.cpp:325 _complt "tgcan")
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A0 C1 G2 T3 N4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DECODE[codes].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (reference: _compltRvseStr)."""
    return _COMP[codes[::-1]]


def _open_maybe_gz(path: str) -> io.BufferedReader:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def read_seq_records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (id, codes) records from a fasta/fastq file, optionally gzipped.

    Dispatches to the native C++ reader (linear_tpu.native.lt_seqio) when
    the toolchain is available; the Python implementation below is the
    byte-identical fallback/oracle.
    """
    try:
        from ..native import seqio_lib

        lib = seqio_lib()
    except Exception:
        lib = None
    if lib is not None:
        yield from _read_seq_records_native(lib, path)
        return
    yield from _read_seq_records_py(path)


def _read_seq_records_native(lib, path: str) -> Iterator[Tuple[str, np.ndarray]]:
    import ctypes

    h = lib.lt_open(path.encode())
    if not h:
        raise FileNotFoundError(f"E[06]: can't open file {path}")
    try:
        pid = ctypes.c_char_p()
        idl = ctypes.c_long()
        pseq = ctypes.c_void_p()
        seql = ctypes.c_long()
        while True:
            rc = lib.lt_next(h, ctypes.byref(pid), ctypes.byref(idl),
                             ctypes.byref(pseq), ctypes.byref(seql))
            if rc == 0:
                return
            if rc < 0:
                err = lib.lt_err(h)
                if err == 3:
                    raise ValueError(f"malformed fastq in {path}")
                raise ValueError(f"unrecognized sequence file format: {path}")
            rid = ctypes.string_at(pid, idl.value).decode()
            n = seql.value
            if n:
                codes = np.frombuffer(
                    ctypes.string_at(pseq, n), dtype=np.uint8).copy()
            else:
                codes = np.zeros(0, dtype=np.uint8)
            yield rid, codes
    finally:
        lib.lt_close(h)


def _read_seq_records_py(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    fh = _open_maybe_gz(path)
    try:
        first = fh.read(1)
        if not first:
            return
        if first == b">":
            header = fh.readline().strip()
            chunks: List[bytes] = []
            for raw in fh:
                line = raw.strip()
                if line.startswith(b">"):
                    yield _meta_id(header), encode(b"".join(chunks))
                    header = line[1:]
                    chunks = []
                elif line:
                    chunks.append(line)
            yield _meta_id(header), encode(b"".join(chunks))
        elif first == b"@":
            header = fh.readline().strip()
            while True:
                seq = fh.readline().strip()
                plus = fh.readline()
                qual = fh.readline()
                if not qual and not seq:
                    break
                yield _meta_id(header), encode(seq)
                nxt = fh.readline()
                if not nxt:
                    break
                if not nxt.startswith(b"@"):
                    raise ValueError(f"malformed fastq near {nxt[:40]!r}")
                header = nxt[1:].strip()
                del plus
        else:
            raise ValueError(f"unrecognized sequence file format: {path}")
    finally:
        fh.close()


def _meta_id(header: bytes) -> str:
    # SeqAn keeps the full meta line; the reference prints the full meta as
    # read id (qName) and genome id. Keep full header to match SAM output.
    return header.decode()


@dataclass
class SeqSet:
    """A loaded set of sequences (genomes or a read block)."""

    ids: List[str] = field(default_factory=list)
    seqs: List[np.ndarray] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.seqs)

    @property
    def lengths(self) -> List[int]:
        return [len(s) for s in self.seqs]


def load_genomes(paths: List[str]) -> SeqSet:
    """Load all genome fasta files (reference: loadRecords src/base.cpp:131)."""
    out = SeqSet()
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"E[06]: can't open file {p}")
        for rid, codes in read_seq_records(p):
            out.ids.append(rid)
            out.seqs.append(codes)
    return out


def read_blocks(path: str, block_size: int = 50000) -> Iterator[SeqSet]:
    """Stream reads in blocks (reference: map() 50k-read blocks,
    src/mapper.cpp:892)."""
    block = SeqSet()
    for rid, codes in read_seq_records(path):
        block.ids.append(rid)
        block.seqs.append(codes)
        if len(block) >= block_size:
            yield block
            block = SeqSet()
    if len(block):
        yield block


def scan_record_offsets(path: str):
    """Byte offsets of every record start in an UNCOMPRESSED fasta/fastq
    file (plus the file size as a final sentinel), or None for gzipped /
    unrecognized input. Lets pipeline workers re-read their chunk of
    reads directly from the file instead of receiving pickled arrays
    over the pool pipe (the read payload dominates task IPC)."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
        if magic[:2] == b"\x1f\x8b" or not magic:
            return None
        fh.seek(0, 2)
        size = fh.tell()
        fh.seek(0)
        data = fh.read()
    if magic[0:1] == b">":
        offs = [0]
        pos = 0
        while True:
            pos = data.find(b"\n>", pos)
            if pos < 0:
                break
            offs.append(pos + 1)
            pos += 2
        offs.append(size)
        return np.asarray(offs, dtype=np.int64)
    if magic[0:1] == b"@":
        # fastq: every 4th line starts a record
        nl = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 10)
        starts = nl[3::4] + 1
        offs = np.concatenate([[0], starts[starts < size]])
        if offs[-1] != size:
            offs = np.concatenate([offs, [size]])
        return offs.astype(np.int64)
    return None


def parse_records_range(path: str, b0: int, b1: int, fh=None):
    """Parse the records in byte range [b0, b1) of an uncompressed
    fasta/fastq file (range bounds from scan_record_offsets). Returns
    (ids, seqs) byte-identical to read_seq_records over those records.

    Dispatches to the native range reader when available — pipeline
    workers parse their own chunk, and the Python fallback parser is
    several times slower than the C++ one the feeder used before the
    byte-range task change."""
    try:
        from ..native import seqio_lib

        lib = seqio_lib()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes as _C

        if not getattr(lib, "_rng_configured", False):
            lib.lt_open_range.restype = _C.c_void_p
            lib.lt_open_range.argtypes = [_C.c_char_p, _C.c_long, _C.c_long]
            lib._rng_configured = True
        h = lib.lt_open_range(path.encode(), b0, b1)
        if h:
            ids: List[str] = []
            seqs: List[np.ndarray] = []
            pid = _C.c_char_p()
            idl = _C.c_long()
            pseq = _C.c_void_p()
            seql = _C.c_long()
            try:
                while True:
                    rc = lib.lt_next(h, _C.byref(pid), _C.byref(idl),
                                     _C.byref(pseq), _C.byref(seql))
                    if rc == 0:
                        break
                    if rc < 0:
                        raise ValueError(f"parse error in range of {path}")
                    ids.append(_C.string_at(pid, idl.value).decode())
                    n = seql.value
                    seqs.append(np.frombuffer(
                        _C.string_at(pseq, n), dtype=np.uint8).copy()
                        if n else np.zeros(0, dtype=np.uint8))
            finally:
                lib.lt_close(h)
            return ids, seqs
    import io as _io

    close = False
    if fh is None:
        fh = open(path, "rb")
        close = True
    try:
        fh.seek(b0)
        data = fh.read(b1 - b0)
    finally:
        if close:
            fh.close()
    ids: List[str] = []
    seqs: List[np.ndarray] = []
    bio = _io.BytesIO(data)
    first = bio.read(1)
    if first == b">":
        header = bio.readline().strip()
        chunks: List[bytes] = []
        for raw in bio:
            line = raw.strip()
            if line.startswith(b">"):
                ids.append(_meta_id(header))
                seqs.append(encode(b"".join(chunks)))
                header = line[1:]
                chunks = []
            elif line:
                chunks.append(line)
        ids.append(_meta_id(header))
        seqs.append(encode(b"".join(chunks)))
    elif first == b"@":
        header = bio.readline().strip()
        while True:
            seq = bio.readline().strip()
            plus = bio.readline()
            qual = bio.readline()
            if not qual and not seq:
                break
            ids.append(_meta_id(header))
            seqs.append(encode(seq))
            nxt = bio.readline()
            if not nxt:
                break
            if not nxt.startswith(b"@"):
                raise ValueError(f"malformed fastq near {nxt[:40]!r}")
            header = nxt[1:].strip()
            del plus
    return ids, seqs


def write_fasta(path: str, ids: List[str], seqs: List[np.ndarray], width: int = 80) -> None:
    with open(path, "w") as fh:
        for rid, s in zip(ids, seqs):
            fh.write(f">{rid}\n")
            txt = decode(s)
            for i in range(0, len(txt), width):
                fh.write(txt[i : i + width] + "\n")
