"""ctypes wrapper for the native per-read mapping engine (lt_engine).

The native engine is the production host runtime: it consumes the
device seeding results (or seeds on the host itself) and runs the exact
per-read pipeline — chaining DP, dense window extension, gap/SV resolution,
cords -> CIGAR/SAM — at C++ speed. It is validated bit-identical against
the Python host oracle (linear_tpu.map.*) by tests/test_nengine.py; the
Python engine stays as the reference implementation and fallback
(LINEAR_TPU_ENGINE=py forces it).
"""
from __future__ import annotations

import ctypes as C
import os
from typing import List, Optional

import numpy as np

from ..native import load

_LIB = None
_LIB_TRIED = False


def engine_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        lib = load("lt_engine")
        if lib is not None:
            lib.le_create2.restype = C.c_void_p
            lib.le_create2.argtypes = [
                C.c_int64,
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64),
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64),
                C.c_void_p, C.c_void_p, C.c_void_p,
                C.c_int, C.c_int,
                C.c_int64, C.c_int64, C.c_int64,
                C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_double, C.POINTER(C.c_char_p)]
            lib.le_create.restype = C.c_void_p
            lib.le_create.argtypes = [
                C.c_int64,                      # n_genomes
                C.POINTER(C.c_void_p),          # genome_ptrs
                C.POINTER(C.c_int64),           # genome_lens
                C.POINTER(C.c_void_p),          # gfeat_ptrs
                C.POINTER(C.c_int64),           # gfeat_rows
                C.c_void_p,                     # dir (int32*)
                C.c_void_p,                     # hs (u64*)
                C.c_int, C.c_int,               # span, weight
                C.c_int64, C.c_int64,           # thd_DI, thd_X
                C.c_int64,                      # gap_len_min
                C.c_int, C.c_int, C.c_int, C.c_int,  # f_dup f_chain ss rccs
                C.c_double,                     # cah_stop_ratio (preset)
                C.POINTER(C.c_char_p),          # genome ids
            ]
            lib.le_set_hindex.restype = None
            lib.le_set_hindex.argtypes = [
                C.c_void_p,
                C.c_void_p, C.c_int64,          # ysa, n_ysa
                C.c_void_p, C.c_void_p,         # xs_val1, xs_val2
                C.c_int64, C.c_int64,           # xs_mask, empty_dir
                C.c_int, C.c_int,               # span, weight
            ]
            lib.le_reset.restype = None
            lib.le_reset.argtypes = [C.c_void_p]
            lib.le_destroy.restype = None
            lib.le_destroy.argtypes = [C.c_void_p]
            lib.le_map_block.restype = C.c_int
            lib.le_map_block.argtypes = [
                C.c_void_p, C.POINTER(C.c_void_p), C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_void_p),
                C.POINTER(C.c_int64), C.c_int64, C.c_int,
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64)]
            lib.le_map_read.restype = C.c_int
            lib.le_map_read.argtypes = [
                C.c_void_p,
                C.c_void_p, C.c_int64,          # read, len
                C.c_char_p,                     # rid
                C.c_void_p, C.c_int64,          # seeds, n_seeds
                C.c_int, C.c_int,               # tid, do_output
                C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),  # out cs/ce
                C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
            ]
            lib.le_apx_hits.restype = C.c_int
            lib.le_apx_hits.argtypes = [
                C.c_void_p, C.c_void_p, C.c_int64, C.c_void_p, C.c_int64,
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64),
            ]
            lib.le_apx_finish.restype = C.c_int
            lib.le_apx_finish.argtypes = [
                C.c_void_p, C.c_void_p, C.c_int64, C.c_char_p,
                C.c_void_p, C.c_int64, C.c_int, C.c_int,
                C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),
                C.POINTER(C.c_int64),
                C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
            ]
            lib.le_feature_rows.restype = C.c_int64
            lib.le_feature_rows.argtypes = [C.c_int64, C.c_int64]
            lib.le_build_features.restype = None
            lib.le_build_features.argtypes = [C.c_void_p, C.c_int64, C.c_int64,
                                              C.c_void_p]
            lib.le_build_index.restype = C.c_void_p
            lib.le_build_index.argtypes = [
                C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
                C.c_int, C.c_int, C.c_int64, C.c_int64, C.c_int64, C.c_int64,
                C.c_void_p,
            ]
            lib.le_index_hs_len.restype = C.c_int64
            lib.le_index_hs_len.argtypes = [C.c_void_p]
            lib.le_index_fetch_hs.restype = None
            lib.le_index_fetch_hs.argtypes = [C.c_void_p, C.c_void_p]
            lib.le_index_nz_len.restype = C.c_int64
            lib.le_index_nz_len.argtypes = [C.c_void_p]
            lib.le_index_fetch_nz.restype = None
            lib.le_index_fetch_nz.argtypes = [C.c_void_p, C.c_void_p]
            lib.le_index_free.restype = None
            lib.le_index_free.argtypes = [C.c_void_p]
        _LIB = lib
    return _LIB


def build_features_native(seq: np.ndarray, threads: int) -> Optional[np.ndarray]:
    """Genome feature scripts via the native builder (None if unavailable);
    identical to ops.features.create_features_genome."""
    lib = engine_lib()
    if lib is None or not enabled():
        return None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = lib.le_feature_rows(len(seq), threads)
    out = np.empty((n, 3), dtype=np.int32)
    lib.le_build_features(seq.ctypes.data, len(seq), threads, out.ctypes.data)
    return out


def build_dindex_native(seqs: List[np.ndarray], span: int, weight: int,
                        min_step: int, max_step: int, omit_block: int,
                        threads: int):
    """DIndex tables via the native builder: returns (dir int32, hs uint64)
    numpy copies, or None if unavailable. Identical to index.dindex's
    sort-based numpy build (tests/test_nengine.py asserts this)."""
    lib = engine_lib()
    if lib is None or not enabled():
        return None
    pinned = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
    n = len(pinned)
    gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in pinned])
    glens = (C.c_int64 * n)(*[len(g) for g in pinned])
    full = (1 << (2 * weight)) + 1
    dirp = np.zeros(full, dtype=np.int32)  # filled in place by the builder
    h = lib.le_build_index(gptrs, glens, n, span, weight, min_step, max_step,
                           omit_block, threads, dirp.ctypes.data)
    n_hs = lib.le_index_hs_len(h)
    hs = np.empty(n_hs, dtype=np.uint64)
    lib.le_index_fetch_hs(h, hs.ctypes.data)
    n_nz = lib.le_index_nz_len(h)
    nz = np.empty(n_nz, dtype=np.uint64)
    lib.le_index_fetch_nz(h, nz.ctypes.data)
    lib.le_index_free(h)
    return dirp, hs, nz


def build_hindex_native(seqs: List[np.ndarray], span: int, step: int,
                        blocklimit: int, alpha: float, threads: int):
    """HIndex (-i 2) tables via the native builder (le_hibuild.hpp):
    returns an index.hindex.HIndex, or None if unavailable. Bit-identical
    to the Python build (tests/test_hindex.py asserts this)."""
    lib = engine_lib()
    if lib is None or not enabled():
        return None
    if not getattr(lib, "_hb_configured", False):
        lib.le_build_hindex.restype = C.c_void_p
        lib.le_build_hindex.argtypes = [
            C.POINTER(C.c_void_p), C.POINTER(C.c_int64), C.c_int64,
            C.c_int, C.c_int64, C.c_int64, C.c_double, C.c_int64]
        lib.le_hindex_sizes.restype = None
        lib.le_hindex_sizes.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
        lib.le_hindex_ptrs.restype = None
        lib.le_hindex_ptrs.argtypes = [C.c_void_p, C.POINTER(C.c_void_p),
                                       C.c_void_p]
        lib.le_hindex_build_free.restype = None
        lib.le_hindex_build_free.argtypes = [C.c_void_p]
        lib._hb_configured = True
    pinned = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
    n = len(pinned)
    gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in pinned])
    glens = (C.c_int64 * n)(*[len(g) for g in pinned])
    h = lib.le_build_hindex(gptrs, glens, n, span, step, blocklimit,
                            alpha, threads)
    sizes = (C.c_int64 * 3)()
    lib.le_hindex_sizes(h, sizes)
    # zero-copy: numpy views over the build's own buffers; the handle is
    # freed when the index is garbage-collected (a fetch would pay a full
    # memcpy plus fresh-page faults, large at genome scale)
    ptrs = (C.c_void_p * 3)()
    mask = np.zeros(1, dtype=np.uint64)
    lib.le_hindex_ptrs(h, ptrs, mask.ctypes.data)

    def view(ptr, count, dtype):
        if count == 0:
            return np.zeros(0, dtype=dtype)
        buf = (C.c_char * (count * 8)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype)

    ysa = view(ptrs[0], sizes[0], np.uint64)
    v1 = view(ptrs[1], sizes[1], np.uint64)
    v2 = view(ptrs[2], sizes[1], np.int64)
    from ..index.hindex import HIndex

    idx = HIndex(span=span, weight=span - 8, ysa=ysa, xs_val1=v1,
                 xs_val2=v2, xs_mask=int(mask[0]),
                 empty_dir=int(sizes[2]))
    idx._native_keepalive = _BuildHandle(lib, h)
    return idx


class _BuildHandle:
    """Frees a native build's buffers when the wrapping index dies."""

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h

    def __del__(self):
        try:
            self._lib.le_hindex_build_free(self._h)
        except Exception:
            pass


def enabled() -> bool:
    if os.environ.get("LINEAR_TPU_ENGINE", "native") == "py":
        return False
    return engine_lib() is not None


class NativeEngine:
    """One engine instance per process; keeps the backing numpy arrays
    alive for the engine's lifetime."""

    def __init__(self, genomes: List[np.ndarray], gfeats: List[np.ndarray],
                 index, genome_ids: List[str], thd_DI: int, thd_X: int,
                 gap_len_min: int, f_dup: int, f_chain: int,
                 sequence_sam: int, reform_ccs: int,
                 cah_stop_ratio: float = 0.0):
        lib = engine_lib()
        assert lib is not None
        self._lib = lib
        # pinned references (the engine stores raw pointers)
        self._genomes = [np.ascontiguousarray(g, dtype=np.uint8) for g in genomes]
        self._gfeats = [np.ascontiguousarray(f, dtype=np.int32) for f in gfeats]
        self._hindex = None
        if hasattr(index, "ysa"):  # -i 2 HIndex: engine seeds via le_hindex
            self._hindex = index
            self._dir = np.zeros(2, dtype=np.int32)
            self._hs = np.zeros(0, dtype=np.uint64)
        else:
            self._dir = np.ascontiguousarray(index.dir, dtype=np.int32)
            self._hs = np.ascontiguousarray(index.hs, dtype=np.uint64)
        self._nz = None
        if getattr(index, "ensure_nz", None) is not None:
            self._nz = np.ascontiguousarray(index.ensure_nz(),
                                            dtype=np.uint64)
        n = len(self._genomes)
        gptrs = (C.c_void_p * n)(*[g.ctypes.data for g in self._genomes])
        glens = (C.c_int64 * n)(*[len(g) for g in self._genomes])
        fptrs = (C.c_void_p * n)(*[f.ctypes.data for f in self._gfeats])
        frows = (C.c_int64 * n)(*[f.shape[0] for f in self._gfeats])
        gids = (C.c_char_p * n)(*[s.encode() for s in genome_ids])
        self._h = lib.le_create2(
            n, gptrs, glens, fptrs, frows,
            self._dir.ctypes.data, self._hs.ctypes.data,
            self._nz.ctypes.data if self._nz is not None else None,
            index.span, index.weight,
            thd_DI, thd_X, gap_len_min, f_dup, f_chain,
            sequence_sam, reform_ccs, cah_stop_ratio, gids)
        if self._hindex is not None:
            hi = self._hindex
            self._hi_ysa = np.ascontiguousarray(hi.ysa, dtype=np.uint64)
            self._hi_v1 = np.ascontiguousarray(hi.xs_val1, dtype=np.uint64)
            self._hi_v2 = np.ascontiguousarray(hi.xs_val2, dtype=np.int64)
            lib.le_set_hindex(self._h, self._hi_ysa.ctypes.data,
                              len(self._hi_ysa), self._hi_v1.ctypes.data,
                              self._hi_v2.ctypes.data, hi.xs_mask,
                              hi.empty_dir, hi.span, hi.weight)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.le_destroy(self._h)
        except Exception:
            pass

    def reset(self) -> None:
        """Fresh per-task GapParms (reference: per-compute-task state)."""
        self._lib.le_reset(self._h)

    def map_read(self, read: np.ndarray, rid: str,
                 seeds: Optional[np.ndarray] = None, tid: int = 0,
                 do_output: bool = True):
        """Returns (cords_str int64-u64 ndarray copy, cords_end, sam str)."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        if seeds is None:
            seeds_ptr, n_seeds = None, -1
        else:
            seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
            seeds_ptr, n_seeds = seeds.ctypes.data, len(seeds)
        cs_p = C.c_void_p()
        ce_p = C.c_void_p()
        n_out = C.c_int64()
        sam_p = C.c_char_p()
        sam_n = C.c_int64()
        self._lib.le_map_read(
            self._h, read.ctypes.data, len(read), rid.encode(),
            seeds_ptr, n_seeds, tid, 1 if do_output else 0,
            C.byref(cs_p), C.byref(ce_p), C.byref(n_out),
            C.byref(sam_p), C.byref(sam_n))
        n = n_out.value
        if n:
            cs = np.ctypeslib.as_array(
                C.cast(cs_p, C.POINTER(C.c_uint64)), shape=(n,)).copy()
            ce = np.ctypeslib.as_array(
                C.cast(ce_p, C.POINTER(C.c_uint64)), shape=(n,)).copy()
        else:
            cs = np.zeros(0, dtype=np.uint64)
            ce = np.zeros(0, dtype=np.uint64)
        sam = C.string_at(sam_p, sam_n.value).decode() if sam_n.value else ""
        return cs, ce, sam

    def map_block(self, reads, rids, seeds_list=None, tid: int = 0) -> str:
        """Map a chunk of reads with ONE ctypes crossing; returns the
        concatenated SAM text (bit-identical to per-read map_read calls
        in order). Use when neither cords nor BAM lines are needed."""
        n = len(reads)
        pinned = [np.ascontiguousarray(r, dtype=np.uint8) for r in reads]
        rptrs = (C.c_void_p * n)(*[r.ctypes.data for r in pinned])
        rlens = (C.c_int64 * n)(*[len(r) for r in pinned])
        rid_b = [r.encode() for r in rids]
        ridp = (C.c_char_p * n)(*rid_b)
        seeds_pinned = []
        sptrs = (C.c_void_p * n)()
        scnts = (C.c_int64 * n)()
        for i in range(n):
            sd = seeds_list[i] if seeds_list is not None else None
            if sd is None:
                sptrs[i], scnts[i] = None, -1
            else:
                sd = np.ascontiguousarray(sd, dtype=np.uint64)
                seeds_pinned.append(sd)
                sptrs[i], scnts[i] = sd.ctypes.data, len(sd)
        sam_p = C.c_char_p()
        sam_n = C.c_int64()
        self._lib.le_map_block(self._h, rptrs, rlens, ridp, sptrs, scnts,
                               n, tid, C.byref(sam_p), C.byref(sam_n))
        return C.string_at(sam_p, sam_n.value).decode() if sam_n.value else ""

    def apx_hits(self, read: np.ndarray, seeds: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        """Phase B of the device pipeline: first-pass apx up to the PRE-filter
        hits (the device runs _filterHits + path_dst_2 on them)."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        if seeds is None:
            seeds_ptr, n_seeds = None, -1
        else:
            seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
            seeds_ptr, n_seeds = seeds.ctypes.data, len(seeds)
        h_p = C.c_void_p()
        n_out = C.c_int64()
        self._lib.le_apx_hits(self._h, read.ctypes.data, len(read),
                              seeds_ptr, n_seeds, C.byref(h_p), C.byref(n_out))
        n = n_out.value
        if not n:
            return np.zeros(0, dtype=np.uint64)
        return np.ctypeslib.as_array(
            C.cast(h_p, C.POINTER(C.c_uint64)), shape=(n,)).copy()

    def apx_finish(self, read: np.ndarray, rid: str, cords: np.ndarray,
                   tid: int = 0, do_output: bool = True):
        """Phase D: consume device path_dst_2 cords; apx tail + gap +
        output. Returns None when the read needs the full host re-map
        (re-apx path) — caller falls back to map_read."""
        read = np.ascontiguousarray(read, dtype=np.uint8)
        cords = np.ascontiguousarray(cords, dtype=np.uint64)
        cs_p = C.c_void_p()
        ce_p = C.c_void_p()
        n_out = C.c_int64()
        sam_p = C.c_char_p()
        sam_n = C.c_int64()
        rc = self._lib.le_apx_finish(
            self._h, read.ctypes.data, len(read), rid.encode(),
            cords.ctypes.data if len(cords) else None, len(cords),
            tid, 1 if do_output else 0,
            C.byref(cs_p), C.byref(ce_p), C.byref(n_out),
            C.byref(sam_p), C.byref(sam_n))
        if rc:
            return None
        n = n_out.value
        if n:
            cs = np.ctypeslib.as_array(
                C.cast(cs_p, C.POINTER(C.c_uint64)), shape=(n,)).copy()
            ce = np.ctypeslib.as_array(
                C.cast(ce_p, C.POINTER(C.c_uint64)), shape=(n,)).copy()
        else:
            cs = np.zeros(0, dtype=np.uint64)
            ce = np.zeros(0, dtype=np.uint64)
        sam = C.string_at(sam_p, sam_n.value).decode() if sam_n.value else ""
        return cs, ce, sam
