"""Native (C++) runtime components.

The reference's runtime is C++ end to end; here the compute path is
JAX/XLA and the IO-bound runtime pieces are C++ behind ctypes:
  lt_seqio   fasta/fastq(.gz) record reader + Dna5 encoding
              (analog of loadRecords src/base.cpp:131 and the
              parallel_io fetch stage src/parallel_io.cpp:433)

Libraries are built on demand with g++ (one-time per machine, cached
next to the sources); every caller must handle `None` (no toolchain)
and fall back to the pure-Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict = {}


def _build(name: str) -> str | None:
    import glob

    src = os.path.join(_DIR, f"{name}.cpp")
    so = os.path.join(_DIR, f"{name}.so")
    deps = [src] + glob.glob(os.path.join(_DIR, "*.hpp"))
    newest_dep = max(os.path.getmtime(d) for d in deps)
    if os.path.exists(so) and os.path.getmtime(so) >= newest_dep:
        return so
    # a private output file per builder: processes that build at once
    # (test workers, a pool's first users) must not write the same file;
    # the rename that publishes the library is atomic
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        # -march=native is safe here: the .so is built on demand PER
        # MACHINE (never shipped), and the host's vector ISA speeds up the
        # feature-script and window-distance lane math measurably
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fopenmp",
               "-shared", "-fPIC", src, "-lz", "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        except subprocess.CalledProcessError:
            cmd.remove("-march=native")  # unusual toolchains
            subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
        return so
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def load(name: str):
    """ctypes CDLL for a native lib, or None when unavailable."""
    if os.environ.get("LINEAR_TPU_NATIVE", "1") == "0":
        return None
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = _build(name)
        lib = None
        if so:
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib


def seqio_lib():
    lib = load("lt_seqio")
    if lib is None:
        return None
    if not getattr(lib, "_lt_configured", False):
        lib.lt_open.restype = ctypes.c_void_p
        lib.lt_open.argtypes = [ctypes.c_char_p]
        lib.lt_next.restype = ctypes.c_int
        lib.lt_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.lt_err.restype = ctypes.c_int
        lib.lt_err.argtypes = [ctypes.c_void_p]
        lib.lt_close.restype = None
        lib.lt_close.argtypes = [ctypes.c_void_p]
        lib._lt_configured = True
    return lib
