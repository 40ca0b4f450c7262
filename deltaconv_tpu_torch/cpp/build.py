"""Lazy ``g++`` build and ``ctypes`` loader of ``geodesic_fps.cpp``.

The library goes to ``deltaconv_tpu_torch/_build/libdeltaconv_fps.so``
(rebuilt when the source is newer). Each build writes a file of its own
and renames it into place, so processes that build at once never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_SRC = Path(__file__).resolve().parent / "geodesic_fps.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SO = _BUILD / "libdeltaconv_fps.so"


def _compile() -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    try:
        try:
            subprocess.run([*base, "-fopenmp", str(_SRC), "-o", tmp],
                           check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # Toolchains without libgomp: the same source without OpenMP.
            subprocess.run([*base, str(_SRC), "-o", tmp], check=True,
                           capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where no C++
    toolchain works (callers then take the pure-Python fallback)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if (not _SO.exists()
                or _SRC.stat().st_mtime > _SO.stat().st_mtime):
            try:
                _compile()
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.geodesic_fps.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.geodesic_fps.restype = ctypes.c_int
        lib.knn_graph_cpu.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.knn_graph_cpu.restype = ctypes.c_int
        _LIB = lib
        return _LIB
