"""ctypes bindings for the native preprocessing library (native/shudc.cpp).

The shared library is built from ``native/shudc.cpp`` on first use (or by
``tools/build_native.sh``) and rebuilt when the source is newer.  Without a
C++ compiler the pure-Python implementations run instead; the native path
is required in practice for 1M+-cell meshes, where the sequential
preprocessing passes dominate setup time.  ``status()`` says which path is
in use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "libshudc.so")
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "shudc.cpp")

_LIB = None
_TRIED = False
_STATUS = "not loaded"


def _build() -> "float | None":
    """Compile ``_SRC`` into ``_SO``; returns the build seconds, or None
    when there is no source or no compiler, or the compile fails.  The
    library is written to a temporary file and renamed into place, so a
    concurrent loader never sees a partial file."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SRC):
        return None
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        r = subprocess.run(
            [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            return None
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def _lib():
    global _LIB, _TRIED, _STATUS
    if not _TRIED:
        _TRIED = True
        stale = (not os.path.exists(_SO)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SRC) > os.path.getmtime(_SO)))
        if stale:
            secs = _build()
            _STATUS = (f"native library built from {os.path.basename(_SRC)}"
                       f" in {secs:.2f} s" if secs is not None else
                       "pure-Python fallback (native library not built)")
        else:
            _STATUS = "native library (already built)"
        if os.path.exists(_SO):
            lib = ctypes.CDLL(_SO)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.shud_rm_sinks.argtypes = [
                ctypes.c_int64, i64p, i64p, f64p, f64p, f64p,
            ]
            lib.shud_rm_sinks.restype = None
            lib.shud_nabr_to_me.argtypes = [ctypes.c_int64, i64p, i64p]
            lib.shud_nabr_to_me.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def status() -> str:
    """Which preprocessing path is in use, and how it got there."""
    _lib()
    return _STATUS


def rm_sinks(nabr: np.ndarray, riv_id: np.ndarray, aq_depth: np.ndarray,
             z_surf: np.ndarray, z_bottom: np.ndarray) -> None:
    """In-place sequential sink removal."""
    lib = _lib()
    ne = len(z_surf)
    if lib is not None:
        lib.shud_rm_sinks(
            ne,
            np.ascontiguousarray(nabr, np.int64),
            np.ascontiguousarray(riv_id, np.int64),
            np.ascontiguousarray(aq_depth, np.float64),
            z_surf, z_bottom,
        )
        return
    for i in range(ne):
        zmin_nb = np.inf
        for j in range(3):
            nb = nabr[i, j]
            if nb >= 0:
                zmin_nb = min(zmin_nb, z_surf[nb])
        if np.isfinite(zmin_nb) and zmin_nb > z_surf[i] and riv_id[i] <= 0:
            z_surf[i] = zmin_nb
            z_bottom[i] = zmin_nb - aq_depth[i]


def nabr_to_me(nabr: np.ndarray) -> np.ndarray:
    lib = _lib()
    ne = nabr.shape[0]
    if lib is not None:
        out = np.empty((ne, 3), dtype=np.int64)
        lib.shud_nabr_to_me(ne, np.ascontiguousarray(nabr, np.int64), out)
        return out
    out = np.full((ne, 3), -1, dtype=np.int64)
    for i in range(ne):
        for j in range(3):
            nb = nabr[i, j]
            if nb >= 0:
                for k in range(3):
                    if nabr[nb, k] == i:
                        out[i, j] = k
    return out
