"""ctypes bindings for the native host library (native/uspmv_host.cpp).

The C++ library implements the ingest/convert hot path natively — mirroring
the reference's native components (mmio.cpp, convert_to_scs at
utilities.hpp:1842-2104) — with semantics bit-identical to the Python
implementations, which remain the fallback and the parity oracle for tests.

The library is built on demand from native/ (g++ required); set
USPMV_DISABLE_NATIVE=1 to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

# USPMV_NATIVE_LIB selects an alternate build of the library (the ASAN/
# UBSAN variants from native/Makefile, driven by scripts/native_sanitize.sh)
_LIB_NAME = os.environ.get("USPMV_NATIVE_LIB", "libuspmv_host.so")
_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_SRC_DIR = os.path.join(_HERE, "..", "..", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i64 = ctypes.c_int64
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


def _try_build() -> bool:
    makefile = os.path.join(_NATIVE_SRC_DIR, "Makefile")
    if not os.path.exists(makefile):
        return False
    try:
        # serialize concurrent builds across PROCESSES (multi-host runs
        # spawn several importing processes; two concurrent makes racing on
        # libuspmv_host.so can nondeterministically break dlopen/the ABI
        # check and silently drop a process to the slow Python converter)
        import fcntl

        lockpath = os.path.join(_NATIVE_SRC_DIR, ".build.lock")
        with open(lockpath, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                subprocess.run(
                    ["make", "-s"],
                    cwd=_NATIVE_SRC_DIR,
                    check=True,
                    capture_output=True,
                    timeout=300,
                )
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        return True
    except (subprocess.SubprocessError, OSError, ImportError):
        return False


_ABI_VERSION = 8  # must match uspmv_abi_version() in native/uspmv_host.cpp


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    try:
        lib.uspmv_abi_version.restype = _i64
        version = int(lib.uspmv_abi_version())
    except AttributeError:
        version = 0  # pre-versioning library
    if version != _ABI_VERSION:
        raise OSError(
            f"native library ABI version {version} != expected "
            f"{_ABI_VERSION}; rebuild native/ (make -C native)"
        )
    lib.uspmv_last_error.restype = ctypes.c_char_p
    lib.uspmv_read_mtx.restype = ctypes.c_void_p
    lib.uspmv_read_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.uspmv_mtx_sizes.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p, _i32p]
    lib.uspmv_mtx_fetch.argtypes = [ctypes.c_void_p, _i32p, _i32p, _f64p]
    lib.uspmv_mtx_free.argtypes = [ctypes.c_void_p]
    lib.uspmv_convert_to_scs.restype = ctypes.c_void_p
    lib.uspmv_convert_to_scs.argtypes = [
        _i64, _i64, _i32p, _i32p, _f64p, _i64, _i64, _i32p,
    ]
    lib.uspmv_scs_sizes.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p, _i64p]
    lib.uspmv_scs_fetch.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, _i32p, _f64p, _i32p, _i32p, _i32p,
    ]
    lib.uspmv_scs_fetch_vals_f32.argtypes = [ctypes.c_void_p, _f32p]
    lib.uspmv_scs_free.argtypes = [ctypes.c_void_p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None (never raises)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("USPMV_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = os.path.join(_HERE, _LIB_NAME)
        # always run make when the source tree is present: it is a cheap
        # no-op when up to date and rebuilds a stale .so after source or
        # ABI changes (the ABI check in _bind is the backstop)
        if not _try_build() and not os.path.exists(path):
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _load_failed = True
            return None
        return _lib


def available() -> bool:
    return load() is not None


def _ptr_i32(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


def _raise_last(lib):
    raise ValueError(lib.uspmv_last_error().decode("utf-8", "replace"))


def read_mtx_native(path: str, require_square: bool = True):
    """Native MatrixMarket read -> MtxData, or None if lib unavailable."""
    lib = load()
    if lib is None:
        return None
    from ..formats.coo import MtxData

    h = lib.uspmv_read_mtx(path.encode(), 1 if require_square else 0)
    if not h:
        _raise_last(lib)
    try:
        n_rows = _i64(0)
        n_cols = _i64(0)
        nnz = _i64(0)
        is_sym = ctypes.c_int32(0)
        lib.uspmv_mtx_sizes(
            h,
            ctypes.byref(n_rows),
            ctypes.byref(n_cols),
            ctypes.byref(nnz),
            ctypes.byref(is_sym),
        )
        I = np.empty(nnz.value, dtype=np.int32)
        J = np.empty(nnz.value, dtype=np.int32)
        vals = np.empty(nnz.value, dtype=np.float64)
        lib.uspmv_mtx_fetch(h, _ptr_i32(I), _ptr_i32(J), vals.ctypes.data_as(_f64p))
    finally:
        lib.uspmv_mtx_free(h)
    return MtxData(
        n_rows=n_rows.value,
        n_cols=n_cols.value,
        nnz=nnz.value,
        is_sorted=True,
        is_symmetric=bool(is_sym.value),
        I=I,
        J=J,
        values=vals,
    )


def convert_to_scs_native(mtx, C: int, sigma: int, dtype=None,
                          fixed_permutation=None):
    """Native COO -> SCS, or None if lib unavailable.

    Same result object as formats.scs.convert_to_scs.
    """
    lib = load()
    if lib is None:
        return None
    from ..formats.scs import ScsData

    I = np.ascontiguousarray(mtx.I, dtype=np.int32)
    J = np.ascontiguousarray(mtx.J, dtype=np.int32)
    vals = np.ascontiguousarray(mtx.values, dtype=np.float64)
    fp = None
    fpp = None
    if fixed_permutation is not None:
        fp = np.ascontiguousarray(fixed_permutation, dtype=np.int32)
        if fp.shape[0] < mtx.n_rows:
            raise ValueError("fixed_permutation shorter than n_rows")
        fpp = _ptr_i32(fp)
    h = lib.uspmv_convert_to_scs(
        mtx.n_rows, mtx.nnz, _ptr_i32(I), _ptr_i32(J),
        vals.ctypes.data_as(_f64p), C, sigma, fpp,
    )
    if not h:
        _raise_last(lib)
    try:
        n_rows = _i64(0)
        n_pad = _i64(0)
        n_chunks = _i64(0)
        n_elems = _i64(0)
        lib.uspmv_scs_sizes(
            h,
            ctypes.byref(n_rows),
            ctypes.byref(n_pad),
            ctypes.byref(n_chunks),
            ctypes.byref(n_elems),
        )
        chunk_ptrs = np.empty(n_chunks.value + 1, dtype=np.int32)
        chunk_lengths = np.empty(n_chunks.value, dtype=np.int32)
        col_idxs = np.empty(n_elems.value, dtype=np.int32)
        out_dtype = np.dtype(dtype if dtype is not None
                             else mtx.values.dtype)
        # the padded value array can be many times nnz; for f32 targets
        # cast DURING the copy (uspmv_scs_fetch_vals_f32) instead of
        # fetching a second full-size f64 buffer and astype-ing it
        f32_fast = out_dtype == np.float32
        values = np.empty(
            n_elems.value, dtype=np.float32 if f32_fast else np.float64
        )
        old_to_new = np.empty(n_rows.value, dtype=np.int32)
        new_to_old = np.empty(n_pad.value, dtype=np.int32)
        row_counts = np.empty(n_pad.value, dtype=np.int32)
        lib.uspmv_scs_fetch(
            h, _ptr_i32(chunk_ptrs), _ptr_i32(chunk_lengths),
            _ptr_i32(col_idxs),
            None if f32_fast else values.ctypes.data_as(_f64p),
            _ptr_i32(old_to_new), _ptr_i32(new_to_old), _ptr_i32(row_counts),
        )
        if f32_fast:
            lib.uspmv_scs_fetch_vals_f32(h, values.ctypes.data_as(_f32p))
    finally:
        lib.uspmv_scs_free(h)
    return ScsData(
        C=int(C),
        sigma=int(sigma),
        n_rows=n_rows.value,
        n_rows_padded=n_pad.value,
        n_chunks=n_chunks.value,
        n_elements=n_elems.value,
        nnz=mtx.nnz,
        chunk_ptrs=chunk_ptrs,
        chunk_lengths=chunk_lengths,
        col_idxs=col_idxs,
        values=values if values.dtype == out_dtype
        else values.astype(out_dtype),
        old_to_new_idx=old_to_new,
        new_to_old_idx=new_to_old,
        n_cols=mtx.n_cols,
        row_counts_new=row_counts,
    )
