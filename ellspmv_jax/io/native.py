"""ctypes binding to the native C++ Matrix Market parser (native/mtxio.cc)
and writer (native/mtxwrite.cc).

The reference's MM read is its wall-clock bottleneck (32 s / 99.7 MB/s for a
3 GB file, README:130-131) because it parses line-at-a-time with strtod
(ellspmv.c:825-844). The native parser mmaps the file and tokenizes it with
all host cores, then hands zero-copy NumPy arrays back through ctypes.

Builds to ``ellspmv_jax/io/_libmtxio.so`` via ``make -C native`` (also
attempted automatically on first use).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "_libmtxio.so")
_NATIVE_DIR = os.path.normpath(os.path.join(_HERE, "..", "..", "native"))

_lock = threading.Lock()
_lib = None
_load_failed = False


class NativeUnsupported(RuntimeError):
    """Input not handled by the native fast path; caller should fall back."""


class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("num_rows", ctypes.c_int64),
        ("num_columns", ctypes.c_int64),
        ("num_nonzeros", ctypes.c_int64),
        ("field", ctypes.c_int32),      # 0=real 1=integer 2=pattern
        ("symmetry", ctypes.c_int32),   # 0=general 1=symmetric
        ("rowidx", ctypes.POINTER(ctypes.c_int64)),
        ("colidx", ctypes.POINTER(ctypes.c_int64)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


def _try_build(target: str | None = None) -> bool:
    makefile = os.path.join(_NATIVE_DIR, "Makefile")
    if not os.path.exists(makefile):
        return False
    cmd = ["make", "-C", _NATIVE_DIR, "-s"]
    if target is not None:
        # out-of-place rebuild (stale-version path): never clobber the
        # existing library until the new one links successfully
        cmd += [f"TARGET={target}", "-B"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception:
        return False
    return os.path.exists(target if target is not None else _LIB_PATH)


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _try_build():
            _load_failed = True
            return None
        lib = None
        for attempt in range(2):
            try:
                lib = ctypes.CDLL(_LIB_PATH)
            except OSError:
                lib = None
            # version gate: a STALE prebuilt .so (the file is gitignored
            # and only auto-built when missing) lacks the newest symbols;
            # binding them later would raise AttributeError deep inside a
            # conversion instead of falling back. Rebuild once, else
            # treat the library as unavailable.
            if lib is not None and hasattr(lib, "mtxio_write_coo"):
                break
            lib = None
            if attempt == 0:
                # rebuild to a temp path and replace only on success: on a
                # host without a working compiler the old (stale but
                # partially functional) library survives
                tmp = _LIB_PATH + ".new"
                if not _try_build(tmp):
                    break
                try:
                    os.replace(tmp, _LIB_PATH)
                except OSError:
                    break
        if lib is None:
            _load_failed = True
            return None
        lib.mtxio_read_matrix.restype = ctypes.POINTER(_MtxResult)
        lib.mtxio_read_matrix.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.mtxio_free.restype = None
        lib.mtxio_free.argtypes = [ctypes.POINTER(_MtxResult)]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("ELLSPMV_NO_NATIVE"):
        return False
    return _load() is not None


def read_matrix(path: str, gzipped: bool | None = None,
                index_dtype=None, value_dtype=np.float64):
    """Parse `path` with the native library. Raises NativeUnsupported for
    inputs the native parser does not take (so callers fall back to Python)."""
    from ellspmv_jax.config import select_index_dtype
    from ellspmv_jax.formats.coo import CooMatrix

    lib = _load()
    if lib is None:
        raise NativeUnsupported("native parser not built")
    want_gzip = 1 if gzipped else (0 if gzipped is not None
                                   else (1 if path.endswith(".gz") else 0))
    res = lib.mtxio_read_matrix(path.encode(), want_gzip)
    if not res:
        raise NativeUnsupported("native parser returned null")
    try:
        r = res.contents
        if r.error:
            msg = r.error.decode()
            if msg.startswith("unsupported"):
                raise NativeUnsupported(msg)
            from ellspmv_jax.io.mtx import MtxFormatError
            raise MtxFormatError(msg)
        nnz = r.num_nonzeros
        idx_dt = select_index_dtype(r.num_rows, r.num_columns, nnz,
                                    index_dtype)
        # One conversion straight out of the C buffers (astype always
        # copies across dtypes, and copy=True pins it for same-dtype), so
        # the library memory can be freed eagerly without an intermediate
        # int64 copy.
        rowidx = np.ctypeslib.as_array(r.rowidx, shape=(nnz,)).astype(
            idx_dt, copy=True)
        colidx = np.ctypeslib.as_array(r.colidx, shape=(nnz,)).astype(
            idx_dt, copy=True)
        if r.field == 2:  # pattern → value 1.0 (ellspmv.c:882)
            values = np.ones(nnz, dtype=value_dtype)
        else:
            values = np.ctypeslib.as_array(
                r.values, shape=(nnz,)).astype(value_dtype, copy=True)
        field = ("real", "integer", "pattern")[r.field]
        symmetry = ("general", "symmetric")[r.symmetry]
        return CooMatrix(num_rows=int(r.num_rows),
                         num_columns=int(r.num_columns),
                         rowidx=rowidx, colidx=colidx,
                         values=values, symmetry=symmetry, field=field)
    finally:
        lib.mtxio_free(res)


def write_coo(path: str, num_rows: int, num_cols: int, rowidx, colidx,
              values=None, symmetric: bool = False) -> None:
    """Fast Matrix Market coordinate writer (native/mtxwrite.cc);
    shortest-round-trip value formatting. Raises NativeUnsupported when
    the library is unavailable (callers fall back to the python writer)."""
    lib = _load()
    if lib is None:
        raise NativeUnsupported("native library not built")
    if not getattr(lib, "_write_bound", False):
        lib.mtxio_write_coo.restype = ctypes.c_int32
        lib.mtxio_write_coo.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
        lib._write_bound = True
    rowidx = np.ascontiguousarray(rowidx, np.int64)
    colidx = np.ascontiguousarray(colidx, np.int64)
    vptr = ctypes.POINTER(ctypes.c_double)()
    if values is not None:
        values = np.ascontiguousarray(values, np.float64)
        vptr = values.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.mtxio_write_coo(
        os.fspath(path).encode(), int(num_rows), int(num_cols),
        len(rowidx),
        rowidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        colidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vptr, 1 if symmetric else 0)
    if rc != 0:
        raise OSError(f"native matrix write failed ({rc})")


class _EllPackResult(ctypes.Structure):
    _fields_ = [
        ("colidx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


def _bind_ell_pack(lib):
    if getattr(lib, "_ell_pack_bound", False):
        return
    lib.mtxio_ell_pack.restype = ctypes.POINTER(_EllPackResult)
    lib.mtxio_ell_pack.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
    ]
    lib.mtxio_ell_pack_free.restype = None
    lib.mtxio_ell_pack_free.argtypes = [ctypes.POINTER(_EllPackResult)]
    lib._ell_pack_bound = True


def ell_pack(num_rows, num_cols, n_pad, rowsize, rowidx, colidx, values,
             sort_rows):
    """Native COO->ELL packing core; returns (colidx (n_pad, rowsize) int32,
    values (n_pad, rowsize) float64) or raises NativeUnsupported."""
    lib = _load()
    if lib is None:
        raise NativeUnsupported("native library not built")
    _bind_ell_pack(lib)
    rowidx = np.ascontiguousarray(rowidx, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    res = lib.mtxio_ell_pack(
        int(num_rows), int(num_cols), int(n_pad), int(rowsize),
        len(rowidx),
        rowidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        colidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 
        1 if sort_rows else 0)
    if not res:
        raise NativeUnsupported("ell_pack returned null")
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())
        shape = (int(n_pad), int(rowsize))
        n_el = shape[0] * shape[1]
        out_c = np.ctypeslib.as_array(r.colidx, shape=(n_el,)).copy()
        out_v = np.ctypeslib.as_array(r.values, shape=(n_el,)).copy()
        return out_c.reshape(shape), out_v.reshape(shape)
    finally:
        lib.mtxio_ell_pack_free(res)
