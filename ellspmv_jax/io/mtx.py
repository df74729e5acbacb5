"""Matrix Market I/O.

Replicates the reference's parser surface (mtxfile_fread_header
ellspmv.c:707-806, mtxfile_fread_matrix_coordinate ellspmv.c:808-888,
mtxfile_fread_vector_array ellspmv.c:890-929) with the same strictness:

- objects: ``matrix`` | ``vector``
- formats: ``coordinate`` (matrix) | ``array`` (vector)
- fields: ``real`` | ``integer`` (parsed as float64) | ``pattern`` (value 1.0,
  ellspmv.c:882)
- symmetries: ``general`` | ``symmetric``
- ``%`` comment lines are skipped between the header and the size line
- 1-based indices converted to 0-based at load
- gzip-compressed streams (the reference's ``-z`` / HAVE_LIBZ path,
  ellspmv.c:1285)

Unlike the reference's line-at-a-time ``fgets`` + ``strtod`` loop (the
reference's own wall-clock bottleneck — 32 s for a 3 GB file, README:131),
the body is parsed in bulk with NumPy, with an optional native C++ parser
(`ellspmv_jax.io.native`) as the fast path.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

__all__ = [
    "MtxHeader",
    "MtxFormatError",
    "read_header",
    "read_matrix",
    "read_vector",
    "write_vector",
    "write_matrix",
]


class MtxFormatError(ValueError):
    """Strict-parse failure, mirroring the reference's EINVAL paths with
    file/line diagnostics (ellspmv.c:1309-1311)."""


VALID_OBJECTS = ("matrix", "vector")
VALID_FORMATS = ("coordinate", "array")
VALID_FIELDS = ("real", "integer", "pattern", "double")
VALID_SYMMETRIES = ("general", "symmetric")


@dataclasses.dataclass
class MtxHeader:
    object: str
    format: str
    field: str
    symmetry: str
    num_rows: int
    num_columns: int
    num_nonzeros: int   # stored entries in the file (not symmetric-expanded)
    comment_lines: int = 0


def _open_stream(path_or_file, gzipped: bool | None = None):
    """Open `path_or_file` as a binary stream, transparently gunzipping.

    `gzipped=None` auto-detects from the filename / magic bytes; the explicit
    flag mirrors the reference's `-z/--gzip` option (ellspmv.c:241).
    """
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        path = os.fspath(path_or_file)
        if gzipped is None:
            gzipped = path.endswith(".gz")
        f = open(path, "rb")
        close = True
    try:
        if gzipped is None or gzipped:
            # zlib's gzopen (the reference's -z path, ellspmv.c:1285) reads
            # uncompressed files transparently; match that by sniffing the
            # magic bytes even when gzip was requested explicitly.
            magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
            gzipped = magic == b"\x1f\x8b"
        if gzipped:
            f = gzip.GzipFile(fileobj=f)
    except Exception:
        if close:
            f.close()
        raise
    return f


def read_header(f) -> MtxHeader:
    """Parse the banner, comments and size line from binary stream `f`.

    Mirrors mtxfile_fread_header (ellspmv.c:707-806): banner must be
    ``%%MatrixMarket object format field symmetry``; size line is
    ``rows cols nnz`` for matrix-coordinate, ``rows cols`` for matrix-array,
    ``n`` for vector-array.
    """
    line = f.readline()
    if isinstance(line, bytes):
        line = line.decode("latin-1")
    parts = line.split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MtxFormatError(f"invalid Matrix Market banner: {line!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    if obj not in VALID_OBJECTS:
        raise MtxFormatError(f"invalid object {obj!r}")
    if fmt not in VALID_FORMATS:
        raise MtxFormatError(f"invalid format {fmt!r}")
    if field not in VALID_FIELDS:
        raise MtxFormatError(f"invalid field {field!r}")
    if field == "double":  # accepted by the reference's parser as real
        field = "real"
    if symmetry not in VALID_SYMMETRIES:
        raise MtxFormatError(
            f"unsupported symmetry {symmetry!r} (the reference supports "
            "general and symmetric, ellspmv.c:764-770)")

    comment_lines = 0
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("latin-1")
        if not line:
            raise MtxFormatError("unexpected EOF before size line")
        if line.startswith("%"):
            comment_lines += 1
            continue
        if line.strip() == "":
            continue
        break

    sizes = line.split()
    try:
        sizes = [int(s) for s in sizes]
    except ValueError as e:
        raise MtxFormatError(f"invalid size line: {line!r}") from e

    if obj == "matrix" and fmt == "coordinate":
        if len(sizes) != 3:
            raise MtxFormatError(f"matrix coordinate size line needs "
                                 f"'rows cols nnz', got {line!r}")
        nr, nc, nnz = sizes
    elif obj == "matrix" and fmt == "array":
        if len(sizes) != 2:
            raise MtxFormatError(f"matrix array size line needs "
                                 f"'rows cols', got {line!r}")
        nr, nc = sizes
        nnz = nr * nc
    elif obj == "vector" and fmt == "array":
        if len(sizes) != 1:
            raise MtxFormatError(f"vector array size line needs 'n', "
                                 f"got {line!r}")
        nr, nc, nnz = sizes[0], 1, sizes[0]
    else:
        raise MtxFormatError(f"unsupported object/format: {obj}/{fmt}")
    if nr < 0 or nc < 0 or nnz < 0:
        raise MtxFormatError(f"negative sizes in size line: {line!r}")
    return MtxHeader(obj, fmt, field, symmetry, nr, nc, nnz, comment_lines)


def _read_body_numpy(f, num_fields: int, num_lines: int) -> np.ndarray:
    """Bulk-parse `num_lines` whitespace-separated numeric rows.

    The reference parses line-at-a-time with strtod (ellspmv.c:825-844); here
    the whole body is tokenized in one NumPy call, with the reference's
    per-token strictness (parse_double, ellspmv.c:436-460): garbage tokens
    and mid-body ``%`` comment lines are EINVAL (comments are only legal
    between banner and size line, ellspmv.c:744-758), and out-of-range
    values like ``1e999`` are ERANGE. Divergence note: strtod accepts
    literal ``inf``/``nan`` tokens without errno; those are rejected here
    too, since overflow and literal infinities are indistinguishable after
    bulk parsing (and no real Matrix Market file contains them).
    """
    try:
        data = np.loadtxt(f, dtype=np.float64, comments=None, ndmin=2,
                          max_rows=num_lines if num_lines > 0 else 1)
    except ValueError as e:
        raise MtxFormatError(f"invalid matrix data: {e}") from e
    if num_lines == 0:
        return np.empty((0, num_fields), dtype=np.float64)
    if data.shape[0] != num_lines:
        raise MtxFormatError(
            f"expected {num_lines} data lines, found {data.shape[0]}")
    if data.shape[1] != num_fields:
        raise MtxFormatError(
            f"expected {num_fields} fields per line, found {data.shape[1]}")
    if not np.isfinite(data).all():
        bad = np.argwhere(~np.isfinite(data))[0]
        raise MtxFormatError(
            f"value out of range at data line {bad[0] + 1}, "
            f"field {bad[1] + 1}")
    return data


def read_matrix(path_or_file, gzipped: bool | None = None,
                index_dtype=None, value_dtype=np.float64,
                use_native: bool | None = None):
    """Read a Matrix Market file into a `CooMatrix`.

    Returns the stored triplets only; symmetric expansion happens at format
    conversion, matching the reference (csr_from_coo_size, csrspmv.c:1240-1248
    expands; the file reader does not).

    `use_native` selects the C++ bulk parser (None = use it when available
    for plain files).
    """
    from ellspmv_jax.config import select_index_dtype
    from ellspmv_jax.formats.coo import CooMatrix

    # Native fast path: plain (non-gzip) on-disk files.
    if use_native is None or use_native:
        from ellspmv_jax.io import native
        if (native.available() and not hasattr(path_or_file, "read")):
            try:
                return native.read_matrix(
                    os.fspath(path_or_file), gzipped=gzipped,
                    index_dtype=index_dtype, value_dtype=value_dtype)
            except native.NativeUnsupported:
                if use_native:
                    raise
        elif use_native:
            raise RuntimeError("native MM parser requested but unavailable")

    f = _open_stream(path_or_file, gzipped)
    try:
        hdr = read_header(f)
        if hdr.object != "matrix" or hdr.format != "coordinate":
            raise MtxFormatError(
                "expected a matrix in coordinate format "
                f"(got {hdr.object}/{hdr.format})")
        nfields = 2 if hdr.field == "pattern" else 3
        body = _read_body_numpy(f, nfields, hdr.num_nonzeros)
    finally:
        f.close()

    idx_dt = select_index_dtype(hdr.num_rows, hdr.num_columns,
                                hdr.num_nonzeros, index_dtype)
    rowidx = body[:, 0].astype(idx_dt)
    colidx = body[:, 1].astype(idx_dt)
    # Validate 1-based index ranges like the reference's strict parse.
    if hdr.num_nonzeros:
        if (body[:, 0] != np.floor(body[:, 0])).any() or \
           (body[:, 1] != np.floor(body[:, 1])).any():
            raise MtxFormatError("non-integer row/column index")
        if rowidx.min() < 1 or rowidx.max() > hdr.num_rows \
           or colidx.min() < 1 or colidx.max() > hdr.num_columns:
            raise MtxFormatError("row/column index out of range")
    rowidx -= 1
    colidx -= 1
    if hdr.field == "pattern":
        vals = np.ones(hdr.num_nonzeros, dtype=value_dtype)  # ellspmv.c:882
    else:
        vals = body[:, 2].astype(value_dtype)
    return CooMatrix(num_rows=hdr.num_rows, num_columns=hdr.num_columns,
                     rowidx=rowidx, colidx=colidx, values=vals,
                     symmetry=hdr.symmetry, field=hdr.field)


def read_vector(path_or_file, gzipped: bool | None = None,
                value_dtype=np.float64) -> np.ndarray:
    """Read a dense MM vector (array format), per mtxfile_fread_vector_array
    (ellspmv.c:890-929). Also accepts an Nx1 matrix in array format, which
    other MM writers commonly emit."""
    f = _open_stream(path_or_file, gzipped)
    try:
        hdr = read_header(f)
        if hdr.format != "array":
            raise MtxFormatError("expected a dense vector in array format")
        if hdr.field not in ("real", "integer"):
            raise MtxFormatError(f"unsupported vector field {hdr.field!r}")
        if hdr.object == "matrix" and hdr.num_columns != 1:
            raise MtxFormatError("expected a vector or single-column matrix")
        body = _read_body_numpy(f, 1, hdr.num_rows)
    finally:
        f.close()
    return body[:, 0].astype(value_dtype)


def write_vector(f_or_path, y: np.ndarray, comment: str | None = None,
                 precision: int = 15) -> None:
    """Write `y` as a MM vector in array format.

    The reference prints with ``%.*g`` at DBL_DIG=15 digits (ellspmv.c:1907);
    `precision` mirrors that and may be raised to 17 for round-trip-exact
    output.
    """
    own = not hasattr(f_or_path, "write")
    f = open(f_or_path, "w") if own else f_or_path
    try:
        f.write("%%MatrixMarket vector array real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{len(y)}\n")
        fmt = f"%.{precision}g\n"
        f.write("".join(fmt % v for v in np.asarray(y, dtype=np.float64)))
    finally:
        if own:
            f.close()


def write_matrix(f_or_path, coo, comment: str | None = None,
                 precision: int = 17) -> None:
    """Write a CooMatrix in coordinate format (1-based). Used by tests and
    the matrix generators; the reference has no matrix writer. Large
    matrices written to a path use the native bulk writer
    (native/mtxwrite.cc) when available."""
    own = not hasattr(f_or_path, "write")
    if (own and comment is None and precision >= 17
            and len(coo.rowidx) >= 1_000_000):
        from ellspmv_jax.io import native
        if native.available():
            try:
                native.write_coo(
                    f_or_path, coo.num_rows, coo.num_columns,
                    coo.rowidx, coo.colidx,
                    None if coo.field == "pattern" else coo.values,
                    symmetric=coo.symmetry == "symmetric")
                return
            except native.NativeUnsupported:
                pass
    f = open(f_or_path, "w") if own else f_or_path
    try:
        field = "pattern" if coo.field == "pattern" else "real"
        f.write(f"%%MatrixMarket matrix coordinate {field} {coo.symmetry}\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.num_rows} {coo.num_columns} {len(coo.rowidx)}\n")
        if field == "pattern":
            for i, j in zip(coo.rowidx, coo.colidx):
                f.write(f"{i + 1} {j + 1}\n")
        else:
            fmt = f"%d %d %.{precision}g\n"
            for i, j, v in zip(coo.rowidx, coo.colidx, coo.values):
                f.write(fmt % (i + 1, j + 1, v))
    finally:
        if own:
            f.close()
