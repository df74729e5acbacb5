"""Bytes each format stores and moves per SpMV iteration.

The reference's byte accounting (min_bytes/max_bytes, ellspmv.c:1858-1862)
is a FORMAT-INDEPENDENT model: x once (min) or per nonzero (max) over the
padded ELLPACK arrays with their nominal dtypes. A format that stores less
than ELLPACK (DIA stores no column indices at all) therefore reports an
*effective* bandwidth above the device's memory line. That number is the
right parity metric against the reference's 148 GB/s, but on its own it
reads like a broken roofline.

This module counts the bytes the format's own arrays hold, plus x read
once and y read and written once, so every report can carry both columns:

- effective GB/s = reference min-bytes model / time (parity metric);
- actual GB/s   = stored bytes / time (the format's own traffic floor).

The count assumes every x entry is read from device memory once; x
entries gathered again after falling out of cache are not counted.
"""

from __future__ import annotations

import numpy as np


def _arr_bytes(*arrays) -> int:
    total = 0
    for a in arrays:
        if a is None:
            continue
        total += int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
    return total


def _stored_bytes(matrix) -> int:
    """Bytes of the matrix's own arrays (values, indices, maps)."""
    from ellspmv_jax.formats.csr import CsrMatrix
    from ellspmv_jax.formats.dia import DiaMatrix
    from ellspmv_jax.formats.ell import EllMatrix
    from ellspmv_jax.formats.hybrid import HybridMatrix
    from ellspmv_jax.formats.sell import SellMatrix

    if isinstance(matrix, EllMatrix):
        return _arr_bytes(matrix.colidx, matrix.values, matrix.diag)
    if isinstance(matrix, CsrMatrix):
        # the kernel reads rowids, not rowptr (ops/csr_xla.py)
        return _arr_bytes(matrix.colidx, matrix.values, matrix.rowids,
                          matrix.diag)
    if isinstance(matrix, DiaMatrix):
        return _arr_bytes(matrix.data)
    if isinstance(matrix, SellMatrix):
        total = sum(_stored_bytes(b) for b in matrix.buckets)
        if matrix.tail is not None:
            total += _stored_bytes(matrix.tail)
        return total + _arr_bytes(matrix.order, matrix.row_unperm,
                                  matrix.extra_rows)
    if isinstance(matrix, HybridMatrix):
        total = _stored_bytes(matrix.rest)
        if matrix.hub is not None:
            total += _stored_bytes(matrix.hub) + _arr_bytes(matrix.hub_cols)
        return total
    raise TypeError(f"unsupported matrix type {type(matrix)}")


def estimate_actual_bytes(matrix) -> int | None:
    """Stored bytes + x once + y read and written, per SpMV; None for a
    matrix type without a count (e.g. a sharded wrapper)."""
    try:
        stored = _stored_bytes(matrix)
    except TypeError:
        return None
    vb = np.dtype(matrix.values.dtype if hasattr(matrix, "values")
                  else matrix.data.dtype).itemsize
    return stored + (matrix.num_columns + 2 * matrix.num_rows) * vb
