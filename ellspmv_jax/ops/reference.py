"""Host-side NumPy oracles for tests — the cross-implementation check the
reference performs by diffing ellspmv/csrspmv stdout (SURVEY §4)."""

from __future__ import annotations

import numpy as np


def coo_spmv_numpy(coo, x: np.ndarray, y: np.ndarray | None = None
                   ) -> np.ndarray:
    """y := A*x + y on the expanded COO triplets, in exact IEEE fp64."""
    coo = coo.expand_symmetry()
    out = np.bincount(
        coo.rowidx, minlength=coo.num_rows,
        weights=coo.values.astype(np.float64)
        * np.asarray(x, np.float64)[coo.colidx]).astype(np.float64)
    if y is not None:
        out += np.asarray(y, np.float64)
    return out


def ell_spmv_numpy(ell, x: np.ndarray, y: np.ndarray | None = None
                   ) -> np.ndarray:
    """ellgemv/ellgemvsd semantics (ellspmv.c:1129-1180) in NumPy."""
    n = ell.num_rows
    colidx = np.asarray(ell.colidx)[:n]
    vals = np.asarray(ell.values, np.float64)[:n]
    xx = np.asarray(x, np.float64)
    out = np.zeros(n, np.float64) if y is None \
        else np.asarray(y, np.float64).copy()
    if ell.rowsize:
        out += (vals * xx[colidx]).sum(axis=1)
    if ell.diag is not None:
        d = np.asarray(ell.diag, np.float64)[:n]
        k = min(n, len(xx))
        out[:k] += d[:k] * xx[:k]
    return out


def csr_spmv_numpy(csr, x: np.ndarray, y: np.ndarray | None = None
                   ) -> np.ndarray:
    """csrgemv/csrgemvsd semantics (csrspmv.c:1565-1629) in NumPy."""
    n = csr.num_rows
    out = np.zeros(n, np.float64) if y is None \
        else np.asarray(y, np.float64).copy()
    xx = np.asarray(x, np.float64)
    np.add.at(out, np.asarray(csr.rowids),
              np.asarray(csr.values, np.float64) * xx[np.asarray(csr.colidx)])
    if csr.diag is not None:
        d = np.asarray(csr.diag, np.float64)
        k = min(n, len(xx))
        out[:k] += d[:k] * xx[:k]
    return out


def spmv_error(coo, x: np.ndarray, got, y: np.ndarray | None = None,
               times: int = 1) -> float:
    """Largest row error of `got` against `times` applications of
    y := A*x + y (exact fp64 oracle), each row scaled by its own sum of
    |a_ij * x_j| (plus |y_i|): a reordered sum of k terms stays within
    about k ulp of that scale, whatever cancellation the row has."""
    coo = coo.expand_symmetry()
    xx = np.asarray(x, np.float64)
    want = times * coo_spmv_numpy(coo, xx)
    scale = times * np.bincount(
        coo.rowidx, minlength=coo.num_rows,
        weights=np.abs(coo.values.astype(np.float64) * xx[coo.colidx]
                       )).astype(np.float64)
    if y is not None:
        want += np.asarray(y, np.float64)
        scale += np.abs(np.asarray(y, np.float64))
    err = np.abs(np.asarray(got, np.float64) - want)
    return float(np.max(err / np.maximum(scale, np.finfo(np.float64).tiny),
                        initial=0.0))
