"""Automatic format selection: DIA vs ELLPACK vs CSR, by structure alone.

The reference dispatches kernels on user flags (ellspmv.c:1834-1843); this
chooser picks the format from the matrix's structure with three fixed
thresholds:

- DIA when the matrix lives on at most `_MAX_DIAGS` distinct diagonals that
  are at least half full (gather-free streaming SpMV; one device only,
  since the sharded path takes ELL/CSR);
- else ELLPACK when its padding (rows x max row length, ellspmv.c:955)
  stores at most `_MAX_PAD_RATIO` times the nonzeros;
- else CSR, whose stored size is the nonzero count whatever the row
  lengths (power-law and dense-rows matrices).

No cost model prices the candidates: these are structural rules, not
measurements.
"""

from __future__ import annotations

import numpy as np

from ellspmv_jax.formats.coo import CooMatrix

# DIA acceptance: few diagonals, each at least half full.
_MAX_DIAGS = 32
_MIN_DIA_FILL = 0.5
# ELL acceptance: padded slots per stored nonzero.
_MAX_PAD_RATIO = 4.0


def _tag(mat, choice: str, reason: str):
    object.__setattr__(mat, "_auto_choice", choice)
    object.__setattr__(mat, "_auto_reason", reason)
    return mat


def auto_from_coo(coo: CooMatrix, separate_diagonal: bool = False,
                  sort_rows: bool = True, value_dtype=None,
                  index_dtype=None, allow_dia: bool = True):
    """Return the matrix in the format the structural rule picks.

    The decision is recorded on the returned matrix as `_auto_choice`
    ('dia', 'ell' or 'csr') with `_auto_reason` for verbose reporting.
    """
    from ellspmv_jax.formats.csr import csr_from_coo
    from ellspmv_jax.formats.dia import dia_from_coo
    from ellspmv_jax.formats.ell import ell_from_coo

    expanded = coo.expand_symmetry()
    n = expanded.num_rows
    nnz = max(expanded.num_nonzeros, 1)

    if allow_dia and not separate_diagonal:
        dia = dia_from_coo(expanded, max_diags=_MAX_DIAGS,
                           value_dtype=value_dtype)
        if dia is not None and nnz >= _MIN_DIA_FILL * dia.diasize:
            return _tag(dia, "dia",
                        f"{dia.num_diags} diagonals, "
                        f"{100 * nnz / max(dia.diasize, 1):.0f}% full")

    counts = (np.bincount(expanded.rowidx, minlength=n)
              if n else np.zeros(0, int))
    rowsize = int(counts.max()) if counts.size else 0
    ellsize = n * rowsize
    if ellsize <= _MAX_PAD_RATIO * nnz:
        ell = ell_from_coo(coo, separate_diagonal=separate_diagonal,
                           sort_rows=sort_rows, value_dtype=value_dtype,
                           index_dtype=index_dtype)
        return _tag(ell, "ell",
                    f"ELL padding {ellsize / nnz:.2f}x the nonzeros")
    csr = csr_from_coo(coo, separate_diagonal=separate_diagonal,
                       sort_rows=sort_rows, value_dtype=value_dtype,
                       index_dtype=index_dtype)
    return _tag(csr, "csr",
                f"ELL padding would be {ellsize / nnz:.1f}x the nonzeros")
