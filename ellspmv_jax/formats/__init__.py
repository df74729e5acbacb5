from ellspmv_jax.formats.auto import auto_from_coo
from ellspmv_jax.formats.coo import CooMatrix
from ellspmv_jax.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_jax.formats.ell import EllMatrix, ell_from_coo

__all__ = ["CooMatrix", "CsrMatrix", "EllMatrix", "auto_from_coo",
           "csr_from_coo", "ell_from_coo"]
