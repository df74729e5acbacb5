"""ellspmv_jax — a sparse matrix–vector multiplication framework in JAX.

Built with the capabilities of the reference C/OpenMP programs
``ellspmv``/``csrspmv`` (jamtrott/ellspmv): a Matrix Market loader (incl.
gzip, real/integer/pattern fields, general/symmetric), COO→ELL and COO→CSR
conversion with diagonal splitting and per-row column sorting,
``y := A*x + y`` SpMV kernels, a benchmark harness with the reference's
exact flop/byte accounting, and a row-sharded multi-device path.

Every format has exactly one SpMV implementation, written in plain
`jax.numpy`/`lax` and compiled by XLA for whatever backend JAX runs on
(the GPU in production, the CPU in tests). fp64 is native. Multi-device
parallelism is a `jax.sharding.Mesh` + `shard_map` row sharding with an
`all_gather` of x (the reference's only parallelism is OpenMP threads,
csrspmv.c:2834-2837 — the mesh is its scaling analogue).
"""

from ellspmv_jax.config import Config, default_index_dtype, select_index_dtype
from ellspmv_jax.formats.auto import auto_from_coo
from ellspmv_jax.formats.coo import CooMatrix
from ellspmv_jax.formats.ell import EllMatrix, ell_from_coo
from ellspmv_jax.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_jax.io.mtx import (
    MtxHeader,
    read_matrix,
    read_vector,
    write_vector,
)
from ellspmv_jax.ops import spmv

__version__ = "0.1.0"

__all__ = [
    "Config",
    "CooMatrix",
    "CsrMatrix",
    "EllMatrix",
    "MtxHeader",
    "auto_from_coo",
    "csr_from_coo",
    "default_index_dtype",
    "ell_from_coo",
    "read_matrix",
    "read_vector",
    "select_index_dtype",
    "spmv",
    "write_vector",
]
