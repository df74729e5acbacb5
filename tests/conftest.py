"""Test configuration: exact IEEE fp64 and, on the CPU, an 8-device virtual
mesh.

The reference has no test suite (SURVEY §4); this is the test pyramid for
the framework. Run the suite on the CPU with ``JAX_PLATFORMS=cpu``: fp64
there is true IEEE double in a fixed summation order, and
``--xla_force_host_platform_device_count=8`` gives the multi-device tests
a virtual mesh. Tests marked ``gpu`` need an NVIDIA card and skip
without one; run them on the card with ``python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ellspmv_jax.formats.coo import CooMatrix  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_peak_row(monkeypatch):
    """The device table has no CPU row (a CPU time is no device rate);
    tests that print a roofline on the CPU get a placeholder row."""
    from ellspmv_jax import config
    monkeypatch.setitem(config.HBM_PEAK_BYTES_PER_S, "cpu", 50e9)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise
    (decided at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU, found {dev.platform!r}")
    return dev


@pytest.fixture
def rng():
    return np.random.RandomState(12345)


def random_coo(rng, n, m, nnz, symmetric=False, with_dups=False,
               pattern=False, index_dtype=np.int32):
    """Random COO fixture; symmetric instances store only the lower triangle
    (the on-disk convention the reference expands, csrspmv.c:1240-1248)."""
    rows = rng.randint(0, n, nnz).astype(index_dtype)
    cols = rng.randint(0, m, nnz).astype(index_dtype)
    if symmetric:
        lo = np.minimum(rows, cols)
        hi = np.maximum(rows, cols)
        rows, cols = hi, lo
    if not with_dups:
        keys = rows.astype(np.int64) * m + cols
        _, keep = np.unique(keys, return_index=True)
        rows, cols = rows[keep], cols[keep]
        nnz = len(rows)
    vals = np.ones(nnz) if pattern else rng.randn(nnz)
    return CooMatrix(num_rows=n, num_columns=m, rowidx=rows, colidx=cols,
                     values=vals,
                     symmetry="symmetric" if symmetric else "general",
                     field="pattern" if pattern else "real")


@pytest.fixture
def small_coo(rng):
    """4x5, 9-nnz general matrix with an empty-ish row and a long row —
    structurally equivalent to the reference's bundled test.mtx (SURVEY §4:
    rows with 2/1/1/5 entries; all-ones x gives y = [3, 1, 3, 6])."""
    rows = np.array([0, 0, 1, 2, 3, 3, 3, 3, 3], dtype=np.int32)
    cols = np.array([0, 3, 1, 2, 0, 1, 2, 3, 4], dtype=np.int32)
    vals = np.array([1.5, 1.5, 1.0, 3.0, 2.0, 1.0, 1.0, 1.0, 1.0])
    return CooMatrix(num_rows=4, num_columns=5, rowidx=rows, colidx=cols,
                     values=vals)


def assert_fp64_close(got, want, scale=None):
    """fp64 agreement up to summation-reorder ulp noise: tolerance scaled by
    the magnitude of the summands, not the (possibly cancelled) result."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scale is None:
        scale = max(np.max(np.abs(want), initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * scale)
