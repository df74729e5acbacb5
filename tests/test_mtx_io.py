"""Matrix Market I/O tests: header strictness, fields, symmetry, gzip,
vector round-trip — the parser surface of ellspmv.c:707-929."""

import gzip
import io

import numpy as np
import pytest

from ellspmv_jax.io.mtx import (MtxFormatError, read_header, read_matrix,
                                read_vector, write_matrix, write_vector)
from tests.conftest import random_coo

MTX = """%%MatrixMarket matrix coordinate real general
% a comment line
4 5 9
1 1 1.5
1 4 1.5
2 2 1
3 3 3
4 1 2
4 2 1
4 3 1
4 4 1
4 5 1
"""


def as_stream(text):
    return io.BytesIO(text.encode())


def test_read_header():
    h = read_header(as_stream(MTX))
    assert (h.object, h.format, h.field, h.symmetry) == (
        "matrix", "coordinate", "real", "general")
    assert (h.num_rows, h.num_columns, h.num_nonzeros) == (4, 5, 9)
    assert h.comment_lines == 1


def test_read_matrix_golden():
    coo = read_matrix(as_stream(MTX))
    assert coo.num_rows == 4 and coo.num_columns == 5
    assert coo.num_nonzeros == 9
    assert coo.rowidx.dtype == np.int32          # 0-based after load
    assert coo.rowidx.min() == 0 and coo.colidx.max() == 4
    y = coo.to_dense() @ np.ones(5)
    np.testing.assert_allclose(y, [3, 1, 3, 6])


@pytest.mark.parametrize("banner, err", [
    ("%%MatrixMart matrix coordinate real general\n1 1 1\n1 1 1\n", "banner"),
    ("%%MatrixMarket tensor coordinate real general\n1 1 1\n", "object"),
    ("%%MatrixMarket matrix list real general\n1 1 1\n", "format"),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n", "field"),
    ("%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n", "symmetry"),
    ("%%MatrixMarket matrix coordinate real general\n1 1\n", "size"),
])
def test_bad_headers(banner, err):
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(banner))


def test_bad_body():
    txt = "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n"
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # too few lines
    txt = "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n"
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # index out of range
    txt = "%%MatrixMarket matrix coordinate real general\n2 2 1\n1.5 1 1.0\n"
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # non-integer index


def test_pattern_field():
    txt = "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 1\n2 2\n"
    coo = read_matrix(as_stream(txt))
    np.testing.assert_array_equal(coo.values, [1.0, 1.0])  # ellspmv.c:882


def test_integer_field():
    txt = ("%%MatrixMarket matrix coordinate integer general\n"
           "2 2 2\n1 1 7\n2 2 -3\n")
    coo = read_matrix(as_stream(txt))
    assert coo.values.dtype == np.float64
    np.testing.assert_array_equal(coo.values, [7.0, -3.0])


def test_symmetric_header():
    txt = ("%%MatrixMarket matrix coordinate real symmetric\n"
           "3 3 3\n1 1 2\n2 1 5\n3 3 1\n")
    coo = read_matrix(as_stream(txt))
    assert coo.symmetry == "symmetric"
    d = coo.to_dense()
    assert d[0, 1] == d[1, 0] == 5

def test_gzip_roundtrip(tmp_path):
    p = tmp_path / "m.mtx.gz"
    with gzip.open(p, "wb") as f:
        f.write(MTX.encode())
    coo = read_matrix(p)                      # auto-detect by suffix
    assert coo.num_nonzeros == 9
    coo2 = read_matrix(p, gzipped=True)       # explicit -z
    np.testing.assert_array_equal(coo.values, coo2.values)


def test_vector_roundtrip(tmp_path):
    y = np.array([3.0, 1.0, 3.0, 6.0, 1e-17, -2.5e300])
    p = tmp_path / "y.mtx"
    write_vector(p, y, precision=17)
    got = read_vector(p)
    np.testing.assert_array_equal(got, y)
    # DBL_DIG=15 default (ellspmv.c:1907)
    write_vector(p, y)
    got = read_vector(p)
    np.testing.assert_allclose(got, y, rtol=1e-14)


def test_vector_as_nx1_matrix():
    txt = "%%MatrixMarket matrix array real general\n3 1\n1\n2\n3\n"
    np.testing.assert_array_equal(read_vector(as_stream(txt)), [1, 2, 3])


def test_vector_bad_sizes():
    txt = "%%MatrixMarket vector array real general\n3\n1\n2\n"
    with pytest.raises(MtxFormatError):
        read_vector(as_stream(txt))


def test_matrix_writer_roundtrip(rng, tmp_path):
    coo = random_coo(rng, 17, 13, 60)
    p = tmp_path / "m.mtx"
    write_matrix(p, coo)
    got = read_matrix(p, use_native=False)
    np.testing.assert_array_equal(got.rowidx, coo.rowidx)
    np.testing.assert_array_equal(got.colidx, coo.colidx)
    np.testing.assert_array_equal(got.values, coo.values)


def test_strict_value_parsing():
    """Value tokens get the reference's per-token strictness
    (parse_double, ellspmv.c:436-460): overflow is ERANGE, garbage and
    mid-body % comments are EINVAL (comments are only legal before the
    size line, ellspmv.c:744-758)."""
    txt = "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 1e999\n"
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # overflow -> inf
    txt = ("%%MatrixMarket matrix coordinate real general\n2 2 2\n"
           "1 1 1.0\n% stray comment\n2 2 2.0\n")
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # comment inside the body
    txt = "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 abc\n"
    with pytest.raises(MtxFormatError):
        read_matrix(as_stream(txt))          # garbage token


def test_native_writer_roundtrip(rng, tmp_path):
    """Native bulk writer (native/mtxwrite.cc) round-trips exactly against
    both readers (shortest-round-trip float formatting)."""
    from ellspmv_jax.io import native
    if not native.available():
        pytest.skip("native library unavailable")
    n = 2000
    nnz = 1_100_000        # above the native-writer threshold
    rows = rng.randint(0, n, nnz)
    cols = rng.randint(0, n, nnz)
    vals = rng.randn(nnz) * 10.0 ** rng.randint(-30, 30, nnz)
    from ellspmv_jax.formats.coo import CooMatrix
    coo = CooMatrix(n, n, rows.astype(np.int64), cols.astype(np.int64),
                    vals)
    p = str(tmp_path / "big.mtx")
    write_matrix(p, coo)
    back = read_matrix(p, use_native=False)
    np.testing.assert_array_equal(back.rowidx, rows)
    np.testing.assert_array_equal(back.colidx, cols)
    np.testing.assert_array_equal(back.values, vals)   # exact round trip
    back2 = read_matrix(p, use_native=True)
    np.testing.assert_array_equal(back2.values, vals)
