"""cgsolve CLI tests: SPD solve end-to-end."""

import io

import numpy as np
import pytest

from ellspmv_jax.cli import cgsolve
from ellspmv_jax.io.mtx import read_vector, write_matrix, write_vector
from ellspmv_jax.models.generators import poisson2d


@pytest.fixture
def poisson_file(tmp_path):
    coo = poisson2d(12)          # SPD, 144 rows
    p = str(tmp_path / "p.mtx")
    write_matrix(p, coo)
    return p, coo


def test_solve(poisson_file, capsys):
    p, coo = poisson_file
    rc = cgsolve.main(["-v", p])
    out = capsys.readouterr()
    assert rc == 0
    x = read_vector(io.BytesIO(out.out.encode()))
    np.testing.assert_allclose(coo.to_dense() @ x, np.ones(144),
                               rtol=1e-6, atol=1e-6)
    assert "iterations" in out.err


def test_solve_with_b_and_reorder(poisson_file, tmp_path, capsys):
    p, coo = poisson_file
    b = np.random.RandomState(0).rand(144)
    bp = str(tmp_path / "b.mtx")
    write_vector(bp, b)
    rc = cgsolve.main(["--reorder=rcm", "--tol=1e-10", p, bp])
    out = capsys.readouterr()
    assert rc == 0
    x = read_vector(io.BytesIO(out.out.encode()))
    np.testing.assert_allclose(coo.to_dense() @ x, b, rtol=1e-7, atol=1e-7)


def test_solve_sharded(poisson_file, capsys):
    p, coo = poisson_file
    rc = cgsolve.main(["--devices=4", "-q", "-v", p])
    assert rc == 0
    assert "iterations" in capsys.readouterr().err


def test_rejects_rectangular(tmp_path, capsys):
    from tests.conftest import random_coo
    coo = random_coo(np.random.RandomState(0), 10, 12, 30)
    p = str(tmp_path / "r.mtx")
    write_matrix(p, coo)
    rc = cgsolve.main([p])
    assert rc == 1
    assert "square" in capsys.readouterr().err


def test_nonconvergence_exit_code(poisson_file, capsys):
    p, _ = poisson_file
    rc = cgsolve.main(["--maxiter=2", "--tol=1e-14", "-q", p])
    assert rc == 2
