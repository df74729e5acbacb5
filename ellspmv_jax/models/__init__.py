from ellspmv_jax.models.generators import (banded_random, dense_rows,
                                           poisson2d, power_law)
from ellspmv_jax.models.solvers import cg

__all__ = ["banded_random", "cg", "dense_rows", "poisson2d", "power_law"]
