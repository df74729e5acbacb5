from ellspmv_jax.io.mtx import MtxHeader, read_matrix, read_vector, write_vector

__all__ = ["MtxHeader", "read_matrix", "read_vector", "write_vector"]
