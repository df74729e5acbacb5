from ellspmv_jax.parallel.mesh import make_mesh
from ellspmv_jax.parallel.spmv import ShardedMatrix, shard_matrix, sharded_spmv_fn

__all__ = ["ShardedMatrix", "make_mesh", "shard_matrix", "sharded_spmv_fn"]
