from ellspmv_jax.bench.harness import BenchResult, SpmvMetrics, benchmark_spmv

__all__ = ["BenchResult", "SpmvMetrics", "benchmark_spmv"]
