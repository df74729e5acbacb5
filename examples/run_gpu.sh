#!/usr/bin/env bash
# Example GPU runs (the run_a64fx.sh analogue: environment + invocations).
# One process per card: a JAX process reserves most of the card's memory.
set -euo pipefail
cd "$(dirname "$0")/.."

# Compiled kernels persist in $JAX_COMPILATION_CACHE_DIR when set, else in
# .jax_cache at the root of the checkout.

# ELLPACK benchmark, 10 timed iterations, per-iteration metric lines:
python -m ellspmv_jax.cli.ellspmv --repeat=10 --warmup=2 --sort-rows -v -q \
    examples/test.mtx

# Device time per SpMV (in-jit loop, two lengths, slope) and the roofline:
python -m ellspmv_jax.cli.ellspmv --format=auto --protocol=chained \
    --repeat=10 -q --papi-event-summary examples/test.mtx

# CSR with a derived-metric file:
python -m ellspmv_jax.cli.csrspmv -q --papi-event-summary \
    --papi-event-file=examples/membw.metrics examples/test.mtx

# Conjugate-gradient solve (SPD matrix), RCM-reordered internally:
python -m ellspmv_jax.cli.cgsolve -v --tol=1e-10 --reorder=rcm \
    examples/test_spd.mtx || true

# Every user path once at full size, checked against the fp64 oracle:
python chip_smoke.py

# Full benchmark suite over the BASELINE configs:
python -m ellspmv_jax.bench.suite --quick
