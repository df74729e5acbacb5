from ellspmv_jax.utils.timing import PhaseTimer
from ellspmv_jax.utils.trace import device_trace

__all__ = ["PhaseTimer", "device_trace"]
