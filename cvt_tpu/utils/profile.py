"""Profiling observability (SURVEY §5.1 replacement).

The reference instruments with ad-hoc wall-clock prints
(opq/train_codebook/train_PQ_codebook.cpp:161-169, util/timer.h). Here:

  * `trace(logdir)` — context manager over jax.profiler.trace, producing
    a TensorBoard-loadable device trace of every XLA/Pallas kernel.
  * `roofline(flops, bytes_accessed, seconds)` — achieved TFLOP/s and
    device-memory GB/s for a measured kernel invocation.

Step times come from the host clock around work that ends in
`jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@contextlib.contextmanager
def trace(logdir: str):
    """JAX profiler trace context (TensorBoard format)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Roofline:
    tflops: float
    hbm_gbps: float

    def __str__(self) -> str:
        return f"{self.tflops:.1f} TFLOP/s, {self.hbm_gbps:.0f} GB/s"


def roofline(flops: float, bytes_accessed: float, seconds: float) -> Roofline:
    return Roofline(tflops=flops / seconds / 1e12,
                    hbm_gbps=bytes_accessed / seconds / 1e9)
