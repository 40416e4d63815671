"""Profiling: the kernel-history / NVTX analog.

The reference reads drjit-core's kernel launch history
(dr.kernel_history, /root/reference/path.py:332-351) and brackets phases
with NVTX ranges (dr.profile_range, nerad.py:392-396).  The JAX equivalents:

  * `kernel_history(fn, *args)`  — compile the jitted fn and report XLA's
    cost analysis (flops, bytes accessed, peak memory) per executable:
    the "how many kernels / how heavy" question kernel history answers.
  * `profile_range(name)`        — jax.profiler.TraceAnnotation context
    (shows up in TensorBoard/perfetto traces like NVTX ranges).
  * `trace(dir)`                 — jax.profiler.trace wrapper.
"""
from __future__ import annotations

import contextlib
import time

import jax


def kernel_history(fn, *args, **kwargs):
    """Lower+compile `fn(*args)` and return its cost analysis dict(s)."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    lowered = jitted.lower(*args, **kwargs)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    mem = compiled.memory_analysis()
    out = dict(cost or {})
    if mem is not None:
        for k in (
            "temp_size_in_bytes",
            "argument_size_in_bytes",
            "output_size_in_bytes",
        ):
            v = getattr(mem, k, None)
            if v is not None:
                out[k] = v
    return out


@contextlib.contextmanager
def profile_range(name: str):
    """dr.profile_range analog: named range in the device trace."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler.trace wrapper for capturing a device trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, warmup: int = 1, iters: int = 5):
    """Wall-clock a jitted callable (block_until_ready semantics)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return dt, out
