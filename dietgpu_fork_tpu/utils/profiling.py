"""Profiling and timing hooks: the analog of the reference's
profilerStart/Stop (`dietgpu/utils/DeviceUtils.cpp:48-54`), a wall timer
that waits for the device, and the device description every benchmark
prints beside its numbers.

Usage::

    from dietgpu_fork_tpu.utils.profiling import trace, timed

    with trace("/tmp/tb"):           # view with TensorBoard / xprof
        out = compress_data(...)

    ms = timed(lambda: jax.jit(f)(x))   # median milliseconds
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace around the body (profilerStart/Stop).
    A trace that cannot start or stop raises."""
    jax.profiler.start_trace(
        log_dir, create_perfetto_link=False, create_perfetto_trace=True
    )
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn: Callable[[], object], *, repeats: int = 10) -> float:
    """Median wall time of ``fn`` in milliseconds over ``repeats`` calls
    after one warm-up call, each ended by block_until_ready (includes
    dispatch)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def gpu_description() -> str:
    """"platform, device_kind, count, card name and power limit" of the
    GPU JAX runs on (name and limit from nvidia-smi). Exits non-zero
    unless JAX's platform is the GPU: a benchmark never falls back to the
    CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"needs a GPU; JAX's platform is {devs[0].platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return (f"platform {devs[0].platform}, device_kind "
            f"{devs[0].device_kind}, count {len(devs)}, card {smi}")
