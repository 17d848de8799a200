"""Profiling / tracing utilities.

The reference's observability was per-batch trace files plus
``time.perf_counter`` spans (reference: src/pipeline/kg_builder.py:86-254);
both are kept (see KGBuilder).  This module adds the device layer:
``jax.profiler`` device traces viewable in XProf/TensorBoard, and a
lightweight span timer that aggregates into the MetricsTracker.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from .logger import get_logger
from .metrics import MetricsTracker

logger = get_logger("profiling")


@contextlib.contextmanager
def device_trace(log_dir: str = "profiles") -> Iterator[None]:
    """Capture a jax.profiler device trace around the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("Device trace written to %s (open with xprof / "
                    "tensorboard --logdir)", log_dir)


@contextlib.contextmanager
def span(name: str, metrics: Optional[MetricsTracker] = None,
         annotate_device: bool = False) -> Iterator[None]:
    """Wall-clock span; optionally also a jax.profiler TraceAnnotation so
    the region shows up inside device traces."""
    ctx = contextlib.nullcontext()
    if annotate_device:
        import jax

        ctx = jax.profiler.TraceAnnotation(name)
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    if metrics is not None:
        metrics.record_timing(name, dt)
    logger.debug("span %s: %.3fs", name, dt)
