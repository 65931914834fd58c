"""Profiler trace capture (SURVEY.md §5 tracing/profiling).

The reference's only instrumentation is wall-clock prints
(``model_control_example.cpp:91,95``, ``ModelControl.cpp:108``).  Here the
per-stage wall-clock story lives in ``benchmarks/profile_stages.py`` and
``SolveStats``; this module adds the device-level view: a ``jax.profiler``
trace (viewable in Perfetto / TensorBoard) around any region, exposed as a
``--profile DIR`` flag on the benchmark harnesses.  On a GPU the trace holds
the device's own timeline beside the host threads.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``trace_dir`` (no-op when None).

    Usage:  ``with device_trace(args.profile): run_benchmark()``
    View:   ``tensorboard --logdir <dir>`` or load the ``.trace.json.gz``
    in https://ui.perfetto.dev.
    """
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield


def annotate(name: str):
    """Named sub-region inside a device_trace (jax.profiler.TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
