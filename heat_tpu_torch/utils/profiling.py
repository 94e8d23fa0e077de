"""Profiling hooks (heat_tpu ``utils/profiling.py``) on ``torch.profiler``:
a trace of the host and the card written as a TensorBoard trace file,
named annotation scopes, and a wall-clock timer that waits for the card, so
that a measurement covers the computation and not its enqueue.

>>> with profiling.trace("logs/step"):
...     with profiling.annotate("train_step"):
...         params, opt_state, loss = step(params, opt_state, toks)
>>> with profiling.Timer("epoch") as t:
...     out = run_epoch()
...     t.sync(out)
>>> t.seconds
"""

from __future__ import annotations

import contextlib

import torch

from .metrics import Timer

__all__ = ["trace", "annotate", "Timer", "start_trace", "stop_trace"]

_PROFILER = None


def start_trace(logdir: str) -> None:
    """Begin a trace of the host and, where there is one, the card
    (``torch.profiler`` with CPU and CUDA activities); :func:`stop_trace`
    writes it into ``logdir`` as a TensorBoard trace file
    (``*.pt.trace.json``). One trace runs at a time."""
    global _PROFILER
    if _PROFILER is not None:
        raise RuntimeError("a trace is running already; stop_trace() ends it")
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _PROFILER = prof


def stop_trace() -> None:
    """End the trace :func:`start_trace` began and write its file."""
    global _PROFILER
    prof, _PROFILER = _PROFILER, None
    if prof is None:
        raise RuntimeError("no trace is running")
    prof.stop()


@contextlib.contextmanager
def trace(logdir: str):
    """Context manager around a trace written into ``logdir``."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """A named scope on the trace's timeline
    (``torch.profiler.record_function``), and on the card an NVTX range of
    the same name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
