"""Span API and profiler bridging (port of ``repro.obs.trace``).

``span("train/step", seq=3)`` times a host-side phase: the duration lands
in the registry (``repro_span_seconds`` histogram, labeled by span name,
plus a raw-duration ring the benchmarks read) and the body is bracketed
with ``torch.profiler.record_function(name)``, so trainer phases show up
named in traces captured by :func:`profile_trace`.

Spans wrap host code around the launches and never read a device tensor,
so a step makes the same launches with tracing on or off and no host sync
(the same contract as ``obs.metrics``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from . import metrics


@contextlib.contextmanager
def span(name: str, registry: Optional[metrics.Registry] = None,
         annotate: bool = True, **attrs):
    """Time a named host-side phase.

    * records the wall-clock duration into ``registry`` (process default
      when ``None``) as a ``repro_span_seconds`` histogram sample + a raw
      duration + a JSONL ``span`` event (with ``attrs``);
    * brackets the body with ``torch.profiler.record_function(name)`` (when
      ``annotate`` and the registry is enabled), so a concurrently captured
      profile shows the phase by name.
    """
    reg = metrics.resolve(registry)
    ann = torch.profiler.record_function(name) \
        if (annotate and reg.enabled) else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with ann:
            yield
    finally:
        dt = time.perf_counter() - t0
        if reg.enabled:
            reg.record_span(name, dt, attrs or None)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    where there is a card) for the duration of the block and write it into
    ``log_dir`` as a Chrome trace, ``trace_<pid>_<ms>.json`` (no-op when
    ``log_dir`` is falsy: callers wire a ``--profile-dir`` knob straight
    through). Spans inside the block appear as named ranges."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns() // 10**6}.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_call(fn, *args, iters: int = 10, warmup: int = 2,
               repeats: int = 1, name: str = "call",
               registry: Optional[metrics.Registry] = None) -> float:
    """Best-of-``repeats`` median wall-time per call in microseconds,
    measured THROUGH the registry: each timed iteration runs under
    ``span(f"bench/{name}")`` and the return value is the best (minimum)
    over ``repeats`` rounds of the median of each round's ``iters``
    durations. The best-of-medians estimator is robust to one-off
    scheduler noise in either direction: the median absorbs spikes within
    a round, the min discards whole rounds degraded by background load.
    Each timed call ends in a synchronisation of the card (where one is in
    use), so the span covers the device's work, not only its launch."""
    import numpy as np

    reg = metrics.resolve(registry)
    sname = f"bench/{name}"
    for _ in range(warmup):
        fn(*args)
    _sync()
    best = None
    for _ in range(max(1, repeats)):
        for _ in range(iters):
            with span(sname, registry=reg):
                fn(*args)
                _sync()
        ds = reg.span_durations(sname)[-iters:]
        med = float(np.median(ds) * 1e6)
        best = med if best is None else min(best, med)
    return best
