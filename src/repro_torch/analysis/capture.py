"""Capture harness: record the ``LaunchPlan`` a port wrapper would launch,
without launching (port of ``repro.analysis.capture``).

The grid pass needs the real plans the shipped wrappers build — not a
hand-maintained mirror that silently drifts. Every wrapper launches through
one hook, ``kernels.launch.run``, and plans with the SM count from
``kernels.launch.sm_count`` after ``kernels.launch.check_device`` has
accepted its operands. ``capture_launch`` patches the three (as the JAX
package's capture patches ``pl.pallas_call``): the device check accepts
CPU and ``meta`` tensors, the SM count is the one asked for, and the hook
records the plan and aborts the call with a control-flow exception before
anything runs. The wrapper's dtype, shape and pattern checks run as they
do on the card, so a plan is built on the CPU for the H100's 132 SMs.
Pattern tensors (block_idx, out_idx/out_slot, page tables, lengths) must be
CPU tensors: the plan's reads follow their values; float operands may be
``meta`` tensors, so a full-width plan allocates nothing.
"""
from __future__ import annotations

from typing import Callable

from ..kernels import launch
from ..kernels.launch import H100_SMS, LaunchPlan


class _CaptureSignal(Exception):
    """Control-flow: carries the captured plan out of the wrapper."""

    def __init__(self, plan: LaunchPlan):
        super().__init__("launch captured")
        self.plan = plan


def capture_launch(fn: Callable, *args, n_sm: int = H100_SMS,
                   **kwargs) -> LaunchPlan:
    """Run ``fn(*args, **kwargs)`` with the launch hook patched to record
    its plan for ``n_sm`` SMs; returns the first plan. No kernel runs."""
    real = launch.run, launch.sm_count, launch.check_device

    def record(plan, buffers, call):
        raise _CaptureSignal(plan)

    launch.run = record
    launch.sm_count = lambda device: n_sm
    launch.check_device = lambda name, tensors: None
    try:
        fn(*args, **kwargs)
    except _CaptureSignal as sig:
        return sig.plan
    finally:
        launch.run, launch.sm_count, launch.check_device = real
    raise RuntimeError(f"{fn!r} launched nothing — nothing to analyze")
