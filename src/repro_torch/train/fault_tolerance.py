"""Launcher-level fault tolerance: heartbeats, stragglers, elastic re-mesh
(port of ``repro.train.fault_tolerance``; pure Python, the reference's
logic and its ``ft_*`` metrics through the port's registry).

A data-parallel step is lockstep: a dead or slow host cannot be handled
inside a step, so failures are handled at the launcher layer, which this
module implements so that it is testable without a cluster:

* ``HeartbeatMonitor``  — per-host last-seen timestamps; hosts exceeding the
  timeout are declared dead, hosts whose step lag exceeds the straggler
  threshold are flagged (so the launcher can pre-emptively checkpoint and
  exclude them at the next restart boundary).
* ``remesh_plan``       — given surviving host count, picks the largest
  power-of-two data-parallel degree that the survivors support, keeping the
  model axis intact. Returns the new mesh shape + the batch scaling.
* ``RestartLoop``       — drives try/except around the step function:
  checkpoint-restore, failure counting, backoff.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from ..obs import metrics as obs_metrics


@dataclasses.dataclass
class HostState:
    last_seen: float
    step: int = 0


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], timeout_s: float = 60.0,
                 straggler_steps: int = 3,
                 registry: Optional[obs_metrics.Registry] = None):
        self.timeout = timeout_s
        self.straggler_steps = straggler_steps
        now = time.monotonic()
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_seen=now) for h in hosts}
        self.obs = registry if registry is not None \
            else obs_metrics.get_registry()
        self._m_age = self.obs.gauge(
            "ft_heartbeat_age_seconds",
            "seconds since each host's last heartbeat")
        self._m_dead = self.obs.gauge(
            "ft_dead_hosts", "hosts past the heartbeat timeout")
        self._m_strag = self.obs.gauge(
            "ft_stragglers", "live hosts lagging the lead step")

    def beat(self, host: str, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        st = self.hosts[host]
        st.last_seen = now
        st.step = step
        self._m_age.set(0.0, host=host)

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        for h, st in self.hosts.items():
            self._m_age.set(max(now - st.last_seen, 0.0), host=h)
        d = [h for h, st in self.hosts.items()
             if now - st.last_seen > self.timeout]
        self._m_dead.set(len(d))
        return d

    def stragglers(self, now: Optional[float] = None) -> List[str]:
        """Live hosts whose step lags the lead by the threshold. Dead
        hosts are excluded from BOTH the lead computation and the
        returned list: a dead host that stopped beating behind the pack
        is not a straggler (it is handled by ``dead()``), and a dead
        host that died ahead of the pack must not drag the lead up and
        flag every healthy host."""
        alive = self.healthy(now)
        if not alive:
            return []
        lead = max(self.hosts[h].step for h in alive)
        lag = [h for h in alive
               if lead - self.hosts[h].step >= self.straggler_steps]
        self._m_strag.set(len(lag))
        return lag

    def healthy(self, now: Optional[float] = None) -> List[str]:
        d = set(self.dead(now))
        return [h for h in self.hosts if h not in d]


def remesh_plan(n_alive_hosts: int, devices_per_host: int,
                model_axis: int, pod_axis: int = 1
                ) -> Optional[dict]:
    """Largest runnable mesh on the survivors.

    The model axis is preserved (parameter layout); the data axis shrinks to
    the largest power of two that fits. Returns None if even model_axis
    devices are not available. global_batch should be scaled by
    ``plan['data'] / old_data`` or grad-accum increased to compensate.
    """
    total = n_alive_hosts * devices_per_host
    per_replica = model_axis * pod_axis
    if total < per_replica:
        return None
    data = 1
    while data * 2 * per_replica <= total:
        data *= 2
    return {"pod": pod_axis, "data": data, "model": model_axis,
            "devices_used": data * per_replica,
            "devices_idle": total - data * per_replica}


@dataclasses.dataclass
class RestartPolicy:
    max_failures: int = 10
    backoff_s: float = 0.0  # kept 0 in tests
    checkpoint_every: int = 50


class RestartLoop:
    """Checkpoint-restart driver with failure injection hooks (tests)."""

    def __init__(self, policy: RestartPolicy, save_fn: Callable[[int], None],
                 restore_fn: Callable[[], int],
                 registry: Optional[obs_metrics.Registry] = None):
        self.policy = policy
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.failures = 0
        self.restarts = 0
        self.obs = registry if registry is not None \
            else obs_metrics.get_registry()
        self._m_restarts = self.obs.counter(
            "ft_restarts_total", "checkpoint-restore restarts taken")
        self._m_failures = self.obs.counter(
            "ft_failures_total", "step failures caught by the loop")

    def run(self, step_fn: Callable[[int], None], total_steps: int) -> int:
        """Runs step_fn(step) for steps [resume..total); returns steps run."""
        executed = 0
        while True:
            start = self.restore_fn()
            try:
                for step in range(start, total_steps):
                    step_fn(step)
                    executed += 1
                    if (step + 1) % self.policy.checkpoint_every == 0:
                        self.save_fn(step + 1)
                        # a checkpoint landing IS progress: reset the
                        # failure budget so max_failures bounds
                        # consecutive no-progress crash loops, not the
                        # total transient-fault count over a job's
                        # lifetime (a month-long run would otherwise be
                        # killed by its 11th unrelated blip)
                        self.failures = 0
                self.save_fn(total_steps)
                return executed
            except RuntimeError:
                self.failures += 1
                self.restarts += 1
                self._m_failures.inc()
                self._m_restarts.inc()
                if self.failures > self.policy.max_failures:
                    raise
                if self.policy.backoff_s:
                    time.sleep(self.policy.backoff_s)
