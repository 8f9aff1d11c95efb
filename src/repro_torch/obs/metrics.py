"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(port of ``repro.obs.metrics``, stdlib only; the same metric kinds, bucket
edges, Prometheus text and JSONL event schema, so that a stream written by
either package replays through the other's ``dump``).

Design rules (the contract the rest of the port instruments against):

* **Host-side only.** Recording is plain Python on the host. Nothing here
  launches a kernel, reads a device tensor or synchronises the card, so a
  training step makes the same launches in the same order with metrics
  enabled or disabled (``chip_smoke.py`` phase 7d counts them).
* **Dependency-free.** stdlib only; ``torch`` is never imported here.
* **Cheap when off.** A disabled registry's handles are no-ops; call sites
  keep one ``if``'s worth of overhead.
* **Replayable.** With a JSONL sink attached every mutation appends one
  event line stamped with a monotonic timestamp; ``repro_torch.obs.dump``
  reconstructs the full registry from the stream in another process, so
  the CI artifact and the live ``/metrics`` endpoint can never disagree.

Label sets are free-form keyword arguments; per-metric series cardinality
is capped (``max_series``) and a breach raises — a runaway label (e.g. a
request id used as a label) is a bug, not a scaling strategy.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# latency-oriented default buckets (seconds): 0.5 ms .. 30 s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_SPAN_RING = 1024  # raw span durations kept per span name (benchmarks read)


def _labels_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _prom_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + body + "}"


class CardinalityError(ValueError):
    """A metric exceeded its label-cardinality budget."""


class _Metric:
    """One named metric: a family of label-keyed series."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str,
                 max_series: int):
        self._reg = registry
        self.name = name
        self.help = help
        self.max_series = max_series
        self.series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _series(self, labels: Dict[str, object], default):
        key = _labels_key(labels)
        s = self.series.get(key)
        if s is None:
            if len(self.series) >= self.max_series:
                raise CardinalityError(
                    f"metric {self.name!r} exceeded {self.max_series} label "
                    f"sets (offending labels: {dict(key)!r}) — an unbounded "
                    f"label (request id? timestamp?) is leaking into the "
                    f"label space")
            s = self.series[key] = default()
        return key, s


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not self._reg.enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} increment must be >= 0")
        key, _ = self._series(labels, float)
        self.series[key] += value
        self._reg._event("counter", self.name, key, value)

    def value(self, **labels) -> float:
        return float(self.series.get(_labels_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key, _ = self._series(labels, float)
        self.series[key] = float(value)
        self._reg._event("gauge", self.name, key, float(value))

    def set_max(self, value: float, **labels) -> None:
        """High-water-mark update: keep the max of old and new."""
        if not self._reg.enabled:
            return
        key, _ = self._series(labels, float)
        new = max(self.series[key], float(value))
        self.series[key] = new
        self._reg._event("gauge", self.name, key, new)

    def value(self, **labels) -> float:
        return float(self.series.get(_labels_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, max_series,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help, max_series)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        if not self._reg.enabled:
            return
        key, s = self._series(
            labels, lambda: _HistSeries(len(self.buckets)))
        v = float(value)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        s.counts[i] += 1
        s.sum += v
        s.count += 1
        self._reg._event("hist", self.name, key, v)

    def stats(self, **labels) -> Tuple[int, float]:
        """(count, sum) for one series — 0s when never observed."""
        s = self.series.get(_labels_key(labels))
        return (0, 0.0) if s is None else (s.count, s.sum)


class Registry:
    """A process-local metric registry + optional JSONL event sink.

    ``enabled=False`` turns every handle into a no-op (creation still
    succeeds so call sites need no branching).
    """

    def __init__(self, enabled: bool = True, max_series: int = 256,
                 jsonl_path: Optional[str] = None):
        self.enabled = enabled
        self.max_series = max_series
        self._metrics: Dict[str, _Metric] = {}
        self._spans: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._sink = None
        self._t0 = time.monotonic()
        if jsonl_path:
            self.set_jsonl(jsonl_path)

    # -- metric construction (get-or-create) -------------------------------

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help,
                                              self.max_series, **kw)
                self._def_event(m)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # -- spans (recorded by obs.trace) ------------------------------------

    def record_span(self, name: str, duration_s: float,
                    attrs: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            ring = self._spans.get(name)
            if ring is None:
                if len(self._spans) >= self.max_series:
                    raise CardinalityError(
                        f"span name cardinality exceeded {self.max_series} "
                        f"(offending span: {name!r})")
                ring = self._spans[name] = deque(maxlen=_SPAN_RING)
            ring.append(float(duration_s))
        self.histogram("repro_span_seconds",
                       "wall-clock duration of named host spans").observe(
            duration_s, span=name)
        if self._sink is not None:
            self._write({"t": time.monotonic(), "kind": "span",
                         "name": name, "dur": float(duration_s),
                         "attrs": attrs or {}})

    def span_durations(self, name: str) -> List[float]:
        """Raw recent durations (seconds) for one span name, oldest first."""
        return list(self._spans.get(name, ()))

    # -- JSONL sink ---------------------------------------------------------

    def set_jsonl(self, path: Optional[str]) -> None:
        """Attach (or with ``None`` detach) a JSONL event sink. Definition
        events for already-registered metrics are replayed into a fresh
        sink so the stream is self-describing."""
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if path is None:
            return
        self._sink = open(path, "a", buffering=1)
        self._write({"t": time.monotonic(), "kind": "meta",
                     "clock": "monotonic", "pid": os.getpid()})
        with self._lock:
            for m in self._metrics.values():
                self._def_event(m)

    def close(self) -> None:
        self.set_jsonl(None)

    def _write(self, event: dict) -> None:
        try:
            self._sink.write(json.dumps(event) + "\n")
        except ValueError:  # sink closed under us
            self._sink = None

    def _def_event(self, m: _Metric) -> None:
        if self._sink is None:
            return
        ev = {"t": time.monotonic(), "kind": "def", "mtype": m.kind,
              "name": m.name, "help": m.help}
        if isinstance(m, Histogram):
            ev["buckets"] = list(m.buckets)
        self._write(ev)

    def _event(self, kind: str, name: str,
               key: Tuple[Tuple[str, str], ...], value: float) -> None:
        if self._sink is None:
            return
        self._write({"t": time.monotonic(), "kind": kind, "name": name,
                     "labels": dict(key), "v": value})

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-friendly dump of every series."""
        out = {"counters": {}, "gauges": {}, "histograms": {}, "spans": {}}
        with self._lock:
            for m in self._metrics.values():
                if isinstance(m, Histogram):
                    out["histograms"][m.name] = {
                        "help": m.help, "buckets": list(m.buckets),
                        "series": [
                            {"labels": dict(k), "count": s.count,
                             "sum": s.sum,
                             "bucket_counts": list(s.counts)}
                            for k, s in m.series.items()]}
                else:
                    dest = out["counters"] if isinstance(m, Counter) \
                        else out["gauges"]
                    dest[m.name] = {
                        "help": m.help,
                        "series": [{"labels": dict(k), "value": v}
                                   for k, v in m.series.items()]}
            for name, ring in self._spans.items():
                ds = list(ring)
                out["spans"][name] = {
                    "count": len(ds), "total_s": sum(ds),
                    "mean_s": (sum(ds) / len(ds)) if ds else 0.0}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                if isinstance(m, Histogram):
                    for key, s in sorted(m.series.items()):
                        cum = 0
                        for b, c in zip(m.buckets, s.counts):
                            cum += c
                            lk = _prom_labels(key + (("le", f"{b:g}"),))
                            lines.append(f"{name}_bucket{lk} {cum}")
                        cum += s.counts[-1]
                        lk = _prom_labels(key + (("le", "+Inf"),))
                        lines.append(f"{name}_bucket{lk} {cum}")
                        lines.append(
                            f"{name}_sum{_prom_labels(key)} {s.sum:g}")
                        lines.append(
                            f"{name}_count{_prom_labels(key)} {s.count}")
                else:
                    for key, v in sorted(m.series.items()):
                        lines.append(f"{name}{_prom_labels(key)} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# -- process-global default registry ----------------------------------------

_default: Optional[Registry] = None
_disabled: Optional[Registry] = None
_lock = threading.Lock()


def get_registry() -> Registry:
    """The process-default registry. On first use, attaches a JSONL sink
    if ``REPRO_METRICS_JSONL`` names a path."""
    global _default
    with _lock:
        if _default is None:
            _default = Registry(
                jsonl_path=os.environ.get("REPRO_METRICS_JSONL") or None)
        return _default


def disabled_registry() -> Registry:
    """A shared always-off registry: handles exist, every record is a
    no-op. What ``metrics=False`` configs route through."""
    global _disabled
    with _lock:
        if _disabled is None:
            _disabled = Registry(enabled=False)
        return _disabled


def resolve(registry: Optional[Registry], enabled: bool = True) -> Registry:
    """The registry a component should record into: an explicit instance
    wins, else the process default, else (``enabled=False``) the no-op."""
    if registry is not None:
        return registry
    return get_registry() if enabled else disabled_registry()


# -- optional stdlib /metrics endpoint ---------------------------------------


def serve_http(registry: Registry, port: int, host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` from a
    daemon thread. Returns the ``ThreadingHTTPServer``; call
    ``.shutdown()`` to stop. ``port=0`` binds an ephemeral port
    (``server.server_address[1]`` has the real one — tests use this)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] == "/metrics":
                body = registry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path.split("?")[0] == "/metrics.json":
                body = json.dumps(registry.snapshot()).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: metrics scrapes are not news
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="repro-obs-metrics-http")
    t.start()
    return server
