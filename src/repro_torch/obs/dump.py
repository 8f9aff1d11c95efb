"""``python -m repro_torch.obs.dump`` — render a metrics stream or live
registry (port of ``repro.obs.dump``).

The JSONL event stream a :class:`repro_torch.obs.metrics.Registry` writes is
self-describing (``def`` events carry metric kinds and histogram buckets)
and replayable: this CLI reconstructs the registry another process
recorded and renders it as human text, JSON, or Prometheus exposition
format — the same exporters the live ``/metrics`` endpoint uses, so the
offline artifact and the online scrape can never disagree.

    python -m repro_torch.obs.dump --input metrics.jsonl --format prom
    python -m repro_torch.obs.dump --input metrics.jsonl --format json \\
        -o out.json

Without ``--input`` the path is taken from ``REPRO_METRICS_JSONL``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import deque
from typing import Optional

from .metrics import DEFAULT_BUCKETS, Registry


def replay(path: str) -> Registry:
    """Reconstruct a registry from a JSONL event stream."""
    reg = Registry()
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            kind = ev.get("kind")
            name = ev.get("name", "")
            labels = ev.get("labels", {})
            if kind == "def":
                if ev["mtype"] == "counter":
                    reg.counter(name, ev.get("help", ""))
                elif ev["mtype"] == "gauge":
                    reg.gauge(name, ev.get("help", ""))
                elif ev["mtype"] == "histogram":
                    reg.histogram(name, ev.get("help", ""),
                                  buckets=ev.get("buckets",
                                                 DEFAULT_BUCKETS))
            elif kind == "counter":
                reg.counter(name).inc(ev["v"], **labels)
            elif kind == "gauge":
                reg.gauge(name).set(ev["v"], **labels)
            elif kind == "hist":
                reg.histogram(name).observe(ev["v"], **labels)
            elif kind == "span":
                # bypass record_span: the hist/span events were ALSO
                # written by the recorder, so only refill the raw ring
                ring = reg._spans.setdefault(name, deque(maxlen=1024))
                ring.append(float(ev["dur"]))
            # "meta" lines are informational
    return reg


def render_text(reg: Registry) -> str:
    """Human-readable summary: one line per series."""
    snap = reg.snapshot()
    lines = []
    for kind in ("counters", "gauges"):
        for name, m in sorted(snap[kind].items()):
            for s in m["series"]:
                lab = ",".join(f"{k}={v}" for k, v in
                               sorted(s["labels"].items()))
                lines.append(f"{kind[:-1]:9s} {name}"
                             f"{'{' + lab + '}' if lab else ''} "
                             f"= {s['value']:g}")
    for name, m in sorted(snap["histograms"].items()):
        for s in m["series"]:
            lab = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
            mean = s["sum"] / s["count"] if s["count"] else 0.0
            lines.append(f"histogram {name}"
                         f"{'{' + lab + '}' if lab else ''} "
                         f"count={s['count']} sum={s['sum']:g} "
                         f"mean={mean:g}")
    for name, s in sorted(snap["spans"].items()):
        lines.append(f"span      {name} count={s['count']} "
                     f"total_s={s['total_s']:g} mean_s={s['mean_s']:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.dump",
        description="render an obs JSONL metrics stream")
    ap.add_argument("--input", default=None,
                    help="JSONL stream (default: $REPRO_METRICS_JSONL)")
    ap.add_argument("--format", choices=("text", "json", "prom"),
                    default="text")
    ap.add_argument("--output", "-o", default="-",
                    help="output file ('-' = stdout)")
    args = ap.parse_args(argv)
    path = args.input or os.environ.get("REPRO_METRICS_JSONL")
    if not path:
        ap.error("no --input and REPRO_METRICS_JSONL is unset")
    if not os.path.exists(path):
        ap.error(f"metrics stream not found: {path}")
    reg = replay(path)
    if args.format == "prom":
        out = reg.prometheus_text()
    elif args.format == "json":
        out = json.dumps(reg.snapshot(), indent=2) + "\n"
    else:
        out = render_text(reg)
    if args.output == "-":
        sys.stdout.write(out)
    else:
        with open(args.output, "w") as fh:
            fh.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
