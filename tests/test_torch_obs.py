"""The port's obs registry (``repro_torch.obs``) against the JAX package's
(``repro.obs``), on the CPU.

The port's versions of ``tests/test_obs.py``'s registry, span, JSONL,
dump-CLI and HTTP tests; then parity: the same calls on both registries
give equal Prometheus text and equal snapshots, and a JSONL stream written
by either replays through the other's ``dump.replay``. The span of a
``Trainer`` step reaches the registry and a captured profile, and a trainer
with ``metrics=False`` records nothing. Everything here is exact: the
registries hold Python floats and ints.
"""
import glob
import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from repro.obs import dump as jdump
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.data import BigramLM
from repro_torch.nn.common import ModelConfig
from repro_torch.nn.model import LM
from repro_torch.obs import dump, metrics, trace
from repro_torch.obs.metrics import CardinalityError, Registry
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small CPU steps run up
    to a hundred times slower in torch's thread pool when the test workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# registry semantics (the port's versions of tests/test_obs.py's)
# ---------------------------------------------------------------------------


def test_counter_and_gauge_basics():
    reg = Registry()
    c = reg.counter("c_total", "help text")
    c.inc()
    c.inc(2.5, phase="prefill")
    assert c.value() == 1.0
    assert c.value(phase="prefill") == 2.5
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = reg.gauge("g")
    g.set(3.0)
    g.set_max(1.0)
    assert g.value() == 3.0
    g.set_max(7.0)
    assert g.value() == 7.0
    assert reg.counter("c_total") is c
    with pytest.raises(ValueError):
        reg.gauge("c_total")


def test_disabled_registry_is_noop():
    reg = Registry(enabled=False)
    c = reg.counter("c")
    c.inc(5)
    reg.gauge("g").set(1)
    reg.histogram("h").observe(0.1)
    reg.record_span("s", 0.5)
    assert c.value() == 0.0
    assert reg.snapshot()["counters"]["c"]["series"] == []
    assert reg.span_durations("s") == []


def test_label_cardinality_budget():
    reg = Registry(max_series=4)
    c = reg.counter("c")
    for i in range(4):
        c.inc(series=i)
    with pytest.raises(CardinalityError):
        c.inc(series="one-too-many")
    c.inc(series=0)
    assert c.value(series=0) == 2.0


def test_histogram_buckets_exact():
    reg = Registry()
    h = reg.histogram("h", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 2.0, 100.0):
        h.observe(v)
    s = reg.snapshot()["histograms"]["h"]["series"][0]
    assert s["bucket_counts"] == [2, 1, 1, 1]
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(102.65)
    assert h.stats() == (5, pytest.approx(102.65))


def test_prometheus_text_golden():
    reg = Registry()
    reg.counter("req_total", "requests").inc(3, kind="a")
    reg.gauge("depth").set(2)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    assert reg.prometheus_text() == (
        '# TYPE depth gauge\n'
        'depth 2\n'
        '# HELP lat_seconds latency\n'
        '# TYPE lat_seconds histogram\n'
        'lat_seconds_bucket{le="0.1"} 1\n'
        'lat_seconds_bucket{le="1"} 2\n'
        'lat_seconds_bucket{le="+Inf"} 3\n'
        'lat_seconds_sum 5.55\n'
        'lat_seconds_count 3\n'
        '# HELP req_total requests\n'
        '# TYPE req_total counter\n'
        'req_total{kind="a"} 3\n')


def test_span_recording():
    reg = Registry()
    with trace.span("phase/x", registry=reg, n=3):
        pass
    ds = reg.span_durations("phase/x")
    assert len(ds) == 1 and ds[0] >= 0.0
    cnt, _ = reg.histogram("repro_span_seconds").stats(span="phase/x")
    assert cnt == 1


def test_jsonl_replay_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    reg = Registry(jsonl_path=path)
    reg.counter("tok_total", "tokens").inc(7, phase="decode")
    reg.gauge("occ").set(0.5)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.7)
    with trace.span("bench/x", registry=reg):
        pass
    reg.close()
    replayed = dump.replay(path)
    a, b = reg.snapshot(), replayed.snapshot()
    for k in ("counters", "gauges", "histograms"):
        assert a[k] == b[k], k
    assert replayed.span_durations("bench/x") == \
        reg.span_durations("bench/x")
    assert reg.prometheus_text() == replayed.prometheus_text()


def test_dump_cli(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    reg = Registry(jsonl_path=path)
    reg.counter("c").inc(2)
    reg.close()
    assert dump.main(["--input", path, "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["counters"]["c"]["series"][0]["value"] == 2.0
    outfile = str(tmp_path / "m.prom")
    assert dump.main(["--input", path, "--format", "prom",
                      "-o", outfile]) == 0
    assert "c 2" in open(outfile).read()
    assert dump.main(["--input", path]) == 0
    assert "counter   c = 2" in capsys.readouterr().out


def test_metrics_http_endpoint():
    reg = Registry()
    reg.counter("c_total").inc(4)
    server = metrics.serve_http(reg, port=0)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "c_total 4" in body
        j = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=5).read())
        assert j["counters"]["c_total"]["series"][0]["value"] == 4.0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/nope", timeout=5)
    finally:
        server.shutdown()


def test_timed_call_reads_registry_spans():
    reg = Registry()
    x = torch.ones(8)
    us = trace.timed_call(lambda t: t * 2, x, iters=3, warmup=1,
                          name="mul", registry=reg)
    assert us > 0
    assert len(reg.span_durations("bench/mul")) == 3
    cnt, _ = reg.histogram("repro_span_seconds").stats(span="bench/mul")
    assert cnt == 3


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _drive(mod_metrics, span_fn):
    """One sequence of counter, gauge, histogram and span calls."""
    reg = mod_metrics.Registry()
    c = reg.counter("req_total", "requests")
    c.inc()
    c.inc(2.5, kind="a")
    c.inc(4, kind="b")
    g = reg.gauge("depth", "queue depth")
    g.set(3)
    g.set_max(1.5, pool="x")
    g.set_max(9.25, pool="x")
    h = reg.histogram("lat_seconds", "latency")      # default buckets
    for v in (0.0001, 0.003, 0.04, 0.7, 12.0, 45.0):
        h.observe(v, phase="decode")
    h2 = reg.histogram("size", buckets=(1, 10, 100))
    for v in (0.5, 10, 11, 1e6):
        h2.observe(v)
    reg.record_span("train/step", 0.125, {"n": 1})
    reg.record_span("train/step", 0.25)
    with span_fn("phase/y", registry=reg):
        pass
    return reg


def _strip_span_times(snap):
    """The span sections without their measured durations: the
    ``phase/y`` span's duration is a measured time."""
    out = json.loads(json.dumps(snap))
    for s in out["histograms"]["repro_span_seconds"]["series"]:
        if s["labels"] == {"span": "phase/y"}:
            s["sum"], s["bucket_counts"] = None, None
    out["spans"]["phase/y"] = out["spans"]["phase/y"]["count"]
    return out


def test_prometheus_and_snapshot_equal_the_reference():
    got = _drive(metrics, trace.span)
    want = _drive(jmetrics, jtrace.span)
    assert _strip_span_times(got.snapshot()) == \
        _strip_span_times(want.snapshot())
    drop = "phase/y"

    def prom(reg):
        return "\n".join(ln for ln in reg.prometheus_text().splitlines()
                         if drop not in ln)

    assert prom(got) == prom(want)
    assert got.prometheus_text().count("phase/y") == \
        want.prometheus_text().count("phase/y")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_jsonl_streams_replay_through_either_dump(tmp_path, writer):
    path = str(tmp_path / f"{writer}.jsonl")
    mod, span_fn = (jmetrics, jtrace.span) if writer == "jax" \
        else (metrics, trace.span)
    reg = _drive(mod, span_fn)
    reg.set_jsonl(path)    # the definitions of what is registered first
    reg.counter("late_total", "after the sink").inc(5, kind="z")
    reg.histogram("lat_seconds").observe(0.2, phase="prefill")
    with span_fn("bench/z", registry=reg):
        pass
    reg.close()
    a, b = jdump.replay(path), dump.replay(path)
    assert a.prometheus_text() == b.prometheus_text()
    assert a.snapshot() == b.snapshot()
    assert b.counter("late_total").value(kind="z") == 5.0
    assert b.span_durations("bench/z") == reg.span_durations("bench/z")
    assert jdump.render_text(a) == dump.render_text(b)


# ---------------------------------------------------------------------------
# the trainer's recording
# ---------------------------------------------------------------------------


def _tiny_model():
    cfg = ModelConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                      d_ff=64, vocab_size=64, loss_chunk=16,
                      dtype="float32", remat=False)
    return LM(cfg, device="cpu",
              generator=torch.Generator().manual_seed(0)), cfg


def test_trainer_records_steps_spans_and_profile(tmp_path):
    reg = Registry()
    model, cfg = _tiny_model()
    prof = str(tmp_path / "prof")
    tr = Trainer(model, TrainerConfig(opt=AdamWConfig(lr=1e-3), log_every=1,
                                      profile_dir=prof),
                 device="cpu", registry=reg)
    data = BigramLM(vocab_size=cfg.vocab_size, seed=0)
    _, _, hist = tr.fit(data.iterate(2, 16), 2, on_step=lambda s, m: None)
    assert reg.counter("train_steps_total").value() == 2.0
    assert reg.counter("train_tokens_total").value() == 64.0
    assert reg.histogram("train_step_seconds").stats()[0] == 2
    assert reg.gauge("train_loss").value() == hist[-1]["loss"]
    assert reg.gauge("train_microbatches").value() == 1.0
    assert len(reg.span_durations("train/step")) == 2
    traces = glob.glob(os.path.join(prof, "trace_*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert sum(e.get("name") == "train/step" for e in events) == 2


def test_trainer_with_metrics_off_records_nothing():
    model, cfg = _tiny_model()
    default = metrics.get_registry()
    before = default.snapshot()
    tr = Trainer(model, TrainerConfig(opt=AdamWConfig(lr=1e-3), log_every=1,
                                      metrics=False), device="cpu")
    assert not tr.obs.enabled
    data = BigramLM(vocab_size=cfg.vocab_size, seed=0)
    tr.fit(data.iterate(2, 16), 2, on_step=lambda s, m: None)
    assert default.snapshot() == before
    snap = tr.obs.snapshot()
    assert all(not m["series"] for kind in ("counters", "gauges",
                                            "histograms")
               for m in snap[kind].values())
    assert snap["spans"] == {}
