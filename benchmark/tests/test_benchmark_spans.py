"""The readers of the port's spans: None with nothing recorded (no span
module loaded, as in a checkout older than the spans, or none kept), each
span's device seconds over the window's steps or views, the idle gaps that
began inside a host `render.chunk` record, and a traced run of the harness
on the CPU through the port's real spans."""

import sys
import types

import pytest

from benchmark import devtrace, harness, port_spans, spec

from test_benchmark_runs import SEED, tiny

SPAN_METRICS = {  # metric -> (traffic kind, the span it reads)
    "train.forward_device_ms": ("train", "train.forward"),
    "train.backward_device_ms": ("train", "train.backward"),
    "train.optimizer_device_ms": ("train", "train.optimizer"),
    "render.solar_device_ms": ("render", "render.solar"),
    "render.field_inputs_device_ms": ("render", "field.inputs"),
}
ALL = sorted(SPAN_METRICS) + ["render.chunk_idle_ms"]


def context(kind, units=7, trace=None):
    return harness.Context(kind, {}, {}, 30.0, units, units * 1024, trace)


@pytest.fixture
def no_span_module(monkeypatch):
    monkeypatch.delitem(sys.modules, port_spans.MODULE, raising=False)


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("kind", ["train", "render"])
def test_nothing_recorded_reads_none(name, kind, no_span_module,
                                     monkeypatch):
    read = spec.load_reader(name)
    assert read(context(kind)) is None
    assert read(context(kind, trace=devtrace.Trace(
        device=[("k", 0.0, 1.0)], window=(0.0, 2.0)))) is None
    empty = types.SimpleNamespace(totals=dict)  # loaded, nothing kept
    monkeypatch.setitem(sys.modules, port_spans.MODULE, empty)
    assert read(context(kind)) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_device_seconds_over_the_units(name, monkeypatch):
    kind, span = SPAN_METRICS[name]
    other = {"train": "render", "render": "train"}[kind]
    monkeypatch.setattr(port_spans, "totals", lambda: {
        span: {"n": 28, "device_s": 1.4, "host_s": 0.2, "parents": [None]},
        "unrelated": {"n": 1, "device_s": 9.0, "host_s": 9.0,
                      "parents": [None]}})
    read = spec.load_reader(name)
    assert read(context(kind, units=7)) == pytest.approx(200.0)
    assert read(context(kind, units=0)) is None
    assert read(context(other, units=7)) is None
    monkeypatch.setattr(port_spans, "totals", lambda: {
        span: {"n": 28, "device_s": None, "host_s": 0.2, "parents": [None]}})
    assert read(context(kind, units=7)) is None  # not timed on a device


def test_chunk_idle_counts_gaps_that_begin_inside_a_chunk():
    tr = devtrace.Trace(
        device=[("k", 0.0, 1.0), ("k", 1.5, 2.0), ("k", 2.6, 3.0)],
        host=[("render.chunk", 0.9, 1.8), ("render.chunk", 2.7, 2.9),
              ("aten::copy_", 1.9, 2.5)],
        window=(0.0, 3.2))
    # gaps (1.0, 0.5) inside the first chunk; (2.0, 0.6) and (3.0, 0.2)
    # begin outside both
    read = spec.load_reader("render.chunk_idle_ms")
    assert read(context("render", units=2, trace=tr)) == pytest.approx(250.0)
    assert read(context("render", units=0, trace=tr)) is None
    assert read(context("train", units=2, trace=tr)) is None
    tr.host = [("aten::copy_", 0.0, 3.2)]
    assert read(context("render", units=2, trace=tr)) is None


@pytest.mark.parametrize("name,read_by", [
    ("flagship.train", set()), ("flagship.render", {"render.chunk_idle_ms"})])
def test_traced_run_on_the_cpu_reads_the_port_spans(name, read_by):
    """The harness's traced window over the port's real spans: on the CPU
    no span is timed on a device, so only the trace's reader reports."""
    from spnerf_torch import spans

    spans.reset()
    out = harness.run_cell(tiny(name), SEED, 0.0, 1, "cpu")
    kind = "train" if name.endswith("train") else "render"
    kept = port_spans.totals()
    assert {s for k, s in SPAN_METRICS.values() if k == kind} - {
        "field.inputs"} <= set(kept)
    assert all(t["n"] >= out["attempted"] for t in kept.values())
    assert set(ALL) & set(out["metrics"]) == read_by
    spans.reset()
