"""CPU tests of the readers that charge the device's idle time to the
program's spans (``metrics/_spans.py``), on hand-built event lists."""

import pytest

from portbench import harness, trace
from portbench.metrics import _spans

# each cell's readers, which split its idle time among them
TRAIN = ("modes_idle_ms.train", "lookup_idle_ms.train",
         "upload_idle_ms.train", "replay_idle_ms.train",
         "loop_idle_ms.train", "untraced_idle_ms.train")
SERVE = ("plan_idle_ms.serve", "fill_idle_ms.serve", "lookup_idle_ms.serve",
         "replay_idle_ms.serve", "readback_idle_ms.serve",
         "request_idle_ms.serve", "untraced_idle_ms.serve")


def ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "tid": tid}


def kernel(ts, dur):
    return ev("kernel", "void k(x)", ts, dur)


def span(name, ts, dur, tid=1):
    return ev("cpu_op", name, ts, dur, tid)


def train_step(t0):
    """One step of 100 us from ``t0``: the device runs the previous
    replay until t0 + 10 and the batch's copy at t0 + 10..15; idle until
    the replay starts at t0 + 60.  In that gap: 5 us of upload, 5 of the
    step span alone, 20 of modes, 10 of lookup, 5 of replay."""
    return [kernel(t0, 10),
            ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t0 + 10, 5),
            span("fhpe.train.step", t0, 95),
            span("fhpe.train.upload", t0, 20),
            span("fhpe.train.modes", t0 + 25, 20),
            span("fhpe.graph.lookup", t0 + 45, 10),
            span("fhpe.graph.replay", t0 + 55, 30),
            kernel(t0 + 60, 40),
            span("fhpe.train.meters", t0 + 85, 10)]


def test_innermost_span_takes_each_instant():
    events = [kernel(0, 10), kernel(100, 10),
              span("fhpe.train.step", 0, 110),
              span("fhpe.graph.lookup", 20, 60),
              span("fhpe.graph.replay", 40, 10)]    # inside lookup
    charged = _spans.idle_by_span(events, _spans.TRAIN_ROOT)
    us = {k: v * 1e3 for k, v in charged.items()}
    assert us["fhpe.train.step"] == pytest.approx(10 + 20)  # 10-20, 80-100
    assert us["fhpe.graph.lookup"] == pytest.approx(50)     # 20-40, 50-80
    assert us["fhpe.graph.replay"] == pytest.approx(10)
    assert us[_spans.UNTRACED] == 0.0


def test_charges_partition_the_idle_between_device_ops():
    events = [e for t0 in (0, 100, 200) for e in train_step(t0)]
    events.append(kernel(300, 5))                           # the next step
    charged = _spans.idle_by_span(events, _spans.TRAIN_ROOT)
    spans = trace.intervals(events)
    idle_us = sum(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    assert sum(charged.values()) * 3 * 1e3 == pytest.approx(idle_us)
    assert trace.idle_gaps(events)[0][0] == "fhpe.train.modes"
    # per step: the 45 us from the copy's end to the replay's start
    us = {k: v * 1e3 for k, v in charged.items()}
    assert us == pytest.approx({
        "fhpe.train.upload": 5, "fhpe.train.modes": 20,
        "fhpe.graph.lookup": 10, "fhpe.graph.replay": 5,
        "fhpe.train.step": 5, _spans.UNTRACED: 0})
    r = {"events": events, "window_s": 1e-3}
    got = [harness.reader(m)(r) for m in TRAIN]
    assert got == pytest.approx([0.020, 0.010, 0.005, 0.005, 0.005, 0.0])
    assert sum(got) * 3 * 1e3 == pytest.approx(idle_us)


def test_untraced_time_and_per_root_normalisation():
    """Two requests, each with 30 us of idle under its plan, 10 under its
    wait for the fill, and 10 after it ends with no span open; each charge
    is divided by the two requests."""
    events = []
    for t0 in (0, 100):
        events += [kernel(t0, 10),
                   span("fhpe.serve.request", t0 + 10, 80),
                   span("fhpe.serve.plan", t0 + 10, 30),
                   span("fhpe.serve.wait_fill", t0 + 40, 10),
                   kernel(t0 + 50, 40)]
    events.append(kernel(200, 10))
    r = {"events": events, "window_s": 1e-3}
    got = [harness.reader(m)(r) for m in SERVE]
    # 90-100 and 190-200 lie between requests: 20 us over 2 requests
    assert got == pytest.approx([0.030, 0.010, 0, 0, 0, 0, 0.010])
    # a stretch that starts idle: the first request's planning, before
    # the first device op, is charged too
    r["events"] = events[1:]
    assert [harness.reader(m)(r) for m in SERVE] == pytest.approx(got)


def test_spans_on_another_thread_take_no_idle():
    events = train_step(0) + [kernel(100, 5),
                              span("fhpe.train.modes", 0, 100, tid=7),
                              span("fhpe.serve.plan", 15, 45, tid=7)]
    mine = _spans.idle_by_span(train_step(0) + [kernel(100, 5)],
                               _spans.TRAIN_ROOT)
    assert _spans.idle_by_span(events, _spans.TRAIN_ROOT) == \
        pytest.approx(mine)
    assert "fhpe.serve.plan" not in _spans.idle_by_span(
        events, _spans.TRAIN_ROOT)


def test_none_without_a_root_span():
    """A program without the spans (or a stretch with no step in it)
    reports nothing; one whose spans took no idle reports 0."""
    bare = [kernel(0, 10), kernel(50, 10),
            ev("cpu_op", "aten::copy_", 10, 40)]
    r = {"events": bare, "window_s": 1e-3}
    assert all(harness.reader(m)(r) is None for m in TRAIN + SERVE)
    busy = [kernel(0, 100), span("fhpe.train.step", 0, 100),
            span("fhpe.train.modes", 10, 5)]
    assert harness.reader("modes_idle_ms.train")(
        {"events": busy, "window_s": 1e-3}) == 0.0
    # a device-side event of an fhpe. name is device work, not a span
    dev = [kernel(0, 10), ev("kernel", "fhpe.train.step", 20, 10),
           kernel(40, 10)]
    assert _spans.idle_by_span(dev, _spans.TRAIN_ROOT) is None
