"""repro_torch.tracing: the port's spans and counters.

Off, the program reads no tracing clock and opens no profiler range; on,
each layer's spans sit on the right thread under the right parent, the
spans of one flush group or dispatch share its number across threads, and
a driver-thread span's stamps match its ``repro_torch.*`` range in a
``torch.profiler`` trace.  The benchmark's readers of those spans, and the
frontend's admission times, are checked on tiny shapes on the CPU.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chipbench import bench                                  # noqa: E402
from chipbench.trace import TraceSummary                     # noqa: E402
from repro_torch import tracing                              # noqa: E402
from repro_torch.core.thinning import prng_key               # noqa: E402
from repro_torch.features.spec import ProfileSpec            # noqa: E402
from repro_torch.serving.frontend import VirtualClock        # noqa: E402
from repro_torch.serving.pipeline import (ScoringPipeline,  # noqa: E402
                                          init_scorer)
from repro_torch.streaming.persistence import WriteBehindSink  # noqa: E402

SPEC = ProfileSpec(windows=(60.0, 3600.0), kde_bandwidth=600.0,
                   write_budget_per_min=30.0, policy="pp")
N_KEYS = 64
MAIN = threading.current_thread().name


@pytest.fixture(autouse=True)
def _no_recording():
    tracing._rec = None
    tracing._profiled.clear()
    yield
    tracing._rec = None
    tracing._profiled.clear()


def _events(n=700, seed=0):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, N_KEYS + 1) ** 1.1
    keys = rng.choice(N_KEYS, n, p=w / w.sum()).astype(np.int32)
    ts = np.cumsum(rng.exponential(5.0, n)).astype(np.float32)
    qs = rng.lognormal(1.0, 0.5, n).astype(np.float32)
    return keys, qs, ts


def _pipe():
    pipe = ScoringPipeline.build(SPEC, N_KEYS, device="cpu")
    pipe.scorer = init_scorer(torch.Generator().manual_seed(1),
                              SPEC.feature_dim, hidden=8, device="cpu")
    return pipe


def _sink(pipe, d):
    return WriteBehindSink(pipe.engine.cfg, n_partitions=2,
                           backend="durable", store_dir=str(d),
                           device="cpu")


def _stream(pipe, d, keys, qs, ts):
    """A durable ``process_stream`` in flush groups of 2 blocks of 64."""
    sink = _sink(pipe, d)
    try:
        _, info = pipe.process_stream(pipe.init(), keys, qs, ts,
                                      rng=prng_key(3), batch_per_shard=64,
                                      sink=sink, sink_group=2)
        sink.flush()
    finally:
        sink.close()
    return sink, info


def _serve(pipe, d, keys, qs, ts, arrival):
    sink = _sink(pipe, d)
    try:
        res = pipe.serve(keys, qs, ts, arrival_s=arrival, batch=32,
                         max_wait_s=0.002, clock=VirtualClock(),
                         rng=prng_key(3), sink=sink)
        sink.flush()
    finally:
        sink.close()
    return res


def _arrivals(n, rate=20000.0, seed=1):
    return np.cumsum(np.random.default_rng(seed).exponential(1 / rate, n))


def _by(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_reads_no_clock_and_opens_no_range(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the program traced with no recording active")

    monkeypatch.setattr(tracing, "_clock", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    keys, qs, ts = _events()
    sink, info = _stream(_pipe(), tmp_path / "s", keys, qs, ts)
    assert sink.stats.rows_stored > 0 and info.z.shape[0] == keys.size
    res = _serve(_pipe(), tmp_path / "o", keys[:300], qs[:300], ts[:300],
                 _arrivals(300))
    assert sum(b.size for b in res.batches) == 300
    assert not tracing.active() and tracing.profiled() is None


def test_stream_spans_threads_parents_and_groups(tmp_path):
    keys, qs, ts = _events()
    with tracing.recording() as rec:
        sink, _ = _stream(_pipe(), tmp_path, keys, qs, ts)
    for name in ("stream.route", "stream.stage", "stream.group",
                 "stream.concat"):
        got = _by(rec, name)
        assert got and all(s.thread == MAIN and s.parent is None
                           for s in got), name
    for name, parent in (("stream.step", "stream.group"),
                         ("sink.submit", "stream.group")):
        got = _by(rec, name)
        assert got and all(s.thread == MAIN and s.parent == parent
                           for s in got), name
    flush = _by(rec, "sink.flush")
    (dispatcher,) = {s.thread for s in flush}
    assert dispatcher != MAIN and all(s.parent is None for s in flush)
    d2h = _by(rec, "sink.d2h")
    assert d2h and all(s.thread == dispatcher and s.parent == "sink.flush"
                       for s in d2h)
    puts = _by(rec, "sink.put")
    workers = {s.thread for s in puts}
    assert len(workers) == 2 and not workers & {MAIN, dispatcher}
    assert all(s.parent is None for s in puts)
    # one number a flush group, carried by its submit and on every thread
    submits = _by(rec, "sink.submit")
    groups = [s.id for s in submits]
    assert groups == list(range(len(groups)))
    for g, sub in zip(_by(rec, "stream.group"), submits):
        assert g.start_ns <= sub.start_ns <= sub.end_ns <= g.end_ns
    assert sorted(s.id for s in flush) == groups
    assert {s.id for s in puts} <= set(groups)
    submit = {s.id: s for s in _by(rec, "sink.submit")}
    assert all(s.start_ns >= submit[s.id].start_ns for s in flush + puts)
    n_blocks = -(-keys.size // 64)
    assert rec.counts == {"stream.blocks": n_blocks}
    assert len(_by(rec, "stream.group")) == len(groups) == -(-n_blocks // 2)
    assert not tracing.active()


def test_frontend_spans_follow_the_dispatches(tmp_path):
    keys, qs, ts = _events(400)
    with tracing.recording() as rec:
        res = _serve(_pipe(), tmp_path, keys, qs, ts, _arrivals(400))
    disp = _by(rec, "frontend.dispatch")
    assert [s.id for s in disp] == list(range(len(res.batches)))
    assert all(s.thread == MAIN and s.parent is None for s in disp)
    for name in ("frontend.compose", "frontend.stage", "frontend.launch",
                 "frontend.score", "frontend.materialize"):
        got = _by(rec, name)
        assert len(got) == len(res.batches), name
        assert all(s.parent == "frontend.dispatch" for s in got), name
    assert all(s.parent == "frontend.launch"
               for s in _by(rec, "sink.submit"))
    assert [s.id for s in _by(rec, "sink.submit")] == \
        sorted(s.id for s in _by(rec, "sink.flush"))
    for name in ("frontend.admit", "frontend.sleep"):
        assert _by(rec, name) and all(s.parent is None
                                      for s in _by(rec, name)), name
    lag = rec.values["frontend.admit_lag_s"]
    assert lag.size == keys.size and lag.min() >= 0


def test_stamps_lie_on_the_profilers_ranges(tmp_path):
    keys, qs, ts = _events()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.recording() as rec:
            _stream(_pipe(), tmp_path, keys, qs, ts)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            # not a user annotation: the card's timeline would mirror one
            # over the kernels it launched, and a trace count it as work
            assert not e.is_user_annotation(), e.name()
            a = int(e.start_ns())
            ranges.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (a, a + int(e.duration_ns())))
    mine = [s for s in rec.spans if s.thread == MAIN]
    assert {s.name for s in mine} >= {"stream.group", "stream.step",
                                      "sink.submit", "stream.route"}
    gaps = []
    for name in {s.name for s in mine}:
        spans = [s for s in mine if s.name == name]
        got = sorted(ranges.get(name, []))
        assert len(got) == len(spans), name
        for s, (a, b) in zip(spans, got):
            # the range opens before the stamps and closes after them;
            # the sink's threads can hold the interpreter in between, so
            # the stamps lie inside the range, give or take 50 us
            assert a - 50_000 <= s.start_ns <= s.end_ns <= b + 50_000, name
            gaps += [s.start_ns - a, b - s.end_ns]
    assert np.median(np.abs(gaps)) <= 50_000


def test_a_profiled_call_is_recorded_until_it_returns(tmp_path):
    keys, qs, ts = _events(2000)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        _stream(_pipe(), tmp_path / "a", keys, qs, ts)
        # the call that started the recording ended it
        assert not tracing.active()
        with tracing.recording() as own:
            _stream(_pipe(), tmp_path / "b", keys, qs, ts)
    assert _by(own, "stream.step")
    rec = tracing.profiled()
    assert rec is not None and not tracing.active()
    sink_threads = {s.thread for s in rec.spans
                    if s.name in ("sink.flush", "sink.put")}
    assert sink_threads and MAIN not in sink_threads
    # the first call's blocks only: the second ran under its own recording
    assert rec.counts["stream.blocks"] == own.counts["stream.blocks"]
    assert len(_by(rec, "stream.step")) == len(_by(own, "stream.step"))
    # handed over once; a call without a profiler keeps nothing
    assert tracing.profiled() is None
    _stream(_pipe(), tmp_path / "c", keys, qs, ts)
    assert tracing.profiled() is None


def test_admission_times_lie_between_arrival_and_dispatch(tmp_path):
    keys, qs, ts = _events(400)
    arrival = _arrivals(400, rate=5000.0)
    res = _serve(_pipe(), tmp_path, keys, qs, ts, arrival)
    start = 0
    for b in res.batches:
        rids = res.order[start:start + b.size]
        start += b.size
        assert np.all(res.admitted_s[rids] >= arrival[rids])
        assert np.all(res.admitted_s[rids] <= b.t_dispatch)
    assert start == keys.size


def _hand_recording():
    """Driver spans on ``main``, the flush dispatcher and two partition
    workers, dispatches, and admission lags; 1 ms units."""
    U = 1_000_000
    S = lambda name, th, a, b, parent=None, id=None: tracing.Span(
        name, th, a * U, b * U, parent, id)
    rec = tracing.Recording()
    rec.spans = sorted([
        S("stream.route", "main", 0, 10), S("stream.stage", "main", 10, 20),
        S("stream.group", "main", 20, 100, id=0),
        S("stream.step", "main", 25, 75, "stream.group"),
        S("sink.submit", "main", 80, 95, "stream.group", 0),
        S("stream.group", "main", 100, 200, id=1),
        S("stream.step", "main", 100, 150, "stream.group"),
        S("sink.submit", "main", 160, 190, "stream.group", 1),
        S("stream.concat", "main", 200, 210),
        S("sink.flush", "flush", 30, 90, id=0),
        S("sink.d2h", "flush", 30, 50, "sink.flush"),
        S("sink.flush", "flush", 160, 230, id=1),
        S("sink.d2h", "flush", 160, 170, "sink.flush"),
        S("sink.put", "store-0", 95, 120, id=0),
        S("sink.put", "store-0", 235, 260, id=1),
        S("sink.put", "store-1", 100, 110, id=0),
        S("frontend.materialize", "main", 300, 301, "frontend.dispatch"),
        S("frontend.materialize", "main", 310, 312, "frontend.dispatch"),
        S("frontend.materialize", "main", 320, 325, "frontend.dispatch"),
    ], key=lambda s: s.start_ns)
    rec.counts = {"stream.blocks": 4}
    rec.values = {"frontend.admit_lag_s": np.arange(1, 101) * 1e-3}
    return rec


READINGS = {
    "step_enqueue_ms.stream": 25.0,          # (50 + 50) ms over 4 blocks
    "driver_host_ms.stream": 27.5,           # (210 - 100) ms over 4
    "sink_busy_pct.stream": 100.0 * 80 / 210,  # the dispatcher, clipped
    "dispatch_wait_ms.online": 2.0,
    "admit_lag_ms.online": 99.01,
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_span_readers(metric):
    read = bench.reader(metric)
    view = SimpleNamespace(trace=object(), counters={},
                           tracing=_hand_recording())
    assert read(view) == pytest.approx(READINGS[metric])
    assert read(SimpleNamespace(trace=None, counters={})) is None
    assert read(SimpleNamespace(trace=object(), counters={},
                                tracing=tracing.Recording())) is None
    # a traced run of a program that recorded nothing
    assert read(SimpleNamespace(trace=object(), counters={})) is None


class _Event:
    def __init__(self, name, cuda, a, b, cid=0, link=0, tid=1):
        self.v = (name, torch.autograd.DeviceType.CUDA if cuda
                  else torch.autograd.DeviceType.CPU, a, b, cid, link, tid)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3] - self.v[2]

    def correlation_id(self):
        return self.v[4]

    def linked_correlation_id(self):
        return self.v[5]

    def start_thread_id(self):
        return self.v[6]


def test_program_ranges_leave_the_trace_readers_alone():
    """The program's ranges inside the benchmark's spans change only the
    names of the idle gaps they cover: busy time, span device time and
    the readers read the same."""
    base = [_Event("chipbench.process_stream", False, 0, 100, cid=1),
            _Event("aten::add", False, 10, 20, cid=2),
            _Event("cudaLaunchKernel", False, 12, 15, cid=900, link=2),
            _Event("add_kernel", True, 30, 40, link=2),
            _Event("thinning_rmw_kernel<true>", True, 60, 70, link=2),
            _Event("chipbench.score", False, 100, 200, cid=3),
            _Event("aten::mm", False, 110, 150, cid=4),
            _Event("gemm", True, 150, 170, link=4)]
    ours = [_Event("repro_torch.stream.group", False, 5, 90, cid=10),
            _Event("repro_torch.stream.step", False, 8, 25, cid=11)]
    a, b = TraceSummary(base, 0, 200), TraceSummary(base + ours, 0, 200)
    assert (a.busy_s, a.window_s) == (b.busy_s, b.window_s)
    for name in ("process_stream", "score"):
        assert a.span_device_seconds(name) == b.span_device_seconds(name)
    counters = {"traced_blocks": 2, "window_s": 1.0,
                "sink_submit_wait_s": 0.25}
    for metric in ("step_device_ms.stream", "sink_wait_pct.stream"):
        read = bench.reader(metric)
        assert read(SimpleNamespace(trace=a, counters=counters)) == \
            read(SimpleNamespace(trace=b, counters=counters))
    # the gap from 40 to 60 is named after the program's group, not the
    # benchmark's call around it
    assert dict(a.idle_by_host)["chipbench.process_stream"] == \
        pytest.approx(20e-9)
    named = dict(b.idle_by_host)
    assert named["repro_torch.stream.group"] == pytest.approx(20e-9)
    assert "chipbench.process_stream" not in named
