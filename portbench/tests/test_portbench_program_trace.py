"""The five readers of the program's own spans and counters
(``portbench/program_trace.py`` and ``metrics/launches.py``,
``launch_host_us.py``, ``filter_idle_s.py``, ``h2d_gib.py``,
``cheb_steps.py``): synthetic spans, device intervals and a clock offset
with answers worked out by hand, including idle stretches that straddle a
span's edge; and a traced harness run on the CPU, where no device trace
exists and every reader returns None."""
import time

import pytest

from portbench import harness, program_trace
from portbench.tests.conftest import ROOT
from portbench.tracing import load_file

from feastkit_tpu_torch.utils import trace as program

READERS = ["launches", "launch_host_us", "filter_idle_s", "h2d_gib",
           "cheb_steps"]
MS = 10 ** 6          # the synthetic times are in ms, the clocks in ns
OFFSET = 7 * MS       # the host clock runs 7 ms behind the trace's


def _reader(name):
    return load_file(ROOT / "portbench" / "metrics" / f"{name}.py",
                     f"portbench_metric_{name}")


def _span(index, name, start, end, parent, solve, **attrs):
    s = program.Span(name, dict(launches=0, launch_host_ns=0, h2d_bytes=0))
    s.index, s.parent, s.solve = index, parent, solve
    s.start_ns, s.end_ns = start * MS - OFFSET, end * MS - OFFSET
    s.attrs.update(attrs)
    return s


def _solve(base, solve, t0):
    """One solve's spans from t0 ms (indices from ``base``): feast
    [0, 100] with route [0, 30], q0 [30, 40], a loop [40, 90] holding a
    filter [40, 80] of 10 steps on f32 (30 launches, 20 host ns each) and
    rr [80, 88], verify [90, 98] holding a filter [90, 97] of 5 steps on
    f64 (10 launches, 90 host ns each: a full queue's wait, left out of
    ``launch_host_us``), and result [98, 100]."""
    rows = [("feast", 0, 100, None, dict(launches=50, launch_host_ns=1000,
                                         h2d_bytes=2 ** 30)),
            ("route", 0, 30, 0, {}), ("q0", 30, 40, 0, {}),
            ("loop", 40, 90, 0, {}),
            ("filter", 40, 80, 3, dict(steps=10, rung="f32", launches=30,
                                       launch_host_ns=600)),
            ("rr", 80, 88, 3, {}), ("verify", 90, 98, 0, {}),
            ("filter", 90, 97, 6, dict(steps=5, rung="f64", launches=10,
                                       launch_host_ns=900)),
            ("result", 98, 100, 0, {})]
    return [_span(base + i, name, t0 + s, t0 + e,
                  None if up is None else base + up, solve, **attrs)
            for i, (name, s, e, up, attrs) in enumerate(rows)]


# the device is busy over these stretches of each solve (ms from its
# start); idle: [0, 5] and [20, 30] in route, [30, 35] in q0 (the stretch
# [20, 35] straddles route's end), [45, 50] and [70, 80] in the first
# filter, [80, 85] in rr (the stretch [70, 85] straddles the filter's
# end), [95, 97] in the second filter, [97, 98] in verify, [98, 100] in
# result: 45 ms, of which 17 ms in the filters
BUSY = [(5, 20), (35, 45), (50, 70), (85, 95)]


def _ctx(solves=2):
    """The program's spans and a run's context: the warm-up solve, then
    ``solves`` solves 200 ms apart, the card idle between them."""
    spans, device, windows = _solve(0, 0, 0), [], []
    for k in range(solves):
        t0 = 1000 + 200 * k
        spans += _solve(len(spans), k + 1, t0)
        device += [((t0 + s) * MS, (t0 + e) * MS) for s, e in BUSY]
        windows.append(("solve", (t0 - 1) * MS, (t0 + 101) * MS))
    trace = dict(spans=windows, device=[("k", s, e, "kernel", None)
                                        for s, e in device],
                 offset_ns=OFFSET, window_s=0.2 * solves,
                 busy_s=0.055 * solves)
    return spans, dict(trace=trace, window=dict(records=[{}] * solves))


@pytest.fixture
def fake_program(monkeypatch):
    class Stub:
        def __init__(self):
            self.recorded = []

        def spans(self):
            return list(self.recorded)
    stub = Stub()
    monkeypatch.setattr(program_trace, "program", stub)
    return stub


@pytest.mark.parametrize("name,want", [
    ("launches", 50.0), ("launch_host_us", 600 / 30 * 1e-3),
    ("filter_idle_s", 17e-3), ("h2d_gib", 1.0), ("cheb_steps", 15.0)])
def test_readers_on_synthetic_spans(fake_program, name, want):
    fake_program.recorded, ctx = _ctx()
    assert _reader(name).read(ctx) == pytest.approx(want, rel=1e-12)


def test_idle_split_across_span_edges(fake_program, capsys):
    fake_program.recorded, ctx = _ctx(solves=3)
    run = program_trace.read(ctx)
    assert run["solves"] == 3 and run["cover"] == [1.0] * 3
    ms = {k: v * 1e3 for k, v in run["idle_by_span"].items()}
    assert ms == pytest.approx(dict(feast=0.0, route=15.0, q0=5.0, loop=0.0,
                                    filter=17.0, rr=5.0, verify=1.0,
                                    result=2.0))
    assert run["idle_in_spans_s"] == pytest.approx(3 * 45e-3)
    # the line on stderr, printed once
    err = capsys.readouterr().err
    assert err.count("program spans: 3 solves read") == 1
    assert "most idle, s a solve: filter 0.017000, route 0.015000" in err
    program_trace.read(ctx)
    assert "program spans" not in capsys.readouterr().err


def test_children_that_leave_part_of_a_solve_uncovered(fake_program):
    spans, ctx = _ctx(solves=1)
    # drop the result span: its 2 ms, all idle, fall to the feast span
    fake_program.recorded = [s for s in spans
                             if not (s.name == "result" and s.solve == 1)]
    run = program_trace.read(ctx)
    assert run["cover"] == [pytest.approx(0.98)]
    assert run["idle_by_span"]["feast"] == pytest.approx(2e-3)
    assert "result" not in run["idle_by_span"]


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_spans_or_trace(fake_program, name,
                                                    monkeypatch):
    _, ctx = _ctx()
    assert _reader(name).read(ctx) is None       # no program solve
    assert _reader(name).read({"window": ctx["window"]}) is None
    monkeypatch.setattr(program_trace, "program", None)   # an older program
    assert _reader(name).read(_ctx()[1]) is None


def test_traced_cpu_run_reads_none(tiny_root):
    bench = harness.json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, "cmass_tiny.fresh")
    rows = harness.cell_metrics(bench, cell, True)
    assert set(READERS) <= {m["name"] for m in rows}
    try:
        r = harness.run(tiny_root, "cmass_tiny.fresh", 2 ** 33 + 5, 0.5,
                        True, device="cpu", t_start=time.perf_counter())
    finally:
        program.disable()
        program.clear()
    assert r["correct"] is True
    assert not set(READERS) & set(r["metrics"])
