"""The port's spans and counters (``feastkit_tpu_torch/utils/trace.py``) on
the sparse polynomial path, on the CPU.

Two small pencils through ``feast`` on the auto route with the f32 -> f64
ladder forced (fpm[42] = 2): a five-point Laplacian with a potential on a
32 x 32 grid (B = I) and the P1 consistent-mass pencil of the same grid
(the SPD-B composite). With tracing off nothing is recorded; with it on a
solve gives the span tree of the sparse polynomial path under one solve
id, the filter spans' rung and A-products equal to what the benchmark's
schedule (``portbench/schedule.py``) records of the same applications,
the same results to the bit, nothing but plain values behind the spans,
and no bytes to a card. The card's byte count is in test_torch_cuda.py.
A third operator, the complex Harper-Hofstadter cylinder of the
benchmark's ``herm_p9`` cell on 24 x 24 sites, runs the unfused complex
recurrence: its filter spans say so (``body``) and count its torch passes
(``glue_passes``, four a step), which the fused bodies of the other two
never run.
"""
import functools
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.utils import trace  # noqa: E402

CASES = ["lap2d", "cmass"]
# with the Hermitian operator, for what holds on every filter body
BODIES = {"lap2d": "fused", "cmass": "fused_gen", "herm": "unfused"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _problem(case):
    """(A, B, Emax, M0): the pencil, an upper edge in a spectral gap past
    the ten lowest pairs, and the subspace."""
    if case == "herm":
        from portbench.generators import hofstadter_cyl
        A = hofstadter_cyl.operator(0.01 * np.cos(np.arange(24)), 1 / 64, 24)
        w = np.linalg.eigvalsh(A.toarray())
        gaps = np.nonzero(np.diff(w) > 1e-6 * w[-1])[0]
        hi = gaps[np.searchsorted(gaps, 9)]
        return A, None, float(0.5 * (w[hi] + w[hi + 1])), hi + 7
    nx = 32
    h = 1.0 / (nx + 1)
    T = sp.diags([-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    v = 0.05 * np.cos(np.arange(nx))
    if case == "lap2d":
        A = (sp.kron(sp.eye(nx), T + sp.diags(v))
             + sp.kron(T + sp.diags(v[::-1]), sp.eye(nx))).tocsr()
        B = None
        w = np.linalg.eigvalsh(A.toarray())
    else:
        D = T / h
        Mx = sp.diags([h / 6 * np.ones(nx - 1), 4 * h / 6 * np.ones(nx),
                       h / 6 * np.ones(nx - 1)], [-1, 0, 1])
        A = (sp.kron(D, Mx) + sp.kron(Mx, D)).tocsr()
        B = sp.kron(Mx, Mx).tocsr()
        import scipy.linalg as sla
        w = sla.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    gaps = np.nonzero(np.diff(w) > 1e-6 * w[-1])[0]
    hi = gaps[np.searchsorted(gaps, 9)]
    return A, B, float(0.5 * (w[hi] + w[hi + 1])), hi + 7


def _solve(case):
    A, B, Emax, M0 = _problem(case)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[42] = 2
    return ft.feast(A, B, (0.0, Emax), M0, fpm, device="cpu")


@functools.lru_cache(maxsize=None)
def _traced(case):
    """The solve with tracing off (what it recorded and how far the byte
    and launch-time counters moved), then on (its spans, and the filter
    applications the benchmark's schedule recorded of it)."""
    from portbench.schedule import Schedule
    before = trace.counters()
    off = _solve(case)
    after = trace.counters()
    off_record = (trace.spans(), after["h2d_bytes"] - before["h2d_bytes"],
                  after["launch_host_ns"] - before["launch_host_ns"])
    trace.enable()
    schedule = Schedule()
    schedule.install()
    try:
        on = _solve(case)
    finally:
        schedule.restore()
        trace.disable()
    spans = trace.spans()
    trace.clear()
    return off, off_record, on, spans, schedule


def _dicts(case):
    return [s.as_dict() for s in _traced(case)[3]]


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent]


@pytest.mark.parametrize("case", list(BODIES))
def test_off_records_nothing(case):
    off, (recorded, h2d, launch_ns), _, _, _ = _traced(case)
    assert off.M > 0
    assert recorded == [] and h2d == 0 and launch_ns == 0
    assert trace.span("feast", N=1) is trace.OFF
    with trace.span("route") as s:
        s.set(degree=3)
    assert trace.spans() == []


@pytest.mark.parametrize("case", CASES)
def test_span_tree(case):
    spans = _dicts(case)
    A, B, _, M0 = _problem(case)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["feast"]
    feast = roots[0]
    assert feast["attrs"]["path"] == "cheb"
    assert feast["attrs"]["N"] == A.shape[0] and feast["attrs"]["M0"] == M0
    assert {s["solve"] for s in spans} == {feast["solve"]}
    assert [s["index"] for s in spans] == list(range(len(spans)))
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    top = [s["name"] for s in _children(spans, feast["index"])]
    assert top[:3] == ["route.band", "route", "q0"]
    assert top[-2:] == ["verify", "result"]
    loops = _children(spans, feast["index"])[3:-2]
    assert {s["name"] for s in loops} == {"loop"} and len(loops) >= 2
    assert [s["attrs"]["index"] for s in loops] == list(range(len(loops)))
    assert loops[0]["attrs"]["rung"] == "f32"
    assert loops[-1]["attrs"]["rung"] == "f64"
    for loop in loops:
        assert [s["name"] for s in _children(spans, loop["index"])] == [
            "filter", "rr", "fetch"]
    route = spans[top.index("route") + feast["index"] + 1]
    assert route["name"] == "route"
    assert route["attrs"]["b_kind"] == ("identity" if B is None else "spd")
    assert route["attrs"]["filter"] in ("rational", "indicator")
    assert route["attrs"]["degree"] > 0
    stages = _children(spans, route["index"])
    names = [s["name"] for s in stages]
    assert set(names) == {"route.coo", "route.dia", "route.bounds",
                          "route.coeffs", "route.upload"}
    coeffs = {s["attrs"]["which"] for s in stages
              if s["name"] == "route.coeffs"}
    assert {"rational", "indicator"} <= coeffs
    if B is not None:
        assert {"inverse", "inverse_lo"} <= coeffs
        assert {s["attrs"]["of"] for s in stages
                if s["name"] == "route.bounds"} == {"B", "pencil"}
    q0 = _children(spans, feast["index"])[2]
    assert [s["name"] for s in _children(spans, q0["index"])] == ["q0.upload"]
    verify = _children(spans, feast["index"])[-2]
    assert [s["name"] for s in _children(spans, verify["index"])] == [
        "filter"]
    result = _children(spans, feast["index"])[-1]
    assert "fetch" in [s["name"] for s in _children(spans, result["index"])]


@pytest.mark.parametrize("case", CASES)
def test_filter_spans_follow_the_schedule(case):
    spans, schedule = _dicts(case), _traced(case)[4]
    gen = case == "cmass"
    apps = schedule.applications[gen]
    assert not schedule.applications[not gen]
    filters = [s for s in spans if s["name"] == "filter"]
    assert [(s["attrs"]["rung"], s["attrs"]["steps"]) for s in filters] == [
        (rung, n - 1) for rung, n in apps]
    _, _, _, M0 = _problem(case)
    for s in filters:
        assert s["attrs"]["columns"] == M0
        assert s["attrs"]["inner"] == (schedule.qlen[s["attrs"]["rung"]]
                                       if gen else 0)


@pytest.mark.parametrize("case", list(BODIES))
def test_results_bitwise_identical(case):
    off, _, on, _, _ = _traced(case)
    assert (off.M, int(off.info), off.loop) == (on.M, int(on.info), on.loop)
    assert off.epsout == on.epsout
    assert np.array_equal(np.asarray(off.lam), np.asarray(on.lam))
    assert np.array_equal(np.asarray(off.res), np.asarray(on.res))
    assert torch.equal(off.q, on.q)


@pytest.mark.parametrize("case", list(BODIES))
def test_no_tensor_behind_the_spans(case):
    held = _traced(case)[3]
    gc.collect()
    assert held
    seen, todo = set(), [held]
    while todo:
        obj = todo.pop()
        if id(obj) in seen or isinstance(obj, type):
            continue
        seen.add(id(obj))
        assert not isinstance(obj, (torch.Tensor, np.ndarray)), obj
        if isinstance(obj, (list, dict, tuple, trace.Span)):
            todo.extend(gc.get_referents(obj))
    for s in held:
        assert all(type(v) in (int, float, str) for v in s.attrs.values())


@pytest.mark.parametrize("case", list(BODIES))
def test_no_bytes_to_a_card_on_the_cpu(case):
    spans = _dicts(case)
    for s in spans:
        assert s["attrs"]["h2d_bytes"] == 0
        assert s["attrs"]["launches"] == 0
        assert s["attrs"]["launch_host_ns"] == 0


@pytest.mark.parametrize("case", list(BODIES))
def test_filter_body_and_glue_passes(case):
    """Each filter span names the body that ran; the unfused recurrence
    counts four torch passes a step (its init is one of the ``steps``:
    the k = 1 term's product) and the fused bodies none."""
    spans = _dicts(case)
    filters = [s for s in spans if s["name"] == "filter"]
    assert len(filters) >= 3
    for s in filters:
        assert s["attrs"]["body"] == BODIES[case]
        want = 4 * s["attrs"]["steps"] if case == "herm" else 0
        assert s["attrs"]["glue_passes"] == want
    feast = spans[0]
    assert feast["name"] == "feast"
    assert feast["attrs"]["glue_passes"] == sum(
        s["attrs"]["glue_passes"] for s in filters)
    off = _traced(case)[0]
    assert off.M == 10 and int(off.info) == 0
    assert off.q.is_complex() == (case == "herm")


def test_glue_counted_only_while_tracing():
    apply = lambda X: 2.0 * X                            # noqa: E731
    from feastkit_tpu_torch.ops.chebfilter import make_cheb_filter
    filt = make_cheb_filter(apply, 0.0, 4.0, np.array([0.5, 0.2, 0.1, 0.05]))
    Q = torch.ones(5, 2, dtype=torch.complex128)
    before = trace.counters()["glue_passes"]
    off = filt(Q)
    assert trace.counters()["glue_passes"] == before
    trace.enable()
    with trace.span("filter") as s:
        on = filt(Q)
    trace.disable()
    assert s.attrs["glue_passes"] == 4 + 2 * 4         # the init, 2 steps
    assert torch.equal(off, on)


def test_span_attributes_are_plain_values():
    trace.enable()
    s = trace.span("filter", steps=np.int64(3), rho=np.float32(0.5))
    assert type(s.attrs["steps"]) is int and type(s.attrs["rho"]) is float
    with pytest.raises(TypeError, match="ints, floats and strings"):
        trace.span("filter", steps=torch.tensor(3))
    with trace.span("route") as s:
        with pytest.raises(TypeError):
            s.set(q=torch.zeros(2))
        with pytest.raises(ValueError):
            with trace.span("route.coo"):
                raise ValueError("x")
    trace.disable()
    route, coo = trace.spans()
    assert coo.parent == route.index
    assert coo.attrs["error"] == "ValueError" and "error" not in route.attrs
    assert route.solve is None


def test_note_sets_the_innermost_span_of_its_name():
    trace.note("filter", steps=1)            # off: nothing to set
    trace.enable()
    with trace.span("loop"):
        trace.note("filter", steps=2)        # "loop" is innermost: no-op
        with trace.span("filter") as f:
            trace.note("filter", steps=np.int64(7))
            with trace.span("rr"):
                trace.note("filter", steps=9)
    trace.disable()
    loop, filt, rr = trace.spans()
    assert "steps" not in loop.attrs and "steps" not in rr.attrs
    assert filt is f and type(f.attrs["steps"]) is int
    assert f.attrs["steps"] == 7


@pytest.mark.parametrize("dtype,size", [(None, 4), (torch.float64, 8),
                                        (torch.float16, 2)])
def test_h2d_counts_the_bytes_that_cross(dtype, size):
    """A blocking copy converts on the host: the destination dtype's bytes
    cross, whatever the source's."""
    host = torch.zeros(6, 5, dtype=torch.float32)
    trace.enable()
    with trace.span("q0.upload") as s:
        trace.count_h2d(host, torch.device("cuda", 0), dtype)
        trace.count_h2d(host, "cuda:1", dtype)
        trace.count_h2d(host, "cpu", dtype)            # no crossing
    trace.count_h2d(host, "cuda", dtype)
    trace.disable()
    trace.count_h2d(host, "cuda", dtype)               # off: not counted
    assert s.attrs["h2d_bytes"] == 2 * 30 * size
    assert trace.spans() == [s]


@pytest.mark.parametrize("cleared", [False, True])
def test_marks_survive_a_clear(cleared):
    trace.enable()
    with trace.span("before"):
        pass
    m = trace.mark()
    with trace.span("a"):
        pass
    if cleared:
        trace.clear()
    with trace.span("b"):
        pass
    got = [s.name for s in trace.since(m)]
    assert got == (["b"] if cleared else ["a", "b"])
    trace.drop_since(m)
    assert [s.name for s in trace.spans()] == ([] if cleared else ["before"])
    with trace.span("c") as c:
        pass
    assert trace.spans()[c.index] is c
