"""The trace's reduction, the per-layer readers and the kernel count
files, on synthetic activity lists."""
import math

import pytest

from portbench import tracing
from portbench.tests.conftest import ROOT

PEAKS = dict(bytes_per_s=3.35e12, flops=dict(f32=67e12, f64=34e12))
FAMILIES = tracing.kernel_families(ROOT)
CSRC = ROOT / "feastkit_tpu_torch" / "ops" / "csrc"
STREAM4_F32 = dict(entry="cheb_step4_f32", N=1 << 20, M=72, nd=5,
                   itemsize=4, steps=4)
STEP_F32 = dict(entry="cheb_step_f32", N=1 << 20, M=72, nd=5, itemsize=4)


def reader(name):
    return tracing.load_file(ROOT / "portbench" / "metrics" / f"{name}.py",
                             f"test_metric_{name}")


US = 1000   # ns


def synthetic(offset=1000 * US):
    """One window of 1000 us on the host; the trace's clock runs
    ``offset`` ns ahead. Two kernels of the port in a filter span (logged
    10 us and 8 us before their launch calls), a library kernel in a
    Rayleigh-Ritz span, a copy in the Q0 span."""
    spans = [("window", 0, 1000 * US), ("solve", 10 * US, 990 * US),
             ("q0/initial_subspace", 20 * US, 90 * US),
             ("filter/f", 100 * US, 500 * US), ("rr/update", 600 * US,
                                                700 * US)]
    events = dict(
        launches={1: 110 * US + offset, 2: 120 * US + offset,
                  3: 610 * US + offset, 4: 15 * US + offset},
        device=[
            ("void (anonymous namespace)::cheb_stream_kernel<float, 4, 5, "
             "4>(float const*)", 150 * US + offset, 350 * US + offset,
             "kernel", 1, 0),
            ("void (anonymous namespace)::cheb_step_kernel<float, 8>(float)",
             360 * US + offset, 400 * US + offset, "kernel", 2, 0),
            ("sm90_xmma_gemm_f64f64", 620 * US + offset, 680 * US + offset,
             "kernel", 3, 0),
            ("Memcpy HtoD (Pageable -> Device)", 92 * US + offset,
             99 * US + offset, "gpu_memcpy", 4, 0)])
    log = [("cheb_stream4", STREAM4_F32, "filter/f", 100 * US),
           ("cheb_step", STEP_F32, "filter/f", 112 * US)]
    return events, spans, log


def reduced(**kw):
    events, spans, log = synthetic(**kw)
    return tracing.reduce(events, spans, log, FAMILIES,
                          tracing.port_kernel_names(CSRC), PEAKS)


def test_reduction_places_spans_and_counts_busy_time():
    t = reduced()
    # the (upper) median lag of a logged launch to its call: 8 and 10 us
    assert t["offset_ns"] == 1010 * US and t["mismatch"] is None
    assert t["disagree"] == 0 and t["unattributed"] == 0
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx((200 + 40 + 60 + 7) * 1e-6,
                                        rel=0.03)
    assert tracing.device_seconds(t, "filter") == pytest.approx(240e-6)
    assert tracing.device_seconds(t, "rr") == pytest.approx(60e-6)
    assert tracing.span_seconds(t, "q0") == pytest.approx(70e-6)
    ops = dict(t["breakdown"]["device_ops"])
    assert ops["cheb_step4_f32"] == pytest.approx(200e-6)
    gaps = dict(t["breakdown"]["idle_gaps"][:1])
    assert gaps == {"solve": pytest.approx(320e-6, rel=0.05)}
    assert "q0/initial_subspace" in dict(t["breakdown"]["idle_gaps"])


def test_idle_and_roofline_arithmetic():
    t = reduced()
    window = dict(records=[{"loop": 2}], start=0.0, end=1.0)
    ctx = dict(trace=t, window=window)
    assert reader("device_idle_pct").read(ctx) == pytest.approx(
        100 * (1 - t["busy_s"] / 1000e-6))
    least = 0.5471375665671643e-3 + (5 * 302e6 + 21e6) / 3.35e12
    got = reader("kernel_roofline_pct").read(ctx)
    # 1,831 MB + 1,531 MB over 3.35 TB/s in 240 us of kernels: the least
    # times exceed the synthetic durations, as no real run may
    assert got == pytest.approx(100 * least / 240e-6, rel=1e-3)
    assert reader("filter_s").read(ctx) == pytest.approx(240e-6)
    assert reader("loops").read(ctx) == 2


def test_a_dropped_record_is_counted_not_guessed():
    events, spans, log = synthetic()
    del events["device"][0]           # the trace lost the 4-step kernel
    t = tracing.reduce(events, spans, log, FAMILIES,
                       tracing.port_kernel_names(CSRC), PEAKS)
    assert t["unpaired"] == (0, 1) and len(t["matched"]) == 1
    assert t["matched"][0][0] == "cheb_step"


def test_a_launch_log_that_does_not_match_reads_nothing():
    # no launch pairs to set the clocks by: the host's clock is taken as the
    # trace's
    events, spans, log = synthetic(offset=0)
    log = [("dia_matvec",) + entry[1:] for entry in log]
    t = tracing.reduce(events, spans, log, FAMILIES,
                       tracing.port_kernel_names(CSRC), PEAKS)
    assert t["offset_ns"] == 0 and not t["matched"]
    assert t["unpaired"] == (2, 2) and not t["matched"]
    ctx = dict(trace=t, window=dict(records=[{}], start=0, end=1))
    assert reader("kernel_roofline_pct").read(ctx) is None
    # the spans still place the device work by its launch calls
    assert tracing.device_seconds(t, "filter") == pytest.approx(240e-6)


def test_readers_without_a_trace_read_nothing():
    ctx = dict(window=dict(records=[{}], start=0, end=1))
    for name in ("route_host_s", "q0_host_s", "filter_s", "rr_s",
                 "kernel_roofline_pct", "device_idle_pct"):
        assert reader(name).read(ctx) is None


def test_timeline_innermost_span():
    tl = tracing.Timeline([("a", 0, 100), ("b", 10, 20), ("c", 30, 40)])
    assert [tl.at(t) for t in (-1, 5, 15, 25, 35, 99, 100)] == \
        [None, "a", "b", "a", "c", "a", None]


def test_kernel_names():
    assert tracing.base_name(
        "void (anonymous namespace)::cheb_stream_kernel<double, 4, 9, 2, "
        "false>(double const*, int)") == "cheb_stream_kernel"
    assert tracing.base_name("void at::native::elementwise_kernel<128>(int)"
                             ) == "elementwise_kernel"
    assert tracing.port_kernel_names(CSRC) >= {
        "cheb_step_kernel", "cheb_step_cm_kernel", "cheb_stream_kernel",
        "cheb_combine_kernel", "dia_matvec_kernel", "dia_ring_kernel"}
    counted = {k for spec in FAMILIES.values() for k in spec.KERNELS}
    assert counted == tracing.port_kernel_names(CSRC)


MB = 1e6
# (family, shape, the bound column of PERF.md's kernel table, ms)
BOUNDS = [
    ("cheb_stream4", dict(N=1 << 20, M=72, nd=5, itemsize=4, steps=4),
     0.5471),
    ("cheb_stream4", dict(N=1 << 20, M=72, nd=5, itemsize=4, steps=2),
     0.5471),
    ("cheb_stream4", dict(N=1 << 20, M=72, nd=5, itemsize=8, steps=4),
     1.0943),
    ("cheb_stream4", dict(N=65536, M=72, nd=9, itemsize=4, steps=4), 0.0345),
    ("cheb_stream4", dict(N=65536, M=72, nd=9, itemsize=8, steps=4), 0.0690),
    ("cheb_stream4", dict(N=1 << 18, M=72, nd=5, itemsize=4, steps=2),
     0.1368),
    ("cheb_step", dict(N=1 << 20, M=72, nd=5, itemsize=4), 0.4570),
    ("cheb_step", dict(N=1 << 20, M=72, nd=5, itemsize=8), 0.9140),
    ("cheb_step_cm", dict(N=65536, M=72, nd=9, itemsize=4, t0=False,
                          acc=False), 0.0120),
    ("cheb_step_cm", dict(N=65536, M=72, nd=9, itemsize=4, t0=False,
                          acc=True), 0.0232),
    ("cheb_step_cm", dict(N=65536, M=72, nd=9, itemsize=4, t0=True,
                          acc=True), 0.0289),
    ("cheb_step_cm", dict(N=65536, M=72, nd=9, itemsize=8, t0=False,
                          acc=False), 0.0239),
    ("cheb_step_cm", dict(N=65536, M=72, nd=9, itemsize=8, t0=True,
                          acc=True), 0.0577),
    ("cheb_combine", dict(elements=65536 * 72, itemsize=8, t0=True, f=True),
     0.0676),
    ("cheb_combine", dict(elements=65536 * 72, itemsize=4, t0=True, f=True),
     0.0338),
    ("dia_matvec", dict(g=1, N=65536, M=128, nd=5, itemsize=4,
                        diag_itemsize=4, complex=False), 0.0204),
    ("dia_matvec", dict(g=1, N=65536, M=72, nd=5, itemsize=8,
                        diag_itemsize=8, complex=False), 0.0233),
    ("dia_matvec", dict(g=1, N=1 << 20, M=72, nd=5, itemsize=8,
                        diag_itemsize=8, complex=False), 0.3731),
    ("dia_matvec", dict(g=1, N=1 << 20, M=72, nd=5, itemsize=16,
                        diag_itemsize=16, complex=True), 0.7462),
    ("dia_matvec", dict(g=1, N=1 << 20, M=10, nd=5, itemsize=8,
                        diag_itemsize=8, complex=False), 0.0626),
    ("dia_matvec", dict(g=2, N=65536, M=128, nd=5, itemsize=4,
                        diag_itemsize=4, complex=False), 0.0405),
    ("dia_matvec", dict(g=2, N=16384, M=72, nd=5, itemsize=8,
                        diag_itemsize=8, complex=True), 0.0115),
]


@pytest.mark.parametrize("family,shape,bound_ms", BOUNDS)
def test_count_files_give_the_table_bounds(family, shape, bound_ms):
    nbytes, ops, precision = FAMILIES[family].cost(shape)
    least = max(nbytes / PEAKS["bytes_per_s"], ops / PEAKS["flops"][precision])
    assert least * 1e3 == pytest.approx(bound_ms, abs=1e-4)
    # every one of these launches is bound by its bytes
    assert nbytes / PEAKS["bytes_per_s"] > ops / PEAKS["flops"][precision]


def test_hooks_log_cuda_launches_only_and_restore():
    import torch

    from feastkit_tpu_torch.ops import cheb_kernels
    rec = tracing.Recorder()
    orig = cheb_kernels._multistep
    rec.install_hooks(FAMILIES)
    try:
        assert cheb_kernels._multistep is not orig
        planes = [torch.zeros(2, 40) for _ in range(5)]
        diags = torch.ones(3, 40)
        cheb_kernels.cheb_step4_f32(diags, (-1, 0, 1), *planes, 1.0, 0.0,
                                    [1.0, 1.0, 1.0, 1.0])
        assert rec.launches == []
    finally:
        rec.restore()
    assert cheb_kernels._multistep is orig


def test_spans_wrap_and_restore():
    from feastkit_tpu_torch.solvers import sparse
    rec = tracing.Recorder()
    orig = sparse.initial_subspace
    rec.install_spans([("q0", "feastkit_tpu_torch.solvers.sparse",
                        "initial_subspace", "call")])
    try:
        sparse.initial_subspace(None, None, 5, 2, "float64")
    finally:
        rec.restore()
    assert sparse.initial_subspace is orig
    assert [s[0] for s in rec.spans] == ["q0/initial_subspace"]
    assert not math.isnan(rec.spans[0][2] - rec.spans[0][1])
