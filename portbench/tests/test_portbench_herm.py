"""The ``herm_p9`` configuration on the CPU at a tiny size, and the
readers of the two metrics it brings (``filter_glue_s``, ``glue_passes``)
on synthetic traces: what they count, and that a program without the
``body`` attribute or the ``glue_passes`` counter gives them nothing to
read."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, program_trace
from portbench.tests.conftest import copy_benchmark
from portbench.tracing import load_file

SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def herm_root(tmp_path_factory):
    """A copy of the benchmark with ``herm_tiny.fresh``: the cell's own
    configuration on a 32 x 32 cylinder at phi = 1/64, 11 pairs."""
    root = copy_benchmark(tmp_path_factory.mktemp("herm"))
    cfg = json.loads((root / "portbench" / "configs" / "herm_p9.json")
                     .read_text())
    cfg.update(name="herm_tiny", grid=[32, 32], flux=1 / 64, pairs_past=10,
               M0=16)
    (root / "portbench" / "configs" / "herm_tiny.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="herm_tiny.fresh",
                                   config="herm_tiny", traffic="fresh",
                                   chips=1, why="a CPU test"))
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append("herm_tiny.fresh")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_is_correct(herm_root, trace):
    r = harness.run(herm_root, "herm_tiny.fresh", SEED, 0.5, trace,
                    device="cpu", t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["eig_err"]["value"] <= 1e-12
    # no device trace on the CPU: the new readers read nothing
    assert set(r["metrics"]) == ({"loops"} if trace
                                 else {"solve_s", "setup_s"})


def test_complex64_control_is_not_correct(herm_root):
    session = harness.Session(herm_root, "herm_tiny.fresh", device="cpu")
    r = session.run_once(SEED, 0.5, False, t_start=time.perf_counter(),
                         precision=np.complex64)
    assert r["correct"] is False
    assert r["checks"]["eig_err"]["value"] > 1e-9
    assert r["checks"]["res_max"]["value"] > 1e-8


def _metric(name):
    from portbench.tests.conftest import ROOT
    return load_file(ROOT / "portbench" / "metrics" / f"{name}.py",
                     f"portbench_test_metric_{name}")


def _span(name, start, end=None, **attrs):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           attrs=attrs)


def test_filter_glue_seconds_on_a_synthetic_trace():
    glue = _metric("filter_glue_s")
    offset = 1_000
    spans = [_span("feast", 0, 10_000),
             _span("filter", 100, body="unfused"),
             _span("rr", 4_000),
             _span("filter", 5_000, body="fused"),
             _span("filter", 8_000, body="unfused")]
    ns = 1e-9
    port = {"dia_matvec_kernel", "dia_matvec_c64"}
    device = [
        # the first unfused application (from 1,100 on the trace's clock)
        ("elementwise_add", 1_200, 1_700, "kernel",
         "filter/_sparse_cheb_filter_host"),
        ("dia_matvec_c64", 1_700, 1_900, "kernel",
         "filter/_sparse_cheb_filter_host"),            # the port's: out
        ("dia_matvec_kernel<float2, 7>", 1_900, 2_000, "kernel",
         "filter/_sparse_cheb_filter_host"),            # the port's: out
        ("gpu_memset", 2_000, 2_100, "gpu_memset",
         "filter/_sparse_cheb_filter_host"),
        ("gemm", 5_100, 5_400, "kernel", "rr/make_rayleigh_ritz_update"),
        # the fused application (from 6,000): not glue
        ("cast", 6_100, 6_300, "kernel",
         "filter/_sparse_cheb_filter_host_fused"),
        # the second unfused one (from 9,000), still running past its
        # span's end on the host
        ("elementwise_mul", 9_100, 9_600, "kernel",
         "filter/_sparse_cheb_filter_host"),
        ("no span", 9_700, 9_800, "kernel", None),
    ]
    got = glue.glue_seconds(spans, offset, device, port)
    assert got == pytest.approx((500 + 100 + 500) * ns)
    # a program whose filter spans carry no body: nothing to read
    bare = [_span(s.name, s.start_ns) for s in spans]
    assert glue.glue_seconds(bare, offset, device, port) is None


@pytest.mark.parametrize("counter", [True, False])
def test_glue_passes_over_the_window(monkeypatch, counter):
    passes = _metric("glue_passes")
    extra = {"glue_passes": 40} if counter else {}
    spans = [_span("feast", 0, 90, **extra),          # the warm-up
             _span("feast", 100, 190, **extra),
             _span("filter", 110, 150, **extra),
             _span("feast", 200, 290,
                   **({"glue_passes": 80} if counter else {}))]
    monkeypatch.setattr(program_trace, "program",
                        SimpleNamespace(spans=lambda: spans))
    trace = dict(offset_ns=5, spans=[("solve", 100, 200), ("solve", 200, 300),
                                     ("filter/x", 110, 150)])
    got = passes.read(dict(trace=trace))
    assert got == (60.0 if counter else None)
    assert passes.read(dict(trace=None)) is None
