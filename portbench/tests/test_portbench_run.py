"""Whole runs of the harness on the CPU at tiny sizes: the result's line,
cells, mixes and metrics added from files alone, the guard against the JAX
package, and ``correct`` coming out false under the control and under the
faults a cell can have."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import checks, harness
from portbench.tests.conftest import ROOT

SEED = 2 ** 33 + 17


def run(root, workload, trace=False, seconds=0.5, **kw):
    return harness.run(root, workload, SEED, seconds, trace, device="cpu",
                       t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("workload", ["lap2d_tiny.fresh", "cmass_tiny.fresh"])
def test_result_line(tiny_root, workload):
    r = run(tiny_root, workload)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"failed", "eig_err", "res_max"}
    for n in r["checks"].values():
        assert set(n) == {"value", "limit"} and n["value"] <= n["limit"]
    # on the CPU there is no device peak: the metric is left out
    assert set(r["metrics"]) == {"solve_s", "setup_s"}
    assert r["metrics"]["solve_s"] == dict(
        value=pytest.approx(r["metrics"]["solve_s"]["value"]), unit="s")
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    json.dumps(r)


def test_traced_result_line(tiny_root):
    r = run(tiny_root, "lap2d_tiny.fresh", trace=True)
    assert r["correct"] is True
    # only the per-layer metrics, and only those the CPU can read
    assert set(r["metrics"]) == {"loops"}
    assert r["metrics"]["loops"]["unit"] == "loops/solve"


def test_cell_mix_and_metric_added_from_files_alone(tiny_root, tmp_path):
    from portbench.tests.conftest import copy_benchmark
    root = copy_benchmark(tmp_path)
    for name in ("lap2d_tiny", "cmass_tiny"):
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            (tiny_root / "portbench" / "configs" / f"{name}.json")
            .read_text())
    mix = json.loads((root / "portbench" / "traffic" / "fresh.json")
                     .read_text())
    mix.update(name="fresh_slow", solve_floor_s=10.0)
    (root / "portbench" / "traffic" / "fresh_slow.json").write_text(
        json.dumps(mix))
    (root / "portbench" / "metrics" / "solves_done.py").write_text(
        "def read(ctx):\n    return len(ctx['window']['records'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="lap2d_tiny.fresh_slow",
                                   config="lap2d_tiny", traffic="fresh_slow",
                                   chips=1, why="added by files"))
    bench["end_to_end"].append(dict(name="solves_done", unit="solves",
                                    better="higher", bound=0.25,
                                    source="host_clock",
                                    workloads=["lap2d_tiny.fresh_slow"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, "lap2d_tiny.fresh_slow")
    assert r["correct"] is True
    assert r["metrics"]["solves_done"] == dict(value=r["attempted"],
                                               unit="solves")


def test_control_comes_out_not_correct(tiny_root):
    # the port's own single-precision path in place of the program
    for workload in ("lap2d_tiny.fresh", "cmass_tiny.fresh"):
        r = run(tiny_root, workload, precision=np.float32)
        assert r["correct"] is False
        assert r["checks"]["res_max"]["value"] > 1e-6


SPARSE = "feastkit_tpu_torch.solvers.sparse"
FILTERS = {"lap2d_tiny.fresh": "_sparse_cheb_filter_host_fused",
           "cmass_tiny.fresh": "_sparse_cheb_filter_host_fused_gen"}


def unchanged(orig):
    def step(ctx, Q, **kw):
        return Q.clone()
    return step


def half_left_out(orig):
    def step(ctx, Q, **kw):
        out = orig(ctx, Q, **kw)
        out[:, out.shape[1] // 2:] = 0
        return out
    return step


@pytest.mark.parametrize("workload", sorted(FILTERS))
@pytest.mark.parametrize("fault", [unchanged, half_left_out],
                         ids=["state_unchanged", "half_left_out"])
def test_broken_filter_comes_out_not_correct(tiny_root, monkeypatch,
                                             workload, fault):
    import importlib
    sparse = importlib.import_module(SPARSE)
    name = FILTERS[workload]
    monkeypatch.setattr(sparse, name, fault(getattr(sparse, name)))
    r = run(tiny_root, workload)
    assert r["correct"] is False


@pytest.mark.parametrize("part", ["eigenvalue", "eigenvector"])
def test_altered_answer_comes_out_not_correct(tiny_root, monkeypatch, part):
    import feastkit_tpu_torch as ft
    orig = ft.feast

    def altered(*a, **k):
        r = orig(*a, **k)
        if part == "eigenvalue":
            r.lam[0] += 1e-9
        else:
            r.q[:, 0] += 1e-6 * r.q[:, 1]
        return r
    monkeypatch.setattr(ft, "feast", altered)
    r = run(tiny_root, "lap2d_tiny.fresh")
    assert r["correct"] is False
    key = "eig_err" if part == "eigenvalue" else "res_max"
    assert r["checks"][key]["value"] > r["checks"][key]["limit"]


def test_guard_compares_whole_top_level_names():
    assert checks.forbidden_modules({"jax.numpy": 1, "numpy": 1}) == ["jax"]
    assert checks.forbidden_modules({"feastkit_tpu.core.tools": 1}) == \
        ["feastkit_tpu"]
    assert checks.forbidden_modules({"jaxlib": 1, "flax.linen": 1}) == \
        ["flax", "jaxlib"]
    assert checks.forbidden_modules({"feastkit_tpu_torch.ops": 1,
                                     "jaxtyping": 1, "feastkit_tpux": 1}) \
        == []


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from portbench import checks, harness; "
            "import feastkit_tpu_torch, portbench.tracing, "
            "portbench.schedule, portbench.calibrate; "
            "print(checks.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be seen here")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lap2d_p10.fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cmass_p8.fresh",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
