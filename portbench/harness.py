"""One run of one cell: set-up, the measured window, the traced window's
reduction, and the reference's judgement.

``run.py`` looks for the card and calls :func:`run`; tests call the same
function on the CPU at small sizes, and ``calibrate.py`` calls
:func:`Session.run_once` for many seeds in one process.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import checks, loadgen, tracing
from .schedule import Schedule
from .tracing import load_file


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows
            if "workloads" not in m or cell["name"] in m["workloads"]]


def card_peaks(root: Path, kind: str) -> dict:
    table = json.loads((Path(root) / "portbench" / "peaks.json").read_text())
    for row in table["cards"]:
        if row["match"] in kind:
            return row
    raise KeyError(f"no peaks for {kind!r} in peaks.json")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"
    return out[0] if out else "power limit not read"


def note(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Session:
    """A cell's files and the port, loaded once per process."""

    def __init__(self, root: Path, workload: str, *, device: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cell = find_cell(self.bench, workload)
        pb = self.root / "portbench"
        self.cfg = json.loads((pb / "configs"
                               / f"{self.cell['config']}.json").read_text())
        self.generator = load_file(
            pb / "generators" / f"{self.cfg['generator']}.py",
            f"portbench.generators.{self.cfg['generator']}")
        self.reference = load_file(
            pb / "reference" / f"{self.cfg['reference']}.py",
            f"portbench.reference.{self.cfg['reference']}")
        self.mix = loadgen.load(self.root, self.cell["traffic"])
        self.device = device
        import torch

        import feastkit_tpu_torch as ft
        self.torch, self.ft = torch, ft
        self.cuda = device == "cuda"
        if self.cuda:
            self._build_kernels()
        self.warm = False

    def _build_kernels(self) -> None:
        """Every kernel library of the port, built in parallel where
        missing (only a checkout's first run compiles)."""
        from feastkit_tpu_torch.ops import cuda_build
        names = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(cuda_build.build, names))

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def metric_modules(self, rows) -> dict:
        pb = self.root / "portbench" / "metrics"
        return {m["name"]: load_file(pb / f"{m['name']}.py",
                                     f"portbench_metric_{m['name']}")
                for m in rows}

    def run_once(self, seed: int, seconds: float, trace: bool, *,
                 t_start: float, precision=None) -> dict:
        """One run: the result's fields (the caller prints the line)."""
        torch, ft, cfg = self.torch, self.ft, self.cfg
        rows = cell_metrics(self.bench, self.cell, trace)
        readers = self.metric_modules(rows)
        fpm = loadgen.fpm_for(ft, cfg, self.mix)
        pool = loadgen.build_pool(cfg, self.generator, self.mix, seed,
                                  seconds)
        if not self.warm:
            for i, problem in enumerate(loadgen.build_warmup(
                    cfg, self.generator, self.mix, seed, seconds)):
                rec = loadgen.solve(ft, problem, fpm, device=self.device,
                                    precision=precision, label=f"warm-up {i}")
                if "error" in rec:
                    raise RuntimeError("the warm-up solve raised")
            self.warm = True
        setup_peak = torch.cuda.max_memory_allocated() if self.cuda else 0

        recorder = schedule = prof = None
        if trace:
            recorder = tracing.Recorder()
            recorder.install_spans(
                [row for mod in readers.values()
                 for row in getattr(mod, "SPANS", ())])
            families = tracing.kernel_families(self.root)
            recorder.install_hooks(families)
            schedule = Schedule()
            schedule.install()
            if self.cuda:
                prof = tracing.profiler()
                prof.start()
        gc.collect()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        t_window = time.perf_counter()
        try:
            if trace:
                with recorder.span("window"):
                    window = loadgen.run_window(
                        ft, pool, fpm, seconds, device=self.device,
                        sync=self.sync, span=recorder.span,
                        precision=precision)
            else:
                window = loadgen.run_window(
                    ft, pool, fpm, seconds, device=self.device,
                    sync=self.sync, precision=precision)
        finally:
            if trace:
                if prof is not None:
                    prof.stop()
                schedule.restore()
                recorder.restore()
        setup_s = t_window - t_start
        window_peak = torch.cuda.max_memory_allocated() if self.cuda else None
        ctx = dict(window=window, setup_s=setup_s,
                   window_peak_bytes=window_peak)
        kind = torch.cuda.get_device_name(0) if self.cuda else "cpu"
        limit = power_limit() if self.cuda else "cpu"
        breakdown = None
        if trace and self.cuda:
            ok, want, got = schedule.verdict()
            note(f"launch schedule {'matches' if ok else 'DIFFERS'}: "
                 f"expected {want}, counted {got}")
            events = tracing.read_events(prof)
            del prof
            csrc = Path(ft.__file__).resolve().parent / "ops" / "csrc"
            t = ctx["trace"] = tracing.reduce(
                events, recorder.spans, recorder.launches, families,
                tracing.port_kernel_names(csrc), card_peaks(self.root, kind))
            del events
            breakdown = t["breakdown"]
            note(f"trace: window {t['window_s']:.6f} s, device busy "
                 f"{t['busy_s']:.6f} s, {len(t['device'])} device activities "
                 f"({t['no_call']} with no launch call found, "
                 f"{t['unattributed']} with no span), {len(t['matched'])} "
                 f"counted launches matched, {t['disagree']} of them logged "
                 f"in another span than their launch call's; host clock "
                 f"{t['offset_ns']} ns behind the trace's"
                 + (f"; {t['mismatch']}" if t["mismatch"] else ""))
            if t["uncounted"]:
                note(f"kernels of the port with no count file, left out of "
                     f"kernel_roofline_pct: {t['uncounted']}")
        metrics = {}
        for m in rows:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        if "kernel_roofline_pct" in metrics:
            note(f"kernel_roofline_pct "
                 f"{metrics['kernel_roofline_pct']['value']} ({limit})")

        # judge once the window has closed, its peak read and the port's
        # state freed; the reference runs on the host
        records = window["records"]
        ctx = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        numbers = checks.judge(self.reference, cfg, records)
        attempted = len(records)
        failed = numbers["failed"]["value"]
        loops = sorted({r["loop"] for r in records if "loop" in r})
        note(f"{self.cell['name']} seed {seed}: {attempted} solves, loops "
             f"{loops}, card {limit}; seconds a solve "
             f"{[round(r['seconds'], 4) for r in records]}")
        for name, n in numbers.items():
            note(f"check {name} {n['value']!r} limit {n['limit']!r}")
        device = dict(platform="gpu" if self.cuda else "cpu", kind=kind,
                      count=int(self.cell["chips"]),
                      memory_peak_bytes=int(max(setup_peak,
                                                window_peak or 0)))
        result = dict(correct=checks.passes(numbers, attempted),
                      attempted=attempted, failed=failed, metrics=metrics,
                      device=device)
        if breakdown is not None:
            device.update(busy_s=t["busy_s"], window_s=t["window_s"])
            result["breakdown"] = breakdown
        result["checks"] = numbers
        return result


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        *, device: str, t_start: float, precision=None) -> dict:
    session = Session(root, workload, device=device)
    return session.run_once(seed, seconds, trace, t_start=t_start,
                            precision=precision)
