"""Fixtures of the benchmark's CPU tests: a copy of the benchmark beside a
BENCHMARK.json that adds cells at sizes the CPU runs in seconds.

Run from the repository's root: python -m pytest portbench/tests
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny cells: each configuration's own file with its grid, pair count
# and subspace cut, the potential scaled with the grid's spacing
TINY = {
    "lap2d_tiny": ("lap2d_p10", dict(grid=[24, 20], pairs_past=10, M0=16,
                                     lowest_1d=20), 300.0),
    "cmass_tiny": ("cmass_p8", dict(grid=[16, 20], pairs_past=10, M0=16,
                                    lowest_1d=16), 30.0),
}


def add_tiny_cells(root: Path) -> None:
    """Write the tiny configurations and their cells into ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (base, sizes, scale) in TINY.items():
        cfg = json.loads((root / "portbench" / "configs"
                          / f"{base}.json").read_text())
        cfg.update(sizes, name=name)
        cfg["potential"] = dict(cfg["potential"],
                                amplitude=cfg["potential"]["amplitude"]
                                * scale)
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        cell = f"{name}.fresh"
        bench["workloads"].append(dict(name=cell, config=name,
                                       traffic="fresh", chips=1,
                                       why="a CPU test"))
        for metric in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in metric:
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def copy_benchmark(dest: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out",
                                                  "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_tiny_cells(root)
    return root
