"""Fixtures of the benchmark's CPU tests: a temporary checkout of the
benchmark with its configurations cut to a size the CPU runs in seconds.

    python -m pytest -p no:cacheprovider portbench/tests
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = dict(n=6000, d=128, pool=256, k=5, L=4, per_table=64, judge_rows=128, build_reps=2)


def make_tiny(root: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ under root, every
    configuration at TINY's sizes, every mix at requests of 128 rows and a
    short traced stretch."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY)
        (root / c["file"]).write_text(json.dumps(cfg))
    for f in (root / "portbench" / "mixes").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(size={"kind": "fixed", "value": 128}, trace_requests=3)
        f.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels)")
    return torch.device("cuda")
