"""What the benchmark may import, and how it refuses to run."""

import ast
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

REPO = harness.Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = imported_top_levels(path) & {"jax", "jaxlib", "flax", "crypto_rec_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "bounds.py", "traffic.py"):
        assert "crypto_rec_tpu_torch" not in imported_top_levels(BENCH / name), name


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = dict(sys.modules)
    try:
        sys.modules["crypto_rec_tpu_torch_probe"] = sys
        assert "crypto_rec_tpu" not in run.loaded_forbidden()
        sys.modules["crypto_rec_tpu.ops"] = sys
        assert run.loaded_forbidden() == ["crypto_rec_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_the_port_beside_it(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    res = _run(tmp_path, "--workload", "cf-jester-73k-100.bulk", "--seed", "1", "--seconds", "1")
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "no crypto_rec_tpu_torch" in res.stderr


def test_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _run(REPO, "--workload", "cf-jester-73k-100.bulk", "--seed", "1", "--seconds", "1")
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["portbench"]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (BENCH / "paths" / f"{cfg['path']}.py").is_file()
    for w in bench["workloads"]:
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
