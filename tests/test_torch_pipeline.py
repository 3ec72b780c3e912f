"""The recommender program as a whole: `main -validate` on one synthetic
reference-format dataset through the JAX package and through the port
(`--device cpu`).  The two draw different random numbers, so their
recommendations differ; the counts, the output file's structure and the
JSON summary's keys must agree, and the port's 10-fold MAE must lie in
PARITY.md's band for hide_mode "fixed" (0.551 +- 2 x 0.056)."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crypto_rec_tpu.main import main as jax_main
from crypto_rec_tpu_torch import main as port_main
from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
from crypto_rec_tpu_torch.models.rec import pipeline as port_pipeline
from crypto_rec_tpu_torch.utils.timing import PhaseTimer

REPO = Path(__file__).resolve().parents[1]
MAE_BAND = (0.551 - 2 * 0.056, 0.551 + 2 * 0.056)
HEADERS = ["Cosine LSH", "Cosine LSH", "Clustering Recommendation",
           "Clustering Recommendation"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    tweets, conf = write_synthetic_dataset(str(out), seed=3)
    return out, tweets, conf


def _run(fn, dataset, name, capsys, *extra):
    out_dir, tweets, conf = dataset
    out = out_dir / name
    assert fn(["-d", tweets, "-o", str(out), "-c", conf, *extra]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out.read_text(), summary


@pytest.fixture(scope="module")
def runs(dataset):
    """JAX's run and the port's, -validate, and the port's without it; the
    summaries parsed from stdout."""
    res = {}
    for key, fn, extra in (("jax", jax_main, ["-validate"]),
                           ("port", port_main.main, ["-validate", "--device", "cpu"]),
                           ("port_again", port_main.main, ["-validate", "--device", "cpu"]),
                           ("port_novalidate", port_main.main, ["--device", "cpu"])):
        out = dataset[0] / f"{key}.txt"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(["-d", dataset[1], "-o", str(out), "-c", dataset[2], *extra])
        assert rc == 0
        res[key] = (out.read_text(), json.loads(buf.getvalue().strip().splitlines()[-1]))
    return res


def _coin_names(dataset):
    rows = (dataset[0] / "coins.tsv").read_text().splitlines()
    return {r.split("\t")[4] for r in rows}


def _structure(text, coin_names):
    """-> (headers in order, per-section user-line counts); checks every
    user line names real coins and every section ends with its time."""
    headers, counts = [], []
    lines = text.splitlines()
    for line in lines:
        if line in ("Cosine LSH", "Clustering Recommendation"):
            headers.append(line)
            counts.append(0)
        elif line.startswith("Execution Time: "):
            assert int(line.split(": ")[1]) >= 0
        else:
            toks = line.split(" ")
            assert toks[0].startswith("user") and set(toks[1:]) <= coin_names, line
            counts[-1] += 1
    assert sum(line.startswith("Execution Time: ") for line in lines) == 4
    return headers, counts


def _without_times(text):
    return [line for line in text.splitlines() if not line.startswith("Execution Time")]


def test_port_and_jax_agree_on_counts_and_structure(runs, dataset):
    (jtext, jsum), (ptext, psum) = runs["jax"], runs["port"]
    assert psum["n_users"] == jsum["n_users"] > 30
    assert psum["n_fake_users"] == jsum["n_fake_users"] > 0
    assert set(psum) == set(jsum) == {"phase_ms", "n_users", "n_fake_users", "mae_10fold"}
    assert set(psum["phase_ms"]) == set(jsum["phase_ms"])
    names = _coin_names(dataset)
    jh, jc = _structure(jtext, names)
    ph, pc = _structure(ptext, names)
    assert ph == jh == HEADERS
    # every user has neighbours in the clustering phases, in both packages
    assert pc[2:] == jc[2:] == [psum["n_users"]] * 2
    assert all(0 < c <= psum["n_users"] for c in pc)


def test_port_mae_lies_in_the_parity_band(runs):
    mae = runs["port"][1]["mae_10fold"]
    assert MAE_BAND[0] <= mae <= MAE_BAND[1], mae


def test_same_seed_gives_the_same_file_and_validate_changes_no_other_phase(runs):
    base = _without_times(runs["port"][0])
    assert base == _without_times(runs["port_again"][0])
    assert base == _without_times(runs["port_novalidate"][0])
    assert "mae_10fold" not in runs["port_novalidate"][1]


def test_lowered_auto_threshold_routes_phase_a_through_csr(dataset, monkeypatch, caplog,
                                                            capsys):
    calls = []
    real = port_pipeline.candidate_ids

    def spy(*a, **kw):
        calls.append(a[1].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(port_pipeline, "candidate_ids", spy)
    monkeypatch.setattr(port_pipeline, "AUTO_MASK_MAX_ELEMS", 0)
    caplog.set_level("INFO", logger=port_pipeline.log.name)
    text, summary = _run(port_main.main, dataset, "csr.txt", capsys, "--device", "cpu",
                         "--silhouette", "--budget", "8")
    assert calls and calls[0] == summary["n_users"]          # phase A's queries
    assert "switching to the csr engine" in caplog.text
    assert "csr engine truncated candidate unions" in caplog.text    # budget 8
    assert _structure(text, _coin_names(dataset))[0] == HEADERS
    assert set(summary["silhouettes"]) == {"cluster_A", "cluster_B"}


def test_profile_writes_a_trace(dataset, tmp_path, capsys):
    _run(port_main.main, dataset, "prof.txt", capsys, "--device", "cpu",
         "--profile", str(tmp_path / "trace"))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_main_without_a_gpu_exits_with_an_error(dataset, monkeypatch, capsys):
    """`--device cuda` is the default: with no GPU main fails with a message
    naming the missing GPU and never falls back to the CPU."""
    out_dir, tweets, conf = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-d", tweets, "-o", str(out_dir / "nogpu.txt"), "-c", conf]
    for extra in ([], ["--device", "cuda"]):
        assert port_main.main(args + extra) != 0
        assert "no NVIDIA GPU" in capsys.readouterr().err
    assert not (out_dir / "nogpu.txt").exists()
    res = subprocess.run([sys.executable, "-m", "crypto_rec_tpu_torch.main", *args],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and "GPU" in res.stderr


def test_phase_timer_accumulates():
    t = PhaseTimer(torch.device("cpu"))
    for _ in range(2):
        with t.phase("a"):
            pass
    assert set(t.phases) == {"a"} and t.ms("a") >= 0 and t.ms("missing") == 0


def test_p_header_above_the_virtual_user_count(tmp_path, capsys):
    """P = 20 neighbours asked of 10 virtual users (phase B): the port keeps
    every candidate, as the reference does; the JAX package's lax.top_k
    raises there."""
    tweets, conf = write_synthetic_dataset(str(tmp_path), seed=4, p_header=20)
    text, summary = _run(port_main.main, (tmp_path, tweets, conf), "out.txt", capsys,
                         "--device", "cpu")
    assert summary["n_fake_users"] < 20
    assert _structure(text, _coin_names((tmp_path,)))[0] == HEADERS
    with pytest.raises(ValueError, match="top_k"):
        jax_main(["-d", tweets, "-o", str(tmp_path / "jax.txt"), "-c", conf])
