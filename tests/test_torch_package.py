"""Package-level checks of the PyTorch port that need no JAX reference."""

import subprocess
import sys
from pathlib import Path

import torch

from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Importing the port and every submodule, the probe entry points
    (`experiments`) and the recommender program (`main`) included, loads no
    jax* or ml_dtypes module and nothing of the JAX package crypto_rec_tpu
    (run in a fresh interpreter: the test harness imports jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import crypto_rec_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('crypto_rec_tpu', 'ml_dtypes')\n"
        "             or k.split('.')[0].startswith('jax'))\n"
        "print(','.join(sorted(k for k in sys.modules if k.startswith(p.__name__))), bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods, bad = res.stdout.split(" ", 1)
    mods = set(mods.split(","))
    assert len(mods) >= 30
    assert {"crypto_rec_tpu_torch.models.lsh.pstable",
            "crypto_rec_tpu_torch.models.lsh.hypercube",
            "crypto_rec_tpu_torch.ops.hamming"} <= mods
    # the probe entry points and their kernels' wrappers
    assert {f"crypto_rec_tpu_torch.experiments.{m}" for m in (
        "_common", "probe_r3_mask", "probe_r3_split", "probe_r3_binned",
        "probe_r3_final", "probe_r4_blk", "probe_r5_int4")} <= mods
    assert {f"crypto_rec_tpu_torch.ops.kernels.{m}" for m in (
        "binned", "int4slab", "slabvariants", "blkslab")} <= mods
    # the recommender program and its modules
    assert {f"crypto_rec_tpu_torch.{m}" for m in (
        "main", "utils.timing", "utils.logging", "io.readers", "io.ingest", "io.users",
        "io.synth", "models.rec.validate", "models.rec.pipeline", "models.cluster.init",
        "models.cluster.assign", "models.cluster.update", "models.cluster.silhouette",
        "models.cluster.kmeans")} <= mods
    assert bad.strip() == "[]", bad


def test_planted_corpus_protocol():
    """Shapes, planted rows next to their query, and exact-NN recall of the
    planted truth (the recall protocol of the CF bench)."""
    g = torch.Generator().manual_seed(0)
    corpus, queries, true_idx = planted_clustered_corpus(g, 5000, 32, 20, 10,
                                                         n_chunks=7)
    assert corpus.shape == (5000, 32) and queries.shape == (20, 32)
    assert true_idx.dtype == torch.int32
    assert torch.equal(true_idx[3], torch.arange(30, 40, dtype=torch.int32))
    planted = corpus[:200].view(20, 10, 32) - queries[:, None, :]
    assert float(planted.std()) < 0.2                      # 0.15 noise
    _, idx = exact_nearest(queries, corpus, "cosine", 10, block_rows=8)
    assert recall_at_k(idx, true_idx) > 0.95
    again = planted_clustered_corpus(torch.Generator().manual_seed(0), 5000, 32,
                                     20, 10, n_chunks=7)[0]
    assert torch.equal(again, corpus)


def test_recall_at_k_ignores_pads():
    true_idx = torch.tensor([[1, 2], [3, 4]])
    got = torch.tensor([[2, -1, 1], [-1, -1, 3]])
    assert recall_at_k(got, true_idx) == 0.75
