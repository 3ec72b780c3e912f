"""The fused LSH -> CF slice as a whole: the port against the JAX package on
one JAX-built index (4,096 x 128, L = 5) handed over with index_from_numpy.

JAX's own retrieve_topk runs its kernel branch only with interpret=False
(index.py:1125), so the JAX side of every fused comparison is
retrieve_topk_pallas(interpret=True) followed by recommend_topk_retrieved.
predicted: rtol 1e-5, atol 1e-5; top_n equal except where predictions
tie within 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu.config import RecConfig as JaxRecConfig
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.models.rec import engine as jax_engine
from crypto_rec_tpu.models.rec import pipeline as jax_pipeline
from crypto_rec_tpu_torch import serve_cli
from crypto_rec_tpu_torch.config import RecConfig
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.rec import engine as port_engine
from crypto_rec_tpu_torch.models.rec import pipeline as port_pipeline

from _torch_parity import assert_topk_match, handover

N, D, Q, K, L, PT, TOP_P, TOP_N = 4096, 128, 48, 5, 5, 200, 20, 5
CPU = torch.device("cpu")


def _rating_set(x, rng):
    known = rng.random(x.shape) < 0.6
    mean = (x * known).sum(1) / np.maximum(known.sum(1), 1)
    ratings = np.where(known, x, mean[:, None]).astype(np.float32)
    return ratings, known, mean.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = 2.0 * rng.normal(size=(64, D))
    x = (centers[rng.integers(0, 64, N)] + 0.5 * rng.normal(size=(N, D))).astype(np.float32)
    qs = (x[:Q] + 0.2 * rng.normal(size=(Q, D))).astype(np.float32)
    nset, qset = _rating_set(x, rng), _rating_set(qs, rng)
    key = jax.random.PRNGKey(4)
    jidx = jax_index.build_index(key, jnp.asarray(nset[0]), "cosine", k=K, L=L,
                                 lsh_bucket_div=4, euclidean_h_w=1.0)
    jp = jax_index.pack_index(jidx, jnp.asarray(nset[0]), dtype=jnp.int8)
    return dict(nset=nset, qset=qset, key=key, jidx=jidx, jp=jp)


def _jax_set(s):
    return jax_engine.RatingSet(*(jnp.asarray(a) for a in s))


def _port_set(s):
    return port_engine.RatingSet(*(torch.from_numpy(np.asarray(a).copy()) for a in s))


def _assert_recs_match(want, got):
    wp, gp = np.asarray(want.predicted), got.predicted.numpy()
    np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=1e-5)
    wt, gt = np.asarray(want.top_n), got.top_n.numpy()
    np.testing.assert_array_equal(got.has_neighbors.numpy(), np.asarray(want.has_neighbors))
    for q in np.nonzero((wt != gt).any(1))[0]:
        # a differing slot must be a tie of predictions within 1e-6
        a, b = wt[q][wt[q] != gt[q]], gt[q][wt[q] != gt[q]]
        assert (a >= 0).all() and (b >= 0).all(), f"user {q}: top-n pads differ"
        assert np.abs(np.sort(wp[q, a]) - np.sort(wp[q, b])).max() <= 1e-6, (
            f"user {q}: top-n differs beyond a prediction tie"
        )


@pytest.mark.parametrize("int8_rerank", [True, False])
def test_retrieve_topk_pallas_matches_jax(data, int8_rerank):
    jp, qs, corpus = data["jp"], data["qset"][0], data["nset"][0]
    want = jax_index.retrieve_topk_pallas(
        jp, jnp.asarray(qs), jnp.asarray(corpus), top_k=TOP_P, per_table=PT,
        interpret=True, int8_rerank=int8_rerank, stage1_per_table=12,
    )
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    args = (pidx, torch.from_numpy(qs), torch.from_numpy(corpus))
    got = port_index.retrieve_topk_pallas(
        *args, top_k=TOP_P, per_table=PT, int8_rerank=int8_rerank,
        stage1_per_table=12,
    )
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    # retrieve_topk takes the same kernel branch under JAX's condition
    via = port_index.retrieve_topk(*args, top_k=TOP_P, per_table=PT,
                                   int8_rerank=int8_rerank, stage1_per_table=12)
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


def test_recommend_topk_retrieved_matches_jax(data):
    rng = np.random.default_rng(2)
    ids = rng.integers(-1, N, size=(Q, TOP_P)).astype(np.int32)
    sims = -np.sort(-rng.random((Q, TOP_P)).astype(np.float32), axis=1)
    want = jax_engine.recommend_topk_retrieved(
        _jax_set(data["qset"]), _jax_set(data["nset"]), jnp.asarray(sims),
        jnp.asarray(ids), TOP_N,
    )
    got = port_engine.recommend_topk_retrieved(
        _port_set(data["qset"]), _port_set(data["nset"]), torch.from_numpy(sims),
        torch.from_numpy(ids), TOP_N,
    )
    _assert_recs_match(want, got)
    np.testing.assert_array_equal(got.neighbor_valid.numpy(), ids >= 0)


def test_lsh_phase_mask_matches_jax(data):
    cfg = dict(k=K, L=L, engine="mask")
    jcache = {}
    want = jax_pipeline.lsh_phase(
        data["key"], _jax_set(data["qset"]), _jax_set(data["nset"]),
        JaxRecConfig(**cfg), top_n=TOP_N, top_p=TOP_P, index_cache=jcache,
    )
    (jidx,) = jcache.values()
    cache = {(4, "users"): port_index.index_from_numpy(*handover(jidx), CPU)}
    got = port_pipeline.lsh_phase(
        4, _port_set(data["qset"]), _port_set(data["nset"]), RecConfig(**cfg),
        top_n=TOP_N, top_p=TOP_P, index_cache=cache, index_token="users",
    )
    _assert_recs_match(want, got)
    assert_topk_match(want.sims, want.neighbor_idx, got.sims, got.neighbor_idx,
                      rtol=1e-5, atol=1e-6)


def test_lsh_phase_fused_matches_jax(data):
    """engine="fused" with int8 slabs: JAX's reference is the kernel path in
    interpret mode (retrieve_topk's defaults: production windows, exact
    rerank of a 4x over-fetch) followed by recommend_topk_retrieved."""
    cfg = dict(k=K, L=L, engine="fused", pack_dtype="int8", candidate_budget=PT)
    qset, nset = _jax_set(data["qset"]), _jax_set(data["nset"])
    sims, nidx = jax_index.retrieve_topk_pallas(
        data["jp"], qset.ratings, nset.ratings, top_k=TOP_P, per_table=PT,
        interpret=True,
    )
    want = jax_engine.recommend_topk_retrieved(qset, nset, sims, nidx, TOP_N)
    cache = {(4, "users"): port_index.index_from_numpy(*handover(data["jp"]), CPU)}
    got = port_pipeline.lsh_phase(
        4, _port_set(data["qset"]), _port_set(data["nset"]), RecConfig(**cfg),
        top_n=TOP_N, top_p=TOP_P, index_cache=cache, index_token="users",
    )
    assert cache[(4, "users")].packed.dtype == torch.int8   # slabs reused
    _assert_recs_match(want, got)
    assert_topk_match(sims, nidx, got.sims, got.neighbor_idx, rtol=1e-5, atol=1e-5)
    assert got.has_neighbors.all()


def test_lsh_phase_builds_and_caches_its_own_index(data):
    """Without a handed-over index the port hashes with its own seeded
    hyperplanes; the cache is keyed on (seed, token) and reused."""
    cfg = RecConfig(k=K, L=L, engine="fused", pack_dtype="bfloat16",
                    candidate_budget=PT)
    qset, nset = _port_set(data["qset"]), _port_set(data["nset"])
    cache = {}
    a = port_pipeline.lsh_phase(9, qset, nset, cfg, TOP_N, TOP_P,
                                index_cache=cache, index_token="users")
    (idx,) = cache.values()
    assert idx.packed.dtype == torch.bfloat16
    b = port_pipeline.lsh_phase(9, qset, nset, cfg, TOP_N, TOP_P,
                                index_cache=cache, index_token="users")
    assert torch.equal(a.top_n, b.top_n) and cache[(9, "users")] is idx
    assert a.predicted.shape == (Q, D) and bool(a.has_neighbors.all())
    with pytest.raises(ValueError):
        port_pipeline.lsh_phase(9, qset, nset, cfg, TOP_N, TOP_P, index_cache={})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        port_pipeline.lsh_phase(9, qset, nset, cfg.replace(engine="csr"), TOP_N, TOP_P)


def test_serve_cli_answers_from_a_jax_checkpoint(data, tmp_path):
    """An index archive written by the JAX package serves through the port's
    CLI (on CPU tensors, `--device cpu`), with the same top-k
    as JAX's kernel path."""
    corpus, qs = data["nset"][0], data["qset"][0]
    jax_ckpt.save_index(str(tmp_path / "idx.npz"), data["jidx"])
    np.savez(tmp_path / "corpus.npz", vectors=corpus)
    with open(tmp_path / "q.csv", "w") as f:
        for i, v in enumerate(qs):
            f.write(",".join([f"q{i}"] + [repr(float(t)) for t in v]) + "\n")
    rc = serve_cli.main([
        "retrieve", "--index", str(tmp_path / "idx.npz"),
        "--corpus", str(tmp_path / "corpus.npz"), "--queries", str(tmp_path / "q.csv"),
        "--top-k", "10", "--per-table", str(PT), "--pack", "--device", "cpu",
        "-o", str(tmp_path / "out.tsv"),
    ])
    assert rc == 0
    lines = (tmp_path / "out.tsv").read_text().splitlines()
    assert len(lines) == Q
    # JAX side: the same archive's index, packed bf16 as --pack does
    jp = jax_index.pack_index(data["jidx"], jnp.asarray(corpus))
    ws, wi = jax_index.retrieve_topk_pallas(
        jp, jnp.asarray(qs), jnp.asarray(corpus), top_k=10, per_table=PT,
        interpret=True,
    )
    got_i = np.full((Q, 10), -1, np.int32)
    got_s = np.full((Q, 10), -np.inf, np.float32)
    for q, line in enumerate(lines):
        toks = line.split("\t")
        assert toks[0] == f"q{q}"
        for j, pair in enumerate(toks[1:]):
            r, s = pair.split(":")
            got_i[q, j], got_s[q, j] = int(r), float(s)
    # scores are printed with 5 decimals
    assert_topk_match(ws, wi, got_s, got_i, rtol=0, atol=1e-5 + 5e-6)


def test_serve_cli_augment_answers_from_a_jax_euclidean_checkpoint(data, tmp_path):
    """A JAX-written euclidean archive (unpacked) serves through the port's
    `retrieve --pack --augment`: bf16 augmented slabs, 2x over-fetch, exact
    rerank, so the scores are true negated distances; the top-k matches
    JAX's own augmented kernel branch on the same archive."""
    corpus, qs = data["nset"][0], data["qset"][0]
    jidx = jax_index.build_index(jax.random.PRNGKey(6), jnp.asarray(corpus), "euclidean",
                                 k=4, L=4, lsh_bucket_div=4, euclidean_h_w=8.0)
    jax_ckpt.save_index(str(tmp_path / "idx.npz"), jidx)
    np.savez(tmp_path / "corpus.npz", vectors=corpus)
    with open(tmp_path / "q.csv", "w") as f:
        for i, v in enumerate(qs):
            f.write(",".join([f"q{i}"] + [repr(float(t)) for t in v]) + "\n")
    rc = serve_cli.main([
        "retrieve", "--index", str(tmp_path / "idx.npz"),
        "--corpus", str(tmp_path / "corpus.npz"), "--queries", str(tmp_path / "q.csv"),
        "--top-k", "10", "--per-table", str(PT), "--pack", "--augment",
        "--device", "cpu", "-o", str(tmp_path / "out.tsv"),
    ])
    assert rc == 0
    lines = (tmp_path / "out.tsv").read_text().splitlines()
    assert len(lines) == Q
    jp = jax_index.pack_index(jidx, jnp.asarray(corpus), augment=True)   # bf16
    ws, wi = jax_index.retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(corpus),
                                     top_k=10, per_table=PT)
    got_i = np.full((Q, 10), -1, np.int32)
    got_s = np.full((Q, 10), -np.inf, np.float32)
    for q, line in enumerate(lines):
        toks = line.split("\t")
        assert toks[0] == f"q{q}"
        for j, pair in enumerate(toks[1:]):
            r, s = pair.split(":")
            got_i[q, j], got_s[q, j] = int(r), float(s)
    assert (got_s[:, 0] < 0).all()                 # negated distances
    # scores are printed with 5 decimals
    assert_topk_match(ws, wi, got_s, got_i, rtol=1e-5, atol=1e-5 + 5e-6)


def test_serve_cli_device_cuda_without_a_card_exits_with_an_error(tmp_path, monkeypatch,
                                                                  capsys):
    """`retrieve` defaults to `--device cuda`; with no GPU it fails with a
    message naming the missing GPU and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["retrieve", "--index", str(tmp_path / "idx.npz"), "--corpus",
            str(tmp_path / "corpus.npz"), "--queries", str(tmp_path / "q.csv"),
            "-o", str(tmp_path / "out.tsv")]
    for extra in ([], ["--device", "cuda"]):
        assert serve_cli.main(args + extra) != 0
        assert "no NVIDIA GPU" in capsys.readouterr().err
    assert not (tmp_path / "out.tsv").exists()
