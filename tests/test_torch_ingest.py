"""Ingest parity: the port's synthetic dataset writer, readers, tweet
scoring and user-matrix builds against the JAX package's on the same
files.  Files byte for byte; ids, known masks and pair lists exactly;
ratings and means within rtol 1e-6."""

import io

import numpy as np
import pytest

from crypto_rec_tpu.io import ingest as jax_ingest
from crypto_rec_tpu.io import readers as jax_readers
from crypto_rec_tpu.io import synth as jax_synth
from crypto_rec_tpu.io import users as jax_users
from crypto_rec_tpu_torch.config import load_config
from crypto_rec_tpu_torch.io import ingest, readers, synth, users

FILES = ("tweets.tsv", "coins.tsv", "lexicon.tsv", "proj2.csv", "cluster.conf")


@pytest.mark.parametrize("seed,kw", [(3, {}), (11, dict(n_users=90, n_tweets=700,
                                                        n_coins=20, emb_dim=8,
                                                        p_header=7))])
def test_synthetic_dataset_is_byte_identical(tmp_path, seed, kw):
    tw, conf = synth.write_synthetic_dataset(str(tmp_path / "port"), seed=seed, **kw)
    jtw, jconf = jax_synth.write_synthetic_dataset(str(tmp_path / "jax"), seed=seed, **kw)
    for name in FILES:
        port = (tmp_path / "port" / name).read_bytes()
        want = (tmp_path / "jax" / name).read_bytes()
        # the conf names its own directory's files
        assert port.replace(b"/port/", b"/jax/") == want, name
    assert tw.endswith("tweets.tsv") and conf.endswith("cluster.conf")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("ingest")
    tw, conf = synth.write_synthetic_dataset(str(out), seed=3)
    cfg = load_config(conf)
    # a duplicate tweet id, a short row and an unparsable lexicon line
    with open(tw, "a") as f:
        f.write("user1\ttw0\tgoodword1\tbitcoin\n")
        f.write("lonely\n")
    with open(cfg.lexicon_file, "a") as f:
        f.write("oddword\tnotanumber\ngoodword0\t9.0\n")
    return tw, cfg


def test_readers_match_jax(dataset):
    tw, cfg = dataset
    got = readers.read_str_vectors(tw, cfg.csv_delimiter, with_header_p=True)
    want = jax_readers.read_str_vectors(tw, cfg.csv_delimiter, with_header_p=True)
    assert got == want and got[1] == 4
    assert readers.read_str_vectors(cfg.query_file, "\t") == \
        jax_readers.read_str_vectors(cfg.query_file, "\t")
    lex = readers.read_lexicon(cfg.lexicon_file, cfg.csv_delimiter)
    assert lex == jax_readers.read_lexicon(cfg.lexicon_file, cfg.csv_delimiter)
    assert lex["goodword0"] != 9.0 and "oddword" not in lex     # first wins
    ids, vec = readers.read_dense_vectors(cfg.proj2_input, ",")
    jids, jvec = jax_readers.read_dense_vectors(cfg.proj2_input, ",")
    assert ids == jids
    np.testing.assert_array_equal(vec, jvec)
    rows, _ = readers.read_str_vectors(cfg.query_file, "\t")
    for coins in ([0, 3, -1, 1], [7]):
        a, b = io.StringIO(), io.StringIO()
        readers.write_recommendations(a, "u9", coins, rows + [["short"]])
        jax_readers.write_recommendations(b, "u9", coins, rows + [["short"]])
        assert a.getvalue() == b.getvalue()


def _batches(dataset):
    tw, cfg = dataset
    rows, _ = readers.read_str_vectors(tw, cfg.csv_delimiter, with_header_p=True)
    coin_rows, _ = readers.read_str_vectors(cfg.query_file, cfg.csv_delimiter)
    lex = readers.read_lexicon(cfg.lexicon_file, cfg.csv_delimiter)
    got = ingest.score_tweets(rows, lex, ingest.CoinTable.from_rows(coin_rows))
    want = jax_ingest.score_tweets(rows, lex, jax_ingest.CoinTable.from_rows(coin_rows))
    return got, want


def test_score_tweets_matches_jax(dataset):
    got, want = _batches(dataset)
    assert got.user_ids == want.user_ids and got.tweet_ids == want.tweet_ids
    assert got.n_tweets == 400 and got.n_coins == want.n_coins == 8
    for f in ("tweet_user", "pair_tweet", "pair_coin"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)
    assert ingest.sentiment_score(3.0) == jax_ingest.sentiment_score(3.0)


def _assert_matrix(got, want):
    assert got.ids == want.ids
    np.testing.assert_array_equal(got.known, want.known)
    np.testing.assert_allclose(got.ratings, want.ratings, rtol=1e-6)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6)
    assert got.ratings.dtype == np.float32 and got.mean.dtype == np.float32


def test_user_matrices_match_jax(dataset):
    got, want = _batches(dataset)
    um = users.build_user_matrix(got)
    _assert_matrix(um, jax_users.build_user_matrix(want))
    assert 0 < um.n_users <= got.n_users and um.n_coins == 8
    rng = np.random.default_rng(0)
    cluster = rng.integers(0, 6, got.n_tweets).astype(np.int32)
    mask = rng.random(got.n_tweets) < 0.8
    for m in (None, mask):
        _assert_matrix(users.build_cluster_user_matrix(got, cluster, 6, m),
                       jax_users.build_cluster_user_matrix(want, cluster, 6, m))


def test_user_matrix_select_matches_jax(dataset):
    """UserMatrix.select: the rows at an index array, in its order (repeats
    and a reversed run included): ratings, known, mean and ids exactly."""
    got, want = _batches(dataset)
    um, jum = users.build_user_matrix(got), jax_users.build_user_matrix(want)
    idx = np.concatenate([np.arange(um.n_users)[::-3], [0, 0, um.n_users - 1]])
    sub, jsub = um.select(idx), jum.select(idx)
    assert isinstance(sub, users.UserMatrix) and sub.n_users == len(idx)
    for f in ("ratings", "known", "mean"):
        np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f), err_msg=f)
        np.testing.assert_array_equal(getattr(sub, f), getattr(um, f)[idx], err_msg=f)
    assert sub.ids == jsub.ids == [um.ids[i] for i in idx]
    assert um.select(np.array([], np.int64)).n_users == 0
