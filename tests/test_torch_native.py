"""The native C++ ingest (io/native.py) against the Python `score_tweets`
and the JAX package's `score_tweets_native` on synthetic datasets.

Against the port's Python path every array is equal exactly: the port's
C++ parses lexicon scores as doubles, as Python's float() does.  The JAX
package's C++ parses them as floats (std::stof), so its f32 scores sit up
to one f32 ulp from both (measured: 359 of 3,000 tweets on seed 21); ids,
users, tweet -> user and the (tweet, coin) pairs are equal exactly.
"""

import os

import numpy as np
import pytest

from crypto_rec_tpu.io.native import score_tweets_native as jax_native
from crypto_rec_tpu_torch.io import native
from crypto_rec_tpu_torch.io.ingest import CoinTable, score_tweets
from crypto_rec_tpu_torch.io.readers import read_lexicon, read_str_vectors
from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset


@pytest.fixture(scope="module", params=[(800, 21, 4), (3000, 5, 20)],
                ids=["small", "header-p20"])
def dataset(request, tmp_path_factory):
    n_tweets, seed, p = request.param
    out = tmp_path_factory.mktemp("native")
    tweets, _ = write_synthetic_dataset(str(out), n_tweets=n_tweets, seed=seed,
                                        p_header=p)
    return str(out), tweets, p


def _paths(root):
    return f"{root}/lexicon.tsv", f"{root}/coins.tsv"


def test_native_equals_python_exactly(dataset):
    root, tweets, p = dataset
    lex, coins = _paths(root)
    rows, p_py = read_str_vectors(tweets, "\t", with_header_p=True)
    py = score_tweets(rows, read_lexicon(lex, "\t"),
                      CoinTable.from_rows(read_str_vectors(coins, "\t")[0]))
    nat = native.score_tweets_native(tweets, lex, coins, "\t")
    assert native.read_header_p(tweets, "\t") == p_py == p
    assert nat.user_ids == py.user_ids and nat.tweet_ids == py.tweet_ids
    assert nat.n_coins == py.n_coins
    for f in ("tweet_user", "scores", "pair_tweet", "pair_coin"):
        a, b = getattr(nat, f), getattr(py, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_native_matches_jax_native(dataset):
    root, tweets, _ = dataset
    lex, coins = _paths(root)
    want = jax_native(tweets, lex, coins, "\t")
    got = native.score_tweets_native(tweets, lex, coins, "\t")
    assert got.user_ids == want.user_ids and got.tweet_ids == want.tweet_ids
    for f in ("tweet_user", "pair_tweet", "pair_coin"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    ulp = np.spacing(np.abs(want.scores).astype(np.float32))
    assert (np.abs(got.scores - want.scores) <= ulp).all()


def test_missing_file_raises(dataset):
    root, tweets, _ = dataset
    with pytest.raises(IOError):
        native.score_tweets_native(tweets, f"{root}/nope.tsv", f"{root}/coins.tsv", "\t")


def test_library_lives_in_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The port builds its own copy into build/native/ under a source hash,
    never into native/; a source g++ rejects raises with g++'s stderr."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.name == "native"
    assert path.parent.parent.name == "build" and native.SRC.parent.name == "io"
    native.load_library()
    assert path.exists()
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)      # the loaded library is forgotten
    with pytest.raises(RuntimeError, match="g\\+\\+ ingest.cpp failed"):
        native.load_library()
    assert not os.listdir(tmp_path / "build") or all(
        not n.endswith(".so") for n in os.listdir(tmp_path / "build"))


def test_native_available_and_rebuild(tmp_path, monkeypatch):
    """native_available() is True where the library builds (as the JAX
    package's is here); load_library(rebuild=True) compiles it again even
    though it is built and loaded; where g++ fails native_available()
    returns False instead of raising."""
    from crypto_rec_tpu.io.native import native_available as jax_native_available

    assert native.native_available() is True is jax_native_available()
    path = native.library_path()
    native.load_library()
    before = os.stat(path).st_ino
    lib = native.load_library(rebuild=True)
    assert os.stat(path).st_ino != before              # a new file was written
    assert native.load_library() is lib
    bad = tmp_path / "ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available() is False
