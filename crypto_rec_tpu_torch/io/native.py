"""ctypes bridge to the native C++ ingest (`io/ingest.cpp`).

The reference's whole ingest is C++ (reference lib/utils.cpp:73-147,
lib/data_structures/tweet.cpp); this is a compiled tokenizer and scorer
whose output arrays equal the Python `score_tweets` (io/ingest.py) array
for array.  The source is the package's own copy; it is built with
`g++ -O3 -std=c++17 -shared -fPIC` at first use into `build/native/` at the
repository root, under a file name that carries a hash of the source, so a
stale library is never loaded.  A failed build raises with g++'s stderr:
nothing falls back to the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from crypto_rec_tpu_torch.io.ingest import TweetBatch

SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libcrt_ingest_{h.hexdigest()[:16]}.so"


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build(out: Path) -> None:
    """Compile the library to `out` in a private directory, then rename:
    concurrent builds never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, out.name)
        res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", lib_tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ {SRC.name} failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(lib_tmp, out)


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """The ingest library, compiled on first use (raises on failure);
    rebuild=True compiles it again even when it is built and loaded."""
    global _lib
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        out = library_path()
        if rebuild or not out.exists():
            _build(out)
        _lib = _bind(ctypes.CDLL(str(out)))
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (False, not an error,
    where g++ or the loader fails)."""
    try:
        load_library()
        return True
    except (OSError, RuntimeError):
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C functions' argument and result types."""
    lib.crt_ingest_run.restype = ctypes.c_void_p
    lib.crt_ingest_run.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char, ctypes.c_int]
    for fn in ("crt_n_tweets", "crt_n_users", "crt_n_pairs"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.crt_n_coins.restype = ctypes.c_int32
    lib.crt_n_coins.argtypes = [ctypes.c_void_p]
    lib.crt_fill.restype = None
    lib.crt_fill.argtypes = [ctypes.c_void_p] * 5
    lib.crt_ids_nbytes.restype = ctypes.c_int64
    lib.crt_ids_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.crt_ids_fill.restype = None
    lib.crt_ids_fill.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.crt_free.restype = None
    lib.crt_free.argtypes = [ctypes.c_void_p]
    return lib


def _ids(lib, h, which: int, n: int):
    """All user (which 0) or tweet (which 1) ids in one native call."""
    if n == 0:
        return []
    buf = ctypes.create_string_buffer(lib.crt_ids_nbytes(h, which))
    lib.crt_ids_fill(h, which, buf)
    return buf.raw.decode().split("\n")


def read_header_p(path: str, delimiter: str) -> Optional[int]:
    """Hyper-parameter P from the tweets file's first line (its second
    token), as `read_str_vectors(with_header_p=True)` reads it; None when
    absent."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        toks = f.readline().rstrip("\n").rstrip("\r").split(delimiter)
    try:
        return int(toks[1]) if len(toks) > 1 else None
    except ValueError:
        return None


def score_tweets_native(
    tweets_path: str,
    lexicon_path: str,
    coins_path: str,
    delimiter: str,
    has_header: bool = True,
) -> TweetBatch:
    """File-level ingest: read_str_vectors + read_lexicon + score_tweets in
    one native pass.  has_header skips the tweets file's "P <value>" line."""
    lib = load_library()
    h = lib.crt_ingest_run(tweets_path.encode(), lexicon_path.encode(),
                           coins_path.encode(), delimiter.encode()[0:1],
                           1 if has_header else 0)
    if not h:
        raise IOError(f"native ingest failed to open one of: {tweets_path}, "
                      f"{lexicon_path}, {coins_path}")
    try:
        n_t, n_p = lib.crt_n_tweets(h), lib.crt_n_pairs(h)
        tweet_user = np.empty(n_t, np.int32)
        scores = np.empty(n_t, np.float32)
        pair_tweet = np.empty(n_p, np.int32)
        pair_coin = np.empty(n_p, np.int32)
        lib.crt_fill(h, *(a.ctypes.data_as(ctypes.c_void_p)
                          for a in (tweet_user, scores, pair_tweet, pair_coin)))
        return TweetBatch(
            user_ids=_ids(lib, h, 0, lib.crt_n_users(h)), tweet_ids=_ids(lib, h, 1, n_t),
            tweet_user=tweet_user, scores=scores, pair_tweet=pair_tweet,
            pair_coin=pair_coin, n_coins=int(lib.crt_n_coins(h)),
        )
    finally:
        lib.crt_free(h)
