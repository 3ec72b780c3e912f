"""Host-side file readers for the reference dataset formats.

Covers the reference's reader surface:
* `file_to_str_vectors` (2 overloads; the 3-arg one reads hyper-parameter P
  from line 1 token 1) — reference lib/utils.cpp:73-127;
* `file_to_lexicon` (word -> sentiment score) — utils.cpp:130-147;
* `VectorReader<T>::read` (id + dense dims, a trailing '\\r' stripped) —
  lib/in_out/vector_reader.hpp:55-85; the serving CLI reads its query
  batches with it;
* the per-user recommendation line of main.cpp:557-569.

These run on the host once per job; the arrays they produce are what
moves to the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _clean(line: str) -> str:
    # Reference strips a single trailing '\r' (utils.cpp:84-85).
    return line.rstrip("\n").rstrip("\r")


def read_str_vectors(
    path: str, delimiter: str, with_header_p: bool = False
) -> Tuple[List[List[str]], Optional[int]]:
    """Read a file of delimiter-separated token rows.

    When ``with_header_p`` the first line is a metadata line whose second
    token is the hyper-parameter P (utils.cpp:95-113).  Returns (rows, P);
    P is None when not requested or absent.
    """
    rows: List[List[str]] = []
    p_value: Optional[int] = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        if with_header_p:
            toks = _clean(f.readline()).split(delimiter)
            if len(toks) > 1:
                try:
                    p_value = int(toks[1])
                except ValueError:
                    p_value = None
        for line in f:
            line = _clean(line)
            if line == "":
                continue
            rows.append(line.split(delimiter))
    return rows, p_value


def read_lexicon(path: str, delimiter: str) -> Dict[str, float]:
    """word -> score map (utils.cpp:130-147; first-wins on duplicates like
    unordered_map::emplace)."""
    lex: Dict[str, float] = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = _clean(line).split(delimiter)
            if len(toks) < 2 or toks[0] in lex:
                continue
            try:
                lex[toks[0]] = float(toks[1])
            except ValueError:
                continue
    return lex


def read_dense_vectors(
    path: str, delimiter: str, skip_lines: int = 0, dtype=np.float32
) -> Tuple[List[str], np.ndarray]:
    """Read "id delim v1 delim v2 ..." rows into (ids, [n, d] array).

    Mirrors VectorReader<T>::read with strt_line semantics (the reference
    passes strt_line=1 meaning skip 0 lines — vector_reader.hpp:60-66).
    """
    ids: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for _ in range(skip_lines):
            f.readline()
        for line in f:
            line = _clean(line)
            if line == "":
                continue
            toks = line.split(delimiter)
            ids.append(toks[0])
            rows.append(np.asarray([float(t) for t in toks[1:] if t != ""], dtype=dtype))
    if not rows:
        return ids, np.zeros((0, 0), dtype=dtype)
    return ids, np.stack(rows)


def write_recommendations(
    os_handle,
    user_id: str,
    coin_indexes,
    coin_queries: List[List[str]],
    name_index: int = 4,
) -> None:
    """Write one user's recommendation line.

    The reference prints token `name_index` of the coin's variation row,
    falling back to token 0 when the row is shorter (main.cpp:557-569).
    Negative indexes (the fill for "fewer unknown coins than N") are
    skipped; the reference printed garbage there (crypto_rec.hpp:322).
    """
    parts = [user_id]
    for idx in coin_indexes:
        idx = int(idx)
        if idx < 0:
            continue
        row = coin_queries[idx]
        parts.append(row[name_index] if len(row) > name_index else row[0])
    os_handle.write(" ".join(parts) + "\n")
