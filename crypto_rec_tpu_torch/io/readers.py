"""Host-side reader for the reference's dense-vector file format.

`VectorReader<T>::read` (reference lib/in_out/vector_reader.hpp:55-85): one
row per line, an id followed by the dimensions, a trailing '\\r' stripped.
The serving CLI reads its query batches with it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _clean(line: str) -> str:
    # Reference strips a single trailing '\r' (utils.cpp:84-85).
    return line.rstrip("\n").rstrip("\r")


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
