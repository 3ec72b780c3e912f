"""The one general generator of request traffic, driven by a mix file.

A mix (`portbench/mixes/<name>.json`) states:

- "loop": "closed" (one client sends its next request once the last one
  has returned and synchronised; the only loop the port can take, having
  no request queue);
- "size": {"kind": "pool"} (every row of the pool in each request) or
  {"kind": "fixed", "value": n}; each request takes the first `size` rows
  of a fresh permutation of the pool, drawn from the seed;
- "trace_requests": requests in the traced stretch of a `--trace 1` run;
- "judge_requests": requests kept (a reservoir drawn from the seed) for the
  comparison with the reference once the window has closed.

The pool is the cell's configuration's: its query rows.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def request_size(size: dict, pool: int) -> int:
    """The rows a mix sends in each request."""
    if size["kind"] == "pool":
        n = pool
    elif size["kind"] == "fixed":
        n = int(size["value"])
    else:
        raise ValueError(f"unknown size kind {size['kind']!r}")
    if not 1 <= n <= pool:
        raise ValueError(f"request size {n} outside the pool of {pool}")
    return n


class Traffic:
    """The request sequence of one mix, pool and seed: each request is an
    int64 array of pool rows."""

    def __init__(self, mix: dict, pool: int, seed: int):
        if mix.get("loop") != "closed":
            raise ValueError(f"unknown loop {mix.get('loop')!r}: the port serves a "
                             "closed loop only")
        self.pool = pool
        self.size = request_size(mix["size"], pool)
        self._rng = np.random.default_rng([seed, 1])

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self._rng.permutation(self.pool)[:self.size]

    def warm_up(self, seed: int) -> List[np.ndarray]:
        """One request of the mix's size (its own draw, apart from the
        window's)."""
        return [np.random.default_rng([seed, 2]).permutation(self.pool)[:self.size]]
