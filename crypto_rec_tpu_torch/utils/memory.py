"""Device-memory accounting.

The reference hand-rolls getSize() byte counters on every index class
(cust_hashtable.hpp:128-138, vector_bucket.hpp:57-63).  Here the
equivalents are (a) the exact bytes of the tensors that make up an index
(checkpoint.index_nbytes) and (b) the CUDA caching allocator's own
counters.
"""

from __future__ import annotations

from typing import Dict

import torch


def live_array_bytes() -> int:
    """Bytes of live tensors on every CUDA device (the caching allocator's
    allocated bytes; 0 without CUDA)."""
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-device allocator stats ({} without CUDA)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}


def format_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PiB"
