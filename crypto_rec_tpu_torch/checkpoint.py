"""Index checkpointing in the JAX package's npz archive format (v3).

An archive holds a JSON `meta` blob (version, metric, n_buckets, n_rows,
k, L, packed_dtypes) and the index arrays.  bf16 has no numpy dtype
without ml_dtypes, so bf16 slabs are stored as their uint16 bit view with
"bfloat16" recorded in meta["packed_dtypes"] — the same encoding the JAX
package writes, so archives move between the two packages both ways.
Cosine indexes only.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.index import LshIndex, index_from_numpy

_FORMAT_VERSION = 3
_PACKED_FIELDS = ("packed", "packed_rows", "packed_gscale")


def _encode(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def save_index(path: str, index: LshIndex) -> None:
    if index.metric != "cosine":
        raise NotImplementedError("euclidean indexes (ROADMAP Queue 1 item 10)")
    meta = {
        "version": _FORMAT_VERSION,
        "metric": index.metric,
        "n_buckets": index.n_buckets,
        "n_rows": index.n_rows,
        "k": index.family.k,
        "L": index.family.L,
        "packed_dtypes": {},
    }
    arrays = {
        name: _encode(getattr(index, name))[0]
        for name in ("bucket_ids", "sorted_rows", "bucket_starts")
    }
    arrays["proj"] = _encode(index.family.proj)[0]
    for f in _PACKED_FIELDS:
        t = getattr(index, f)
        if t is not None:
            arrays[f], meta["packed_dtypes"][f] = _encode(t)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_index(path: str, device) -> LshIndex:
    """Restore an archive written by either package onto `device`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] not in (1, 2, _FORMAT_VERSION):
            raise ValueError(f"unsupported index version {meta['version']}")
        return index_from_numpy(meta, z, device)
