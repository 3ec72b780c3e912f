"""Index and user-matrix checkpointing in the JAX package's npz formats.

Index archives (v3):

An archive holds a JSON `meta` blob (version, metric, n_buckets, n_rows,
k, L, w for euclidean tables, packed_dtypes) and the index arrays: the hash
family (proj; euclidean offsets and weights), the CSR tables, euclidean
`detailed` fingerprints, and the packed fields that are present.  bf16 has
no numpy dtype without ml_dtypes, so bf16 slabs are stored as their uint16
bit view with "bfloat16" recorded in meta["packed_dtypes"] — the same
encoding the JAX package writes, so archives move between the two packages
both ways.  A user-matrix archive holds ratings, known, mean and the user
ids as a unicode array (`save_user_matrix`), as the JAX package's does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from crypto_rec_tpu_torch.io.users import UserMatrix
from crypto_rec_tpu_torch.models.lsh.index import (
    PACKED_FIELDS, LshIndex, index_from_numpy,
)
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh

_FORMAT_VERSION = 3


def _encode(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def save_index(path: str, index: LshIndex) -> None:
    fam = index.family
    meta = {
        "version": _FORMAT_VERSION,
        "metric": index.metric,
        "n_buckets": index.n_buckets,
        "n_rows": index.n_rows,
        "k": fam.k,
        "L": fam.L,
        "packed_dtypes": {},
    }
    arrays = {
        name: _encode(getattr(index, name))[0]
        for name in ("bucket_ids", "sorted_rows", "bucket_starts")
    }
    arrays["proj"] = _encode(fam.proj)[0]
    if index.metric != "cosine":
        meta["w"] = fam.w
        arrays["offsets"] = _encode(fam.offsets)[0]
        arrays["weights"] = _encode(fam.weights)[0]
        arrays["detailed"] = _encode(index.detailed)[0]
    for f in PACKED_FIELDS:
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
        if meta["metric"] != "cosine" and meta["version"] < 3:
            raise ValueError(
                "euclidean index archives before v3 store raw h-tuples; "
                "rebuild and re-save the index (detailed hashes are now "
                "[L, n] fingerprints)"
            )
        return index_from_numpy(meta, z, device)


_SHARD_FIELDS = ("sorted_rows", "bucket_starts", "detailed") + PACKED_FIELDS


def save_sharded_index(prefix: str, index, mesh=None) -> list:
    """Per-shard save of a ShardedLshIndex: {prefix}.meta.npz (the hash
    family, kind "sharded", version 3) and one {prefix}.shardNNN.npz per
    shard, the JAX package's layout.  A rank writes only shards it holds;
    with `mesh`, only those of its cells in dp row 0 (and the meta file
    with cell (0, 0)), so dp replicas never write one file twice.
    -> the paths written."""
    fam = index.family
    meta = {"version": _FORMAT_VERSION, "kind": "sharded", "metric": index.metric,
            "n_buckets": index.n_buckets, "n_local": index.n_local,
            "n_shards": index.n_shards, "packed_dtypes": {},
            "has_detailed": index.detailed is not None, "k": fam.k, "L": fam.L}
    fam_arrays = {"proj": _encode(fam.proj)[0]}
    if index.metric != "cosine":
        meta["w"] = fam.w
        fam_arrays["offsets"] = _encode(fam.offsets)[0]
        fam_arrays["weights"] = _encode(fam.weights)[0]
    fields = {f: getattr(index, f) for f in _SHARD_FIELDS if getattr(index, f) is not None}
    for f, t in fields.items():
        if f in PACKED_FIELDS:
            meta["packed_dtypes"][f] = _encode(t[:0])[1]
    writes = set(index.shards) if mesh is None else {j for i, j in mesh.cells if i == 0}
    paths = []
    if 0 in writes:
        paths.append(f"{prefix}.meta.npz")
        np.savez_compressed(paths[0], meta=json.dumps(meta), **fam_arrays)
    for p, s in enumerate(index.shards):
        if s in writes:
            paths.append(f"{prefix}.shard{s:03d}.npz")
            np.savez_compressed(paths[-1], **{f: _encode(t[p])[0] for f, t in fields.items()})
    return paths


def load_sharded_index(prefix: str, mesh):
    """Restore this rank's shards (`mesh.local_shards`) of a sharded
    checkpoint written by either package onto the mesh's device; the
    checkpoint's shard count must equal the mesh's mp axis."""
    from crypto_rec_tpu_torch.models.lsh.index import array_getter, family_from_numpy
    from crypto_rec_tpu_torch.parallel.sharded_index import ShardedLshIndex

    with np.load(f"{prefix}.meta.npz", allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION or meta.get("kind") != "sharded":
            raise ValueError("not a sharded index checkpoint")
        fam = family_from_numpy(meta, z, mesh.device)
    S = meta["n_shards"]
    if mesh.mp != S:
        raise ValueError(f"checkpoint has {S} shards but mesh mp axis is {mesh.mp}")
    blocks = {}
    for s in mesh.local_shards:
        with np.load(f"{prefix}.shard{s:03d}.npz", allow_pickle=False) as z:
            get = array_getter(meta, z, mesh.device)
            for f in z.keys():
                blocks.setdefault(f, []).append(get(f))
    fields = {f: torch.stack(b) for f, b in blocks.items()}
    return ShardedLshIndex(
        metric=meta["metric"], n_buckets=meta["n_buckets"], n_local=meta["n_local"],
        n_shards=S, family=fam, shards=tuple(mesh.local_shards),
        sorted_rows=fields["sorted_rows"], bucket_starts=fields["bucket_starts"],
        detailed=fields.get("detailed"), **{f: fields.get(f) for f in PACKED_FIELDS},
    )


def save_user_matrix(path: str, um: UserMatrix) -> None:
    np.savez_compressed(path, ratings=um.ratings, known=um.known, mean=um.mean,
                        ids=np.asarray(um.ids, dtype=str))


def load_user_matrix(path: str) -> UserMatrix:
    with np.load(path, allow_pickle=False) as z:
        return UserMatrix(ratings=z["ratings"], known=z["known"], mean=z["mean"],
                          ids=[str(s) for s in z["ids"]])


def index_nbytes(index: LshIndex) -> int:
    """Device bytes of the index's arrays (the reference's getSize()
    counters, cust_hashtable.hpp:128-138), counted as the JAX package
    counts them: the tables, fingerprints, slabs, slab row ids, norms,
    per-row scales and the hash family (the scalar scales aside)."""
    total = 0
    for t in (index.bucket_ids, index.sorted_rows, index.bucket_starts, index.detailed,
              index.packed, index.packed_rows, index.packed_sqnorm,
              index.packed_detailed, index.packed_scale):
        if t is not None:
            total += t.numel() * t.element_size()
    fam = index.family
    total += fam.proj.numel() * fam.proj.element_size()
    if isinstance(fam, PStableLsh):
        total += fam.offsets.numel() * 4 + fam.weights.numel() * 4
    return int(total)
