"""Hypercube LSH with Hamming-distance and query-directed probing.

Reference semantics (reference lib/lsh_cube.hpp:108-177), as the JAX
package's `models/lsh/hypercube.py`:
* k bit functions map each vector to a vertex of a k-cube (2^k buckets).
  Cosine: hyperplane signs, hashed through K2 with L = 1.  Euclidean: bit
  i is a stateless integer mix of the p-stable h-value h_i(x) (`_f_bits`),
  standing in for EuclideanFGen's memoized random bit;
* a query visits `probes` vertices, home first: in Hamming order on the
  reference-parity paths (`cube_candidate_mask`, `cube_candidate_ids`),
  by summed bit margins on the retrieval paths (`directed_probe_vertices`).

Retrieval rides K1 in shared-slab mode: the corpus is packed once in
vertex-CSR order (`pack_cube`), a query's `probes` vertex windows are
regrouped as probes/8 replicated query rows of 8 windows, and the
MultiCube lays C cubes' slabs end to end so one launch scores all
C x probes windows.  Euclidean cubes use the augmented rank layout of
`index.pack_index`.  Other slabs (per-row int8, unaugmented euclidean,
probes % 8 != 0) take the blocked branch of `cube_retrieve_topk`:
`index.packed_retrieve_core` with the probes as windows over the one slab.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.index import (
    PACKED_FIELDS, _csr_from_buckets, _dedup_fixed, array_getter, family_from_numpy,
    pack_tables, packed_retrieve_core, rerank_exact,
)
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh, wrap_int32
from crypto_rec_tpu_torch.ops.hamming import hamming_probe_order
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _dedup_topk_pairs, _window_offsets, augment_queries, rank_to_distance,
    slab_window_dots,
)
from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
from crypto_rec_tpu_torch.ops.topk import topk_asc

_GROUP = 8      # windows per replicated query row of the shared-slab launch


@dataclasses.dataclass
class Hypercube:
    """One 2^k-bucket table keyed by cube vertex, with the optional
    single-table packed layout of pack_cube."""

    metric: str
    k: int
    n_rows: int
    family: Union[CosineLsh, PStableLsh]   # L = 1
    mix_mul: Optional[torch.Tensor]   # [k] int32 odd multipliers (euclidean)
    mix_add: Optional[torch.Tensor]   # [k] int32
    vertices: torch.Tensor            # [n] int32 vertex per indexed row
    sorted_rows: torch.Tensor         # [1, n]
    bucket_starts: torch.Tensor       # [1, 2^k + 1]
    packed: Optional[torch.Tensor] = None        # [1, n + pad, d or d_aug]
    packed_rows: Optional[torch.Tensor] = None   # [1, n + pad]
    packed_sqnorm: Optional[torch.Tensor] = None  # [1, n + pad] (euclidean)
    packed_scale: Optional[torch.Tensor] = None   # [1, n + pad] (row int8)
    packed_gscale: Optional[torch.Tensor] = None
    packed_aug_scale: Optional[torch.Tensor] = None


def _f_bits(h: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """Pseudorandom bit per (function, h-value): the parity of a mixed
    product in int32 wrap-around with arithmetic shifts, computed in int64
    (each product stays below 2^62) and wrapped explicitly."""
    mixed = wrap_int32(h.long() * mul.long()[None, :] + add.long()[None, :])
    mixed = mixed ^ wrap_int32((mixed >> 16) * 0x45D9F3B)
    return (mixed ^ (mixed >> 8)) & 1


def _pack_msb_first(bits: torch.Tensor, k: int) -> torch.Tensor:
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=bits.device),
        torch.arange(k - 1, -1, -1, device=bits.device),
    )
    return torch.sum(bits.long() * weights, dim=-1).to(torch.int32)


def _vertex_ids(metric, k, family, mix_mul, mix_add, x: torch.Tensor) -> torch.Tensor:
    """[n, d] -> [n] int32 vertex ids, bits packed MSB-first."""
    if metric == "cosine":
        return family.bucket_ids(x)[:, 0]       # K2 with L = 1
    h = family.hash_values(x)[:, 0, :]           # [n, k]
    return _pack_msb_first(_f_bits(h, mix_mul, mix_add), k)


def build_hypercube(
    generator: Optional[torch.Generator],
    vectors: torch.Tensor,
    metric: str,
    k: int,
    euclidean_h_w: float,
    family: Union[CosineLsh, PStableLsh, None] = None,
    mix_mul: Optional[torch.Tensor] = None,
    mix_add: Optional[torch.Tensor] = None,
) -> Hypercube:
    """create_hypercube (lsh_cube.hpp:108-136).  Parameters come from
    `generator` unless `family` (and, euclidean, mix_mul / mix_add) hand
    them over."""
    d = vectors.shape[1]
    dev = vectors.device
    if metric == "cosine":
        if family is None:
            family = CosineLsh.create(generator, d, k, 1, dev)
    elif metric == "euclidean":
        if family is None:
            family = PStableLsh.create(generator, d, k, 1, euclidean_h_w, dev)
            gdev = generator.device
            mix_mul = torch.randint(0, 1 << 30, (k,), generator=generator,
                                    dtype=torch.int32, device=gdev).to(dev) * 2 + 1
            mix_add = torch.randint(0, 1 << 30, (k,), generator=generator,
                                    dtype=torch.int32, device=gdev).to(dev)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    vertices = _vertex_ids(metric, k, family, mix_mul, mix_add, vectors)
    sorted_rows, starts = _csr_from_buckets(vertices[:, None], 1 << k)
    return Hypercube(
        metric=metric, k=k, n_rows=vectors.shape[0], family=family,
        mix_mul=mix_mul, mix_add=mix_add, vertices=vertices,
        sorted_rows=sorted_rows, bucket_starts=starts,
    )


def _bit_margins(cube: Hypercube, queries: torch.Tensor) -> torch.Tensor:
    """[q, k] confidence per cube bit: cosine |r_i . x|; euclidean f-bits
    change only with the p-stable cell, so the distance of (v.x + t)/w to
    the nearest cell boundary."""
    dots = torch.matmul(queries.float(), cube.family.proj)          # [q, k]
    if cube.metric == "cosine":
        return torch.abs(dots)
    z = (dots + cube.family.offsets[0][None]) / cube.family.w
    frac = z - torch.floor(z)
    return torch.minimum(frac, 1.0 - frac)


def directed_probe_vertices(
    cube: Hypercube, queries: torch.Tensor, probes: int,
    m_bits: Optional[int] = None,
) -> torch.Tensor:
    """Query-directed multiprobe (Lv et al., VLDB'07): [q, d] -> [q, probes]
    int32 vertex ids, home vertex first.  Each query enumerates the subsets
    of its m = min(m_bits, k, 13) least-confident bits (m_bits None: 2
    beyond ceil(log2(probes))), scores a subset by its summed margin and
    probes the `probes` lowest; the empty subset scores 0, so home leads.
    Equal margins and equal subset scores go to the lower bit or subset
    index (`topk_asc`), as JAX's `lax.top_k` of the negated values.  The
    XOR masks are built with integer ops from the selected subset indices.
    With fewer than `probes` subsets (tiny k) the rest are mask 0, the home
    vertex again."""
    k = cube.k
    margins = _bit_margins(cube, queries)                            # [q, k]
    if m_bits is None:
        m_bits = (max(2, probes - 1)).bit_length() + 2
    m = min(m_bits, k, 13)                                           # <= 8192 subsets
    small, pos = topk_asc(margins, m)                                # [q, m] ascending
    dev = margins.device
    subsets = (torch.arange(1 << m, device=dev)[:, None]
               >> torch.arange(m, device=dev)[None, :]) & 1          # [2^m, m]
    score = small @ subsets.float().T                                # [q, 2^m]
    _, sel = topk_asc(score, min(probes, 1 << m))
    bitw = torch.bitwise_left_shift(torch.ones_like(pos), k - 1 - pos)   # MSB-first
    masks = torch.zeros_like(sel)
    for j in range(m):
        masks += ((sel >> j) & 1) * bitw[:, j:j + 1]
    if masks.shape[1] < probes:
        masks = torch.nn.functional.pad(masks, (0, probes - masks.shape[1]))
    home = _vertex_ids(cube.metric, k, cube.family, cube.mix_mul, cube.mix_add, queries)
    return (home[:, None].long() ^ masks).to(torch.int32)


def _hamming_probe_vertices(cube: Hypercube, queries: torch.Tensor, probes: int):
    """[q, probes] home vertex XOR the reference's Hamming-order masks."""
    home = _vertex_ids(cube.metric, cube.k, cube.family, cube.mix_mul,
                       cube.mix_add, queries)
    masks = torch.tensor(hamming_probe_order(cube.k, probes), device=home.device)
    return home[:, None] ^ masks[None, :]


def _probe_vertices(cube, queries, probes, directed):
    if directed:
        return directed_probe_vertices(cube, queries, probes)
    return _hamming_probe_vertices(cube, queries, probes)


def cube_candidate_mask(cube: Hypercube, queries: torch.Tensor, probes: int) -> torch.Tensor:
    """Dense [q, n] mask — union of buckets over the Hamming probe
    schedule (get_hypercube_combined_buckets, lsh_cube.hpp:139-177)."""
    pv = _hamming_probe_vertices(cube, queries, probes)              # [q, p]
    return torch.any(pv[:, :, None] == cube.vertices[None, None, :], dim=1)


def cube_candidate_ids(
    cube: Hypercube, queries: torch.Tensor, probes: int, budget: int
) -> torch.Tensor:
    """CSR fixed-budget probe: [q, d] -> [q, budget] int32 row ids (-1
    pad).  Any single probed vertex may supply the whole budget (the
    reference unions whole buckets, lsh_cube.hpp:139-177)."""
    n = cube.n_rows
    pv = _hamming_probe_vertices(cube, queries, probes).long()       # [q, p]
    starts = cube.bucket_starts[0].long()
    offs = starts[pv][..., None] + torch.arange(budget, device=pv.device)
    rows = cube.sorted_rows[0][torch.clamp(offs, max=n - 1)]
    gathered = torch.where(offs < starts[pv + 1][..., None], rows, n)
    return _dedup_fixed(gathered.reshape(pv.shape[0], -1), n, budget)


def pack_cube(
    cube: Hypercube,
    corpus: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> Hypercube:
    """Attach the packed layout: the corpus in vertex-CSR order, [1, n +
    pad, d or d_aug] (pack_index for the cube's one table, `pack_tables`).
    Cosine rows are normalized; int8 shares one global scale for cosine
    and keeps per-row scales (`packed_scale`) for unaugmented euclidean
    slabs, which also carry `packed_sqnorm`; augment=True (euclidean)
    stores the rank layout [x, -|x|^2/2, 0-pad]."""
    return dataclasses.replace(
        cube, **pack_tables(cube.sorted_rows, corpus, cube.metric, dtype, pad,
                            scale_mode, augment))


def _shared_slab_topk(dots, a_flat, rows_flat, n_rows, top_k):
    """PER-WINDOW stage 1 (`window_topk`, S1 on the card) over shared-slab
    dots [q*R, 8, win] (the LSH production epilogue with absolute window
    offsets a_flat [q, T] into rows_flat), then the id-dedup to top_k."""
    q, T = a_flat.shape
    win = dots.shape[2]
    kk = min(top_k, win)
    s1, lane = window_topk(dots.reshape(q * T, win), kk)
    s1 = s1.reshape(q, T * kk)
    gpos = (a_flat.long()[:, :, None] + lane.reshape(q, T, kk)).reshape(q, T * kk)
    ids1 = rows_flat[torch.clamp(gpos, max=rows_flat.shape[0] - 1)]
    ids1 = torch.where(s1 > float("-inf"), ids1, n_rows)
    return _dedup_topk_pairs(s1, ids1, n_rows, top_k)


def _grouped_dots(packed, s0, sizes, q_kernel, per_probe):
    """The [q, T] windows as T/8 replicated query rows of 8 windows each
    (the JAX form, hypercube.py:461-468): one shared-slab K1 launch ->
    dots [q*R, 8, win]."""
    q, T = s0.shape
    R = T // _GROUP
    return slab_window_dots(
        packed, s0.reshape(q * R, _GROUP), sizes.reshape(q * R, _GROUP),
        q_kernel.repeat_interleave(R, dim=0), per_probe, mask=False,
        shared_slab=True,
    )


def cube_retrieve_topk(
    cube: Hypercube,
    queries: torch.Tensor,   # [q, d]
    corpus: torch.Tensor,    # [n, d] — unused by the kernel branches
    top_k: int,
    probes: int,
    per_probe: int = 256,
    directed: bool = True,
    q_block: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused hypercube retrieval over the packed layout: probe vertices ->
    per-vertex slab windows -> scores -> dedup top-k.  Takes the JAX
    package's branches under its conditions (hypercube.py:344-403):
    scale-free cosine slabs, or augmented euclidean slabs, with a
    128-multiple width, n_pad >= per_probe + 160 and probes % 8 == 0 ride
    shared-slab K1; any other layout takes the blocked branch,
    `packed_retrieve_core` with the probes as windows over the one slab, in
    query blocks of q_block, int8 slabs over-fetching min(4 top_k, probes
    top_k) and reranking exactly against `corpus`.  directed=False probes
    in the reference's Hamming order.

    -> (scores [q, top_k] descending nearest-first, row ids, -1 pad)."""
    if cube.packed is None:
        raise ValueError("pack_cube first (packed layout required)")
    kernel_shape = (cube.packed.shape[-1] % 128 == 0
                    and cube.packed.shape[1] >= per_probe + 160
                    and probes % 8 == 0)
    if kernel_shape and cube.metric == "cosine" and cube.packed_scale is None:
        return _cube_retrieve_kernel(cube, queries, top_k, probes, per_probe,
                                     directed=directed)
    if kernel_shape and cube.packed_aug_scale is not None:
        return _cube_retrieve_kernel_euclid(cube, queries, top_k, probes,
                                            per_probe, directed=directed)
    if cube.packed_aug_scale is not None:
        raise ValueError("augmented cube slabs are kernel-only (probes % 8 == 0 "
                         "and 128-multiple padded width required)")
    quantized = not cube.packed.dtype.is_floating_point
    core_k = min(4 * top_k, probes * top_k) if quantized else top_k
    pv = _probe_vertices(cube, queries, probes, directed)
    s, ids = packed_retrieve_core(
        cube.packed, cube.packed_rows, cube.packed_sqnorm, None, cube.bucket_starts,
        cube.n_rows, cube.metric, queries, pv, None, core_k, per_probe,
        packed_scale=cube.packed_scale, q_block=q_block)
    if quantized:
        return rerank_exact(corpus, cube.metric, queries, ids, top_k)
    return s, ids


def cube_windows(cube: Hypercube, queries: torch.Tensor, probes: int,
                 per_probe: int, directed: bool = True):
    """-> (s0, sizes) [q, probes]: each probed vertex's window in the cube's
    one CSR table, salted by probe index (hypercube.py:440-450)."""
    pv = _probe_vertices(cube, queries, probes, directed)
    return _window_offsets(cube.bucket_starts.expand(probes, -1), pv, per_probe)


def _cube_retrieve_kernel(cube, queries, top_k, probes, per_probe, directed=True):
    """Cosine cube on shared-slab K1: maskless windows, a flat stage 1 of
    max(4 top_k, 16) lanes, dedup; int8 dots dequantized by the
    global scale."""
    q = queries.shape[0]
    qv = queries.float()
    qv = qv / torch.clamp(torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True)), min=1e-30)
    s0, sizes = cube_windows(cube, queries, probes, per_probe, directed)
    dots, a0 = _grouped_dots(cube.packed, s0, sizes, qv, per_probe)
    win = dots.shape[2]
    n_pad = cube.packed.shape[1]
    m1 = min(max(4 * top_k, 2 * _GROUP), probes * win)
    s1, pos1 = window_topk(dots.reshape(q, probes * win), m1)
    t_of = torch.div(pos1, win, rounding_mode="floor")
    gpos = torch.gather(a0.reshape(q, probes).long(), 1, t_of) + pos1 % win
    ids1 = cube.packed_rows[0][torch.clamp(gpos, max=n_pad - 1)]
    ids1 = torch.where(s1 > float("-inf"), ids1, cube.n_rows)
    s2, ids = _dedup_topk_pairs(s1, ids1, cube.n_rows, top_k)
    if cube.packed_gscale is not None:
        s2 = torch.where(ids >= 0, s2 * cube.packed_gscale, float("-inf"))
    return s2, ids


def _cube_retrieve_kernel_euclid(cube, queries, top_k, probes, per_probe,
                                 directed=True):
    """Euclidean cube on shared-slab K1 over augmented slabs: per-window
    stage 1, dedup, then rank -> -distance."""
    q = queries.shape[0]
    s0, sizes = cube_windows(cube, queries, probes, per_probe, directed)
    q_aug = augment_queries(queries, cube.packed_aug_scale, cube.packed.shape[2])
    dots, a0 = _grouped_dots(cube.packed, s0, sizes, q_aug, per_probe)
    rank, ids = _shared_slab_topk(dots, a0.reshape(q, probes), cube.packed_rows[0],
                                  cube.n_rows, top_k)
    return rank_to_distance(rank, ids, queries, cube.packed_gscale)


@dataclasses.dataclass
class MultiCube:
    """C independent hypercubes over one corpus, their slabs laid end to
    end as ONE shared slab, so one K1 launch scores every cube's windows
    (a single cube's recall plateaus where a near neighbour differs in a
    confident bit; independent cubes make those misses independent).
    Euclidean cubes use the augmented rank layout; every segment has the
    same scales (same row set), which build_multicube checks."""

    metric: str
    k: int
    n_rows: int
    n_cubes: int
    n_pad: int                        # per-cube segment length
    cubes: tuple                      # C unpacked Hypercubes (families + mixes)
    packed: torch.Tensor              # [1, C * n_pad, d or d_aug]
    packed_rows: torch.Tensor         # [1, C * n_pad]
    bucket_starts: torch.Tensor       # [C, 2^k + 1], segment-local
    packed_gscale: Optional[torch.Tensor] = None
    packed_aug_scale: Optional[torch.Tensor] = None


def _same_scale(a, b) -> bool:
    return (a is None) == (b is None) and (a is None or bool(torch.equal(a, b)))


def build_multicube(
    generator: torch.Generator,
    vectors: torch.Tensor,
    metric: str,
    n_cubes: int,
    k: int,
    euclidean_h_w: float,
    corpus_dtype: torch.dtype = torch.bfloat16,
    pad: int = 4096,
) -> MultiCube:
    """C build_hypercube + pack_cube (euclidean: augment=True), the slabs
    copied into one [1, C * n_pad, d] shared slab.  Raises if two
    segments' gscale or aug_scale differ."""
    cubes, starts = [], []
    packed = rows = None
    for ci in range(n_cubes):
        cube = build_hypercube(generator, vectors, metric, k, euclidean_h_w)
        pc = pack_cube(cube, vectors, dtype=corpus_dtype, pad=pad,
                       augment=metric == "euclidean")
        n_pad = pc.packed.shape[1]
        if packed is None:
            packed = torch.empty(1, n_cubes * n_pad, pc.packed.shape[2],
                                 dtype=pc.packed.dtype, device=vectors.device)
            rows = torch.empty(1, n_cubes * n_pad, dtype=torch.int32,
                               device=vectors.device)
            gscale, aug_scale = pc.packed_gscale, pc.packed_aug_scale
        elif not (_same_scale(gscale, pc.packed_gscale)
                  and _same_scale(aug_scale, pc.packed_aug_scale)):
            raise ValueError(f"cube {ci}'s slab scales differ from cube 0's")
        packed[:, ci * n_pad:(ci + 1) * n_pad] = pc.packed
        rows[:, ci * n_pad:(ci + 1) * n_pad] = pc.packed_rows
        starts.append(pc.bucket_starts[0])
        cubes.append(cube)
        del pc
    return MultiCube(
        metric=metric, k=k, n_rows=vectors.shape[0], n_cubes=n_cubes,
        n_pad=packed.shape[1] // n_cubes, cubes=tuple(cubes), packed=packed,
        packed_rows=rows, bucket_starts=torch.stack(starts),
        packed_gscale=gscale, packed_aug_scale=aug_scale,
    )


def multicube_windows(mc: MultiCube, queries: torch.Tensor, probes: int,
                      per_probe: int, directed: bool = True):
    """-> (s0, sizes) [q, C * probes] absolute window starts in the shared
    slab: cube ci's probe windows, salted by probe + ci * probes, offset
    by its segment start ci * n_pad."""
    s0_l, sz_l = [], []
    salt = torch.arange(probes, device=queries.device)
    for ci, cube in enumerate(mc.cubes):
        pv = _probe_vertices(cube, queries, probes, directed)
        s0, sz = _window_offsets(mc.bucket_starts[ci:ci + 1].expand(probes, -1),
                                 pv, per_probe, salt=salt + ci * probes)
        s0_l.append(s0 + ci * mc.n_pad)
        sz_l.append(sz)
    return torch.cat(s0_l, dim=1), torch.cat(sz_l, dim=1)


def multicube_retrieve_topk(
    mc: MultiCube,
    queries: torch.Tensor,   # [q, d]
    top_k: int,
    probes: int,             # PER-CUBE probe count
    per_probe: int = 256,
    directed: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union retrieval over C cubes in ONE shared-slab K1 launch, then the
    per-window stage 1 and id-dedup; euclidean ranks map to -distance.

    -> (scores [q, top_k] descending nearest-first, row ids, -1 pad)."""
    q = queries.shape[0]
    T = mc.n_cubes * probes
    if T % _GROUP:
        raise ValueError(f"n_cubes*probes={T} must be a multiple of {_GROUP}")
    qv = queries.float()
    if mc.metric == "cosine":
        q_kernel = qv / torch.clamp(torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True)),
                                    min=1e-30)
    elif mc.packed_aug_scale is None:
        raise ValueError("euclidean multicube requires the augmented slab layout")
    else:
        q_kernel = augment_queries(qv, mc.packed_aug_scale, mc.packed.shape[2])
    s0, sizes = multicube_windows(mc, queries, probes, per_probe, directed)
    dots, a0 = _grouped_dots(mc.packed, s0, sizes, q_kernel, per_probe)
    s2, ids = _shared_slab_topk(dots, a0.reshape(q, T), mc.packed_rows[0],
                                mc.n_rows, top_k)
    del dots
    if mc.metric == "euclidean":
        return rank_to_distance(s2, ids, queries, mc.packed_gscale)
    if mc.packed_gscale is not None:
        s2 = torch.where(ids >= 0, s2 * mc.packed_gscale, float("-inf"))
    return s2, ids


def hypercube_from_numpy(
    meta: Mapping, arrays: Mapping[str, np.ndarray], device
) -> Hypercube:
    """Hand a JAX Hypercube over: meta {metric, k, n_rows, w (euclidean),
    packed_dtypes?}; arrays proj, offsets + weights + mix_mul + mix_add
    (euclidean), vertices, sorted_rows, bucket_starts and the optional
    packed fields (index.PACKED_FIELDS, packed_detailed aside)."""
    get = array_getter(meta, arrays, device)
    k = int(meta["k"])
    return Hypercube(
        metric=meta["metric"], k=k, n_rows=int(meta["n_rows"]),
        family=family_from_numpy(dict(meta, L=1), arrays, device),
        mix_mul=get("mix_mul"), mix_add=get("mix_add"),
        vertices=get("vertices"), sorted_rows=get("sorted_rows"),
        bucket_starts=get("bucket_starts"),
        **{f: get(f) for f in PACKED_FIELDS if f != "packed_detailed"},
    )


def multicube_from_numpy(
    meta: Mapping, arrays: Mapping[str, np.ndarray], device
) -> MultiCube:
    """Hand a JAX MultiCube over: meta {metric, k, n_rows, n_cubes, n_pad,
    w (euclidean), packed_dtypes?}; arrays packed, packed_rows,
    bucket_starts, packed_gscale?, packed_aug_scale? and each cube's
    unpacked arrays under the prefix "cube{ci}." (hypercube_from_numpy)."""
    C = int(meta["n_cubes"])
    cubes = tuple(
        hypercube_from_numpy(
            meta, {name[len(f"cube{ci}."):]: a for name, a in arrays.items()
                   if name.startswith(f"cube{ci}.")}, device)
        for ci in range(C)
    )
    get = array_getter(meta, arrays, device)
    return MultiCube(
        metric=meta["metric"], k=int(meta["k"]), n_rows=int(meta["n_rows"]),
        n_cubes=C, n_pad=int(meta["n_pad"]), cubes=cubes, packed=get("packed"),
        packed_rows=get("packed_rows"), bucket_starts=get("bucket_starts"),
        packed_gscale=get("packed_gscale"),
        packed_aug_scale=get("packed_aug_scale"),
    )
