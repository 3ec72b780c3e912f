"""Top-k primitives.

The selection returns values and the permutation indexes in one op;
gathering any payload by index replaces the reference's recursive co-sort
of a similarity array with its neighbour array (reference
lib/crypto_rec.hpp:234-277).

Equal values come back lowest index first, as JAX's `lax.top_k` returns
them.  `torch.topk` promises no order among equal values (on CUDA it
differs from the CPU's), so the selection is a stable descending sort cut
to k: ratings on a few coins tie often (identical users, users with one
tweet), and the tie order decides which neighbours and coins are picked.
`topk_asc` is the ascending twin (the smallest values: distances, bit
margins), in place of JAX's `lax.top_k` of the negated values.
Values order as that sort orders them on both devices: NaN first, +0.0
and -0.0 equal (`lax.top_k` on the CPU puts +0.0 first).  The sort costs
about what `torch.topk` does where the row is short or k a large share of
it, and several times more for a few winners of a long row;
tools/chip_probes/topk_select.py times it at every caller's shape beside
`torch.topk` and the tie-exact selections that were slower.

The stage-1 selections of K1's epilogue (`slab_topk`, the cubes'
shared-slab epilogue, P6's `slab_topk_int4`) and the CF engine's top-N
(`topn_indices`) go through `ops/kernels/windowtopk.window_topk` instead:
on the card the Hopper kernel S1 (`csrc/windowtopk.cu`), which returns
exactly what `topk_desc` returns, and `topk_desc` itself on the CPU.

The masked forms take k above the axis length: the reference keeps every
candidate when there are fewer than P (get_P_closest truncates only when
size > P, crypto_rec.hpp:225-228), so the slots past the axis are invalid
pads.  JAX's `lax.top_k` raises there instead (e.g. P = 20 neighbours
asked of 10 virtual users).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = float("-inf")


def topk_desc(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k along the last axis -> (values, indices), equal
    values lowest index first."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_asc(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ascending top-k (the k smallest) along the last axis -> (values,
    indices), equal values lowest index first: the order of
    `lax.top_k(-values, k)` with its values negated back."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_padded(values: torch.Tensor, k: int, select=topk_desc) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """`select` (topk_desc's contract) over the last axis for any k: slots
    past the axis length hold -inf at index 0."""
    m = values.shape[-1]
    vals, idx = select(values, min(k, m))
    if k <= m:
        return vals, idx
    return (torch.nn.functional.pad(vals, (0, k - m), value=NEG_INF),
            torch.nn.functional.pad(idx, (0, k - m), value=0))


def masked_topk_desc(
    values: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k over `values` where mask; returns (vals, idx, valid).

    Invalid slots (mask exhausted before k) have valid=False and carry a
    -inf value — callers must weight by `valid`.  The static-shape answer to
    the reference's dynamically sized candidate sets (get_P_closest
    truncates only when size > P, crypto_rec.hpp:225-228).
    """
    vals, idx = _topk_padded(torch.where(mask, values, NEG_INF), k)
    return vals, idx, vals > NEG_INF


def topn_indices(scores: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Indexes of the n best masked scores, -1 where fewer than n are valid
    (the reference returned garbage there, crypto_rec.hpp:322).  The
    selection is `window_topk`: on CUDA tensors S1, which takes float32
    [R, m] scores and raises on others; on CPU tensors `topk_desc`."""
    # windowtopk imports this module, so it is imported here, at the call
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    vals, idx = _topk_padded(torch.where(mask, scores, NEG_INF), n, window_topk)
    return torch.where(vals > NEG_INF, idx, -1)
