"""Top-k primitives.

`torch.topk` returns values and the permutation indexes in one op; gathering
any payload by index replaces the reference's recursive co-sort of a
similarity array with its neighbour array (reference
lib/crypto_rec.hpp:234-277).  Ties may come back in another order than
JAX's `lax.top_k` (lowest index first).

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
    """Descending top-k along the last axis -> (values, indices)."""
    return torch.topk(values, k, dim=-1)


def _topk_padded(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.topk over the last axis for any k: slots past the axis length
    hold -inf at index 0."""
    m = values.shape[-1]
    if k <= m:
        return torch.topk(values, k, dim=-1)
    vals, idx = torch.topk(values, m, dim=-1)
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
    (the reference returned garbage there, crypto_rec.hpp:322)."""
    vals, idx = _topk_padded(torch.where(mask, scores, NEG_INF), n)
    return torch.where(vals > NEG_INF, idx, -1)
