"""The CF engine's prediction kernel (`ops/kernels/cfpredict.py`,
`csrc/cfpredict.cu`) and its top-N through S1, on the CPU.

- the card route's checks accept what the plain version takes (ids int32
  and int64, any P and c) and raise on the rest; its launch hands the
  library the operands and sizes `build._SIGNATURES` names (library and
  stream stubbed);
- on CPU tensors `predict_scores`, `recommend_topk_retrieved` and
  `topn_indices` are bit for bit the ops they ran before the kernel (the
  plain gather and einsum, the stable sort), stated here as they were;
- the counter "cf.neighbors" sums the valid neighbour slots while a
  profiler records, and nothing otherwise;
- the kernel's byte bound at the CF cell's shape.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`).
"""

import contextlib
import types

import pytest
import torch

from crypto_rec_tpu_torch.models.rec import engine
from crypto_rec_tpu_torch.ops import topk
from crypto_rec_tpu_torch.ops.kernels import bounds, build, cfpredict
from crypto_rec_tpu_torch.utils import timing

_EPS = 1e-30


def parent_predict_scores(queries, neighbors, sims, neighbor_idx, neighbor_valid):
    """`engine.predict_scores` as it was before the kernel."""
    w = torch.where(neighbor_valid, sims, 0.0)
    abs_sum = torch.sum(torch.abs(w), dim=1)
    idx = neighbor_idx.long()
    neigh_r = neighbors.ratings[idx]
    neigh_mu = neighbors.mean[idx]
    centered = (neigh_r - neigh_mu[:, :, None]) * neighbor_valid[:, :, None]
    main_sum = torch.einsum("qp,qpc->qc", w, centered)
    delta = main_sum / torch.clamp(abs_sum, min=_EPS)[:, None]
    pred_unknown = queries.mean[:, None] + torch.where(
        (abs_sum > 0.0)[:, None], delta, 0.0
    )
    return torch.where(queries.known, queries.ratings, pred_unknown)


def parent_topn_indices(scores, mask, n):
    """`topn_indices` as it was before S1: the stable sort, padded."""
    m = scores.shape[-1]
    vals, idx = torch.sort(torch.where(mask, scores, topk.NEG_INF), dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[..., :n], idx[..., :n]
    if n > m:
        vals = torch.nn.functional.pad(vals, (0, n - m), value=topk.NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, n - m), value=0)
    return torch.where(vals > topk.NEG_INF, idx, -1)


def _case(q, P, c, n, id_dtype=torch.int64, seed=0, integer=False):
    """Ratings (integer-valued where `integer`: predictions then tie), -1
    padded neighbour ids, and the edge rows: user 0 without a valid
    neighbour, user 1 knowing every coin, user 2 with zero similarities."""
    g = torch.Generator().manual_seed(seed)

    def ratings(rows):
        r = torch.randn(rows, c, generator=g) * 3.0
        return r.round() if integer else r

    nr, qr = ratings(n), ratings(q)
    nk, qk = torch.rand(n, c, generator=g) < 0.56, torch.rand(q, c, generator=g) < 0.56
    users = engine.RatingSet(nr, nk, (nr * nk).sum(1) / nk.sum(1).clamp(min=1))
    queries = engine.RatingSet(qr, qk, (qr * qk).sum(1) / qk.sum(1).clamp(min=1))
    sims = torch.sort(torch.rand(q, P, generator=g) * 2 - 1, dim=1, descending=True)[0]
    ids = torch.randint(0, n, (q, P), generator=g)
    ids = torch.where(torch.rand(q, P, generator=g) < 0.1, -1, ids)
    if q > 2:
        ids[0] = -1
        queries.known[1] = True
        sims[2] = 0.0
    return queries, users, sims, ids.to(id_dtype)


def _operands(queries, users, sims, ids):
    valid = ids >= 0
    return (queries.ratings, queries.known, queries.mean, users.ratings, users.mean, sims,
            torch.clamp(ids, min=0) * valid, valid)


# ---- the card route's checks ----

@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("P", [0, 1, 20, 33, 2000])
def test_card_checks_accept_what_the_plain_version_takes(id_dtype, P):
    """Every shape and id type the plain version runs on the CPU, the card's
    checks take too (meta tensors of the same shapes)."""
    for c in (1, 15, 100, 101, 1000):
        ops = _operands(*_case(3, P, c, 5, id_dtype, seed=P + c))
        out = cfpredict.cf_predict_plain(*ops)
        assert out.shape == (3, c) and out.dtype == torch.float32
        cfpredict.check_cf_predict(*(t.to("meta") for t in ops))


def _bad(i, fn):
    """`_case`'s operands with operand i replaced by fn(operand)."""
    ops = list(_operands(*_case(4, 20, 100, 6)))
    ops[i] = fn(ops[i])
    return ops


@pytest.mark.parametrize("i,fn,err", [
    (0, lambda t: t.double(), TypeError),            # query ratings f64
    (3, lambda t: t.half(), TypeError),              # neighbour ratings f16
    (5, lambda t: t.bfloat16(), TypeError),          # sims bf16
    (2, lambda t: t.double(), TypeError),            # query means f64
    (6, lambda t: t.to(torch.int16), TypeError),     # ids int16
    (1, lambda t: t.to(torch.uint8), TypeError),     # known as bytes
    (7, lambda t: t.float(), TypeError),             # valid as floats
    (1, lambda t: t[:, :50], ValueError),            # known of another width
    (6, lambda t: t[:, :10], ValueError),            # ids of another P
    (4, lambda t: t[:-1], ValueError),               # a mean short
    (0, lambda t: t[None], ValueError),              # 3-D queries
    (5, lambda t: t.to("meta"), ValueError),         # sims on another device
])
def test_card_checks_raise_on_what_the_kernel_does_not_take(i, fn, err):
    with pytest.raises(err):
        cfpredict.check_cf_predict(*_bad(i, fn))


def test_card_route_hands_the_library_its_signature(monkeypatch):
    """The launch passes the eight operands, the output and (q, P, c, n,
    id bytes, stream): as many arguments as `build._SIGNATURES` declares;
    non-contiguous operands go as contiguous copies."""
    calls = []
    lib = types.SimpleNamespace(crt_cf_predict=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    for id_dtype, size in ((torch.int64, 8), (torch.int32, 4)):
        ops = list(_operands(*_case(6, 20, 100, 9, id_dtype)))
        ops[3] = ops[3].t().contiguous().t()             # a column-major table
        out = cfpredict._launch(*ops)
        a = calls[-1]
        assert len(a) == len(build._SIGNATURES["crt_cf_predict"])
        assert a[-6:] == (6, 20, 100, 9, size, 7) and a[8] == out.data_ptr()
        assert a[3] != ops[3].data_ptr()                 # the copy, not the view
        assert out.shape == (6, 100) and out.dtype == torch.float32


# ---- the CPU path is the parent's, bit for bit ----

@pytest.mark.parametrize("q,P,c,n,id_dtype", [(300, 20, 100, 250, torch.int64),
                                              (50, 1, 15, 40, torch.int32),
                                              (40, 33, 101, 60, torch.int64),
                                              (8, 2000, 16, 2500, torch.int64)])
def test_cpu_predict_scores_is_the_parents(q, P, c, n, id_dtype):
    queries, users, sims, ids = _case(q, P, c, n, id_dtype, seed=q)
    valid = ids >= 0
    idx = torch.clamp(ids, min=0) * valid
    got = engine.predict_scores(queries, users, sims, idx, valid)
    assert torch.equal(got, parent_predict_scores(queries, users, sims, idx, valid))


@pytest.mark.parametrize("c,top_n,integer", [(100, 5, False), (100, 5, True),
                                             (15, 20, True)])
def test_cpu_recommend_topk_retrieved_is_the_parents(c, top_n, integer):
    """Predictions, top-N (ties among integer ratings, n > c pads, users
    who know every coin), sims and the neighbour mask as the parent's ops
    give them."""
    queries, users, sims, ids = _case(400, 20, c, 300, seed=c, integer=integer)
    rec = engine.recommend_topk_retrieved(queries, users, sims, ids, top_n)
    valid = ids >= 0
    pred = parent_predict_scores(queries, users, sims, torch.clamp(ids, min=0) * valid, valid)
    assert torch.equal(rec.predicted, pred)
    assert torch.equal(rec.top_n, parent_topn_indices(pred, ~queries.known, top_n))
    assert (rec.top_n[1] == -1).all()
    assert torch.equal(rec.sims, torch.where(valid, sims, float("-inf")))
    assert torch.equal(rec.has_neighbors, valid.any(1)) and not rec.has_neighbors[0]


# ---- the counter ----

def test_cf_neighbors_counts_the_valid_slots_while_tracing():
    """"cf.neighbors" is the sum of the valid slots of every prediction
    while a profiler records (the fused engine and the mask engine alike),
    and nothing while none does."""
    queries, users, sims, ids = _case(200, 20, 100, 150, seed=3)
    timing.reset()
    engine.recommend_topk_retrieved(queries, users, sims, ids, 5)
    assert timing.snapshot()["counters"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.recommend_topk_retrieved(queries, users, sims, ids, 5)
    assert timing.snapshot()["counters"] == {"cf.neighbors": int((ids >= 0).sum())}
    timing.reset()
    cand = torch.rand(200, 150, generator=torch.Generator().manual_seed(4)) < 0.05
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        rec = engine.recommend(queries, users, cand, 20, 5)
    assert timing.snapshot()["counters"] == {"cf.neighbors": int(rec.neighbor_valid.sum())}
    assert int(rec.neighbor_valid.sum()) < 200 * 20      # slots go empty here


def test_cf_predict_bound_counts_each_byte_once():
    """At the CF cell's shape the operands and the prediction come to
    115 MB, 0.034 ms at 3.35 TB/s; the FFMA work is far below it."""
    b = bounds.cf_predict_call(73_421, 20, 100, 73_421, 8)
    assert b["bytes"] == 73_421 * (100 * 9 + 4 + 100 * 4 + 4 + 20 * 13)
    assert b["bound_by"] == "bytes" and 0.0343 < b["bound_ms"] < 0.0345
