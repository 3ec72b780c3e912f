"""The plain reference against the port's CPU path on a tiny index."""

import math

import pytest
import torch

from portbench import reference as ref

N, D, POOL, K, L, PER_TABLE, PAD = 3000, 128, 64, 5, 4, 64, 4096


@pytest.fixture(scope="module")
def tiny():
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh

    g = torch.Generator().manual_seed(2**31 + 99)
    corpus, queries, truth = ref.planted_corpus(g, N, D, POOL, 10)
    proj = torch.randn(D, L * K, generator=g)
    pidx = lsh_index.pack_index(
        lsh_index.build_index(None, corpus, "cosine", K, L, family=CosineLsh(proj, K, L)),
        corpus, dtype=torch.int8, pad=PAD)
    return corpus, queries, truth, proj, pidx


def test_hash_agrees_where_rounding_cannot_decide(tiny):
    corpus, _, _, proj, pidx = tiny
    bits, margin = ref.hash_bits(corpus, proj)
    shifts = torch.arange(K - 1, -1, -1)
    pb = ((pidx.bucket_ids.long()[:, :, None] >> shifts) & 1).bool().reshape(bits.shape)
    assert not bool((pb != bits)[margin > 1e-6].any())


def test_tables_and_slabs_equal_the_ports(tiny):
    corpus, _, _, proj, pidx = tiny
    ridx = ref.build(corpus, proj, K, L, PER_TABLE, PAD, pidx.bucket_ids.long())
    assert torch.equal(ridx.sorted_rows, pidx.packed_rows.long())
    assert torch.equal(ridx.starts, pidx.bucket_starts.long())
    assert torch.equal(ridx.g, pidx.packed_gscale)
    # the int8 slab format, reproduced exactly (pad rows zero)
    assert torch.equal(ref.slab_rows(ridx, ridx.sorted_rows).to(torch.int8), pidx.packed)


def test_window_starts_are_the_ports(tiny):
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    corpus, queries, _, proj, pidx = tiny
    qb = pidx.family.bucket_ids(queries)
    s0, _ = _window_offsets(pidx.bucket_starts, qb, PER_TABLE)
    assert torch.equal(ref.window_starts(pidx.bucket_starts.long(), qb, PER_TABLE), s0.long())


def test_cf_answers_equal_the_ports(tiny):
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index

    corpus, queries, _, proj, pidx = tiny
    ridx = ref.build(corpus, proj, K, L, PER_TABLE, PAD, pidx.bucket_ids.long())
    sims, ids = lsh_index.retrieve_topk_pallas(pidx, queries, corpus, top_k=20,
                                               per_table=PER_TABLE, int8_rerank=False,
                                               stage1_per_table=12)
    qb, _ = ref.query_buckets(ridx, queries)
    want, want_ids = ref.window_topk(ridx, queries, qb, 12, 20)
    want = want * ridx.g.double()
    real = torch.isfinite(want)
    assert torch.equal(want_ids, ids.long())
    assert torch.allclose(sims.double()[real], want[real], rtol=0, atol=1e-5)


def test_retrieval_answers_equal_the_ports(tiny):
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index

    corpus, queries, _, proj, pidx = tiny
    ridx = ref.build(corpus, proj, K, L, PER_TABLE, PAD, pidx.bucket_ids.long())
    s, ids = lsh_index.retrieve_topk(pidx, queries, corpus, 10, per_table=PER_TABLE)
    qb, _ = ref.query_buckets(ridx, queries)
    want, want_ids = ref.retrieve(ridx, queries, qb, 40, 40, 10)
    assert torch.equal(want_ids, ids.long())
    assert torch.allclose(s.double(), want, rtol=0, atol=1e-5)


def test_slack_keeps_what_every_near_selection_keeps():
    # two lanes tied at the cut: the strict pool drops both, the loose keeps both
    v = torch.tensor([[[5.0, 4.0, 3.0, 3.0 + 1e-9, 1.0]]]).sort(dim=2, descending=True).values
    strict, loose = ref._pools(v, 3, 1e-6)
    assert strict.tolist() == [[[True, True, False, False, False]]]
    assert loose.tolist() == [[[True, True, True, True, False]]]


def test_cf_prediction_by_hand():
    q_r = torch.tensor([[1.0, 2.0, 3.0]])
    known = torch.tensor([[True, False, False]])
    q_mean = torch.tensor([1.0])
    n_r = torch.tensor([[2.0, 4.0, 0.0], [1.0, 1.0, 4.0]])
    n_mean = torch.tensor([2.0, 2.0])
    sims = torch.tensor([[0.5, -0.25]])
    ids = torch.tensor([[0, 1]])
    pred = ref.cf_predict(q_r, known, q_mean, n_r, n_mean, sims, ids)
    # coin 1: 1 + (0.5 * 2 - 0.25 * -1) / 0.75; coin 2: 1 + (0.5 * -2 - 0.25 * 2) / 0.75
    assert torch.allclose(pred, torch.tensor([[1.0, 1 + 1.25 / 0.75, 1 - 1.5 / 0.75]],
                                             dtype=torch.float64))
    v, c = ref.top_unknown(pred, known, 3)
    assert c.tolist() == [[1, 2, -1]] and math.isinf(float(v[0, 2]))


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12, -(1.0 + 2.0**-11)])
    assert ref.tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
