"""Streamed serving (models/lsh/streamed.py) against the JAX package, with
JAX's hyperplanes handed over.

The host build's chunk slabs, rows and starts are equal to JAX's exactly.
Serving at d % 128 != 0 takes packed_retrieve_core in both packages: the
port against JAX's streamed_retrieve_topk.  At d = 128 the port runs K1
(its plain version here) through packed_retrieve_pallas; JAX's own loop
takes that kernel only on the TPU, so its reference is the same loop over
JAX's packed_retrieve_pallas in interpret mode with JAX's merge.  Ids
equal wherever scores are not tied, scores within rtol 1e-5 / atol 1e-5;
the planted-truth recall of JAX's own test; a pass without prefetch
returns the same ids.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh as JaxCosine
from crypto_rec_tpu.models.lsh.streamed import (
    build_streamed_index as jax_build, streamed_retrieve_topk as jax_serve,
)
from crypto_rec_tpu.ops.pallas.slabscore import packed_retrieve_pallas as jax_pallas
from crypto_rec_tpu_torch.models.lsh.streamed import (
    build_streamed_index, streamed_retrieve_topk,
)
from crypto_rec_tpu_torch.ops.oracle import recall_at_k

from _torch_parity import assert_topk_match

N, Q, TK, K, L, CHUNKS = 6000, 24, 5, 5, 3, 3
KEY = jax.random.PRNGKey(5)


def _planted(d, seed):
    """The planted protocol of tests/test_streamed.py, scattered across
    chunks: each query's TK near-copies are its true top-TK."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32) * 2
    base = (centers[rng.integers(0, 32, N)] + 0.5 * rng.normal(size=(N, d))).astype(np.float32)
    qs = (centers[rng.integers(0, 32, Q)] + 0.5 * rng.normal(size=(Q, d))).astype(np.float32)
    stride = N // (Q * TK)
    pos = (np.arange(Q * TK) * stride + 3) % N
    base[pos] = np.repeat(qs, TK, axis=0) + 0.05 * rng.normal(size=(Q * TK, d)).astype(np.float32)
    return base, qs, pos.reshape(Q, TK)


@pytest.fixture(scope="module", params=[64, 128], ids=["d64-core", "d128-k1"])
def built(request):
    d = request.param
    base, qs, truth = _planted(d, d)
    cr = -(-N // CHUNKS)

    def src(ci):
        return base[ci * cr:(ci + 1) * cr][: (N - 100 if ci == CHUNKS - 1 else N)]

    jsi = jax_build(KEY, src, N, d, K, L, CHUNKS)
    proj = np.asarray(JaxCosine.create(KEY, d, K, L).proj)
    psi = build_streamed_index(None, src, N, d, K, L, CHUNKS, proj=proj)
    return dict(d=d, base=base, qs=qs, truth=truth, jsi=jsi, psi=psi)


def test_host_build_matches_jax(built):
    jsi, psi = built["jsi"], built["psi"]
    assert (psi.chunk_rows, psi.chunk_pad, psi.n_chunks, psi.gscale) == \
        (jsi.chunk_rows, jsi.chunk_pad, jsi.n_chunks, jsi.gscale)
    np.testing.assert_array_equal(psi.proj, jsi.proj)
    for f in ("slabs", "rows", "starts"):
        for ci in range(jsi.n_chunks):
            np.testing.assert_array_equal(getattr(psi, f)[ci].numpy(),
                                          getattr(jsi, f)[ci], err_msg=f"{f}[{ci}]")
    assert psi.host_bytes() == jsi.host_bytes()


def _jax_kernel_loop(jsi, queries, top_k, per_table):
    """streamed_retrieve_topk's loop with the kernel branch in interpret mode."""
    qb = JaxCosine(proj=jnp.asarray(jsi.proj), k=jsi.k, L=jsi.L).bucket_ids(queries)
    bv = jnp.full((queries.shape[0], top_k), -jnp.inf, jnp.float32)
    bi = jnp.full((queries.shape[0], top_k), -1, jnp.int32)
    for ci in range(jsi.n_chunks):
        v, ids = jax_pallas(jnp.asarray(jsi.slabs[ci]), jnp.asarray(jsi.rows[ci]), None,
                            jnp.asarray(jsi.starts[ci]), jsi.chunk_rows, queries, qb,
                            top_k, per_table, interpret=True)
        gids = jnp.where(ids >= 0, ids + ci * jsi.chunk_rows, -1)
        cat_v, cat_i = jnp.concatenate([bv, v], 1), jnp.concatenate([bi, gids], 1)
        bv, pos = jax.lax.top_k(cat_v, top_k)
        bi = jnp.take_along_axis(cat_i, pos, axis=1)
    return bv * jsi.gscale, bi


def test_streamed_retrieve_matches_jax(built):
    q = jnp.asarray(built["qs"])
    if built["d"] % 128:
        want = jax_serve(built["jsi"], q, top_k=TK, per_table=128, use_pallas=False)
    else:
        want = _jax_kernel_loop(built["jsi"], q, TK, 128)
    stats = {}
    got = streamed_retrieve_topk(built["psi"], torch.from_numpy(built["qs"]), top_k=TK,
                                 per_table=128, stats=stats)
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    assert got[1].max() < N
    assert recall_at_k(got[1], torch.from_numpy(built["truth"])) > 0.95
    assert {"wall_s", "chunks", "bytes_streamed", "stream_gb_per_s", "qps"} <= set(stats)
    assert stats["chunks"] == CHUNKS and stats["bytes_streamed"] == built["psi"].host_bytes()


def test_no_prefetch_gives_the_same_answer(built):
    qs = torch.from_numpy(built["qs"])
    a = streamed_retrieve_topk(built["psi"], qs, top_k=TK, per_table=128)
    b = streamed_retrieve_topk(built["psi"], qs, top_k=TK, per_table=128, prefetch=False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_own_draw_and_short_last_chunk():
    """The port's own hyperplanes (a seeded generator): self-queries come
    back first at sim ~1, no id points into the padded tail."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(32, 32)).astype(np.float32) * 2
    base = (centers[rng.integers(0, 32, 5000)]
            + 0.5 * rng.normal(size=(5000, 32))).astype(np.float32)
    n = 5000
    cr = -(-n // 3)
    sidx = build_streamed_index(torch.Generator().manual_seed(9),
                                lambda ci: base[ci * cr:min(n, (ci + 1) * cr)], n, 32, 5, 4, 3)
    v, i = streamed_retrieve_topk(sidx, torch.from_numpy(base[:16]), top_k=5, per_table=128)
    assert (i[:, 0].numpy() == np.arange(16)).all() and int(i.max()) < n
    assert (np.abs(v[:, 0].numpy() - 1.0) < 0.02).all()
    with pytest.raises(ValueError, match="last chunk"):
        build_streamed_index(torch.Generator().manual_seed(9),
                             lambda ci: base[:10] if ci == 0 else base[:cr], n, 32, 5, 4, 3)
