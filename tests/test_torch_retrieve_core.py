"""The retrieval paths that run no kernel: the port against the JAX package
on one corpus, with JAX's hash parameters and slabs handed over as arrays.

`packed_retrieve_core` (per-row int8 and bf16 cosine slabs, cosine at
d % 128 != 0, unaugmented euclidean f32 and per-row int8 slabs, with and
without the fingerprint filter), the unpacked path, `retrieve_topk`'s
routing to both, per-row packing with `packed_sqnorm`, `pack_index_host`
and per-row / sqnorm archives both ways.

Ids equal wherever scores are not tied, scores within rtol 1e-5 / atol
1e-5 (`assert_topk_match`; euclidean scores compared squared, as in
tests/test_torch_pstable.py).  Slabs within one quantization step on <
0.01% of elements (a row norm's last bit), scales and norms rtol 1e-6;
CSR tables, pack_index_host against the port's pack_index, and archives
exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch import checkpoint
from crypto_rec_tpu_torch.models.lsh import index as port_index

from _torch_parity import assert_topk_match, handover, to_np

N, Q, K, L, PT, TOP = 2048, 24, 4, 3, 96, 8
CPU = torch.device("cpu")


def _corpus(d, seed):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.normal(size=(16, d))
    x = (centers[rng.integers(0, 16, N)] + 0.5 * rng.normal(size=(N, d))).astype(np.float32)
    qs = (x[:Q] + 0.05 * rng.normal(size=(Q, d))).astype(np.float32)
    return x, qs


@pytest.fixture(scope="module", params=[("cosine", 48), ("cosine", 128),
                                        ("euclidean", 40)],
                ids=lambda p: f"{p[0]}-d{p[1]}")
def built(request):
    metric, d = request.param
    x, qs = _corpus(d, 5 if metric == "cosine" else 6)
    jidx = jax_index.build_index(jax.random.PRNGKey(3), jnp.asarray(x), metric, k=K, L=L,
                                 lsh_bucket_div=8, euclidean_h_w=6.0)
    pidx = port_index.index_from_numpy(*handover(jidx), CPU)
    return dict(metric=metric, x=x, qs=qs, jidx=jidx, pidx=pidx,
                X=torch.from_numpy(x), QS=torch.from_numpy(qs))


def _assert_topk(b, want, got):
    if b["metric"] == "cosine":
        assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    else:
        qmax = float((b["qs"] ** 2).sum(1).max())
        assert_topk_match(-to_np(want[0]) ** 2, want[1], -to_np(got[0]) ** 2, got[1],
                          rtol=1e-5, atol=1e-5 * qmax)
    ids = to_np(got[1])
    assert ids.max() < N and (ids[:, 0] >= 0).all()


def _assert_one_step(got: torch.Tensor, want):
    """Slab elements equal but for one quantization step (int8 value or
    bf16 bit pattern) on < 0.01% of them; f32 slabs within rtol 1e-6."""
    want = np.asarray(want)
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        return
    if got.dtype == torch.bfloat16:
        g, w = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        g, w = got.numpy(), want
    off = np.abs(g.astype(np.int64) - w.astype(np.int64))
    assert off.max() <= 1 and (off > 0).mean() <= 1e-4


def _layouts(metric):
    if metric == "cosine":
        return [("bfloat16", "auto"), ("int8", "row"), ("float32", "auto")]
    return [("float32", "auto"), ("int8", "auto"), ("bfloat16", "auto")]


@pytest.mark.parametrize("layout", range(3))
@pytest.mark.parametrize("filtered", [True, False])
def test_packed_retrieve_core_matches_jax(built, layout, filtered):
    """The blocked core on JAX's own slabs (handed over): same windows,
    masks, per-row scales and euclidean norms; stage-1 width T top_k; and
    query blocks change nothing.  Cosine tables have no fingerprint
    filter: filtered=False runs the unfiltered windows at another per_table."""
    b = built
    dt, mode = _layouts(b["metric"])[layout]
    jp = jax_index.pack_index(b["jidx"], jnp.asarray(b["x"]), dtype=jnp.dtype(dt),
                              pad=1024, scale_mode=mode)
    pp = port_index.index_from_numpy(*handover(jp), CPU)
    qb, qd = jax_index.query_hashes(b["jidx"], jnp.asarray(b["qs"]))
    det = jp.packed_detailed if filtered else None
    pt = PT if filtered else PT // 2 + 7
    want = jax_index.packed_retrieve_core(
        jp.packed, jp.packed_rows, jp.packed_sqnorm, det, jp.bucket_starts, N,
        b["metric"], jnp.asarray(b["qs"]), qb, qd, TOP, pt, packed_scale=jp.packed_scale)
    pqb = torch.from_numpy(np.asarray(qb).copy())
    pqd = None if qd is None else torch.from_numpy(np.asarray(qd).copy())
    args = (pp.packed, pp.packed_rows, pp.packed_sqnorm,
            pp.packed_detailed if filtered else None, pp.bucket_starts, N, b["metric"],
            b["QS"], pqb, pqd, TOP, pt)
    got = port_index.packed_retrieve_core(*args, packed_scale=pp.packed_scale)
    _assert_topk(b, want, got)
    again = port_index.packed_retrieve_core(*args, packed_scale=pp.packed_scale, q_block=7)
    assert torch.equal(again[1], got[1]) and torch.equal(again[0], got[0])


@pytest.mark.parametrize("layout", range(3))
def test_pack_index_matches_jax_per_row_and_sqnorm(built, layout):
    """pack_index's per-row int8 scales and euclidean |x|^2 planes, and the
    scale-mode rule ("auto" is per-row for unaugmented euclidean int8)."""
    b = built
    dt, mode = _layouts(b["metric"])[layout]
    jp = jax_index.pack_index(b["jidx"], jnp.asarray(b["x"]), dtype=jnp.dtype(dt),
                              pad=1024, scale_mode=mode)
    pp = port_index.pack_index(b["pidx"], b["X"], dtype=port_index.pack_dtype(dt),
                               pad=1024, scale_mode=mode)
    np.testing.assert_array_equal(pp.packed_rows.numpy(), np.asarray(jp.packed_rows))
    _assert_one_step(pp.packed, jp.packed)
    for f in ("packed_scale", "packed_sqnorm", "packed_gscale"):
        w, g = getattr(jp, f), getattr(pp, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, err_msg=f)
    if jp.packed_detailed is not None:
        np.testing.assert_array_equal(pp.packed_detailed.numpy(),
                                      np.asarray(jp.packed_detailed))


@pytest.mark.parametrize("packed", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("filtered", [True, False])
def test_retrieve_topk_routes_like_jax(built, packed, filtered):
    """retrieve_topk end to end on JAX's archive arrays, against JAX's
    retrieve_topk on the CPU (its XLA branches): the unpacked path, and
    packed layouts outside the kernel's shapes (d % 128 != 0, per-row
    int8, unaugmented euclidean) through the core and the exact rerank.
    bf16 cosine slabs at d = 128 take K1 (tests/test_torch_slice.py): here
    they go unpacked.  Cosine filtered=False runs another window."""
    b = built
    if packed == "bfloat16" and b["metric"] == "cosine" and b["x"].shape[1] % 128 == 0:
        packed = None
    pt = PT if filtered else PT // 2 + 7
    jidx = b["jidx"]
    if packed:
        mode = "row" if packed == "int8" else "auto"
        jidx = jax_index.pack_index(jidx, jnp.asarray(b["x"]), dtype=jnp.dtype(packed),
                                    pad=1024, scale_mode=mode)
    pidx = port_index.index_from_numpy(*handover(jidx), CPU)
    want = jax_index.retrieve_topk(jidx, jnp.asarray(b["qs"]), jnp.asarray(b["x"]),
                                   top_k=TOP, per_table=pt, filtered=filtered,
                                   q_block=16)
    got = port_index.retrieve_topk(pidx, b["QS"], b["X"], top_k=TOP, per_table=pt,
                                   filtered=filtered, q_block=16)
    _assert_topk(b, want, got)


def test_pack_index_host_equals_pack_index(built):
    """pack_index_host (host math, table-by-table upload) against the
    port's pack_index: byte for byte; against JAX's pack_index_host within
    one quantization step."""
    b = built
    augment = b["metric"] == "euclidean"
    for dt in (torch.int8, torch.bfloat16):
        host = port_index.pack_index_host(b["pidx"], b["x"], dtype=dt, pad=1024,
                                          augment=augment)
        dev = port_index.pack_index(b["pidx"], b["X"], dtype=dt, pad=1024,
                                    augment=augment)
        for f in port_index.PACKED_FIELDS:
            g, w = getattr(host, f), getattr(dev, f)
            assert (g is None) == (w is None), f
            if g is not None:
                assert g.dtype == w.dtype and torch.equal(g, w), f
    host = port_index.pack_index_host(b["pidx"], b["x"], pad=1024, augment=augment)
    jh = jax_index.pack_index_host(b["jidx"], b["x"], dtype=jnp.int8, pad=1024,
                                   augment=augment)
    _assert_one_step(host.packed, jh.packed)
    np.testing.assert_array_equal(host.packed_rows.numpy(), np.asarray(jh.packed_rows))


def test_cosine_int8_slabs_at_scale_within_one_step_of_jax():
    """200,000 x 128 cosine rows packed to global-scale int8 by both
    packages: equal but for one step on a few elements, where a row's f32
    norm, summed in another order, rounds to the neighbouring float (the
    port sums in float64, so its card and host agree).  JAX's own
    pack_index_host differs from its pack_index the same way.  -s prints
    both counts."""
    n, d = 200_000, 128
    rng = np.random.default_rng(1)
    centers = 2.0 * rng.normal(size=(16, d))
    x = (centers[rng.integers(0, 16, n)] + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    j = jax_index.build_index(jax.random.PRNGKey(3), jnp.asarray(x), "cosine", k=6, L=1,
                              lsh_bucket_div=8, euclidean_h_w=6.0)
    jp = np.asarray(jax_index.pack_index(j, jnp.asarray(x), dtype=jnp.int8, pad=1024).packed)
    p = port_index.index_from_numpy(*handover(j), CPU)
    pp = port_index.pack_index(p, torch.from_numpy(x), dtype=torch.int8, pad=1024).packed
    off = np.abs(pp.numpy().astype(np.int64) - jp.astype(np.int64))
    jh = np.asarray(jax_index.pack_index_host(j, x, dtype=jnp.int8, pad=1024).packed)
    own = int((jh != jp).sum())
    print(f"int8 slab elements off by one step: port vs JAX {int((off > 0).sum())} of "
          f"{off.size} ({(off > 0).mean():.2e}); JAX pack_index_host vs pack_index {own}")
    assert off.max() <= 1 and (off > 0).mean() <= 1e-5


def test_row_and_sqnorm_archives_move_both_ways(built, tmp_path):
    """A JAX archive with per-row int8 slabs (and, euclidean, the sqnorm and
    fingerprint planes) loads into the port; the port's re-save loads into
    JAX; every array equal."""
    b = built
    jp = jax_index.pack_index(b["jidx"], jnp.asarray(b["x"]), dtype=jnp.int8, pad=1024,
                              scale_mode="row")
    jax_ckpt.save_index(str(tmp_path / "j.npz"), jp)
    pp = checkpoint.load_index(str(tmp_path / "j.npz"), CPU)
    checkpoint.save_index(str(tmp_path / "p.npz"), pp)
    back = jax_ckpt.load_index(str(tmp_path / "p.npz"))
    for f in ("bucket_ids", "sorted_rows", "bucket_starts", "detailed") + \
            port_index.PACKED_FIELDS:
        w, g, r = getattr(jp, f), getattr(pp, f), getattr(back, f)
        assert (w is None) == (g is None) == (r is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
            np.testing.assert_array_equal(np.asarray(r), np.asarray(w), err_msg=f)
    assert checkpoint.index_nbytes(pp) == jax_ckpt.index_nbytes(jp)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_serve_cli_retrieve_without_pack_writes_jax_answers(metric, tmp_path):
    """`serve_cli retrieve` without --pack (the unpacked path) on a JAX
    archive, `--device cpu`: every query's ids and 5-decimal scores as the
    JAX CLI writes them, away from ties."""
    from crypto_rec_tpu import serve_cli as jax_serve
    from crypto_rec_tpu_torch import serve_cli

    x, qs = _corpus(32, 9)
    j = jax_index.build_index(jax.random.PRNGKey(4), jnp.asarray(x), metric, 4, 3, 8, 6.0)
    jax_ckpt.save_index(str(tmp_path / "idx.npz"), j)
    np.savez(tmp_path / "corpus.npz", vectors=x)
    with open(tmp_path / "q.csv", "w") as f:
        for i, v in enumerate(qs):
            f.write(",".join([f"q{i}"] + [repr(float(t)) for t in v]) + "\n")
    args = ["retrieve", "--index", str(tmp_path / "idx.npz"), "--corpus",
            str(tmp_path / "corpus.npz"), "--queries", str(tmp_path / "q.csv"),
            "--top-k", "6", "--per-table", "80"]
    assert jax_serve.main(args + ["-o", str(tmp_path / "jax.tsv")]) == 0
    assert serve_cli.main(args + ["--device", "cpu", "-o", str(tmp_path / "port.tsv")]) == 0

    def parse(path):
        ids = np.full((Q, 6), -1)
        sc = np.full((Q, 6), -np.inf, np.float32)
        for q, line in enumerate(open(path).read().splitlines()):
            for j_, pair in enumerate(line.split("\t")[1:]):
                ids[q, j_], sc[q, j_] = int(pair.split(":")[0]), float(pair.split(":")[1])
        return sc, ids

    (ws, wi), (gs, gi) = parse(tmp_path / "jax.tsv"), parse(tmp_path / "port.tsv")
    assert_topk_match(ws, wi, gs, gi, rtol=1e-5, atol=1e-5)      # 5 printed decimals
