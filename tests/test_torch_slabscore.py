"""K1 (slab-window dots) and its epilogue: the port's plain version against
the JAX package's Pallas kernel in interpret mode, on JAX-packed slabs.

Dots: rtol 1e-5 with atol 1e-4 for int8 (raw dots reach ~100s, so the
difference is summation order only) and 1e-6 for unit-norm bf16 / f32
rows.  Aligned starts must be exactly equal.  Both JAX kernel bodies
(fuse_l=True and the per-window fuse_l=False) are held against the one
port kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.ops.pallas import slabscore as jax_slab
from crypto_rec_tpu_torch.ops.kernels import slabscore

from _torch_parity import assert_topk_match, to_np

N, D, Q, L, PT = 4096, 128, 24, 5, 200
ATOL = {"int8": 1e-4, "bfloat16": 1e-6, "float32": 1e-6}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    qs = x[:Q] + 0.01 * rng.normal(size=(Q, D)).astype(np.float32)
    jidx = jax_index.build_index(
        jax.random.PRNGKey(1), jnp.asarray(x), "cosine", k=5, L=L,
        lsh_bucket_div=4, euclidean_h_w=1.0,
    )
    qb, _ = jax_index.query_hashes(jidx, jnp.asarray(qs))
    l_idx = jnp.arange(L, dtype=jnp.int32)
    start = jidx.bucket_starts[l_idx[None, :], qb]
    end = jidx.bucket_starts[l_idx[None, :], qb + 1]
    sizes = jnp.minimum(end - start, PT)
    qv = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    packs = {
        dt: jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dt), pad=1024)
        for dt in ATOL
    }
    return dict(packs=packs, qb=qb, start=start, sizes=sizes, qv=qv)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _check_dots(jax_out, port_out, dtype):
    (jd, ja), (pd, pa) = jax_out, port_out
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=ATOL[dtype])


# (mask, fuse_l): both masks on the fused body, the per-window body masked
@pytest.mark.parametrize("mask,fuse_l", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("dtype", list(ATOL))
def test_slab_window_dots_matches_jax(setup, dtype, mask, fuse_l):
    packed = setup["packs"][dtype].packed
    want = jax_slab.slab_window_dots(
        packed, None, setup["start"], setup["sizes"], jnp.asarray(setup["qv"]),
        per_table=PT, interpret=True, fuse_l=fuse_l, mask=mask,
    )
    args = (_t(packed), _t(setup["start"]), _t(setup["sizes"]),
            torch.from_numpy(setup["qv"]), PT)
    got = slabscore.slab_window_dots_plain(*args, mask=mask)
    _check_dots(want, got, dtype)
    # the routed wrapper takes the plain version for CPU tensors
    routed = slabscore.slab_window_dots(*args, mask=mask)
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


@pytest.mark.parametrize("dtype", list(ATOL))
def test_slab_window_dots_shared_slab_matches_jax(setup, dtype):
    """shared_slab: every window reads slab 0 (the hypercube form), with
    windows that run into the slab's end (the clamp)."""
    rng = np.random.default_rng(11)
    packed = setup["packs"][dtype].packed[:1]
    n_pad = packed.shape[1]
    starts = rng.integers(0, n_pad, size=(Q, 3)).astype(np.int32)
    sizes = rng.integers(0, 2 * PT, size=(Q, 3)).astype(np.int32)
    want = jax_slab.slab_window_dots(
        packed, None, jnp.asarray(starts), jnp.asarray(sizes),
        jnp.asarray(setup["qv"]), per_table=PT, interpret=True, mask=True,
        shared_slab=True,
    )
    got = slabscore.slab_window_dots_plain(
        _t(packed), torch.from_numpy(starts), torch.from_numpy(sizes),
        torch.from_numpy(setup["qv"]), PT, mask=True, shared_slab=True,
    )
    _check_dots(want, got, dtype)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_slab_topk_and_retrieve_match_jax(setup, dtype, strict):
    """slab_topk on the SAME dots, then the whole packed_retrieve_pallas,
    in strict (exact windows, flat top-k) and production (maskless,
    per-table stage 1) mode."""
    p = setup["packs"][dtype]
    tol = dict(rtol=1e-5, atol=ATOL[dtype])
    dots, a0 = jax_slab.slab_window_dots(
        p.packed, None, setup["start"], setup["sizes"], jnp.asarray(setup["qv"]),
        per_table=PT, interpret=True, mask=strict,
    )
    for kw in ({}, {"stage1_per_table": 3}, {"stage1_width": 24}):
        want = jax_slab.slab_topk(dots, a0, p.packed_rows, p.n_rows, 10,
                                  exact=strict, **kw)
        got = slabscore.slab_topk(_t(dots), _t(a0), _t(p.packed_rows), p.n_rows,
                                  10, exact=strict, **kw)
        assert_topk_match(*want, *got, **tol)

    qs = setup["qv"] * 3.0          # the wrapper normalizes queries itself
    want = jax_slab.packed_retrieve_pallas(
        p.packed, p.packed_rows, None, p.bucket_starts, p.n_rows,
        jnp.asarray(qs), setup["qb"], 10, PT, interpret=True, strict=strict,
        stage1_per_table=4,
    )
    got = slabscore.packed_retrieve_pallas(
        _t(p.packed), _t(p.packed_rows), _t(p.bucket_starts), p.n_rows,
        torch.from_numpy(qs), _t(setup["qb"]), 10, PT, strict=strict,
        stage1_per_table=4,
    )
    assert_topk_match(*want, *got, **tol)
    assert to_np(got[1]).max() < p.n_rows


def test_window_offsets_wrap_like_int32():
    """The pseudo-random window offset keeps JAX's int32 wraparound and
    floor-mod for bucket ids whose product with the golden ratio overflows."""
    rng = np.random.default_rng(5)
    n_buckets, Lt, per_table = 1 << 13, 4, 50
    sizes = rng.integers(0, 400, size=(Lt, n_buckets))
    starts = np.concatenate([np.zeros((Lt, 1), np.int64), np.cumsum(sizes, 1)], 1)
    starts = starts.astype(np.int32)
    qb = rng.integers(0, n_buckets, size=(64, Lt)).astype(np.int32)
    l_idx = jnp.arange(Lt, dtype=jnp.int32)
    jstart = jnp.asarray(starts)[l_idx[None, :], qb]
    jend = jnp.asarray(starts)[l_idx[None, :], qb + 1]
    mix = (jnp.asarray(qb) * jnp.int32(-1640531527)) ^ (l_idx[None, :] * jnp.int32(40503))
    s0 = jstart + jnp.remainder(jnp.abs(mix), jnp.maximum(jend - jstart - per_table, 0) + 1)
    got_s0, got_sizes = slabscore._window_offsets(
        torch.from_numpy(starts), torch.from_numpy(qb), per_table
    )
    np.testing.assert_array_equal(got_s0.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(got_sizes.numpy(),
                                  np.asarray(jnp.minimum(jend - s0, per_table)))
