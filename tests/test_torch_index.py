"""Cosine index build, packing and checkpoints: the port against the JAX
package on one corpus, with JAX's hyperplanes handed over.

CSR tables must be exactly equal.  int8 slab elements may sit one
quantization step off in at most 0.01% of elements (the last bit of a row
norm can move a value across a rounding boundary); bf16 likewise by one
bf16 step.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch import checkpoint
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh

from _torch_parity import handover, to_np

N, D, K, L = 4096, 128, 5, 5


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    jidx = jax_index.build_index(
        jax.random.PRNGKey(1), jnp.asarray(x), "cosine", k=K, L=L,
        lsh_bucket_div=4, euclidean_h_w=1.0,
    )
    fam = CosineLsh(proj=torch.from_numpy(np.asarray(jidx.family.proj).copy()),
                    k=K, L=L)
    pidx = port_index.build_index(None, torch.from_numpy(x), "cosine", K, L,
                                  family=fam)
    return x, jidx, pidx


def test_build_index_matches_jax(built):
    _, jidx, pidx = built
    assert pidx.n_buckets == jidx.n_buckets and pidx.n_rows == N
    for f in ("bucket_ids", "sorted_rows", "bucket_starts"):
        got, want = getattr(pidx, f), np.asarray(getattr(jidx, f))
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _assert_slabs_close(got: torch.Tensor, want: np.ndarray):
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = want.view(np.int16).astype(np.int64)
    else:
        g, w = got.numpy().astype(np.int64), want.astype(np.int64)
    off = np.abs(g - w)
    assert off.max() <= 1, "slab element more than one step off"
    assert (off > 0).mean() <= 1e-4, f"{(off > 0).mean():.2e} of elements off"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_pack_index_matches_jax(built, dtype):
    x, jidx, pidx = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dtype), pad=1024)
    pp = port_index.pack_index(pidx, torch.from_numpy(x),
                               dtype=port_index.pack_dtype(dtype), pad=1024)
    assert tuple(pp.packed.shape) == jp.packed.shape
    np.testing.assert_array_equal(pp.packed_rows.numpy(), np.asarray(jp.packed_rows))
    _assert_slabs_close(pp.packed, np.asarray(jp.packed))
    if dtype == "int8":
        np.testing.assert_allclose(float(pp.packed_gscale),
                                   float(jp.packed_gscale), rtol=1e-6)
    else:
        assert pp.packed_gscale is None and jp.packed_gscale is None


def test_candidate_mask_and_query_hashes_match_jax(built):
    x, jidx, pidx = built
    qs = x[:40] + 0.05 * np.random.default_rng(3).normal(size=(40, D)).astype(np.float32)
    jq, _ = jax_index.query_hashes(jidx, jnp.asarray(qs))
    pq, _ = port_index.query_hashes(pidx, torch.from_numpy(qs))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        port_index.candidate_mask(pidx, torch.from_numpy(qs)).numpy(),
        np.asarray(jax_index.candidate_mask(jidx, jnp.asarray(qs))),
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_checkpoint_jax_to_port_round_trip(built, dtype, tmp_path):
    """An archive written by the JAX package loads into the port bit for bit
    (bf16 decoded from its uint16 view with torch alone)."""
    x, jidx, _ = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dtype), pad=1024)
    path = str(tmp_path / "idx.npz")
    jax_ckpt.save_index(path, jp)
    got = checkpoint.load_index(path, torch.device("cpu"))
    assert (got.metric, got.n_buckets, got.n_rows) == (jp.metric, jp.n_buckets, jp.n_rows)
    assert (got.family.k, got.family.L) == (K, L)
    np.testing.assert_array_equal(got.family.proj.numpy(), np.asarray(jp.family.proj))
    for f in ("bucket_ids", "sorted_rows", "bucket_starts", "packed_rows"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jp, f)))
    assert got.packed.dtype == port_index.pack_dtype(dtype)
    np.testing.assert_array_equal(to_np(got.packed), to_np(jp.packed))
    if dtype == "int8":
        assert float(got.packed_gscale) == float(jp.packed_gscale)


def test_checkpoint_port_to_jax_round_trip(built, tmp_path):
    """The port writes the same archive format: JAX reads it back."""
    x, jidx, pidx = built
    pp = port_index.pack_index(pidx, torch.from_numpy(x), dtype=torch.bfloat16, pad=1024)
    path = str(tmp_path / "idx.npz")
    checkpoint.save_index(path, pp)
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["version"] == 3 and meta["packed_dtypes"]["packed"] == "bfloat16"
    back = jax_ckpt.load_index(path)
    np.testing.assert_array_equal(np.asarray(back.sorted_rows), np.asarray(jidx.sorted_rows))
    np.testing.assert_array_equal(to_np(back.packed), to_np(pp.packed))
    again = port_index.index_from_numpy(*handover(back), torch.device("cpu"))
    assert torch.equal(again.packed, pp.packed)


def test_per_row_int8_archive_is_refused(built):
    """Per-row int8 slabs are not ported yet: loading them raises instead of
    serving a path the port does not have."""
    x, jidx, _ = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.int8, pad=1024,
                              scale_mode="row")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4"):
        port_index.index_from_numpy(*handover(jp), torch.device("cpu"))
