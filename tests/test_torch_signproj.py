"""K2 (sign-projection hash): the port's plain version and CosineLsh against
the JAX package's Pallas kernel (interpret mode) and XLA hash.  Bucket ids
must be exactly equal; JAX's hyperplanes are handed over."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh as JaxCosineLsh
from crypto_rec_tpu.ops.pallas.signproj import signproj_bucket_ids as jax_signproj
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.ops.kernels.signproj import (
    signproj_bucket_ids,
    signproj_bucket_ids_plain,
)

KEY = jax.random.PRNGKey(3)


# the shapes of test_pallas_kernels.py: a block multiple and a ragged count
@pytest.mark.parametrize("k,L,d,n,block_rows", [(5, 3, 32, 300, 128),
                                                (4, 2, 16, 77, 64)])
def test_signproj_matches_jax(k, L, d, n, block_rows):
    rng = np.random.default_rng(23 + n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    fam = JaxCosineLsh.create(KEY, d, k, L)
    want_xla = np.asarray(fam.bucket_ids(jnp.asarray(x)))
    want_pallas = np.asarray(jax_signproj(
        jnp.asarray(x), fam.proj, k, L, block_rows=block_rows, interpret=True
    ))
    np.testing.assert_array_equal(want_pallas, want_xla)

    proj = torch.from_numpy(np.asarray(fam.proj).copy())
    xt = torch.from_numpy(x)
    got_plain = signproj_bucket_ids_plain(xt, proj, k, L)
    assert got_plain.dtype == torch.int32 and got_plain.shape == (n, L)
    np.testing.assert_array_equal(got_plain.numpy(), want_pallas)
    # the routed wrapper and the family take the plain version on CPU
    np.testing.assert_array_equal(signproj_bucket_ids(xt, proj, k, L).numpy(),
                                  want_pallas)
    np.testing.assert_array_equal(
        CosineLsh(proj=proj, k=k, L=L).bucket_ids(xt).numpy(), want_xla
    )


def test_signproj_rejects_wide_k():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        signproj_bucket_ids(x, torch.zeros(8, 31), 31, 1)
    with pytest.raises(ValueError):
        signproj_bucket_ids(x, torch.zeros(8, 6), 4, 2)   # proj is not [d, L*k]


def test_create_is_deterministic_per_seed():
    """One seed gives the same hyperplanes wherever the index lives."""
    a = CosineLsh.create(torch.Generator().manual_seed(5), 16, 4, 3, torch.device("cpu"))
    b = CosineLsh.create(torch.Generator().manual_seed(5), 16, 4, 3, torch.device("cpu"))
    assert a.proj.shape == (16, 12) and a.n_buckets == 16
    assert torch.equal(a.proj, b.proj)
