"""10-fold CV parity: the port's hide_one_score and ten_fold_mae against
the JAX package's, with JAX's draws handed over (the fold permutation,
each fold's hidden coins and hash hyperplanes).  Hidden ratings and means
within rtol 1e-6, hidden coins and scoreable masks exactly; the MAE of
each engine (mask, csr, fused at d = 128) within 1e-5.

JAX's ten_fold_mae(engine="fused") takes retrieve_topk's XLA branch off
the TPU; its kernel branch (the one the port runs, K1) is reached by
pointing retrieve_topk at retrieve_topk_pallas in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.models.lsh.hyperplane import CosineLsh as JaxCosineLsh
from crypto_rec_tpu.models.rec import engine as jax_engine
from crypto_rec_tpu.models.rec import validate as jax_validate
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.rec import validate
from crypto_rec_tpu_torch.models.rec.engine import RatingSet


def _population(n, c, seed):
    """bench_cv.py's recipe at a small size: users mix a few taste
    profiles, 30% of the coins known (at least one)."""
    rng = np.random.default_rng(seed)
    profiles = rng.gamma(2.0, 1.0, (8, c)).astype(np.float32)
    full = np.abs(profiles[rng.integers(0, 8, n)]
                  + 0.15 * rng.standard_normal((n, c))).astype(np.float32)
    known = rng.random((n, c)) < 0.3
    known[np.arange(n), rng.integers(0, c, n)] = True
    known[0] = False
    known[0, 1] = True                                 # one known coin: not scoreable
    mean = ((full * known).sum(1) / np.maximum(known.sum(1), 1)).astype(np.float32)
    return np.where(known, full, mean[:, None]).astype(np.float32), known, mean


@pytest.mark.parametrize("mode", ["fixed", "reference"])
def test_hide_one_score_matches_jax(mode):
    ratings, known, _ = _population(60, 12, 1)
    hidden, hide, ok = jax_validate.hide_one_score(
        jax.random.PRNGKey(3), jnp.asarray(ratings), jnp.asarray(known), 12, hide_mode=mode)
    got, ghide, gok = validate.hide_one_score(
        None, torch.from_numpy(ratings), torch.from_numpy(known), 12, hide_mode=mode,
        hide_idx=torch.from_numpy(np.asarray(hide).copy()))
    np.testing.assert_array_equal(ghide.numpy(), np.asarray(hide))
    np.testing.assert_array_equal(gok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(got.known.numpy(), np.asarray(hidden.known))
    np.testing.assert_allclose(got.ratings.numpy(), np.asarray(hidden.ratings), rtol=1e-6)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(hidden.mean), rtol=1e-6)
    assert not bool(gok[0])
    # the port's own draw: a known coin ("fixed"), a column below the known
    # count ("reference")
    g = torch.Generator().manual_seed(0)
    _, mine, _ = validate.hide_one_score(g, torch.from_numpy(ratings),
                                         torch.from_numpy(known), 12, hide_mode=mode)
    counts = known.sum(1)
    if mode == "fixed":
        assert known[np.arange(60), mine.numpy()].all()
    else:
        assert (mine.numpy() < counts).all()
    with pytest.raises(ValueError):
        validate.hide_one_score(g, torch.from_numpy(ratings), torch.from_numpy(known), 12,
                                hide_mode="bogus")


def _jax_draws(key, users, k, L, hide_mode):
    """The draws JAX's ten_fold_mae makes from `key`, in its order, as the
    port's FoldDraws."""
    ratings, known = np.asarray(users.ratings), np.asarray(users.known)
    n, c = ratings.shape
    fs = n // 10
    key, kperm = jax.random.split(key)
    folds = np.asarray(jax.random.permutation(kperm, n))[:10 * fs].reshape(10, fs)
    hide, fams = [], []
    for i in range(10):
        key, kidx = jax.random.split(key)
        kfold, khide = jax.random.split(kidx)
        rows = folds[i]
        _, h, _ = jax_validate.hide_one_score(khide, jnp.asarray(ratings[rows]),
                                              jnp.asarray(known[rows]), c, hide_mode)
        hide.append(torch.from_numpy(np.asarray(h).copy()))
        proj = np.asarray(JaxCosineLsh.create(kfold, c, k, L).proj)
        fams.append(CosineLsh(proj=torch.from_numpy(proj.copy()), k=k, L=L))
    return validate.FoldDraws(folds=torch.from_numpy(folds.copy()), hide_idx=hide,
                              families=fams)


def _mae_pair(users_np, engine, hide_mode, k, L, top_p, budget):
    users = jax_engine.RatingSet(*map(jnp.asarray, users_np))
    key = jax.random.PRNGKey(22)
    want = jax_validate.ten_fold_mae(key, users, "cosine", k, L, 4, 1.0, top_p,
                                     hide_mode=hide_mode, engine=engine,
                                     candidate_budget=budget)
    draws = _jax_draws(key, users, k, L, hide_mode)
    got = validate.ten_fold_mae(None, RatingSet(*map(torch.from_numpy, users_np)),
                                "cosine", k, L, 4, 1.0, top_p, hide_mode=hide_mode,
                                engine=engine, candidate_budget=budget, draws=draws)
    return want, got


@pytest.mark.parametrize("engine,hide_mode,budget", [("mask", "fixed", 256),
                                                     ("mask", "reference", 256),
                                                     ("csr", "fixed", 32)])
def test_ten_fold_mae_matches_jax(engine, hide_mode, budget):
    """205 users: 5 remainder users are dropped; budget 32 truncates the
    csr unions."""
    want, got = _mae_pair(_population(205, 10, 2), engine, hide_mode, 4, 4, 8, budget)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) < 1e-5, (got, want)


def test_ten_fold_mae_fused_matches_jax_kernel_path(monkeypatch):
    """f32 slabs at d = 128 through K1's plain version against JAX's slab
    kernel (interpret mode)."""
    calls = []

    def kernel_branch(index, queries, corpus, top_k, per_table):
        calls.append(index.packed.dtype)
        return jax_index.retrieve_topk_pallas(index, queries, corpus, top_k=top_k,
                                              per_table=per_table, interpret=True)

    monkeypatch.setattr(jax_index, "retrieve_topk", kernel_branch)
    want, got = _mae_pair(_population(300, 128, 3), "fused", "fixed", 4, 4, 8, 64)
    assert calls and calls[0] == jnp.float32          # traced once, f32 slabs
    assert np.isfinite(got) and got > 0
    assert abs(got - want) < 1e-5, (got, want)


def test_ten_fold_mae_draws_from_its_generator():
    users = RatingSet(*map(torch.from_numpy, _population(100, 10, 4)))
    args = (users, "cosine", 4, 4, 4, 1.0, 8)
    a = validate.ten_fold_mae(torch.Generator().manual_seed(5), *args)
    b = validate.ten_fold_mae(torch.Generator().manual_seed(5), *args)
    c = validate.ten_fold_mae(torch.Generator().manual_seed(6), *args)
    assert a == b and a != c and np.isfinite(a)
    with pytest.raises(ValueError):
        validate.ten_fold_mae(torch.Generator(), *args, engine="bogus")
    with pytest.raises(ValueError):
        validate.ten_fold_mae(torch.Generator(), RatingSet(*(t[:9] for t in (
            users.ratings, users.known, users.mean))), *args[1:])
