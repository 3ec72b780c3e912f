"""`serve_cli recommend`, the user-matrix archive, `index_nbytes` and the
memory accounting, against the JAX package.

The JAX CLI draws its hyperplanes from PRNGKey(seed); they are handed over
to the port's `recommend_users` core, whose output must equal the JAX
CLI's file line for line.  User-matrix archives written by either package
load in the other with every array equal; `index_nbytes` equals JAX's for
cosine and euclidean indexes, packed or not.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu import serve_cli as jax_serve
from crypto_rec_tpu.io.native import score_tweets_native as jax_native
from crypto_rec_tpu.io.users import build_user_matrix as jax_users
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.utils import memory as jax_memory
from crypto_rec_tpu_torch import checkpoint, serve_cli
from crypto_rec_tpu_torch.io.ingest import CoinTable
from crypto_rec_tpu_torch.io.readers import read_str_vectors
from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.utils import memory

from _torch_parity import handover

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def users(tmp_path_factory):
    ds = tmp_path_factory.mktemp("rec")
    write_synthetic_dataset(str(ds), n_users=120, n_tweets=900, n_coins=12, seed=17)
    um = jax_users(jax_native(f"{ds}/tweets.tsv", f"{ds}/lexicon.tsv", f"{ds}/coins.tsv",
                              "\t"))
    jax_ckpt.save_user_matrix(str(ds / "users.npz"), um)
    return ds, um


@pytest.mark.parametrize("seed,top_n,lsh_k,lsh_l", [(0, 3, 4, 5), (7, 5, 3, 2)])
def test_recommend_writes_jax_file(users, tmp_path, seed, top_n, lsh_k, lsh_l):
    ds, um = users
    flags = ["--top-n", str(top_n), "--lsh-k", str(lsh_k), "--lsh-l", str(lsh_l),
             "--seed", str(seed)]
    assert jax_serve.main(["recommend", "--users", str(ds / "users.npz"), "--coins",
                           f"{ds}/coins.tsv", *flags, "-o", str(tmp_path / "jax.txt")]) == 0
    jidx = jax_index.build_index(jax.random.PRNGKey(seed), jnp.asarray(um.ratings),
                                 "cosine", lsh_k, lsh_l, 4, 1.0)
    fam = CosineLsh(proj=torch.from_numpy(np.asarray(jidx.family.proj).copy()),
                    k=lsh_k, L=lsh_l)
    coins = CoinTable.from_rows(read_str_vectors(f"{ds}/coins.tsv", "\t")[0])
    with open(tmp_path / "port.txt", "w") as out:
        n = serve_cli.recommend_users(checkpoint.load_user_matrix(str(ds / "users.npz")),
                                      coins, 20, top_n, fam, out)
    want = (tmp_path / "jax.txt").read_text().splitlines()
    assert (tmp_path / "port.txt").read_text().splitlines() == want
    assert n == len(want) > 10


def test_recommend_cli_runs_and_needs_a_gpu_by_default(users, tmp_path, monkeypatch, capsys):
    ds, um = users
    base = ["recommend", "--users", str(ds / "users.npz"), "--coins", f"{ds}/coins.tsv",
            "--top-n", "3"]
    assert serve_cli.main(base + ["--device", "cpu", "-o", str(tmp_path / "r.txt")]) == 0
    lines = (tmp_path / "r.txt").read_text().splitlines()
    assert len(lines) > 10 and all(l.split()[0].startswith("user") for l in lines)
    assert f"/{len(um.ids)} users" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_cli.main(base + ["-o", str(tmp_path / "g.txt")]) == 2
    assert "no NVIDIA GPU" in capsys.readouterr().err


def test_user_matrix_archives_move_both_ways(users, tmp_path):
    ds, um = users
    got = checkpoint.load_user_matrix(str(ds / "users.npz"))
    checkpoint.save_user_matrix(str(tmp_path / "p.npz"), got)
    back = jax_ckpt.load_user_matrix(str(tmp_path / "p.npz"))
    for m in (got, back):
        assert m.ids == um.ids
        for f in ("ratings", "known", "mean"):
            a = getattr(m, f)
            assert a.dtype == getattr(um, f).dtype, f
            np.testing.assert_array_equal(a, getattr(um, f), err_msg=f)


@pytest.mark.parametrize("metric,dtype", [("cosine", None), ("cosine", "int8"),
                                          ("euclidean", None), ("euclidean", "int8")])
def test_index_nbytes_matches_jax(metric, dtype):
    x = np.random.default_rng(2).normal(size=(600, 16)).astype(np.float32)
    j = jax_index.build_index(jax.random.PRNGKey(0), jnp.asarray(x), metric, 4, 3, 4, 2.0)
    if dtype:
        j = jax_index.pack_index(j, jnp.asarray(x), dtype=jnp.int8, pad=512)
    p = port_index.index_from_numpy(*handover(j), CPU)
    assert checkpoint.index_nbytes(p) == jax_ckpt.index_nbytes(j) > 0


def test_memory_accounting_on_the_cpu():
    for n in (0, 1023, 1024, 5 * 2**20, 3 * 2**40, 2**55):
        assert memory.format_bytes(n) == jax_memory.format_bytes(n)
    assert memory.live_array_bytes() >= 0
    assert isinstance(memory.device_memory_stats(), dict)
