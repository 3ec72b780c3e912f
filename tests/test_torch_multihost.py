"""The port across processes: 2 gloo ranks x 4 logical cells each.

tests/torch_multihost_worker.py runs in two OS processes joined by
torch.distributed (gloo, a file:// store), builds the sharded index on a
(2, 4) mesh (each rank one whole dp row) and on a (1, 8) mesh (each rank
half the shards: the all_gather merges cross processes), runs
sharded_retrieve_topk and sharded_recommend_csr on both, the routed
all_to_all exchange on the (1, 8) mesh, and a per-rank sharded checkpoint.
Its results must equal the port's single-process 8-cell results exactly
and the JAX package's (2, 4) result on its 8 CPU devices (tests/
test_multihost.py's computation) within the parity tolerances.  The
workers import no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _mh_data import make_data
from _torch_parity import assert_topk_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_reference():
    """tests/test_multihost.py's single-process computation on JAX's
    8-device (2, 4) mesh; also returns its hyperplanes."""
    from crypto_rec_tpu.parallel.mesh import make_mesh
    from crypto_rec_tpu.parallel.sharded_index import (
        build_sharded_index, shard_corpus, sharded_recommend_csr, sharded_retrieve_topk,
    )

    corpus_np, queries_np, known_np, mean_np = make_data()
    q = queries_np.shape[0]
    mesh = make_mesh((2, 4))
    corpus = shard_corpus(mesh, jnp.asarray(corpus_np))
    queries = jnp.asarray(queries_np)
    index = build_sharded_index(mesh, jax.random.PRNGKey(9), corpus, "cosine", k=5, L=6)
    vals, ids = sharded_retrieve_topk(mesh, index, queries, corpus, budget=128, top_k=10)
    nm = jax.device_put(jnp.asarray(mean_np), NamedSharding(mesh, P("mp")))
    pred, top, has, sims, gids, stats = sharded_recommend_csr(
        mesh, index, queries, jnp.asarray(known_np[:q]), jnp.asarray(mean_np[:q]),
        corpus, nm, budget=128, top_p=6, top_n=3)
    from crypto_rec_tpu.models.lsh.index import build_index
    from crypto_rec_tpu.parallel.routing import routed_retrieve_topk

    single = build_index(jax.random.PRNGKey(9), jnp.asarray(corpus_np), "cosine", k=5, L=6,
                         lsh_bucket_div=4, euclidean_h_w=1.0)
    rv, ri, _ = routed_retrieve_topk(make_mesh((1, 8)), single, queries,
                                     jnp.asarray(corpus_np), top_k=10, budget=128)
    g = lambda a: np.asarray(jax.device_get(a))
    routed = (g(rv), g(ri))
    ref = dict(vals=g(vals), ids=g(ids), pred=g(pred), top=g(top), has=g(has),
               sims=g(sims), gids=g(gids),
               stats=np.array([int(stats[k]) for k in (
                   "unique_candidates", "budget_dropped", "window_dropped")]))
    assert np.array_equal(np.asarray(single.family.proj), np.asarray(index.family.proj))
    return ref, routed, np.asarray(index.family.proj)


def _port_single_process(proj):
    """The workers' computation in this process, every cell local."""
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.index import build_index
    from crypto_rec_tpu_torch.parallel.mesh import make_mesh
    from crypto_rec_tpu_torch.parallel.routing import routed_retrieve_topk
    from crypto_rec_tpu_torch.parallel.sharded_index import (
        build_sharded_index, shard_corpus, sharded_recommend_csr, sharded_retrieve_topk,
    )

    corpus, queries, known, mean = map(torch.from_numpy, make_data())
    fam = CosineLsh(proj=torch.from_numpy(proj.copy()), k=5, L=6)
    q = queries.shape[0]
    out = {}
    for name, shape in (("dp2", (2, 4)), ("mp8", (1, 8))):
        mesh = make_mesh(shape, device="cpu")
        pc = shard_corpus(mesh, corpus)
        index = build_sharded_index(mesh, None, pc, "cosine", 5, 6, family=fam)
        vals, ids = sharded_retrieve_topk(mesh, index, queries, pc, budget=128, top_k=10)
        pred, top, has, sims, gids, stats = sharded_recommend_csr(
            mesh, index, queries, known[:q], mean[:q], pc, shard_corpus(mesh, mean),
            budget=128, top_p=6, top_n=3)
        out.update({f"{name}_{k}": v.numpy() for k, v in dict(
            vals=vals, ids=ids, pred=pred, top=top, has=has, sims=sims, gids=gids).items()})
        out[f"{name}_stats"] = np.array([int(stats[k]) for k in (
            "unique_candidates", "budget_dropped", "window_dropped")])
    single = build_index(None, corpus, "cosine", 5, 6, family=fam)
    rv, ri, rstats = routed_retrieve_topk(mesh, single, queries, corpus, top_k=10, budget=128)
    out.update(routed_vals=rv.numpy(), routed_ids=ri.numpy(),
               routed_dropped=np.array(rstats["dropped_requests"]))
    return out


def test_two_gloo_processes_match_one_process_and_jax(tmp_path):
    ref, routed, proj = _jax_reference()
    corpus, queries, known, mean = make_data()
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, corpus=corpus, queries=queries, known=known, mean=mean, proj=proj)
    out_npz = str(tmp_path / "out.npz")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_multihost_worker.py"),
             str(tmp_path / "store"), "2", str(rank), inputs, out_npz],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            outs.append((p.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        pytest.fail("multi-process worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, stdout, stderr in outs:
        assert rc == 0, f"worker failed rc={rc}\n{stdout}\n{stderr}"
    got = dict(np.load(out_npz))
    # two processes == one process, bit for bit (the collectives only move data)
    want = _port_single_process(proj)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # == JAX's (2, 4) computation, on both meshes
    for name in ("dp2", "mp8"):
        g = {k: got[f"{name}_{k}"] for k in ref}
        assert_topk_match(ref["vals"], ref["ids"], g["vals"], g["ids"])
        assert_topk_match(ref["sims"], ref["gids"], g["sims"], g["gids"])
        np.testing.assert_allclose(g["pred"], ref["pred"], atol=1e-4)
        np.testing.assert_array_equal(g["top"], ref["top"])
        np.testing.assert_array_equal(g["has"], ref["has"])
        np.testing.assert_array_equal(g["stats"], ref["stats"])
    assert int(got["routed_dropped"]) == 0
    assert_topk_match(*routed, got["routed_vals"], got["routed_ids"])
