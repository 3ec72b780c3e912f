"""Worker process of the port's multi-process test (run by
tests/test_torch_multihost.py, not collected by pytest).

Each process is one torch.distributed rank of a gloo group (CPU tensors)
and owns 4 of the 8 logical cells of each mesh it builds: a (2, 4) mesh,
where each rank holds one whole dp row, and a (1, 8) mesh, where each rank
holds half the shards, so the all_gather merges and the all_to_all
routing cross the process boundary.  It imports torch and the port only,
never JAX.

argv: <store file> <world size> <rank> <inputs npz> <outputs npz>
"""

import os
import sys


def main() -> None:
    store, world, rank, in_path, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from crypto_rec_tpu_torch import checkpoint
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.index import build_index
    from crypto_rec_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from crypto_rec_tpu_torch.parallel.routing import routed_retrieve_topk
    from crypto_rec_tpu_torch.parallel.sharded_index import (
        build_sharded_index, shard_corpus, sharded_recommend_csr, sharded_retrieve_topk,
    )

    initialize_multihost(f"file://{store}", world, rank, retries=2, retry_delay_s=1.0,
                         device="cpu")
    assert torch.distributed.get_world_size() == world
    z = np.load(in_path)
    corpus, queries, known, mean = (torch.from_numpy(z[k]) for k in
                                    ("corpus", "queries", "known", "mean"))
    fam = CosineLsh(proj=torch.from_numpy(z["proj"]), k=5, L=6)
    q = queries.shape[0]
    out = {}
    for name, shape in (("dp2", (2, 4)), ("mp8", (1, 8))):
        mesh = make_mesh(shape, device="cpu")
        assert len(mesh.cells) == 4
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
    # the all_to_all exchange across the two ranks, and per-rank checkpoint
    # files of the (1, 8) index (each rank writes its own four shards)
    single = build_index(None, corpus, "cosine", 5, 6, family=fam)
    rv, ri, rstats = routed_retrieve_topk(mesh, single, queries, corpus, top_k=10, budget=128)
    out.update(routed_vals=rv.numpy(), routed_ids=ri.numpy(),
               routed_dropped=np.array(rstats["dropped_requests"]))
    prefix = os.path.join(os.path.dirname(out_path), "mh_index")
    written = checkpoint.save_sharded_index(prefix, index, mesh)
    assert len(written) == (5 if rank == 0 else 4), written
    torch.distributed.barrier()
    back = checkpoint.load_sharded_index(prefix, mesh)
    assert back.shards == tuple(mesh.local_shards)
    assert torch.equal(back.sorted_rows, index.sorted_rows)
    assert not [m for m in sys.modules if m.split(".")[0].startswith("jax")
                or m.split(".")[0] == "crypto_rec_tpu"]
    if rank == 0:
        np.savez(out_path, **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
