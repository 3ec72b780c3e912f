"""Helpers for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

JAX and torch draw different random numbers from one seed, so the JAX
index's arrays (hash parameters, CSR tables, slabs) cross over to the port
as numpy arrays through `index_from_numpy`.
"""

import numpy as np
import torch


def handover(jidx):
    """JAX LshIndex -> (meta, arrays) for the port's index_from_numpy; bf16
    slabs cross as their uint16 bit view, as in the checkpoint format."""
    meta = {
        "metric": jidx.metric, "n_buckets": jidx.n_buckets,
        "n_rows": jidx.n_rows, "k": jidx.family.k, "L": jidx.family.L,
        "packed_dtypes": {},
    }
    arrays = {
        "proj": np.asarray(jidx.family.proj),
        "bucket_ids": np.asarray(jidx.bucket_ids),
        "sorted_rows": np.asarray(jidx.sorted_rows),
        "bucket_starts": np.asarray(jidx.bucket_starts),
    }
    for f in ("packed", "packed_rows", "packed_scale", "packed_gscale"):
        a = getattr(jidx, f)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
            meta["packed_dtypes"][f] = "bfloat16"
        arrays[f] = a
    return meta, arrays


def to_np(t):
    """torch tensor (any dtype, bf16 -> f32) or jax array -> numpy."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_topk_match(s_ref, i_ref, s_got, i_got, rtol=1e-5, atol=1e-5):
    """Scores agree within rtol/atol; ids agree as sets per query wherever
    the score gap to the k-th (boundary) score exceeds the tolerance — tie
    order differs between lax.top_k and torch.topk.  No duplicate ids."""
    s_ref, i_ref, s_got, i_got = map(to_np, (s_ref, i_ref, s_got, i_got))
    assert s_ref.shape == s_got.shape and i_ref.shape == i_got.shape
    np.testing.assert_allclose(s_got, s_ref, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(i_got < 0, i_ref < 0)
    for q in range(s_ref.shape[0]):
        real = i_got[q][i_got[q] >= 0]
        assert len(set(real.tolist())) == len(real), f"query {q}: duplicate ids"
        fin = np.isfinite(s_ref[q])
        if not fin.any():
            continue
        b = s_ref[q][fin].min()
        tol = atol + rtol * abs(b)
        sure_ref = set(i_ref[q][s_ref[q] > b + 2 * tol].tolist())
        sure_got = set(i_got[q][s_got[q] > b + 2 * tol].tolist())
        assert sure_ref <= set(i_got[q].tolist()), f"query {q}: ids differ"
        assert sure_got <= set(i_ref[q].tolist()), f"query {q}: ids differ"
