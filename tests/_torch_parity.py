"""Helpers for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

JAX and torch draw different random numbers from one seed, so the JAX
index's arrays (hash parameters, CSR tables, slabs) cross over to the port
as numpy arrays through `index_from_numpy`.  `load_probe` takes the
kernel functions of a probe script without running the script.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import torch

EXPERIMENTS = Path(__file__).resolve().parents[1] / "benchmarks" / "experiments"


def load_probe(path, names, consts):
    """The named top-level functions of a probe script, without running
    the script (P1-P4 build a 2M-row corpus at module level).  They are
    compiled from the file's own source into a fresh namespace holding
    jax, jnp, functools, pltpu, `consts` and a `pl` whose pallas_call
    always runs in interpret mode, so the TPU kernels run on the CPU.
    -> SimpleNamespace of the functions."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as real_pl
    from jax.experimental.pallas import tpu as pltpu

    class _InterpretPl:
        def __getattr__(self, name):
            return getattr(real_pl, name)

        @staticmethod
        def pallas_call(*args, **kwargs):
            kwargs["interpret"] = True
            return real_pl.pallas_call(*args, **kwargs)

    with open(path) as f:
        tree = ast.parse(f.read(), filename=str(path))
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    missing = set(names) - {n.name for n in body}
    assert not missing, f"{path}: no functions {sorted(missing)}"
    ns = dict(jax=jax, jnp=jnp, functools=functools, pl=_InterpretPl(), pltpu=pltpu,
              **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return types.SimpleNamespace(**{n: ns[n] for n in names})


def probe_functions():
    """The probe kernels' JAX functions by id, P1-P6 (probe_r5_int4.py has
    a main() guard and interprets off the TPU, so it is imported as is)."""
    a32 = {"_ALIGN": 32}
    spec = importlib.util.spec_from_file_location(
        "probe_r5_int4", EXPERIMENTS / "probe_r5_int4.py")
    p6 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(p6)
    return dict(
        p1=load_probe(EXPERIMENTS / "probe_r3_mask.py",
                      ["make_kernel_nomask", "dots_nomask"], a32),
        p2=load_probe(EXPERIMENTS / "probe_r3_split.py",
                      ["variant_kernel", "run_variant"], a32),
        p3=load_probe(EXPERIMENTS / "probe_r3_binned.py",
                      ["make_binned_kernel", "binned_dots", "retrieve_binned"], a32),
        p4=load_probe(EXPERIMENTS / "probe_r3_final.py",
                      ["make_kernel", "nomask_dots", "dedup_topk", "retrieve_nomask"], a32),
        p5=load_probe(EXPERIMENTS / "probe_r4_blk.py",
                      ["make_blk_kernel", "blk_window_dots"], {"B": 128}),
        p6=p6,
    )


def to_torch(a):
    """numpy / jax array -> torch tensor (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


_PACKED = ("packed", "packed_rows", "packed_detailed", "packed_scale",
           "packed_sqnorm", "packed_gscale", "packed_aug_scale")


def _family(fam, meta, arrays, prefix=""):
    meta.update(k=fam.k, L=fam.L)
    arrays[prefix + "proj"] = np.asarray(fam.proj)
    if hasattr(fam, "offsets"):                     # p-stable
        meta["w"] = fam.w
        arrays[prefix + "offsets"] = np.asarray(fam.offsets)
        arrays[prefix + "weights"] = np.asarray(fam.weights)


def _fields(obj, names, meta, arrays, prefix=""):
    """Copy obj's non-None array fields; bf16 crosses as its uint16 bit
    view with "bfloat16" recorded, as in the checkpoint format."""
    for f in names:
        a = getattr(obj, f, None)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
            meta["packed_dtypes"][prefix + f] = "bfloat16"
        arrays[prefix + f] = a


def handover(jidx):
    """JAX LshIndex -> (meta, arrays) for the port's index_from_numpy."""
    meta = {"metric": jidx.metric, "n_buckets": jidx.n_buckets,
            "n_rows": jidx.n_rows, "packed_dtypes": {}}
    arrays = {}
    _family(jidx.family, meta, arrays)
    _fields(jidx, ("bucket_ids", "sorted_rows", "bucket_starts", "detailed")
            + _PACKED, meta, arrays)
    return meta, arrays


_CUBE = ("mix_mul", "mix_add", "vertices", "sorted_rows", "bucket_starts")


def cube_handover(jcube):
    """JAX Hypercube -> (meta, arrays) for the port's hypercube_from_numpy."""
    meta = {"metric": jcube.metric, "n_rows": jcube.n_rows, "packed_dtypes": {}}
    arrays = {}
    _family(jcube.family, meta, arrays)
    meta["k"] = jcube.k
    _fields(jcube, _CUBE + _PACKED, meta, arrays)
    return meta, arrays


def multicube_handover(jmc):
    """JAX MultiCube -> (meta, arrays) for the port's multicube_from_numpy:
    the shared slab, plus each cube's arrays under "cube{ci}."."""
    meta = {"metric": jmc.metric, "k": jmc.k, "n_rows": jmc.n_rows,
            "n_cubes": jmc.n_cubes, "n_pad": jmc.n_pad, "packed_dtypes": {}}
    arrays = {}
    _fields(jmc, ("packed", "packed_rows", "bucket_starts", "packed_gscale",
                  "packed_aug_scale"), meta, arrays)
    for ci, cube in enumerate(jmc.cubes):
        _family(cube.family, {}, arrays, prefix=f"cube{ci}.")
        if jmc.metric == "euclidean":
            meta["w"] = cube.family.w
        _fields(cube, _CUBE, meta, arrays, prefix=f"cube{ci}.")
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


def assert_recs_match(want, got, rtol=1e-5, atol=1e-5):
    """Two Recommendations (JAX, port) agree: predicted within rtol/atol,
    has_neighbors equal, top_n equal except where predictions tie within
    1e-6."""
    wp, gp = np.asarray(want.predicted), to_np(got.predicted)
    np.testing.assert_allclose(gp, wp, rtol=rtol, atol=atol)
    wt, gt = np.asarray(want.top_n), to_np(got.top_n)
    np.testing.assert_array_equal(to_np(got.has_neighbors), np.asarray(want.has_neighbors))
    for q in np.nonzero((wt != gt).any(1))[0]:
        a, b = wt[q][wt[q] != gt[q]], gt[q][wt[q] != gt[q]]
        assert (a >= 0).all() and (b >= 0).all(), f"user {q}: top-n pads differ"
        assert np.abs(np.sort(wp[q, a]) - np.sort(wp[q, b])).max() <= 1e-6, (
            f"user {q}: top-n differs beyond a prediction tie"
        )
