"""Hypercube and MultiCube: the port against the JAX package, with JAX's
hash parameters (and, for retrieval, its packed slabs) handed over as
arrays (hypercube_from_numpy, multicube_from_numpy).

Exact: Hamming probe order, `_f_bits` (with int32 wrap), vertex ids, CSR
rows / starts, `cube_candidate_mask`, `cube_candidate_ids` (as sets per
query), packed rows.  `directed_probe_vertices`: equal wherever the probe
scores are apart by more than 1e-5 relative, equal as sets elsewhere.
Slabs: one quantization step on < 0.01% of elements; scales rtol 1e-6.
Retrieval: assert_topk_match at rtol 1e-5, JAX's kernel branches running
in interpret mode on the CPU; euclidean scores compared squared (see
tests/test_torch_pstable.py: -sqrt(|q|^2 - 2 rank) cancels two terms of
size |q|^2), with atol 1e-5 |q|^2_max.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh import hypercube as jax_cube
from crypto_rec_tpu.ops.hamming import hamming_probe_order as jax_hamming
from crypto_rec_tpu_torch.models.lsh import hypercube as port_cube
from crypto_rec_tpu_torch.ops.hamming import hamming_probe_order

from _torch_parity import assert_topk_match, cube_handover, multicube_handover

N, D, Q, KB, TOP = 4096, 128, 32, 8, 10
W = {"cosine": 1.0, "euclidean": 6.0}
CPU = torch.device("cpu")
DT = {"int8": torch.int8, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = 2.0 * rng.normal(size=(32, D))
    x = (centers[rng.integers(0, 32, N)] + 0.5 * rng.normal(size=(N, D))).astype(np.float32)
    qs = (x[:Q] + 0.05 * rng.normal(size=(Q, D))).astype(np.float32)
    cubes = {}
    for metric, w in W.items():
        jc = jax_cube.build_hypercube(jax.random.PRNGKey(2), jnp.asarray(x), metric, KB, w)
        hand = port_cube.hypercube_from_numpy(*cube_handover(jc), CPU)
        pc = port_cube.build_hypercube(None, torch.from_numpy(x), metric, KB, w,
                                       family=hand.family, mix_mul=hand.mix_mul,
                                       mix_add=hand.mix_add)
        cubes[metric] = (jc, pc)
    return dict(x=x, qs=qs, X=torch.from_numpy(x), QS=torch.from_numpy(qs), cubes=cubes)


def _assert_euclid_topk(want, got, qs):
    assert_topk_match(-np.asarray(want[0]) ** 2, want[1], -got[0].numpy() ** 2, got[1],
                      rtol=1e-5, atol=1e-5 * float((qs ** 2).sum(1).max()))


def _assert_topk(metric, want, got, qs):
    if metric == "cosine":
        assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    else:
        _assert_euclid_topk(want, got, qs)
    ids = got[1].numpy()
    assert ids.max() < N and (ids[:, 0] >= 0).all()


@pytest.mark.parametrize("k,probes", [(4, 1), (4, 6), (5, 40), (13, 64), (3, 100)])
def test_hamming_probe_order_matches_jax(k, probes):
    np.testing.assert_array_equal(hamming_probe_order(k, probes), jax_hamming(k, probes))


def test_f_bits_match_jax_with_int32_wrap():
    rng = np.random.default_rng(6)
    h = rng.integers(-2**31, 2**31, size=(500, 13)).astype(np.int32)
    h[:100] = rng.integers(-50, 50, size=(100, 13))
    mul = (rng.integers(0, 1 << 30, 13) * 2 + 1).astype(np.int32)
    add = rng.integers(0, 1 << 30, 13).astype(np.int32)
    assert (np.abs(h.astype(np.int64) * mul) >= 2**31).mean() > 0.5   # the product wraps
    want = np.asarray(jax_cube._f_bits(jnp.asarray(h), jnp.asarray(mul), jnp.asarray(add)))
    got = port_cube._f_bits(torch.from_numpy(h), torch.from_numpy(mul), torch.from_numpy(add))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.4 < want.mean() < 0.6


@pytest.mark.parametrize("metric", list(W))
def test_build_hypercube_matches_jax(data, metric):
    jc, pc = data["cubes"][metric]
    for f in ("vertices", "sorted_rows", "bucket_starts"):
        got = getattr(pc, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    # the port's own seeded draws build a valid cube too
    own = port_cube.build_hypercube(torch.Generator().manual_seed(1), data["X"], metric,
                                    KB, W[metric])
    assert int(own.bucket_starts[0, -1]) == N and own.vertices.max() < (1 << KB)
    if metric == "euclidean":
        assert bool((own.mix_mul % 2 == 1).all())


@pytest.mark.parametrize("metric", list(W))
def test_cube_candidate_mask_and_ids_match_jax(data, metric):
    jc, pc = data["cubes"][metric]
    jq, pq = jnp.asarray(data["qs"]), data["QS"]
    np.testing.assert_array_equal(
        port_cube.cube_candidate_mask(pc, pq, 10).numpy(),
        np.asarray(jax_cube.cube_candidate_mask(jc, jq, 10)))
    want = np.asarray(jax_cube.cube_candidate_ids(jc, jq, 10, 64))
    got = port_cube.cube_candidate_ids(pc, pq, 10, 64).numpy()
    assert got.shape == want.shape and (want >= 0).any()
    for a, b in zip(want, got):
        assert set(a.tolist()) == set(b.tolist())


def _assert_probes_match(jc, qs, want, got, probes):
    """Home first; probe scores (summed margins of the flipped bits) decide
    the order, and slots whose score is within 1e-5 relative of a
    neighbour's may swap (the subset sums' f32 order); same sets."""
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])            # home first
    margins = np.asarray(jax_cube._bit_margins(jc, jnp.asarray(qs)))
    bitpos = KB - 1 - np.arange(KB)
    for qi in range(len(qs)):
        flips = (want[qi, 0] ^ want[qi])[:, None] >> bitpos[None, :] & 1
        score = flips @ margins[qi]
        tied = np.zeros(probes, bool)
        close = np.abs(np.diff(score)) <= 1e-5 * np.maximum(np.abs(score[1:]), 1e-30)
        tied[1:] |= close
        tied[:-1] |= close
        np.testing.assert_array_equal(got[qi][~tied], want[qi][~tied])
        assert set(got[qi].tolist()) == set(want[qi].tolist()), f"query {qi}"


@pytest.mark.parametrize("probes", [16, 24, 64])
@pytest.mark.parametrize("metric", list(W))
def test_directed_probe_vertices_match_jax(data, metric, probes):
    jc, pc = data["cubes"][metric]
    want = np.asarray(jax_cube.directed_probe_vertices(jc, jnp.asarray(data["qs"]), probes))
    got = port_cube.directed_probe_vertices(pc, data["QS"], probes).numpy()
    _assert_probes_match(jc, data["qs"], want, got, probes)


@pytest.mark.parametrize("m_bits", [3, 5, None])
@pytest.mark.parametrize("metric", list(W))
def test_directed_probe_vertices_m_bits_match_jax(data, metric, m_bits):
    """m_bits picks how many soft bits are enumerated (min(m_bits, k, 13);
    None: 2 beyond ceil(log2(probes))); at m_bits 3 the 8 subsets run out
    before 12 probes and the rest are the home vertex."""
    jc, pc = data["cubes"][metric]
    probes = 12
    want = np.asarray(jax_cube.directed_probe_vertices(jc, jnp.asarray(data["qs"]), probes,
                                                       m_bits=m_bits))
    got = port_cube.directed_probe_vertices(pc, data["QS"], probes, m_bits=m_bits).numpy()
    _assert_probes_match(jc, data["qs"], want, got, probes)
    if m_bits == 3:
        np.testing.assert_array_equal(got[:, 8:], np.repeat(got[:, :1], 4, axis=1))
    distinct = max(len(set(r.tolist())) for r in got)
    assert distinct == {3: 8, 5: 12, None: 12}[m_bits]


def test_directed_probe_vertices_ties_go_to_the_lower_index():
    """Equal bit margins and equal subset scores (the two `torch.topk`
    sites): integer hyperplanes and queries make the margins exact, and the
    probes equal JAX's exactly, order included, at m_bits 3, 5 and None."""
    rng = np.random.default_rng(13)
    d = 16
    x = rng.integers(-2, 3, size=(600, d)).astype(np.float32)
    jc = jax_cube.build_hypercube(jax.random.PRNGKey(4), jnp.asarray(x), "cosine", KB, 1.0)
    proj = rng.integers(-1, 2, size=(d, KB)).astype(np.float32)
    jc = dataclasses.replace(jc, family=dataclasses.replace(jc.family, proj=jnp.asarray(proj)))
    pc = port_cube.hypercube_from_numpy(*cube_handover(jc), CPU)
    qs = rng.integers(-2, 3, size=(64, d)).astype(np.float32)
    margins = np.abs(qs @ proj)
    assert (np.sort(margins, 1)[:, 1:] == np.sort(margins, 1)[:, :-1]).any(1).mean() > 0.9
    for m_bits in (3, 5, None):
        want = np.asarray(jax_cube.directed_probe_vertices(jc, jnp.asarray(qs), 16,
                                                           m_bits=m_bits))
        got = port_cube.directed_probe_vertices(pc, torch.from_numpy(qs), 16,
                                                m_bits=m_bits).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"m_bits={m_bits}")


def test_directed_probe_vertices_tiny_k_pads_with_home(data):
    x = data["x"][:512, :16]
    jc = jax_cube.build_hypercube(jax.random.PRNGKey(3), jnp.asarray(x), "cosine", 2, 1.0)
    pc = port_cube.hypercube_from_numpy(*cube_handover(jc), CPU)
    want = np.asarray(jax_cube.directed_probe_vertices(jc, jnp.asarray(x[:8]), 8))
    got = port_cube.directed_probe_vertices(pc, torch.from_numpy(x[:8]), 8).numpy()
    np.testing.assert_array_equal(got[:, 4:], want[:, 4:])         # the zero-mask pad
    np.testing.assert_array_equal(got[:, 4:], np.repeat(got[:, :1], 4, axis=1))
    for a, b in zip(want, got):
        assert set(a.tolist()) == set(b.tolist())


def _slab_steps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    if got.dtype == torch.bfloat16:
        return np.abs(got.view(torch.int16).numpy().astype(np.int64)
                      - want.view(np.int16).astype(np.int64))
    return np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("metric", list(W))
def test_pack_cube_matches_jax(data, metric, dtype):
    jc, pc = data["cubes"][metric]
    aug = metric == "euclidean"
    jp = jax_cube.pack_cube(jc, jnp.asarray(data["x"]), dtype=jnp.dtype(dtype), pad=1024,
                            augment=aug)
    pp = port_cube.pack_cube(pc, data["X"], dtype=DT[dtype], pad=1024, augment=aug)
    assert tuple(pp.packed.shape) == jp.packed.shape
    np.testing.assert_array_equal(pp.packed_rows.numpy(), np.asarray(jp.packed_rows))
    off = _slab_steps(pp.packed, np.asarray(jp.packed))
    assert off.max() <= 1 and (off > 0).mean() <= 1e-4
    for f in ("packed_gscale", "packed_aug_scale"):
        a, b = getattr(pp, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("metric,dtype,directed", [
    ("cosine", "int8", True), ("cosine", "bfloat16", False),
    ("euclidean", "int8", True), ("euclidean", "bfloat16", False),
])
def test_cube_retrieve_topk_matches_jax(data, metric, dtype, directed):
    """cube_retrieve_topk's kernel branches: _cube_retrieve_kernel (cosine,
    flat stage 1) and _cube_retrieve_kernel_euclid (augmented, per-window
    stage 1), on JAX's packed cube."""
    jc, _ = data["cubes"][metric]
    jp = jax_cube.pack_cube(jc, jnp.asarray(data["x"]), dtype=jnp.dtype(dtype), pad=1024,
                            augment=metric == "euclidean")
    want = jax_cube.cube_retrieve_topk(jp, jnp.asarray(data["qs"]), jnp.asarray(data["x"]),
                                       top_k=TOP, probes=16, per_probe=200,
                                       directed=directed)
    pp = port_cube.hypercube_from_numpy(*cube_handover(jp), CPU)
    got = port_cube.cube_retrieve_topk(pp, data["QS"], data["X"], top_k=TOP, probes=16,
                                       per_probe=200, directed=directed)
    _assert_topk(metric, want, got, data["qs"])


@pytest.mark.parametrize("metric,dtype", [
    ("cosine", "int8"), ("cosine", "float32"),
    ("euclidean", "int8"), ("euclidean", "float32"),
])
def test_multicube_retrieve_topk_matches_jax(data, metric, dtype):
    """C = 2 cubes in one shared slab.  The int8 euclidean case has no
    test in the JAX suite; here it is held against JAX's own run."""
    jm = jax_cube.build_multicube(jax.random.PRNGKey(5), jnp.asarray(data["x"]), metric,
                                  2, KB, W[metric], corpus_dtype=jnp.dtype(dtype), pad=1024)
    want = jax_cube.multicube_retrieve_topk(jm, jnp.asarray(data["qs"]), top_k=TOP,
                                            probes=8, per_probe=200)
    pm = port_cube.multicube_from_numpy(*multicube_handover(jm), CPU)
    assert pm.packed.shape == (1, 2 * pm.n_pad, 256 if metric == "euclidean" else D)
    got = port_cube.multicube_retrieve_topk(pm, data["QS"], top_k=TOP, probes=8,
                                            per_probe=200)
    _assert_topk(metric, want, got, data["qs"])


@pytest.mark.parametrize("metric", list(W))
def test_port_built_multicube_finds_planted_rows(data, metric):
    """The port's own build_multicube (seeded draws, int8): segments share
    one scale, windows land in their own segment, the planted row leads."""
    x = data["x"]
    qs = x[:Q] + 0.01 * np.random.default_rng(8).normal(size=(Q, D)).astype(np.float32)
    mc = port_cube.build_multicube(torch.Generator().manual_seed(2), data["X"], metric,
                                   3, KB, W[metric], corpus_dtype=torch.int8, pad=1024)
    assert mc.n_cubes == 3 and mc.bucket_starts.shape == (3, (1 << KB) + 1)
    assert mc.packed_gscale is not None
    assert (mc.packed_aug_scale is not None) == (metric == "euclidean")
    s0, _ = port_cube.multicube_windows(mc, torch.from_numpy(qs), 8, 200)
    seg = s0 // mc.n_pad
    assert torch.equal(seg, torch.arange(3).repeat_interleave(8)[None].expand(Q, -1))
    s, ids = port_cube.multicube_retrieve_topk(mc, torch.from_numpy(qs), top_k=TOP,
                                               probes=8, per_probe=200)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(Q))
    assert bool((s[:, :-1] >= s[:, 1:]).all())


def test_build_multicube_refuses_differing_scales(data, monkeypatch):
    """The segments must share gscale / aug_scale (the JAX docstring says
    so, hypercube.py:537-538); a differing one raises."""
    real = port_cube.pack_cube
    calls = []

    def skewed(*args, **kw):
        pc = real(*args, **kw)
        calls.append(1)
        if len(calls) == 2:
            pc.packed_gscale = pc.packed_gscale * 1.5
        return pc

    monkeypatch.setattr(port_cube, "pack_cube", skewed)
    with pytest.raises(ValueError, match="scales differ"):
        port_cube.build_multicube(torch.Generator().manual_seed(0), data["X"][:1024],
                                  "cosine", 2, 5, 1.0, corpus_dtype=torch.int8, pad=512)


def test_unported_cube_branches_raise(data):
    """Outside the kernel branch the cube takes packed_retrieve_core with
    the probes as windows (probes % 8 != 0, per-row int8, unaugmented
    euclidean): the port now matches JAX there; augmented slabs there are
    an error in both packages; JAX's per-row archives load."""
    for metric in ("cosine", "euclidean"):
        jc, pc = data["cubes"][metric]
        jp = jax_cube.pack_cube(jc, jnp.asarray(data["x"]), dtype=jnp.int8, pad=1024)
        pp = port_cube.hypercube_from_numpy(*cube_handover(jp), CPU)
        want = jax_cube.cube_retrieve_topk(jp, jnp.asarray(data["qs"]),
                                           jnp.asarray(data["x"]), top_k=TOP, probes=6)
        got = port_cube.cube_retrieve_topk(pp, data["QS"], data["X"], top_k=TOP, probes=6)
        _assert_topk(metric, want, got, data["qs"])
        own = port_cube.pack_cube(pc, data["X"], dtype=torch.int8, pad=1024)
        assert (own.packed_scale is None) == (metric == "cosine")
        assert (own.packed_sqnorm is None) == (metric == "cosine")
    _, pe = data["cubes"]["euclidean"]
    pa = port_cube.pack_cube(pe, data["X"], dtype=torch.int8, pad=1024, augment=True)
    with pytest.raises(ValueError, match="kernel-only"):
        port_cube.cube_retrieve_topk(pa, data["QS"], data["X"], top_k=TOP, probes=6)
    jc, _ = data["cubes"]["cosine"]
    jp = jax_cube.pack_cube(jc, jnp.asarray(data["x"]), dtype=jnp.int8, pad=1024,
                            scale_mode="row")
    got = port_cube.hypercube_from_numpy(*cube_handover(jp), CPU)
    np.testing.assert_array_equal(got.packed_scale.numpy(), np.asarray(jp.packed_scale))


