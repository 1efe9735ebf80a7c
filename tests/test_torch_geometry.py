"""Parity of the PyTorch port's geometry (autofocusformermod_torch/geometry)
and small layers with the JAX package's, and of the knn kernel with its
plain version on a card.

Inputs come from numpy with a seed; both sides run fp32.  Indices must be
equal (positions are integer or half-integer grids, so distances are exact
and ties are real); float outputs use rtol = atol = 1e-5 (fp32 summation
order), 1e-4 for the sine embedding (sin/cos of arguments up to ~2*pi*1e4
differ by a few ulps between libms)."""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.geometry import cluster as tcl
from autofocusformermod_torch.geometry import gridnn as tg
from autofocusformermod_torch.geometry import shepard as tsh
from autofocusformermod_torch.geometry.knn import (
    MAX_CELLS, PRUNED_MIN_DB, ROUTES, _knn_cuda, knn, knn_cells, knn_plain, knn_route,
    knn_scratch_stride)

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid(h, w, step=1.0, b=1):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], axis=2).reshape(1, -1, 2).astype(np.float32) * step
    return np.broadcast_to(pos, (b, h * w, 2)).copy()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def jnp():
    pytest.importorskip("jax")
    import jax.numpy

    return jax.numpy


@pytest.mark.parametrize("k", [1, 4, 6])
def test_knn_plain_matches_jax_with_ties(jnp, rng, k):
    """Integer query grid against a permuted half-integer and integer
    database: many exact ties, broken by the lowest database index."""
    from autofocusformermod_tpu.geometry.knn import knn as jknn

    q = _grid(16, 16, b=2)
    db = np.concatenate([_grid(8, 8, 2.0, b=2) + 0.5, _grid(5, 5, 3.0, b=2)], 1)
    db = np.stack([d[rng.permutation(d.shape[0])] for d in db])
    idx, dist = knn(_t(q), _t(db), k, return_dist=True)
    ridx, rdist = jknn(jnp.asarray(q), jnp.asarray(db), k, return_dist=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(rdist))


def test_knn_plain_chunks_and_random_points(rng):
    q = rng.uniform(0, 50, (1, 300, 2)).astype(np.float32)
    db = rng.uniform(0, 50, (1, 120, 2)).astype(np.float32)
    d2 = ((q[:, :, None] - db[:, None]) ** 2).sum(-1)
    ref = np.argsort(d2, axis=2, kind="stable")[:, :, :5]
    idx, _ = knn_plain(_t(q), _t(db), 5)
    np.testing.assert_array_equal(idx.numpy(), ref)


@pytest.mark.parametrize("h,w,m", [(16, 16, 8), (12, 20, 8), (8, 8, 5)])
def test_space_filling_cluster_matches_jax(jnp, rng, h, w, m):
    from autofocusformermod_tpu.geometry.cluster import space_filling_cluster as jsfc

    pos = _grid(h, w, b=2)
    pos[1] = pos[1][rng.permutation(h * w)]
    port = tcl.space_filling_cluster(_t(pos), m, h, w)
    ref = jsfc(jnp.asarray(pos), m, h, w)
    for a, r in zip(port, ref):
        if r is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_space_filling_cluster_few_anchors_matches_jax(jnp):
    """Too few anchor patches: tokens ordered on the scanline directly."""
    from autofocusformermod_tpu.geometry.cluster import space_filling_cluster as jsfc

    pos = _grid(4, 4)
    port = tcl.space_filling_cluster(_t(pos), 8, 4, 4)
    ref = jsfc(jnp.asarray(pos), 8, 4, 4)
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("n", [32, 29])
def test_nbhd_from_cluster_ids_matches_jax(jnp, rng, n):
    from autofocusformermod_tpu.geometry.cluster import nbhd_from_cluster_ids as jnb

    pos = _grid(6, 6)[:, :n]
    nc = rng.integers(0, -(-n // 4), (1, n, 3)).astype(np.int32)
    qpos = pos[:, :n] + 0.0
    port = tcl.nbhd_from_cluster_ids(_t(pos), _t(nc), 4, n, query_pos=_t(qpos))
    ref = jnb(jnp.asarray(pos), jnp.asarray(nc), 4, n, query_pos=jnp.asarray(qpos))
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    if ref[1] is None:
        assert port[1] is None
    else:
        np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), **TOL)


def test_shepard_functions_match_jax(jnp, rng):
    from autofocusformermod_tpu.geometry import shepard as jsh

    d = rng.uniform(0, 9, (2, 7, 4)).astype(np.float32)
    for p in (3.0, 2.7):
        np.testing.assert_allclose(tsh.shepard_decay_weights(_t(d), p).numpy(),
                                   np.asarray(jsh.shepard_decay_weights(jnp.asarray(d), p)), **TOL)
    q = _grid(12, 12, b=2)
    db = _grid(6, 6, 2.0, b=2) + 0.5
    f = rng.standard_normal((2, 36, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.upsample_feature_shepard(_t(q), _t(db), _t(f)).numpy(),
        np.asarray(jsh.upsample_feature_shepard(jnp.asarray(q), jnp.asarray(db), jnp.asarray(f))),
        **TOL)


@pytest.mark.parametrize("half,k", [(1, 4), (2, 9)])
def test_window_knn_matches_jax(jnp, rng, half, k):
    from autofocusformermod_tpu.geometry import gridnn as jg

    h, w = 9, 11
    pos = _grid(h, w)
    pos[0] = pos[0][rng.permutation(h * w)]
    query = (rng.integers(0, 2 * w, (1, 40, 2)) / 2.0).astype(np.float32)   # half-integers
    lut = tg.pos_index_lut(_t(pos), h, w)
    jlut = jg.pos_index_lut(jnp.asarray(pos), h, w)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jlut))
    for kw in ({"lut": True}, {"identity_lut": True}):
        a = tg._window_knn(_t(query), h, w, half, k,
                           lut=lut if kw.get("lut") else None,
                           identity_lut=kw.get("identity_lut", False))
        r = jg._window_knn(jnp.asarray(query), h, w, half, k,
                           lut=jlut if kw.get("lut") else None,
                           identity_lut=kw.get("identity_lut", False))
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(r[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(r[1]))


def test_grid_shepard_upsample_matches_jax(jnp, rng):
    from autofocusformermod_tpu.geometry import gridnn as jg

    h, w = 8, 8
    db = _grid(h, w)
    query = (_grid(4, 4, 2.0) + 0.5).astype(np.float32)
    f = rng.standard_normal((1, h * w, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tg.grid_shepard_upsample(_t(query), _t(f), h, w).numpy(),
        np.asarray(jg.grid_shepard_upsample(jnp.asarray(query), None, jnp.asarray(f), h, w,
                                            identity_lut=True)), **TOL)
    np.testing.assert_array_equal(
        tg.grid_neighbors9(_t(db), h, w).numpy(),
        np.asarray(jg.grid_neighbors9(jnp.asarray(db), h, w)))


def test_rel_pos_and_sine_embedding_match_jax(jnp, rng):
    from autofocusformermod_tpu.models import layers as jl
    from autofocusformermod_torch.models import layers as tl

    rel = rng.integers(-600, 600, (3, 7, 2)).astype(np.float32)
    rel[0, 0] = 0
    np.testing.assert_allclose(tl.rel_pos_features(_t(rel)).numpy(),
                               np.asarray(jl.rel_pos_features(jnp.asarray(rel))), **TOL)
    pos = rng.integers(0, 128, (2, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(tl.position_embedding_sine(_t(pos), 8).numpy(),
                               np.asarray(jl.position_embedding_sine(jnp.asarray(pos), 8)),
                               rtol=1e-4, atol=1e-4)


def test_scale_pos_matches_jax(jnp, rng):
    from autofocusformermod_tpu.models.pixel_decoder import scale_pos as jsp
    from autofocusformermod_torch.models.pixel_decoder import scale_pos

    pos = rng.integers(0, 32, (1, 9, 2)).astype(np.float32)
    for nb in (True, False):
        np.testing.assert_array_equal(
            scale_pos(_t(pos), (32, 32), (64, 128), no_bias=nb).numpy(),
            np.asarray(jsp(jnp.asarray(pos), (32, 32), (64, 128), no_bias=nb)))


def test_upsample_and_postprocess_match_jax(jnp, rng):
    """F.interpolate(bilinear, align_corners=False, antialias=False) ==
    jax.image.resize(bilinear) when upsampling."""
    from autofocusformermod_tpu.models import inference as ji
    from autofocusformermod_tpu.models import maskformer as jm
    from autofocusformermod_torch.models import inference as ti
    from autofocusformermod_torch.models import maskformer as tm

    masks = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    cls = rng.standard_normal((3, 5)).astype(np.float32)
    up = tm.upsample_masks(_t(masks), (32, 32))
    np.testing.assert_allclose(up.numpy(), np.asarray(jm.upsample_masks(jnp.asarray(masks), (32, 32))),
                               **TOL)
    sem = tm.semantic_inference(_t(cls), up[0])
    np.testing.assert_allclose(sem.numpy(), np.asarray(jm.semantic_inference(
        jnp.asarray(cls), jnp.asarray(up[0].numpy()))), **TOL)
    np.testing.assert_allclose(
        ti.sem_seg_postprocess(sem, (30, 28), (60, 56)).numpy(),
        np.asarray(ji.sem_seg_postprocess(jnp.asarray(sem.numpy()), (30, 28), (60, 56))), **TOL)


def test_knn_route_by_shape():
    """Sweep below PRUNED_MIN_DB database points, prune from there on (the
    forward's 16384 x 4096 tables, its 4096-token merges and its 512-mean
    cluster neighbours), about 16 points a cell up to MAX_CELLS cells, and
    the scratch layout of csrc/knn.cu."""
    assert knn_route(4096) == "pruned" and knn_route(2048) == "pruned"
    assert knn_route(512) == "pruned" and knn_route(1024) == "pruned"
    assert knn_route(32) == "sweep" and knn_route(256) == "sweep"
    assert knn_route(PRUNED_MIN_DB) == "pruned" and knn_route(PRUNED_MIN_DB - 1) == "sweep"
    assert knn_cells(4096) == 256 and knn_cells(20) == 1 and knn_cells(10 ** 6) == MAX_CELLS
    assert knn_scratch_stride(4096, 256) == 70672      # 16 * 4096 + 16 * 256 + 4 * 257, to 16
    assert knn_scratch_stride(5, 1) % 16 == 0 and knn_scratch_stride(5, 1) >= 80 + 16 + 8
    q, db = torch.zeros((1, 8, 2)), torch.zeros((1, 40, 2))
    with pytest.raises(ValueError):
        _knn_cuda(q, db, 4, route="grid")
    with pytest.raises(ValueError):
        _knn_cuda(q, db, 41)


def test_knn_cell_bound_never_exceeds_a_distance(rng):
    """The pruned route's exactness rests on this: a cell's box-to-box bound,
    computed in fp32 with the distance's own round-to-nearest operations,
    is at most every computed distance from a query in the query box to a
    point in the cell.  Checked in torch (unfused fp32 on the CPU) on boxes
    at large offsets, where the differences round."""
    f = torch.float32
    for trial in range(200):
        off = float(rng.choice([0.0, 1e3, 7e5, 3e6]))
        q = _t((rng.uniform(-8, 8, (32, 2)) + off).astype(np.float32))
        p = _t((rng.uniform(-8, 8, (40, 2)) * rng.uniform(0.1, 3) + off
                + rng.uniform(-30, 30, 2)).astype(np.float32))
        qlo, qhi = q.min(0).values, q.max(0).values
        clo, chi = p.min(0).values, p.max(0).values
        g = torch.clamp(torch.maximum(clo - qhi, qlo - chi), min=0).to(f)
        bound = g[0] * g[0] + g[1] * g[1]
        diff = q[:, None, :] - p[None, :, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        assert bool((d2 >= bound).all()), (trial, off)


def _knn_case(rng, case):
    """(query (b, nq, 2), database (b, ndb, 2)) float32, every database in a
    random order (as the model's importance-ordered tokens are)."""
    if case == "half_integer_ties":        # queries exactly between grid points
        q, db = _grid(64, 64, b=2), _grid(32, 32, 2.0, b=2) + 0.5
    elif case == "coarse_grid":
        q, db = _grid(64, 64, b=2), _grid(16, 16, 4.0, b=2)
    elif case == "duplicates":             # every position three times
        q, db = _grid(40, 40, b=2), np.concatenate([_grid(16, 16, 3.0, b=2)] * 3, 1)
    elif case == "clustered_outliers":     # a dense cluster, far outliers, a ragged warp
        db = np.concatenate([rng.normal(30, 2, (2, 2000, 2)),
                             rng.uniform(-1e4, 1e4, (2, 48, 2))], 1)
        q = np.concatenate([rng.uniform(0, 64, (2, 2001, 2)),
                            rng.uniform(-2e4, 2e4, (2, 7, 2))], 1)
    elif case == "small_db":               # fewer points than one cell
        q, db = rng.uniform(0, 16, (2, 300, 2)), rng.uniform(0, 16, (2, 20, 2))
    elif case == "ragged_db":              # not a multiple of the cell size
        q, db = rng.uniform(0, 64, (2, 1500, 2)), rng.uniform(0, 64, (2, 1037, 2))
    else:                                  # queries all around the database's box
        q, db = rng.uniform(-100, 110, (2, 999, 2)), rng.uniform(0, 10, (2, 1500, 2))
    db = np.stack([d[rng.permutation(d.shape[0])] for d in db])
    return _t(q.astype(np.float32)), _t(db.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["half_integer_ties", "coarse_grid", "duplicates",
                                  "clustered_outliers", "small_db", "ragged_db", "outside_box"])
def test_knn_kernel_matches_plain_on_card(rng, case):
    """Both routes equal the plain version bit for bit (indices and
    distances, ties by lowest index) for every k from 1 to 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, db = (a.cuda() for a in _knn_case(rng, case))
    for k in range(1, 17):
        ridx, rd2 = knn_plain(q, db, k)
        for route in ROUTES:
            idx, d2 = _knn_cuda(q, db, k, route=route)
            assert torch.equal(idx, ridx) and torch.equal(d2, rd2), (case, k, route)
    before = dict(knn.launches_by_route)
    knn(q, db, 4)
    route = knn_route(db.shape[1])
    assert knn.launches_by_route[route] == before[route] + 1
