"""The PyTorch port's nearest-tap point ranking against the JAX package: the
counter hash, the plain versions of the two nearest-read kernels, and the
whole sampler on both routes (i.i.d. candidates with a global top-k, and
y-stratified candidates with a top-k per chunk), plus the wrappers' wiring
and, on a card, the kernels themselves.

Inputs come from numpy with a seed; everything is fp32 on the CPU.  The
reads copy floats and the hash is integer arithmetic, so every comparison
here is exact (bit for bit), except the Pallas nearest kernel on fp32 masks,
which rounds the masks to bf16 (compared exactly on masks rounded first).
JAX's seeds and remainder uniforms are replayed into the port's ``Draw``.
"""

import importlib

import numpy as np
import pytest
import torch

from autofocusformermod_torch.losses import point_sample as tps
from autofocusformermod_torch.losses.criterion import device_draw
from autofocusformermod_torch.ops import point_sample as ops_ps
from autofocusformermod_torch.ops.dispatch import plain_versions


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class Replay:
    """A ``Draw`` that hands out the given arrays in order, checking shapes:
    uint32 arrays as seeds, float32 arrays as uniforms."""

    def __init__(self, arrays):
        self.it = iter(arrays)

    def __call__(self, shape):
        a = np.asarray(next(self.it))
        assert a.dtype == np.float32 and tuple(a.shape) == tuple(shape), (a.dtype, a.shape, shape)
        return torch.from_numpy(a.copy())

    def seeds(self, count):
        a = np.asarray(next(self.it))
        assert a.dtype == np.uint32 and a.shape == (count,), (a.dtype, a.shape, count)
        return torch.from_numpy(a.astype(np.int64))


def jax_ranked_draws(key, n, num_points, importance=0.75):
    """What get_uncertain_point_coords_nn_ranked draws from ``key``, in the
    port's order: the two seeds, then the remainder uniforms."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(key)
    num_random = num_points - int(importance * num_points)
    return [np.asarray(jax.random.bits(k1, (2,), jnp.uint32)),
            np.asarray(jax.random.uniform(k2, (n, num_random, 2)))]


@pytest.fixture(scope="module")
def jax_mods():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.ops import dispatch as jdispatch
    from autofocusformermod_tpu.ops.pallas import point_sample_kernel as jk

    # the package's __init__ rebinds the name point_sample to a function
    jps = importlib.import_module("autofocusformermod_tpu.losses.point_sample")
    return {"jax": jax, "jnp": jnp, "jps": jps, "jk": jk, "jdispatch": jdispatch}


# ------------------------------------------------------------ the counter hash
@pytest.mark.parametrize("seed", [0, 7, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF])
def test_counter_uniform_bit_exact(jax_mods, seed):
    """int32 arithmetic with logical shifts gives the uint32 hash's bits, for
    seeds and counters on both sides of 2**31."""
    jnp, jps = jax_mods["jnp"], jax_mods["jps"]
    rng = np.random.default_rng(seed % 1000)
    ctr = np.concatenate([np.arange(4096, dtype=np.uint32),
                          np.uint32(0x7FFFFFF0) + np.arange(64, dtype=np.uint32),
                          rng.integers(0, 1 << 32, 4096, dtype=np.uint32)])
    want = np.asarray(jps._counter_uniform(jnp.uint32(seed), jnp.asarray(ctr)))
    seeds = tps._seed_bits(torch.tensor([seed], dtype=torch.int64))
    got = tps._counter_uniform(seeds[0], _t(ctr.view(np.int32))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() < 1.0


def test_generator_draw_hands_out_uint32_seeds():
    draw = device_draw(torch.Generator().manual_seed(3))
    s = torch.cat([draw.seeds(2) for _ in range(200)])
    assert s.dtype == torch.int64 and s.min() >= 0 and s.max() < 1 << 32
    assert (s >= 1 << 31).any() and (s < 1 << 31).any()
    assert draw((2, 3)).shape == (2, 3)
    again = device_draw(torch.Generator().manual_seed(3))
    assert torch.equal(again.seeds(2), s[:2])


# ------------------------------------------------- the kernels' plain versions
def test_nearest_plain_matches_pallas_interpret_and_xla(jax_mods):
    """K11's plain version: exact against the Pallas kernel (interpret mode)
    on masks rounded to bf16 first, and exact against the XLA fall-through of
    the JAX sampler on fp32 masks; coordinates reach outside [0, 1]."""
    jnp, jk = jax_mods["jnp"], jax_mods["jk"]
    rng = np.random.default_rng(6)
    n, h, w, p = 3, 128, 128, 256
    masks = rng.standard_normal((n, h, w)).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, (n, p, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    rounded = np.asarray(jnp.asarray(masks).astype(jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jk.point_sample_nearest_pallas(jnp.asarray(rounded), jnp.asarray(coords),
                                                    interpret=True))
    got = ops_ps.point_sample_nearest(_t(rounded), _t(coords))
    np.testing.assert_array_equal(got.numpy(), ref)

    cx = jnp.clip((jnp.asarray(coords)[..., 0] * w).astype(jnp.int32), 0, w - 1)
    cy = jnp.clip((jnp.asarray(coords)[..., 1] * h).astype(jnp.int32), 0, h - 1)
    row0 = (jnp.arange(n, dtype=jnp.int32) * (h * w))[:, None]
    xla = jnp.take(jnp.asarray(masks).reshape(-1), (row0 + cy * w + cx).reshape(-1)).reshape(n, p)
    np.testing.assert_array_equal(ops_ps.point_sample_nearest(_t(masks), _t(coords)).numpy(),
                                  np.asarray(xla))


def _rows_case(rng, n=3, h=16, w=128, chunks=24):
    masks = rng.standard_normal((n, h, w)).astype(np.float32)
    u = rng.uniform(size=(n, chunks, 128))
    ys = (np.arange(chunks)[None, :, None] + u) / chunks
    cy = np.clip((ys * h).astype(np.int32), 0, h - 1)
    cx = rng.integers(0, w, (n, chunks, 128)).astype(np.int32)
    return masks, cx, cy


@pytest.mark.parametrize("h,chunks", [(16, 24), (5, 7), (2, 2), (32, 40)])
def test_nearest_rows_plain_matches_pallas_interpret(jax_mods, h, chunks):
    """K12's plain version: exact against the Pallas kernel in interpret
    mode, chunk counts that divide the rows and that do not."""
    jnp, jk = jax_mods["jnp"], jax_mods["jk"]
    masks, cx, cy = _rows_case(np.random.default_rng(8), n=2, h=h, chunks=chunks)
    assert jk.point_sample_nearest_rows_supported(2, h, 128, chunks * 128)
    assert ops_ps.point_sample_nearest_rows_supported(h, 128, chunks * 128)
    ref = np.asarray(jk.point_sample_nearest_rows_pallas(
        jnp.asarray(masks), jnp.asarray(cx), jnp.asarray(cy), interpret=True))
    got = ops_ps.point_sample_nearest_rows(_t(masks), _t(cx), _t(cy))
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nearest_rows_contract():
    """The plain version raises on a cy outside its chunk's two rows and on
    a cx outside the image; the wrapper on fewer chunks than rows, a ragged
    chunk or one row; the launchers on operands their vector loads cannot
    take."""
    masks, cx, cy = _rows_case(np.random.default_rng(9))
    bad = cy.copy()
    bad[1, 3, 5] = (bad[1, 3, 5] + 3) % 16
    with pytest.raises(ValueError, match="outside its two rows"):
        ops_ps.point_sample_nearest_rows(_t(masks), _t(cx), _t(bad))
    for value in (-1, masks.shape[2]):
        bad = cx.copy()
        bad[0, 2, 7] = value
        with pytest.raises(ValueError, match=r"outside \[0, w\)"):
            ops_ps.point_sample_nearest_rows(_t(masks), _t(bad), _t(cy))
    shifted = torch.zeros(cx.size + 1, dtype=torch.int32)[1:].reshape(cx.shape)   # 4 bytes in
    with pytest.raises(ValueError, match="16 bytes at a time"):
        ops_ps.point_sample_nearest_rows_forward(_t(masks), shifted, _t(cy))
    coords = torch.zeros(3 * 2 * 2 + 1)[1:].reshape(3, 2, 2)
    with pytest.raises(ValueError, match="8 bytes at a time"):
        ops_ps.point_sample_nearest_forward(_t(masks), coords)
    with pytest.raises(ValueError, match="chunks >= h"):
        ops_ps.point_sample_nearest_rows(_t(masks), _t(cx[:, :8]), _t(cy[:, :8]))
    with pytest.raises(ValueError, match="chunks of 128"):
        ops_ps.point_sample_nearest_rows(_t(masks), _t(cx[..., :64]), _t(cy[..., :64]))
    assert not ops_ps.point_sample_nearest_rows_supported(1, 128, 1280)
    assert ops_ps.point_sample_nearest_rows_supported(16, 100, 24 * 128)   # no lane rule on w
    assert not ops_ps.point_sample_nearest_rows_supported(16, 1024, 24 * 128)


# ------------------------------------------------------------ the whole sampler
def _tied_masks(rng, n, h, w):
    """Logits on a coarse integer grid: many cells share a value, and with
    more candidates than cells many candidates share a cell, so equal
    uncertainties are the rule."""
    return rng.integers(-3, 4, (n, h, w)).astype(np.float32)


@pytest.mark.parametrize("h,w,num_points", [(4, 4, 64), (8, 16, 48), (128, 128, 32)])
def test_sampler_iid_route_matches_jax(jax_mods, h, w, num_points):
    """CPU tensors take the i.i.d. route with a global top-k, as the JAX
    sampler does off the accelerator: identical coordinates, ties included."""
    jax, jnp, jps = jax_mods["jax"], jax_mods["jnp"], jax_mods["jps"]
    rng = np.random.default_rng(h * w)
    n = 5
    masks = _tied_masks(rng, n, h, w)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jps.get_uncertain_point_coords_nn_ranked(
        key, jnp.asarray(masks), num_points, 3.0, 0.75))
    got = tps.get_uncertain_point_coords_nn_ranked(
        Replay(jax_ranked_draws(key, n, num_points)), _t(masks), num_points, 3.0, 0.75)
    assert got.shape == (n, num_points, 2) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    # the ties are real: more winners than distinct uncertainties
    assert int(0.75 * num_points) > len(np.unique(np.abs(masks)))


@pytest.mark.parametrize("stratified_topk", [True, False])
@pytest.mark.parametrize("h,num_points", [(4, 256), (6, 256)])
def test_sampler_stratified_route_matches_jax(jax_mods, monkeypatch, stratified_topk, h,
                                              num_points):
    """The y-stratified route, forced on the CPU, against the JAX sampler
    with its accelerator route switched on in this test (the rows kernel in
    interpret mode): identical coordinates with the per-chunk top-k and with
    the global one."""
    jax, jnp, jps, jk = (jax_mods[k] for k in ("jax", "jnp", "jps", "jk"))
    monkeypatch.setattr(jax_mods["jdispatch"], "fused_attention_available", lambda: True)
    rows = jk.point_sample_nearest_rows_pallas
    monkeypatch.setattr(jk, "point_sample_nearest_rows_pallas",
                        lambda m, cx, cy: rows(m, cx, cy, interpret=True))
    monkeypatch.setattr(jps, "STRATIFIED_TOPK", stratified_topk)
    monkeypatch.setattr(tps, "STRATIFIED_TOPK", stratified_topk)
    rng = np.random.default_rng(h)
    n, w = 3, 128
    masks = _tied_masks(rng, n, h, w)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jps.get_uncertain_point_coords_nn_ranked(
        key, jnp.asarray(masks), num_points, 3.0, 0.75))
    got = tps.get_uncertain_point_coords_nn_ranked(
        Replay(jax_ranked_draws(key, n, num_points)), _t(masks), num_points, 3.0, 0.75,
        stratified=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # stratified: the uncertain points' y covers the image band by band
    if stratified_topk:
        chunks = 3 * num_points // 128
        band = np.floor(got.numpy()[:, :192, 1] * chunks).astype(int)
        assert (np.stack([np.bincount(b, minlength=chunks) for b in band]) == 192 // chunks).all()


def test_sampler_route_follows_the_device(monkeypatch):
    """With no route forced, CPU tensors take the i.i.d. route (the rows
    read is not called); stratification that the shapes do not allow falls
    back to it as well."""
    called = []
    real = ops_ps.point_sample_nearest_rows
    monkeypatch.setattr(ops_ps, "point_sample_nearest_rows",
                        lambda *a: called.append(1) or real(*a))
    masks = _t(_tied_masks(np.random.default_rng(0), 2, 4, 128))

    def run(**kw):
        draw = device_draw(torch.Generator().manual_seed(5))
        return tps.get_uncertain_point_coords_nn_ranked(draw, masks, 256, 3.0, 0.75, **kw)

    auto = run()
    assert not called and torch.equal(auto, run(stratified=False))
    strat = run(stratified=True)
    assert called and not torch.equal(auto, strat)
    called.clear()
    tall = _t(_tied_masks(np.random.default_rng(0), 2, 16, 128))     # 6 chunks < 16 rows
    draw = device_draw(torch.Generator().manual_seed(5))
    tps.get_uncertain_point_coords_nn_ranked(draw, tall, 256, 3.0, 0.75, stratified=True)
    assert not called


# ------------------------------------------------------------------ the wiring
def test_nearest_wrappers_wiring(monkeypatch):
    """On a CUDA tensor the wrappers hand contiguous operands to their
    launchers and return what those return, without gradient; here the
    launchers are the plain versions and the device rule is forced."""
    seen = {}

    def nearest(masks, coords):
        seen["nearest"] = (masks.is_contiguous(), coords.is_contiguous())
        return ops_ps.point_sample_nearest_plain(masks, coords)

    def rows(masks, cx, cy):
        seen["rows"] = (masks.is_contiguous(), cx.is_contiguous(), cy.is_contiguous())
        return ops_ps.point_sample_nearest_rows_plain(masks, cx, cy)

    monkeypatch.setattr(ops_ps, "use_kernel", lambda *t: True)
    monkeypatch.setattr(ops_ps, "point_sample_nearest_forward", nearest)
    monkeypatch.setattr(ops_ps, "point_sample_nearest_rows_forward", rows)
    rng = np.random.default_rng(2)
    m, cx, cy = _rows_case(rng)
    masks = _t(m).requires_grad_()
    coords = _t(rng.random((3, 2, 40)).astype(np.float32)).transpose(1, 2)   # not contiguous
    out = ops_ps.point_sample_nearest(masks, coords)
    assert seen["nearest"] == (True, True) and not out.requires_grad
    assert torch.equal(out, ops_ps.point_sample_nearest_plain(masks.detach(), coords))
    out = ops_ps.point_sample_nearest_rows(masks, _t(cx), _t(cy))
    assert seen["rows"] == (True, True, True) and not out.requires_grad
    assert torch.equal(out, ops_ps.point_sample_nearest_rows_plain(masks.detach(), _t(cx), _t(cy)))


# ----------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nearest_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(3)
    masks = _t(rng.standard_normal((5, 24, 40)).astype(np.float32)).to(cuda)
    coords = _t(rng.uniform(-0.05, 1.05, (5, 777, 2)).astype(np.float32)).to(cuda)
    before = ops_ps.point_sample_nearest.launches
    got = ops_ps.point_sample_nearest(masks, coords)
    assert ops_ps.point_sample_nearest.launches == before + 1
    with plain_versions():
        want = ops_ps.point_sample_nearest(masks, coords)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,chunks", [(16, 128, 24), (5, 100, 7), (128, 128, 294)])
def test_nearest_rows_kernel_matches_plain_on_card(cuda, h, w, chunks):
    masks, cx, cy = _rows_case(np.random.default_rng(4), n=3, h=h, w=w, chunks=chunks)
    args = [_t(a).to(cuda) for a in (masks, cx, cy)]
    before = ops_ps.point_sample_nearest_rows.launches
    got = ops_ps.point_sample_nearest_rows(*args)
    assert ops_ps.point_sample_nearest_rows.launches == before + 1
    with plain_versions():
        want = ops_ps.point_sample_nearest_rows(*args)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stratify", [True, False])
def test_sampler_kernel_and_plain_pick_the_same_points_on_card(cuda, monkeypatch, stratify):
    monkeypatch.setattr(tps, "STRATIFY_RANKING", stratify)
    masks = _t(_tied_masks(np.random.default_rng(5), 6, 16, 32)).to(cuda)

    def run():
        draw = device_draw(torch.Generator(device=cuda).manual_seed(1))
        return tps.get_uncertain_point_coords_nn_ranked(draw, masks, 1024, 3.0, 0.75)

    counter = ops_ps.point_sample_nearest_rows if stratify else ops_ps.point_sample_nearest
    before = counter.launches
    got = run()
    assert counter.launches == before + 1
    with plain_versions():
        want = run()
    assert torch.equal(got, want)
