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

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)


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
@pytest.mark.parametrize("side", [16, 32, 64, 128, 160])
def test_nearest_plain_matches_pallas_interpret_and_xla(jax_mods, side):
    """K11's plain version at the ranking's mask sides (the MaskFiner
    cascade's 16-64, the AFF step's 128, Swin-B's 160), on an odd number of
    points: exact against the Pallas kernel (interpret mode) on masks
    rounded to bf16 first, and exact against the XLA fall-through of the JAX
    sampler on fp32 masks; coordinates reach outside [0, 1].  The Pallas
    kernel takes whole blocks of 128 points (``_pick_block_p_nearest``), so
    it reads the first 256 of the 257."""
    jnp, jk = jax_mods["jnp"], jax_mods["jk"]
    rng = np.random.default_rng(6 + side)
    n, h, w, p = 3, side, side, 257
    masks = rng.standard_normal((n, h, w)).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, (n, p, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    rounded = np.asarray(jnp.asarray(masks).astype(jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jk.point_sample_nearest_pallas(jnp.asarray(rounded),
                                                    jnp.asarray(coords[:, :256]), interpret=True))
    got = ops_ps.point_sample_nearest(_t(rounded), _t(coords))
    np.testing.assert_array_equal(got.numpy()[:, :256], ref)

    cx = jnp.clip((jnp.asarray(coords)[..., 0] * w).astype(jnp.int32), 0, w - 1)
    cy = jnp.clip((jnp.asarray(coords)[..., 1] * h).astype(jnp.int32), 0, h - 1)
    row0 = (jnp.arange(n, dtype=jnp.int32) * (h * w))[:, None]
    xla = jnp.take(jnp.asarray(masks).reshape(-1), (row0 + cy * w + cx).reshape(-1)).reshape(n, p)
    np.testing.assert_array_equal(ops_ps.point_sample_nearest(_t(masks), _t(coords)).numpy(),
                                  np.asarray(xla))


# K11's route: the ranking's sides, the edge of a block's 227 KB (232448
# bytes: 241x241 is 232324, 242x242 234256; 227x256 exactly 232448), and
# the COCO logits' and targets' sides
NEAREST_ROUTES = [(16, 16, "shared"), (160, 160, "shared"), (241, 241, "shared"),
                  (242, 242, "direct"), (227, 256, "shared"), (227, 257, "direct"),
                  (256, 256, "direct"), (512, 512, "direct")]


@pytest.mark.parametrize("h,w,route", NEAREST_ROUTES)
def test_nearest_route_rule(h, w, route):
    """Shared memory where one mask's fp32 image fits a block's 227 KB, the
    direct read elsewhere, from the mask's shape alone."""
    assert ops_ps.point_sample_nearest_route(h, w) == route


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
    chunk, one row or more columns than the kernel holds; the launchers on
    operands their vector loads cannot take."""
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
    # the route takes the JAX accelerator's lane rule; the kernel reads any w
    # up to ROWS_MAX_W
    assert not ops_ps.point_sample_nearest_rows_supported(16, 100, 24 * 128)
    assert ops_ps.point_sample_nearest_rows(*(_t(a) for a in _rows_case(
        np.random.default_rng(10), w=100))).shape == (3, 24, 128)
    wide = _rows_case(np.random.default_rng(11), w=1024)
    assert ops_ps.point_sample_nearest_rows_supported(16, 1024, 24 * 128)
    with pytest.raises(ValueError, match="w <= 768"):
        ops_ps.point_sample_nearest_rows(*(_t(a) for a in wide))


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


# (h, w, candidates): MaskFiner-Mini's stage masks (16-, 32-, 64- and 128-wide)
# and the 384x384 and 1024x1024 crops' (96-, 256-wide) at 12544 points, the
# lane rule at small shapes, fewer chunks than rows, ragged chunks, one row,
# and masks wider than the rows kernel's shared memory holds
ROUTE_CASES = [(16, 16, 37632), (32, 32, 37632), (64, 64, 37632), (96, 96, 37632),
               (128, 128, 37632), (256, 256, 37632), (4, 128, 256), (16, 100, 24 * 128),
               (16, 384, 24 * 128), (300, 128, 37632), (16, 128, 24 * 128 + 64),
               (1, 128, 1280), (16, 1024, 24 * 128), (16, 896, 24 * 128)]


@pytest.mark.parametrize("h,w,p", ROUTE_CASES)
def test_stratified_route_rule_matches_the_jax_accelerator(jax_mods, monkeypatch, h, w, p):
    """Where the stratified route is asked for (as on a card), the port
    takes it exactly where the JAX package's accelerator does
    (point_sample_nearest_rows_supported: w % 128 == 0, h >= 2, whole chunks
    of 128 and at least as many chunks as rows) and reads i.i.d. candidates
    through point_sample_nearest elsewhere; a stratified call on masks wider
    than the rows kernel holds (ROWS_MAX_W) raises, naming the width."""
    want = jax_mods["jk"].point_sample_nearest_rows_supported(1, h, w, p)
    assert ops_ps.point_sample_nearest_rows_supported(h, w, p) == want
    called = []
    for name in ("point_sample_nearest", "point_sample_nearest_rows"):
        real = getattr(ops_ps, name)
        monkeypatch.setattr(ops_ps, name,
                            lambda *a, _real=real, _name=name: called.append(_name) or _real(*a))
    masks = _t(_tied_masks(np.random.default_rng(h + w), 1, h, w))
    draw = device_draw(torch.Generator().manual_seed(5))
    num_points = p // 3

    def run():
        return tps.get_uncertain_point_coords_nn_ranked(draw, masks, num_points, 3.0, 0.75,
                                                        stratified=True)

    if want and w > ops_ps.ROWS_MAX_W:
        with pytest.raises(ValueError, match=f"{w} wide"):
            run()
        assert not called
        return
    assert run().shape == (1, num_points, 2)
    assert called == ["point_sample_nearest_rows" if want else "point_sample_nearest"]


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

    def nearest(masks, coords, route):
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


@pytest.mark.parametrize("h,w,route", NEAREST_ROUTES)
def test_nearest_wrapper_passes_the_route(monkeypatch, h, w, route):
    """On a CUDA tensor the wrapper hands its launcher the route the rule
    picks for the masks' shape and returns what the launcher returns; here
    the launcher is the plain version and the device rule is forced."""
    seen = []

    def launcher(masks, coords, route):
        seen.append(route)
        return ops_ps.point_sample_nearest_plain(masks, coords)

    monkeypatch.setattr(ops_ps, "use_kernel", lambda *t: True)
    monkeypatch.setattr(ops_ps, "point_sample_nearest_forward", launcher)
    rng = np.random.default_rng(h * w)
    masks = _t(rng.standard_normal((2, h, w)).astype(np.float32))
    coords = _t(rng.uniform(-0.5, 1.5, (2, 33, 2)).astype(np.float32))
    out = ops_ps.point_sample_nearest(masks, coords)
    assert seen == [route]
    assert torch.equal(out, ops_ps.point_sample_nearest_plain(masks, coords))


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


def _offset(t, floats):
    """A contiguous copy of t that starts `floats` floats into its storage."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    return view


# (n, h, w, p, which operand starts off 16 bytes, forced route): both routes
# with 4 points a slot and with one (an odd p, coordinates 8 bytes in), masks
# copied 16 and 4 bytes at a time (h * w odd, masks 4 bytes in), the direct
# route forced on small masks, and more masks than a grid's 65535 rows
NEAREST_CARD_CASES = [(6, 16, 16, 4000, None, None), (3, 160, 160, 5003, None, None),
                      (4, 241, 241, 1001, None, None), (3, 24, 40, 777, "coords", None),
                      (3, 24, 40, 776, "masks", None), (2, 300, 300, 2048, None, None),
                      (2, 33, 31, 999, None, "direct"), (5, 16, 16, 4000, None, "direct"),
                      (70000, 4, 4, 8, None, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,p,offset,forced", NEAREST_CARD_CASES)
def test_nearest_kernel_routes_on_card(cuda, n, h, w, p, offset, forced):
    """K11 on each route and operand variant equals its plain version bit for
    bit, coordinates outside [0, 1] and on the image's corners included, and
    counts its launch under the route it took."""
    rng = np.random.default_rng(n + h + p)
    masks = _t(rng.standard_normal((n, h, w)).astype(np.float32)).to(cuda)
    coords = rng.uniform(-0.5, 1.5, (n, p, 2)).astype(np.float32)
    coords[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    coords = _t(coords).to(cuda)
    if offset == "coords":
        coords = _offset(coords, 2)
    elif offset == "masks":
        masks = _offset(masks, 1)
    route = forced or ops_ps.point_sample_nearest_route(h, w)
    before = dict(ops_ps.point_sample_nearest.launches_by_route)
    if forced:
        got = ops_ps.point_sample_nearest_forward(masks, coords, forced)
    else:
        got = ops_ps.point_sample_nearest(masks, coords)
    torch.cuda.synchronize()
    after = ops_ps.point_sample_nearest.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {r: int(r == route) for r in after}
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
    """128-wide masks: the stratified route's rule holds, so stratification
    reads through the rows kernel and its absence through the nearest one."""
    monkeypatch.setattr(tps, "STRATIFY_RANKING", stratify)
    masks = _t(_tied_masks(np.random.default_rng(5), 6, 16, 128)).to(cuda)

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
