"""The pixel decoder's alternate operand layouts in the PyTorch port against
the JAX package: Morton ranks, the channel-major table lookup, the per-level,
pair-major, head-natural and interleaved deformable-sampling ops (their plain
versions and gradients), the autograd Functions that wrap the kernels, and
``MSDeformAttnPc`` on each of its four routes with the same weights.

Inputs come from numpy with a seed; both sides run fp32 on the CPU.  The JAX
functions that reach a Pallas kernel run in interpret mode, as the JAX
package's own tests run them.  Tolerances: the sampling ops' forward 1e-5
absolute (with rtol 1e-5: <= 48 products summed in another order), their
gradients rtol = atol = 1e-4 (O(1) cotangents, d_val sums a few hundred
products); the table lookup copies floats and must be exact; the whole module
rtol = atol = 2e-4 on outputs and rtol 5e-3 / atol 5e-4 on parameter
gradients, the limits of the JAX package's tests of the same routes
(``tests/test_fused_prep.py``)."""

import contextlib
import ctypes
import functools

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import aff_mini_cfg
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.geometry import morton as tm
from autofocusformermod_torch.losses.lapjv import hungarian_lsap, lapjv
from autofocusformermod_torch.models import pixel_decoder as tpd
from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config
from autofocusformermod_torch.ops import clusten as tc
from autofocusformermod_torch.ops import msdetrpc as md
from autofocusformermod_torch.ops import window_gather as wg
from autofocusformermod_torch.ops.dispatch import plain_versions

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=2e-4, atol=2e-4)
MODULE_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def jnp():
    pytest.importorskip("jax")
    import jax.numpy

    return jax.numpy


# ------------------------------------------------------------------ Morton
@pytest.mark.parametrize("h,w", [(32, 32), (16, 64), (128, 128), (64, 16)])
def test_morton_rank_and_perm_match_jax(h, w):
    from autofocusformermod_tpu.geometry import morton as jm

    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xs, ys = xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)
    want = jm.morton_rank(xs, ys, lw, lh)
    got = tm.morton_rank(_t(xs), _t(ys), lw, lh)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.morton_perm(h, w), jm.morton_perm(h, w))
    assert tm.is_pow2(h) and not tm.is_pow2(h + 1) and not tm.is_pow2(0)
    with pytest.raises(ValueError):
        tm.morton_perm(h, w + 1)


# --------------------------------------------------- the table lookup (K14)
def test_windowed_row_gather_plain_matches_pallas_interpret(jnp):
    from autofocusformermod_tpu.ops.pallas.window_gather import windowed_row_gather

    rng = np.random.default_rng(1)
    b, c, n = 2, 12, 1024
    table = rng.standard_normal((b, c, n)).astype(np.float32)
    idx = rng.integers(0, n, (b, 500)).astype(np.int32)
    want = np.asarray(windowed_row_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(wg.windowed_row_gather_plain(_t(table), _t(idx)).numpy(), want)
    # the wrapper on CPU tensors: the plain version, no launch, no gradient
    before = wg.windowed_row_gather.launches
    got = wg.windowed_row_gather(_t(table).requires_grad_(), _t(idx))
    assert wg.windowed_row_gather.launches == before and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)


def test_windowed_row_gather_refuses_wide_tables():
    assert wg.windowed_row_gather_supported(torch.zeros(1, 32, 8), torch.zeros(1, 3))
    with pytest.raises(ValueError):
        wg.windowed_row_gather(torch.zeros(1, 33, 8), torch.zeros(1, 3, dtype=torch.int32))


# ------------------------------------------- the sampling ops (K5, K7, K8, K6)
def _make_case(rng, bh=4, n=140, L=3, kpts=4, kk=4, c_=32, sizes=(128, 256, 1024)):
    """Interleaved operands (the JAX tests' case): slot s = ki * L + j holds
    global indices into level j, near a per-query centre."""
    offs = np.cumsum([0] + list(sizes))
    m = kpts * L
    nn_idx = np.zeros((bh, n, m, kk), np.int32)
    for j in range(L):
        centers = rng.integers(0, sizes[j], (bh, n, 1, 1))
        vals = np.clip(centers + rng.integers(-8, 9, (bh, n, kpts, kk)), 0, sizes[j] - 1) + offs[j]
        for ki in range(kpts):
            nn_idx[:, :, ki * L + j, :] = vals[:, :, ki, :]
    nn_w = rng.standard_normal((bh, n, m, kk)).astype(np.float32)
    attn = rng.standard_normal((bh, n, m)).astype(np.float32)
    val = rng.standard_normal((bh, int(offs[-1]), c_)).astype(np.float32)
    return nn_idx, nn_w, attn, val, tuple(sizes)


def _to_levels(nn_idx, nn_w, attn, sizes):
    """Per level (bh, n, P) local indices and weights with the attention folded in."""
    bh, n, m, kk = nn_idx.shape
    L = len(sizes)
    kpts = m // L
    offs = np.cumsum([0] + list(sizes))
    idxs, ws = [], []
    for j in range(L):
        slots = [ki * L + j for ki in range(kpts)]
        idxs.append((nn_idx[:, :, slots, :] - offs[j]).reshape(bh, n, kpts * kk).astype(np.int32))
        ws.append((nn_w[:, :, slots, :] * attn[:, :, slots, None]).reshape(bh, n, kpts * kk))
    return idxs, ws


def _to_t(arrays):
    """(bh, n, P) -> (bh, P, n), queries minor."""
    return [np.ascontiguousarray(a.transpose(0, 2, 1)) for a in arrays]


def _to_bh(arrays, h):
    """(b*h, n, X) -> (b, n, h, X), heads after the queries."""
    return [np.ascontiguousarray(a.reshape(a.shape[0] // h, h, *a.shape[1:]).transpose(0, 2, 1, 3))
            for a in arrays]


def _layout_case(layout, seed, h=2, uniform=False, **shape):
    """One case in the operands of `layout` -> (port function, its plain
    version, idxs, ws, val, sizes, g), numpy arrays.  shape: _make_case's;
    uniform: indices drawn over each whole level instead of near a
    per-query centre."""
    rng = np.random.default_rng(seed)
    nn_idx, nn_w, attn, val, sizes = _make_case(rng, **shape)
    idxs, ws = _to_levels(nn_idx, nn_w, attn, sizes)
    if uniform:
        idxs = [rng.integers(0, s, i.shape).astype(np.int32) for i, s in zip(idxs, sizes)]
    g = rng.standard_normal((val.shape[0], nn_idx.shape[1], val.shape[2])).astype(np.float32)
    if layout == "levels":
        return md.msdetrpc_levels, md.msdetrpc_levels_plain, idxs, ws, val, sizes, g
    if layout == "levels_t":
        return (md.msdetrpc_levels_t, md.msdetrpc_levels_t_plain, _to_t(idxs), _to_t(ws), val,
                sizes, g)
    (val_bh,), (g_bh,) = _to_bh([val], h), _to_bh([g], h)
    return md.msdetrpc_bh, md.msdetrpc_bh_plain, _to_bh(idxs, h), _to_bh(ws, h), val_bh, sizes, g_bh


def _jax_forward(layout, idxs, ws, val, sizes, jnp):
    from autofocusformermod_tpu.ops.pallas import msdetrpc_kernel as mk

    impl = {"levels": functools.partial(mk.msdetrpc_pallas_levels_impl, version=8),
            "levels_t": mk.msdetrpc_pallas_levels_t_impl, "bh": mk.msdetrpc_pallas_bh_impl}[layout]
    return impl(tuple(map(jnp.asarray, idxs)), tuple(map(jnp.asarray, ws)), jnp.asarray(val),
                sizes, interpret=True)


@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_plain_matches_pallas_interpret(jnp, layout):
    """Each plain version, derived from its own docstring, against the TPU
    kernel of the same layout; the wrapper on CPU tensors launches nothing."""
    fn, plain, idxs, ws, val, sizes, _ = _layout_case(layout, seed=1)
    want = _jax_forward(layout, idxs, ws, val, sizes, jnp)
    _close(plain(list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes), want)
    before = fn.launches
    _close(fn(list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes), want)
    assert fn.launches == before


def test_layout_plain_versions_catch_a_swapped_axis():
    """The three layouts are different functions of the same arrays: reading
    one layout's operands as another's (where the shapes allow) disagrees."""
    _, _, idxs, ws, val, sizes, _ = _layout_case("levels", seed=2)
    sq = [np.ascontiguousarray(a[:, :16]) for a in idxs], [np.ascontiguousarray(a[:, :16]) for a in ws]
    a = md.msdetrpc_levels_plain(list(map(_t, sq[0])), list(map(_t, sq[1])), _t(val), sizes)
    b = md.msdetrpc_levels_t_plain(list(map(_t, sq[0])), list(map(_t, sq[1])), _t(val), sizes)
    assert a.shape == b.shape and not torch.allclose(a, b, atol=1e-3)


def _grads(fn, idxs, ws, val, sizes, g):
    ws = [w.clone().requires_grad_() for w in ws]
    val = val.clone().requires_grad_()
    out = fn(idxs, ws, val, sizes)
    return torch.autograd.grad((out * g).sum(), [val, *ws])


def _pallas_backward(layout, idxs, ws, val, g, sizes, jnp):
    """(d_val, [d_w per level]) of the TPU backward of `layout` in interpret
    mode (the pair-major layout's is the per-level one on untransposed
    operands, as in the JAX package)."""
    from autofocusformermod_tpu.ops.pallas import msdetrpc_kernel as mk

    if layout == "bh":
        _, dws, dval = mk.msdetrpc_pallas_bh_bwd_impl(
            tuple(map(jnp.asarray, idxs)), tuple(map(jnp.asarray, ws)), jnp.asarray(val),
            jnp.asarray(g), sizes, interpret=True)
        return dval, dws
    un_t = (lambda a: a.transpose(0, 2, 1)) if layout == "levels_t" else (lambda a: a)
    _, dws, dval = mk._bwd_levels_impl(
        tuple(jnp.asarray(un_t(i)) for i in idxs), tuple(jnp.asarray(un_t(w)) for w in ws),
        jnp.asarray(val), jnp.asarray(g), sizes, interpret=True)
    return dval, [un_t(np.asarray(d)) for d in dws]


@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_plain_backward_matches_pallas_interpret(jnp, layout):
    """d_val and every d_w of each plain version against the TPU backward of
    the same layout in interpret mode."""
    _, plain, idxs, ws, val, sizes, g = _layout_case(layout, seed=4)
    got = _grads(plain, list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes, _t(g))
    dval, dws = _pallas_backward(layout, idxs, ws, val, g, sizes, jnp)
    _close(got[0], dval, **GRAD_TOL)
    for a, r in zip(got[1:], dws):
        _close(a, r, **GRAD_TOL)


# shapes where the CUDA kernels' structure shows: n = 100 spans four of the
# backward's 32-query tiles, the last cut, and is no multiple of the
# forward's 8-query blocks; 8 heads, interleaved in the head-natural value
# table; indices near a per-query centre (a tile's rows repeat) and uniform
# ones (every tile meets every 32-row band)
ACROSS_TILES = dict(bh=8, n=100, sizes=(128, 256, 512))


@pytest.mark.parametrize("indices", ["centred", "uniform"])
@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_plain_matches_pallas_interpret_across_tiles(jnp, layout, indices):
    """Each plain version's forward, d_val and d_w against the TPU kernels of
    the same layout in interpret mode, at ACROSS_TILES."""
    _, plain, idxs, ws, val, sizes, g = _layout_case(
        layout, seed=13, h=8, uniform=indices == "uniform", **ACROSS_TILES)
    _close(plain(list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes),
           _jax_forward(layout, idxs, ws, val, sizes, jnp))
    got = _grads(plain, list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes, _t(g))
    dval, dws = _pallas_backward(layout, idxs, ws, val, g, sizes, jnp)
    _close(got[0], dval, **GRAD_TOL)
    for a, r in zip(got[1:], dws):
        _close(a, r, **GRAD_TOL)


@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_plain_matches_jax_definition_at_odd_level_sizes(jnp, layout):
    """Level sizes that are no multiples of 128 (ntot = 1300: no multiple of
    the backward's 32-row bands either; n = 77), which the TPU forwards do not
    take: each plain version's forward and gradients against jax.vjp of the
    JAX package's definition (ops/clusten.msdetrpc on the interleaved
    operands, its attention 1 so that its weights are the layout's)."""
    import jax

    from autofocusformermod_tpu.ops import clusten as jc

    rng = np.random.default_rng(14)
    nn_idx, nn_w, _, val, sizes = _make_case(rng, bh=8, n=77, sizes=(100, 200, 1000))
    ones = np.ones(nn_idx.shape[:3], np.float32)
    idxs, ws = _to_levels(nn_idx, nn_w, ones, sizes)
    g = rng.standard_normal((8, 77, val.shape[2])).astype(np.float32)
    out, vjp = jax.vjp(lambda w, v: jc.msdetrpc(jnp.asarray(nn_idx), w, jnp.asarray(ones), v),
                       jnp.asarray(nn_w), jnp.asarray(val))
    d_nn_w, d_val = vjp(jnp.asarray(g))
    _, d_ws = _to_levels(nn_idx, np.asarray(d_nn_w), ones, sizes)
    want, want_val, h = np.asarray(out), np.asarray(d_val), 8
    if layout == "levels_t":
        idxs, ws, d_ws = _to_t(idxs), _to_t(ws), _to_t(d_ws)
    elif layout == "bh":
        idxs, ws, d_ws = _to_bh(idxs, h), _to_bh(ws, h), _to_bh(d_ws, h)
        (val, g, want, want_val) = _to_bh([val, g, want, want_val], h)
    plain = {"levels": md.msdetrpc_levels_plain, "levels_t": md.msdetrpc_levels_t_plain,
             "bh": md.msdetrpc_bh_plain}[layout]
    _close(plain(list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes), want)
    got = _grads(plain, list(map(_t, idxs)), list(map(_t, ws)), _t(val), sizes, _t(g))
    _close(got[0], want_val, **GRAD_TOL)
    for a, r in zip(got[1:], d_ws):
        _close(a, r, **GRAD_TOL)


def test_interleaved_plain_matches_pallas_interpret_forward_and_backward(jnp):
    """ops/clusten.msdetrpc against the TPU kernel of the interleaved layout
    and its VJP (d_nn_weight, d_attn, d_val), and against jax.vjp of the JAX
    definition."""
    import jax

    from autofocusformermod_tpu.ops import clusten as jc
    from autofocusformermod_tpu.ops.pallas import msdetrpc_kernel as mk

    rng = np.random.default_rng(5)
    nn_idx, nn_w, attn, val, sizes = _make_case(rng, bh=2)
    g = rng.standard_normal((2, nn_idx.shape[1], val.shape[2])).astype(np.float32)
    j = list(map(jnp.asarray, (nn_idx, nn_w, attn, val)))
    want = mk.msdetrpc_pallas_impl(*j, sizes, version=2, interpret=True)
    before = tc.msdetrpc.launches
    _close(tc.msdetrpc(_t(nn_idx), _t(nn_w), _t(attn), _t(val)), want)
    assert tc.msdetrpc.launches == before
    leaves = [_t(a).requires_grad_() for a in (nn_w, attn, val)]
    got = torch.autograd.grad((tc.msdetrpc_plain(_t(nn_idx), *leaves) * _t(g)).sum(), leaves)
    for a, r in zip(got, mk.msdetrpc_pallas_bwd_impl(*j, jnp.asarray(g), sizes, interpret=True)):
        _close(a, r, **GRAD_TOL)
    _, vjp = jax.vjp(lambda w, a, v: jc.msdetrpc(j[0], w, a, v), *j[1:])
    for a, r in zip(got, vjp(jnp.asarray(g))):
        _close(a, r, **GRAD_TOL)


# ------------------------------------------- the autograd Functions, on CPU
def _plain_backward(plain):
    def bwd(idxs, ws, val, g, level_sizes):
        with torch.enable_grad():
            d_val, *d_ws = _grads(plain, idxs, ws, val, level_sizes, g)
        return d_val, d_ws
    return bwd


@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_function_wiring(monkeypatch, layout):
    """The CUDA path's autograd Function of each layout, its two launchers
    replaced by the plain version and its autograd gradients: a grad_fn, the
    plain version's gradients in the right slots, none to the indices."""
    fn, plain, idxs, ws, val, sizes, g = _layout_case(layout, seed=6)
    monkeypatch.setattr(fn, "forward_launcher", plain)
    monkeypatch.setattr(fn, "backward_launcher", _plain_backward(plain))
    idxs, ws, val, g = list(map(_t, idxs)), list(map(_t, ws)), _t(val), _t(g)

    def through_function(idxs, ws, val, sizes):
        out = md._LayoutFunction.apply(fn, sizes, val, *idxs, *ws)
        assert out.grad_fn is not None
        return out

    got = _grads(through_function, idxs, ws, val, sizes, g)
    want = _grads(plain, idxs, ws, val, sizes, g)
    assert len(got) == 1 + len(sizes)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_interleaved_function_wiring(monkeypatch):
    """The CUDA path's autograd Function, its launchers replaced by the plain
    version and its autograd gradients (a grad_fn, the gradients of
    nn_weight, attn and val in their slots); then the backward launcher's
    call of the C entry point, through a stand-in library: the scratch of
    aff_msdetrpc_bwd_scratch for one level of ntot rows and m * k pairs,
    sized as it answers, and every pointer and size in its place."""
    rng = np.random.default_rng(7)
    nn_idx, nn_w, attn, val, _ = _make_case(rng, bh=2, n=20)
    g = _t(rng.standard_normal((2, 20, val.shape[2])).astype(np.float32))
    launcher = tc.msdetrpc_backward

    def bwd(idx, w, a, v, g):
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in (w, a, v)]
            return torch.autograd.grad((tc.msdetrpc_plain(idx, *leaves) * g).sum(), leaves)

    monkeypatch.setattr(tc, "msdetrpc_forward", tc.msdetrpc_plain)
    monkeypatch.setattr(tc, "msdetrpc_backward", bwd)
    leaves = [_t(a).requires_grad_() for a in (nn_w, attn, val)]
    out = tc._MsdetrpcInterleaved.apply(_t(nn_idx), *leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * g).sum(), leaves)
    want = torch.autograd.grad((tc.msdetrpc_plain(_t(nn_idx), *leaves) * g).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)

    bh, n, m, k = nn_idx.shape
    ntot, c_ = val.shape[1:]
    seen = {}

    class Library:
        def aff_msdetrpc_bwd_scratch(self, n_, n_levels, sizes, pairs, dims):
            seen["scratch"] = (n_, n_levels, ctypes.cast(sizes, ctypes.POINTER(ctypes.c_int))[0],
                               pairs)
            ctypes.memmove(dims, (ctypes.c_int * 3)(3, 5, 7), 3 * ctypes.sizeof(ctypes.c_int))
            return 0

        def aff_msdetrpc_interleaved_bwd(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(tc, "msdetrpc_backward", launcher)
    monkeypatch.setattr(tc, "load_kernels", Library)
    monkeypatch.setattr(tc, "stream_of", lambda t: 99)
    monkeypatch.setattr(tc.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    ops = [_t(nn_idx), _t(nn_w), _t(attn), _t(val), g]
    before = launcher.launches
    d_w, d_attn, d_val = launcher(*ops)
    assert launcher.launches == before + 1
    assert seen["scratch"] == (n, 1, ntot, m * k)
    args = seen["args"]
    assert len(args) == 18 and args[:5] == tuple(t.data_ptr() for t in ops)
    assert args[5:8] == (d_w.data_ptr(), d_attn.data_ptr(), d_val.data_ptr())
    assert (d_w.shape, d_attn.shape, d_val.shape) == (nn_w.shape, attn.shape, val.shape)
    assert len(set(args[:11])) == 11                       # the scratch: three tensors of its own
    assert args[11:] == (bh, n, ntot, c_, m, k, 99)


def test_more_levels_than_the_kernel_holds_raise():
    idxs = [torch.zeros(1, 2, 1, dtype=torch.int32)] * 9
    ws = [torch.zeros(1, 2, 1)] * 9
    with pytest.raises(ValueError, match="at most 8 levels"):
        md._check_level_operands(idxs, ws, torch.zeros(1, 9, 4), [1] * 9, (1, 2, 1), (1, 9, 4))


# --------------------------------------------- MSDeformAttnPc on each route
ROUTES = {  # name -> (port flags, level sizes, level shapes, grid side)
    "stacked": ({}, (512, 256, 128), ((16, 16), (8, 8), (4, 4)), 32),
    "levels": ({"USE_STACKED_GLUE": False}, (512, 256, 128), ((16, 16), (8, 8), (4, 4)), 32),
    "fused_prep": ({"USE_FUSED_PREP": True}, (512, 256, 128), ((16, 16), (8, 8), (4, 4)), 32),
    "bh": ({"USE_BH_LAYOUT": True}, (512, 256, 128), ((16, 16), (8, 8), (4, 4)), 32),
    # a level split that is not all multiples of 128: the interleaved route
    "interleaved": ({"USE_STACKED_GLUE": False}, (144, 100, 36), ((12, 12), (10, 10), (6, 6)), 24),
}


def _module_case(route, learnable, seed=2, b=2, c=64):
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.pixel_decoder import MSDeformAttnPc

    _, level_sizes, shapes, g = ROUTES[route]
    rng = np.random.default_rng(seed)
    spatial_shapes = list(shapes) + [(g, g)]
    querys = [rng.standard_normal((b, n, c)).astype(np.float32) for n in level_sizes]
    values = [rng.standard_normal((b, n, c)).astype(np.float32) for n in level_sizes]
    poss = [rng.uniform(0, [sw, sh], (b, n, 2)).astype(np.float32)
            for n, (sh, sw) in zip(level_sizes, shapes)]
    nb_packed = []
    for n, (sh, sw) in zip(level_sizes, shapes):
        nbi = rng.integers(0, n, (b, g * g, 4)).astype(np.float32)
        nbx = rng.uniform(0, sw, (b, g * g, 4)).astype(np.float32)
        nby = rng.uniform(0, sh, (b, g * g, 4)).astype(np.float32)
        nb_packed.append(np.concatenate([nbi, nbx, nby], -1))
    module = MSDeformAttnPc(d_model=c, n_levels=3, n_heads=4, n_points=4, shepard_power=3.0,
                            shepard_power_learnable=learnable)
    # the module's parameter tree written out (module.init would run a whole
    # forward op by op): random weights, and offset biases wide enough that
    # the sampled locations vary
    widths = {"sampling_offsets": 4 * 3 * 4 * 2, "attention_weights": 4 * 3 * 4,
              "value_proj": c, "output_proj": c}
    params = {name: {"kernel": jnp.asarray(0.02 * rng.standard_normal((c, f)), jnp.float32),
                     "bias": jnp.asarray((1.5 if name == "sampling_offsets" else 0.1)
                                         * rng.standard_normal(f), jnp.float32)}
              for name, f in widths.items()}
    if learnable:
        params["shepard_power"] = jnp.asarray([3.1], jnp.float32)
    variables = {"params": params}
    return module, variables, querys, poss, values, spatial_shapes, nb_packed


def _port_module(variables, learnable, c=64):
    """The port's module with the JAX module's weights, carried across by the
    weights bridge with no rule of its own for these parameter names."""
    port = tpd.MSDeformAttnPc(c, 3, 4, 4, shepard_power=3.0, shepard_power_learnable=learnable)
    sd = flax_to_torch_state_dict({"attn": variables["params"]})
    result = port.load_state_dict({k[len("attn."):]: v for k, v in sd.items()}, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert ("shepard_power" in dict(port.named_parameters())) == learnable
    return port


def _port_forward(port, route, querys, poss, values, spatial_shapes, nb_packed, monkeypatch):
    flags = ROUTES[route][0]
    for name, value in {"USE_STACKED_GLUE": True, "USE_FUSED_PREP": False,
                        "USE_BH_LAYOUT": False, **flags}.items():
        monkeypatch.setattr(tpd, name, value)
    calls = {}
    for mod, name in ((tpd, "msdetrpc_levels_s"), (tpd, "msdetrpc_levels"), (tpd, "msdetrpc"),
                      (tpd, "msdetrpc_levels_t"), (tpd, "msdetrpc_bh"),
                      (tpd, "windowed_row_gather")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    nb = list(map(_t, nb_packed))
    nb_t = None
    if flags.get("USE_FUSED_PREP"):
        g = spatial_shapes[-1][0]
        perm = torch.from_numpy(tm.morton_perm(g, g))
        nb_t = [t[:, perm, :].transpose(1, 2).contiguous() for t in nb]
    out = port(list(map(_t, querys)), list(map(_t, poss)), list(map(_t, values)), spatial_shapes,
               nb, nb_t)
    return out, calls


EXPECTED_CALLS = {"stacked": {"msdetrpc_levels_s": 3}, "levels": {"msdetrpc_levels": 3},
                  "interleaved": {"msdetrpc": 3}, "bh": {"msdetrpc_bh": 3},
                  # every level holds at least an eighth of the 1024 cells
                  "fused_prep": {"msdetrpc_levels_t": 3, "windowed_row_gather": 9}}


def _jax_route(route, monkeypatch):
    """Put the JAX module on the same route, its Pallas calls in interpret
    mode (flags and interpret mode patched from here only)."""
    from autofocusformermod_tpu.models import pixel_decoder as jpd
    from autofocusformermod_tpu.ops import dispatch as jd
    from autofocusformermod_tpu.ops.pallas import msdetrpc_kernel as mk
    from autofocusformermod_tpu.ops.pallas import window_gather as jwg

    if route == "levels":
        monkeypatch.setattr(jd, "fused_attention_available", lambda: True)
        monkeypatch.setattr(jpd, "USE_STACKED_GLUE", False)
        monkeypatch.setattr(mk, "msdetrpc_pallas_levels",
                            functools.partial(mk.msdetrpc_pallas_levels_impl, interpret=True,
                                              version=8))
    elif route == "bh":
        monkeypatch.setattr(jd, "fused_attention_available", lambda: True)
        monkeypatch.setattr(jpd, "USE_BH_LAYOUT", True)
        monkeypatch.setattr(mk, "msdetrpc_pallas_bh",
                            functools.partial(mk.msdetrpc_pallas_bh_impl, interpret=True))
    elif route == "fused_prep":
        # one 128-sample tile per program: the kernel's body is unrolled over
        # its tiles, and exactness does not depend on the tile size
        monkeypatch.setattr(jwg, "windowed_row_gather",
                            functools.partial(jwg.windowed_row_gather, interpret=True, tile_s=128))
        monkeypatch.setattr(mk, "msdetrpc_pallas_levels_t",
                            functools.partial(mk.msdetrpc_pallas_levels_t_impl, interpret=True))
    # "stacked" and "interleaved": on the CPU the JAX module takes its XLA
    # composition, the interleaved ops/clusten.msdetrpc


@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("route", list(ROUTES))
def test_msdeformattn_routes_match_jax(monkeypatch, route, learnable):
    """The port's module on each route against the JAX module on the same
    route, with the same weights, for a learnable and a fixed Shepard power."""
    import jax
    import jax.numpy as jnp

    module, variables, querys, poss, values, shapes, nb_packed = _module_case(route, learnable)
    _jax_route(route, monkeypatch)
    nb = list(map(jnp.asarray, nb_packed))
    nb_t = None
    if route == "fused_prep":
        from autofocusformermod_tpu.geometry.morton import morton_perm

        perm = jnp.asarray(morton_perm(shapes[-1][0], shapes[-1][1]))
        nb_t = [t[:, perm, :].transpose(0, 2, 1) for t in nb]
    def apply(v):
        return module.apply(v, list(map(jnp.asarray, querys)), list(map(jnp.asarray, poss)),
                            list(map(jnp.asarray, values)), shapes, nb, nb_t)

    # the XLA compositions under one jit; the interpreted kernels op by op
    want = (jax.jit(apply) if route in ("stacked", "interleaved") else apply)(variables)
    port = _port_module(variables, learnable)
    got, calls = _port_forward(port, route, querys, poss, values, shapes, nb_packed, monkeypatch)
    assert calls == EXPECTED_CALLS[route]
    for a, r in zip(got, want):
        _close(a, r, **MODULE_TOL)


@functools.lru_cache(maxsize=None)
def _jax_xla_gradients(geometry):
    """The case of the routes with this geometry (they share it, seed and
    all) and jax.grad of sum(out^2) through the JAX module's XLA composition."""
    import jax
    import jax.numpy as jnp

    route = next(r for r in ROUTES if ROUTES[r][1:] == geometry)
    case = _module_case(route, True, seed=4, b=1, c=32)
    module, variables, querys, poss, values, shapes, nb_packed = case

    def loss(v):
        outs = module.apply(v, list(map(jnp.asarray, querys)), list(map(jnp.asarray, poss)),
                            list(map(jnp.asarray, values)), shapes,
                            list(map(jnp.asarray, nb_packed)))
        return sum(jnp.sum(o * o) for o in outs)

    return case, flax_to_torch_state_dict({"attn": jax.jit(jax.grad(loss))(variables)["params"]})


@pytest.mark.parametrize("route", list(ROUTES))
def test_msdeformattn_route_gradients_match_jax(monkeypatch, route):
    """Parameter gradients of sum(out^2) on each route of the port against
    jax.grad of the JAX module's XLA composition (every route of either
    package computes the same function; the JAX kernels' own VJPs are held
    above): the detached table rows cut no real gradient route."""
    geometry = ROUTES[route][1:]
    (_, variables, querys, poss, values, shapes, nb_packed), want = _jax_xla_gradients(geometry)
    port = _port_module(variables, True, c=32)
    got, _ = _port_forward(port, route, querys, poss, values, shapes, nb_packed, monkeypatch)
    sum((o * o).sum() for o in got).backward()
    for name, p in port.named_parameters():
        _close(p.grad, want["attn." + name].numpy(), **MODULE_GRAD_TOL)


# ------------------------------------------------ the slice as a whole
TINY = ["MODEL.AFF.EMBED_DIM", "[8, 12, 16, 20]", "MODEL.AFF.DEPTHS", "[1, 1, 1, 1]",
        "MODEL.AFF.NUM_HEADS", "[2, 2, 2, 2]", "MODEL.AFF.NBHD_SIZE", "[16, 16, 16, 16]",
        "MODEL.SEM_SEG_HEAD.CONVS_DIM", "16", "MODEL.SEM_SEG_HEAD.MASK_DIM", "16",
        "MODEL.MASK_FORMER.HIDDEN_DIM", "16", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "32",
        "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1", "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "4",
        "MODEL.MASK_FORMER.DEC_LAYERS", "2", "MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "4"]


@pytest.fixture(scope="module")
def tiny():
    """A tiny MaskFormer (fixed Shepard power) at 512x512, where the decoder
    levels hold 4096, 1024 and 256 tokens on a 128x128 grid as at full
    width, and its default-layout outputs."""
    cfg = aff_mini_cfg()
    cfg.merge_from_list(TINY + ["MODEL.AFF.SHEPARD_POWER_LEARNABLE", "False"])
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(5)).eval()
    assert not any("shepard_power" in n for n, _ in model.named_parameters())
    image = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 512, 512, 3))
                             .astype(np.uint8))
    with torch.no_grad():
        return model, image, model(image)


@pytest.mark.parametrize("flag,op,calls", [("USE_FUSED_PREP", "msdetrpc_levels_t", 1),
                                           ("USE_BH_LAYOUT", "msdetrpc_bh", 3),
                                           ("USE_STACKED_GLUE", "msdetrpc_levels", 3)])
def test_tiny_maskformer_layouts_match_default(monkeypatch, tiny, flag, op, calls):
    """The whole model under each alternate layout against the default
    layout: the Morton tables, the level gate (only the 4096-token level
    takes the channel-major prep) and the route's op are reached through
    MSDeformAttnPixelDecoder.forward."""
    model, image, want = tiny
    monkeypatch.setattr(tpd, flag, flag != "USE_STACKED_GLUE")
    count = {"n": 0}
    real = getattr(tpd, op)

    def counted(*a, **k):
        count["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tpd, op, counted)
    with torch.no_grad():
        got = model(image)
    assert count["n"] == calls
    for key in ("pred_logits", "pred_masks"):
        torch.testing.assert_close(got[key], want[key], **MODULE_TOL)


def test_fixed_shepard_power_from_config():
    cfg = aff_mini_cfg()
    cfg.merge_from_list(TINY + ["MODEL.AFF.SHEPARD_POWER_LEARNABLE", "False"])
    attn = maskformer_from_config(cfg).sem_seg_head.pixel_decoder.transformer.encoder.layers[0].self_attn
    assert attn.shepard_power == cfg.MODEL.AFF.SHEPARD_POWER / 2.0
    assert "shepard_power" not in attn.state_dict()


# ------------------------------------------------------- lapjv on bad costs
def test_plain_lsap_terminates_on_nan_and_inf():
    """NaN counts as the largest cost, +-inf are clamped: the plain version
    returns distinct queries, and the optimum of the cleaned matrix."""
    rng = np.random.default_rng(8)
    cost = rng.standard_normal((3, 12, 9)).astype(np.float32)
    cost[0, 2, :] = np.nan
    cost[1, :, 4] = np.nan
    cost[2, 3, 3], cost[2, 5, 1] = np.inf, -np.inf
    got = hungarian_lsap(_t(cost))
    clean = np.clip(np.nan_to_num(cost, nan=3e4, posinf=3e4, neginf=-3e4), -3e4, 3e4)
    torch.testing.assert_close(got, hungarian_lsap(_t(clean)), rtol=0, atol=0)
    for row in got.tolist():
        assert len(set(row)) == 9 and all(0 <= q < 12 for q in row)
    assert 2 not in got[0].tolist() and got[2, 1].item() == 5


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh"])
def test_layout_kernels_match_plain_on_card(cuda, layout):
    """Forward and backward kernels of each layout against the plain version
    (n = 140: no multiple of the block's 8 queries)."""
    fn, _, idxs, ws, val, sizes, g = _layout_case(layout, seed=9)
    idxs = [_t(a).to(cuda) for a in idxs]
    ws = [_t(a).to(cuda) for a in ws]
    val, g = _t(val).to(cuda), _t(g).to(cuda)
    before = fn.launches, fn.backward_launcher.launches
    out = fn(idxs, ws, val, sizes)
    got = _grads(fn, idxs, ws, val, sizes, g)
    assert (fn.launches, fn.backward_launcher.launches) == (before[0] + 2, before[1] + 1)
    with plain_versions():
        torch.testing.assert_close(out, fn(idxs, ws, val, sizes), **TOL)
        want = _grads(fn, idxs, ws, val, sizes, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def _interleaved_on_card(cuda, seed, uniform=False, **shape):
    """The interleaved op's kernels on one _make_case case (uniform: global
    indices drawn over the whole table) against the plain version: the
    forward, and the gradients of nn_weight, attn and val; one launch of
    each.  Returns the operands (idx, [nn_weight, attn, val]) and g on the
    card."""
    rng = np.random.default_rng(seed)
    nn_idx, nn_w, attn, val, _ = _make_case(rng, **shape)
    if uniform:
        nn_idx = rng.integers(0, val.shape[1], nn_idx.shape).astype(np.int32)
    g = _t(rng.standard_normal((val.shape[0], nn_idx.shape[1], val.shape[2]))
           .astype(np.float32)).to(cuda)
    idx = _t(nn_idx).to(cuda)
    ops = [_t(a).to(cuda) for a in (nn_w, attn, val)]

    def run():
        leaves = [a.clone().requires_grad_() for a in ops]
        out = tc.msdetrpc(idx, *leaves)
        return out, torch.autograd.grad((out * g).sum(), leaves)

    before = tc.msdetrpc.launches, tc.msdetrpc_backward.launches
    out, got = run()
    assert (tc.msdetrpc.launches, tc.msdetrpc_backward.launches) == (before[0] + 1, before[1] + 1)
    with plain_versions():
        ref, want = run()
    torch.testing.assert_close(out, ref, **TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    return idx, ops, g


@pytest.mark.cuda
@pytest.mark.parametrize("indices", ["centred", "uniform"])
@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh", "interleaved"])
def test_layout_kernels_are_exact_and_deterministic_on_card(cuda, layout, indices):
    """The forward kernel and the fixed-order backward pair of each layout
    over many query tiles and value-row bands: n = 300 (not a multiple of
    32), level sizes (100, 200, 1000) (ntot not a multiple of the 32-row
    band), 8 heads, 16 image-heads; indices near a per-query centre and
    uniform ones.  Against the plain version, and two backward calls bit for
    bit (no atomics: the sums have a fixed order); for the interleaved
    layout d_nn_weight, d_attn and d_val."""
    shape = dict(bh=16, n=300, sizes=(100, 200, 1000))
    if layout == "interleaved":
        idx, ops, g = _interleaved_on_card(cuda, 15, uniform=indices == "uniform", **shape)
        first = tc.msdetrpc_backward(idx, *ops, g)
        again = tc.msdetrpc_backward(idx, *ops, g)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        return
    fn, _, idxs, ws, val, sizes, g = _layout_case(
        layout, seed=15, h=8, uniform=indices == "uniform", **shape)
    idxs = [_t(a).to(cuda) for a in idxs]
    ws = [_t(a).to(cuda) for a in ws]
    val, g = _t(val).to(cuda), _t(g).to(cuda)
    out = fn(idxs, ws, val, sizes)
    got = _grads(fn, idxs, ws, val, sizes, g)
    with plain_versions():
        torch.testing.assert_close(out, fn(idxs, ws, val, sizes), **TOL)
        want = _grads(fn, idxs, ws, val, sizes, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    first = fn.backward_launcher(idxs, ws, val, g, sizes)
    again = fn.backward_launcher(idxs, ws, val, g, sizes)
    assert torch.equal(first[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["levels", "levels_t", "bh", "interleaved"])
def test_layout_kernels_generic_instance_on_card(cuda, layout):
    """The kernels' generic instance (2 levels of 8 pairs, not the path's
    compiled 3 x 16; for the interleaved layout 16 pairs, not its compiled
    48) with 5-channel heads (4-byte row reads) against the plain
    version."""
    shape = dict(bh=8, n=45, L=2, kpts=2, c_=5, sizes=(128, 256))
    if layout == "interleaved":
        _interleaved_on_card(cuda, 16, **shape)
        return
    fn, _, idxs, ws, val, sizes, g = _layout_case(layout, seed=16, h=4, **shape)
    idxs = [_t(a).to(cuda) for a in idxs]
    ws = [_t(a).to(cuda) for a in ws]
    val, g = _t(val).to(cuda), _t(g).to(cuda)
    out = fn(idxs, ws, val, sizes)
    got = _grads(fn, idxs, ws, val, sizes, g)
    with plain_versions():
        torch.testing.assert_close(out, fn(idxs, ws, val, sizes), **TOL)
        want = _grads(fn, idxs, ws, val, sizes, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.cuda
def test_interleaved_kernels_match_plain_on_card(cuda):
    _interleaved_on_card(cuda, 10, sizes=(144, 100, 36))


@pytest.mark.cuda
def test_window_gather_kernel_is_exact_on_card(cuda):
    rng = np.random.default_rng(11)
    table = _t(rng.standard_normal((3, 12, 1000)).astype(np.float32)).to(cuda)
    idx = _t(rng.integers(0, 1000, (3, 777)).astype(np.int32)).to(cuda)
    before = wg.windowed_row_gather.launches
    out = wg.windowed_row_gather(table, idx)
    assert wg.windowed_row_gather.launches == before + 1 and not out.requires_grad
    assert torch.equal(out, wg.windowed_row_gather_plain(table, idx))
    with pytest.raises(ValueError):
        wg.windowed_row_gather(table, idx[:, ::2])          # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["warp", "block"])
def test_lapjv_kernel_terminates_on_nan_and_inf_on_card(cuda, route):
    """The kernel's Dijkstra loop ends on NaN and +-inf costs and gives the
    plain version's assignment on both routes (a hang would never reach the
    comparison: the test's process is then cut by the caller's time
    limit)."""
    rng = np.random.default_rng(12)
    cost = rng.standard_normal((8, 100, 100)).astype(np.float32) * 3
    cost[0] = np.nan
    cost[1, 10:20, :] = np.nan
    cost[2, :, 30:60] = np.nan
    cost[3, 5, 5], cost[3, 6, 7] = np.inf, -np.inf
    cost[4] = np.inf
    cost[5, ::2, ::3] = np.nan
    cost[:, :, 80:] = 1e8
    cost = _t(cost).to(cuda)
    got = lapjv(cost, route=route)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, hungarian_lsap(cost), rtol=0, atol=0)
    assert all(len(set(row)) == 100 for row in got.tolist())
