"""Parity of the PyTorch port's ops (autofocusformermod_torch/ops) with the
JAX package's: the gather-einsums, the plain versions of the local_attn,
msdetrpc and point_sample kernels and their gradients, the autograd
Functions that wrap the kernels, the device rule, and (on a card) the
kernels themselves, forward and backward.

Inputs come from numpy with a seed; both sides run fp32.  Tolerance for the
gather-einsums and the kernels' plain versions: rtol = atol = 1e-5, the
room fp32 leaves for the two frameworks summing the same products in another
order (inner sizes <= 48 here).  Gradients: rtol = atol = 1e-4 (the
cotangents are O(1) and every gradient sums <= 3 * 48 products more).  The
msdetrpc and point_sample kernels scatter their gradients with atomics, whose
order changes from run to run (the local_attn pair sums in a fixed order), so
on the card the gradients are held to the same 1e-4."""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.losses.lapjv import hungarian_lsap, lapjv
from autofocusformermod_torch.losses.point_sample import point_sample
from autofocusformermod_torch.ops import clusten as tc
from autofocusformermod_torch.ops import local_attn as la
from autofocusformermod_torch.ops import msdetrpc as md
from autofocusformermod_torch.ops import point_sample as ps
from autofocusformermod_torch.ops.dispatch import plain_versions, use_kernel
from autofocusformermod_torch.ops.gather import take_rows, take_scalars
from autofocusformermod_torch.ops.local_attn import (
    sfc_cluster_attention, sfc_cluster_attention_plain)
from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s, msdetrpc_levels_s_plain

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def jnp():
    """jax.numpy for the reference side (absent where only the port is installed)."""
    pytest.importorskip("jax")
    import jax.numpy

    return jax.numpy


def test_take_rows_and_scalars(jnp, rng):
    from autofocusformermod_tpu.ops import gather as jg

    feat = rng.standard_normal((2, 11, 3)).astype(np.float32)
    idx = rng.integers(0, 11, (2, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(take_rows(_t(feat), _t(idx)).numpy(),
                                  np.asarray(jg.take_rows(jnp.asarray(feat), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        take_scalars(_t(feat[..., 0]), _t(idx)).numpy(),
        np.asarray(jg.take_scalars(jnp.asarray(feat[..., 0]), jnp.asarray(idx))))


@pytest.mark.parametrize("op", ["cluster_qk", "cluster_av"])
def test_cluster_qk_av_match_jax(jnp, rng, op):
    from autofocusformermod_tpu.ops import clusten as jc

    b, h, n, c, m = 2, 3, 17, 5, 7
    a = rng.standard_normal((b, h, n, m if op == "cluster_av" else c)).astype(np.float32)
    f = rng.standard_normal((b, h, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, m)).astype(np.int32)
    _close(getattr(tc, op)(_t(a), _t(f), _t(idx)),
           getattr(jc, op)(jnp.asarray(a), jnp.asarray(f), jnp.asarray(idx)))


def test_cluster_wf_and_weighted_gather_match_jax(jnp, rng):
    from autofocusformermod_tpu.ops import clusten as jc

    b, n, n_, m, ic, c = 2, 19, 9, 6, 4, 5
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, n_, m)).astype(np.int32)
    w4 = rng.standard_normal((b, n_, m, ic)).astype(np.float32)
    w = rng.random((b, n_, m)).astype(np.float32)
    _close(tc.cluster_wf(_t(w4), _t(feat), _t(idx)),
           jc.cluster_wf(jnp.asarray(w4), jnp.asarray(feat), jnp.asarray(idx)))
    _close(tc.weighted_gather(_t(idx), _t(w), _t(feat)),
           jc.weighted_gather(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(feat)))


def test_msdetrpc_matches_jax(jnp, rng):
    from autofocusformermod_tpu.ops import clusten as jc

    b, n, m, k, nv, c = 2, 13, 6, 4, 23, 5
    idx = rng.integers(0, nv, (b, n, m, k)).astype(np.int32)
    w = rng.random((b, n, m, k)).astype(np.float32)
    attn = rng.random((b, n, m)).astype(np.float32)
    val = rng.standard_normal((b, nv, c)).astype(np.float32)
    _close(tc.msdetrpc(_t(idx), _t(w), _t(attn), _t(val)),
           jc.msdetrpc(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(attn), jnp.asarray(val)))


def _stacked_case(rng, bh=4, n=10, k=4, sizes=(5, 9, 14), c=6):
    """Per-level (bh, n, k, 4) local indices / weights and attention, as the
    pixel decoder builds them, plus the stacked kernel operands."""
    l = len(sizes)
    idxs = [rng.integers(0, s, (bh, n, k, 4)).astype(np.int32) for s in sizes]
    ws = [rng.random((bh, n, k, 4)).astype(np.float32) for _ in sizes]
    attn = rng.random((bh, n, l, k)).astype(np.float32)
    val = rng.standard_normal((bh, sum(sizes), c)).astype(np.float32)
    idx_s = np.concatenate([i.reshape(bh, n, k * 4) for i in idxs], 2)
    w_s = np.concatenate([(w * attn[:, :, j, :, None]).reshape(bh, n, k * 4)
                          for j, w in enumerate(ws)], 2)
    return idxs, ws, attn, val, idx_s, w_s


def test_msdetrpc_levels_plain_matches_interleaved_jax(jnp, rng):
    """The plain stacked version against ops/clusten.msdetrpc on the
    re-interleaved operands (the JAX pixel decoder's XLA path)."""
    from autofocusformermod_tpu.ops import clusten as jc

    sizes = (5, 9, 14)
    idxs, ws, attn, val, idx_s, w_s = _stacked_case(rng, sizes=sizes)
    bh, n, k, _ = idxs[0].shape
    l = len(sizes)
    offs = np.cumsum([0] + list(sizes))[:-1]
    nn_idx = np.stack([i + o for i, o in zip(idxs, offs)], 3).reshape(bh, n, k * l, 4)
    nn_w = np.stack(ws, 3).reshape(bh, n, k * l, 4)
    attn_i = attn.transpose(0, 1, 3, 2).reshape(bh, n, k * l)
    ref = jc.msdetrpc(jnp.asarray(nn_idx), jnp.asarray(nn_w), jnp.asarray(attn_i),
                      jnp.asarray(val))
    _close(msdetrpc_levels_s_plain(_t(idx_s), _t(w_s), _t(val), sizes), ref)
    # the wrapper takes the plain version for CPU tensors and launches nothing
    before = msdetrpc_levels_s.launches
    _close(msdetrpc_levels_s(_t(idx_s), _t(w_s), _t(val), sizes), ref)
    assert msdetrpc_levels_s.launches == before


def _attn_case(rng, b=2, h=2, n=48, c=4, span=4, nnc=3, pad=0):
    """SFC-ordered local-attention operands: positions on a small grid and
    each token's nnc nearest clusters (distinct ids, as knn returns)."""
    n_tok = n - pad
    pos = rng.permutation(np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1)
                          .reshape(-1, 2))[:n_tok].astype(np.float32)
    pos = np.broadcast_to(pos, (b, n_tok, 2)).copy()
    n_cl = -(-n_tok // span)
    nc = np.stack([np.stack([rng.choice(n_cl, nnc, replace=False) for _ in range(n_tok)])
                   for _ in range(b)]).astype(np.int32)
    q = (rng.standard_normal((b, h, n_tok, c)) * c ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, n_tok, c)).astype(np.float32)
    v = rng.standard_normal((b, h, n_tok, c)).astype(np.float32)
    w5 = (0.1 * rng.standard_normal((h, 5))).astype(np.float32)
    b5 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    bk = rng.standard_normal((h, c)).astype(np.float32)
    return q, k, v, pos, nc, w5, b5, bk


@pytest.mark.parametrize("pad", [0, 3])
def test_local_attention_plain_matches_gather_composition(jnp, rng, pad):
    """Plain version == the JAX gather composition, with and without padded
    slots (n % span != 0: both add the reference's -100)."""
    from autofocusformermod_tpu.ops.pallas.local_attn import gather_composition

    args = _attn_case(rng, pad=pad)
    out, blank = sfc_cluster_attention_plain(*map(_t, args), 4)
    rout, rblank = gather_composition(*map(jnp.asarray, args), 4)
    _close(out, rout)
    _close(blank, rblank)


def test_local_attention_matches_mask_formulation(jnp, rng):
    """Where no slot is padded, the gather path and the kernel's exact
    exclusion (the mask formulation) agree."""
    from autofocusformermod_tpu.ops.pallas.local_attn import sfc_attention_reference

    args = _attn_case(rng)
    before = sfc_cluster_attention.launches
    out, blank = sfc_cluster_attention(*map(_t, args), 4)
    assert sfc_cluster_attention.launches == before
    rout, rblank = sfc_attention_reference(*map(jnp.asarray, args), 4)
    _close(out, rout)
    _close(blank, rblank)


def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert use_kernel(cpu) is False
    with plain_versions():
        assert use_kernel(cpu) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(2, device="meta"))


# ------------------------------------------------------------ gradients
def _vjp_torch(fn, args, diff, cots):
    """Gradients of sum(out_i * cot_i) in the arguments listed in diff."""
    leaves = [a.clone().requires_grad_() if i in diff else a for i, a in enumerate(args)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, [leaves[i] for i in diff])


_ATTN_DIFF = (0, 1, 2, 5, 6, 7)            # q, k, v, w5, b5, blank_k


def _attn_cots(rng, q):
    b, h, n, c = q.shape
    return (rng.standard_normal((b, h, n, c)).astype(np.float32),
            rng.standard_normal((b, h, n, 1)).astype(np.float32))


@pytest.mark.parametrize("pad,ref_fn", [(0, "sfc_attention_reference"),
                                        (0, "gather_composition"), (3, "gather_composition")])
def test_local_attention_plain_backward_matches_jax(jnp, rng, pad, ref_fn):
    """d(q, k, v, w5, b5, blank_k) of the plain version == jax.vjp of the
    JAX definitions (the mask formulation agrees where no slot is padded)."""
    import jax

    from autofocusformermod_tpu.ops.pallas import local_attn as jla

    args = _attn_case(rng, pad=pad)
    g, gb = _attn_cots(rng, args[0])
    ref = getattr(jla, ref_fn)
    jargs = list(map(jnp.asarray, args))

    def f(*diff):
        full = list(jargs)
        for i, d in zip(_ATTN_DIFF, diff):
            full[i] = d
        return ref(*full, 4)

    _, vjp = jax.vjp(f, *[jargs[i] for i in _ATTN_DIFF])
    want = vjp((jnp.asarray(g), jnp.asarray(gb)))
    got = _vjp_torch(lambda *a: sfc_cluster_attention_plain(*a, 4), list(map(_t, args)),
                     _ATTN_DIFF, (_t(g), _t(gb)))
    for gt, w in zip(got, want):
        _close(gt, w, **GRAD_TOL)


def test_msdetrpc_plain_backward_matches_jax(jnp, rng):
    """d(w_s, val) of the plain stacked version == jax.vjp of the JAX
    msdetrpc definition (ops/clusten.msdetrpc) on the interleaved operands."""
    import jax

    from autofocusformermod_tpu.ops import clusten as jc

    sizes = (5, 9, 14)
    idxs, ws, attn, val, idx_s, w_s = _stacked_case(rng, sizes=sizes)
    bh, n, k, _ = idxs[0].shape
    l = len(sizes)
    offs = np.cumsum([0] + list(sizes))[:-1]
    nn_idx = np.stack([i + o for i, o in zip(idxs, offs)], 3).reshape(bh, n, k * l, 4)
    # the combined weight per (point, level, tap), interleaved as nn_idx
    w_i = w_s.reshape(bh, n, l, k, 4).transpose(0, 1, 3, 2, 4).reshape(bh, n, k * l, 4)
    g = rng.standard_normal((bh, n, val.shape[-1])).astype(np.float32)
    ones = jnp.ones((bh, n, k * l))
    _, vjp = jax.vjp(lambda w, v: jc.msdetrpc(jnp.asarray(nn_idx), w, ones, v),
                     jnp.asarray(w_i), jnp.asarray(val))
    dw_i, dval = vjp(jnp.asarray(g))
    dw_s = np.asarray(dw_i).reshape(bh, n, k, l, 4).transpose(0, 1, 3, 2, 4).reshape(bh, n, -1)
    got = _vjp_torch(lambda w, v: msdetrpc_levels_s_plain(_t(idx_s), w, v, sizes),
                     [_t(w_s), _t(val)], (0, 1), (_t(g),))
    _close(got[0], dw_s, **GRAD_TOL)
    _close(got[1], dval, **GRAD_TOL)


def test_point_sample_plain_matches_jax_forward_and_backward(jnp, rng):
    """The plain version against JAX point_sample and its VJP in the masks,
    coordinates reaching every border (zeros padding), and the wrapper on CPU
    tensors runs it without launching."""
    import jax

    from autofocusformermod_tpu.losses.point_sample import point_sample as jps

    masks = rng.standard_normal((3, 7, 9)).astype(np.float32)
    coords = rng.random((3, 50, 2)).astype(np.float32)
    coords[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    g = rng.standard_normal((3, 50)).astype(np.float32)
    out, vjp = jax.vjp(lambda m: jps(m, jnp.asarray(coords)), jnp.asarray(masks))
    _close(point_sample(_t(masks), _t(coords)), out)
    (dm,) = _vjp_torch(lambda m: point_sample(m, _t(coords)), [_t(masks)], (0,), (_t(g),))
    _close(dm, vjp(jnp.asarray(g))[0])
    before = ps.point_sample_bilinear.launches
    _close(ps.point_sample_bilinear(_t(masks), _t(coords)), out)
    assert ps.point_sample_bilinear.launches == before


def test_point_sample_plain_matches_pallas_interpret(jnp, rng):
    """Forward and backward against the TPU kernel itself, run in Pallas
    interpret mode (128x128 masks, 256 points, as its tiling needs)."""
    from autofocusformermod_tpu.ops.pallas.point_sample_kernel import (
        point_sample_pallas_bwd_impl, point_sample_pallas_impl)

    masks = rng.standard_normal((2, 128, 128)).astype(np.float32)
    coords = rng.random((2, 256, 2)).astype(np.float32)
    g = rng.standard_normal((2, 256)).astype(np.float32)
    out = point_sample_pallas_impl(jnp.asarray(masks), jnp.asarray(coords), interpret=True)
    dm = point_sample_pallas_bwd_impl(masks.shape, jnp.asarray(coords), jnp.asarray(g),
                                      interpret=True)
    # the TPU kernel's MXU dots round their inputs to bf16 (~0.4% relative)
    _close(point_sample(_t(masks), _t(coords)), out, rtol=1e-2, atol=2e-2)
    (got,) = _vjp_torch(lambda m: point_sample(m, _t(coords)), [_t(masks)], (0,), (_t(g),))
    _close(got, dm, rtol=1e-2, atol=2e-2)


# ------------------------------------------- the autograd Functions, on CPU
def test_local_attention_function_wiring(monkeypatch, rng):
    """The CUDA path's autograd Function, with its two launchers replaced by
    the package's plain versions of them, has a grad_fn and gives the plain version's
    gradients: the blank-sink terms and the w5/b5/blank_k reductions around
    the kernels are right (regression: the CUDA forward returned tensors
    without a grad_fn, so training cut the gradient silently)."""
    monkeypatch.setattr(la, "local_attn_forward", la.local_attn_forward_plain)
    monkeypatch.setattr(la, "sfc_cluster_attention_backward",
                        la.sfc_cluster_attention_backward_plain)
    args = list(map(_t, _attn_case(rng, n=64, c=5, span=8, nnc=3)))
    g, gb = map(_t, _attn_cots(rng, args[0]))

    def fn(*a):
        out = la._LocalAttention.apply(*a, 8)
        assert out[0].grad_fn is not None and out[1].grad_fn is not None
        return out

    got = _vjp_torch(fn, args, _ATTN_DIFF, (g, gb))
    want = _vjp_torch(lambda *a: sfc_cluster_attention_plain(*a, 8), args, _ATTN_DIFF, (g, gb))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_msdetrpc_and_point_sample_function_wiring(monkeypatch, rng):
    """The msdetrpc and point_sample autograd Functions, their launchers
    replaced by the plain versions and their autograd gradients, give the
    plain versions' gradients (and none to the indices or coordinates)."""
    sizes = (5, 9, 14)
    _, _, _, val, idx_s, w_s = _stacked_case(rng, sizes=sizes)

    def md_bwd(idx, w, v, g, level_sizes):
        with torch.enable_grad():
            w, v = w.clone().requires_grad_(), v.clone().requires_grad_()
            out = msdetrpc_levels_s_plain(idx, w, v, level_sizes)
            return tuple(reversed(torch.autograd.grad((out * g).sum(), [w, v])))

    monkeypatch.setattr(md, "msdetrpc_forward", msdetrpc_levels_s_plain)
    monkeypatch.setattr(md, "msdetrpc_levels_s_backward", md_bwd)
    cot = (_t(rng.standard_normal((idx_s.shape[0], idx_s.shape[1], val.shape[-1]))
              .astype(np.float32)),)
    args = [_t(idx_s), _t(w_s), _t(val)]
    got = _vjp_torch(lambda i, w, v: md._Msdetrpc.apply(i, w, v, sizes), args, (1, 2), cot)
    want = _vjp_torch(lambda i, w, v: msdetrpc_levels_s_plain(i, w, v, sizes), args, (1, 2), cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)

    def ps_bwd(coords, g, shape):
        with torch.enable_grad():
            m = torch.zeros(shape, requires_grad=True)
            return torch.autograd.grad((point_sample(m, coords) * g).sum(), m)[0]

    monkeypatch.setattr(ps, "point_sample_forward", point_sample)
    monkeypatch.setattr(ps, "point_sample_backward", ps_bwd)
    masks = _t(rng.standard_normal((3, 7, 9)).astype(np.float32)).requires_grad_()
    coords = _t(rng.random((3, 20, 2)).astype(np.float32)).requires_grad_()
    g = _t(rng.standard_normal((3, 20)).astype(np.float32))
    dm, dc = torch.autograd.grad((ps._PointSample.apply(masks, coords) * g).sum(),
                                 [masks, coords], allow_unused=True)
    assert dc is None
    (want,) = torch.autograd.grad((point_sample(masks, coords.detach()) * g).sum(), masks)
    torch.testing.assert_close(dm, want, **GRAD_TOL)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_local_attn_kernel_matches_plain_on_card(rng, cuda):
    args = [_t(a).to(cuda) for a in _attn_case(rng, n=64, c=16, span=8, nnc=6)]
    out, blank = sfc_cluster_attention(*args, 8)
    with plain_versions():
        rout, rblank = sfc_cluster_attention(*args, 8)
    torch.testing.assert_close(out, rout, **TOL)
    torch.testing.assert_close(blank, rblank, **TOL)


@pytest.mark.cuda
def test_msdetrpc_kernel_matches_plain_on_card(rng, cuda):
    sizes = (5, 9, 14)
    _, _, _, val, idx_s, w_s = _stacked_case(rng, sizes=sizes)
    args = [_t(a).to(cuda) for a in (idx_s, w_s, val)]
    out = msdetrpc_levels_s(*args, sizes)
    with plain_versions():
        ref = msdetrpc_levels_s(*args, sizes)
    torch.testing.assert_close(out, ref, **TOL)


def _attn_grads_on_card(args, span, g, gb):
    return _vjp_torch(lambda *a: sfc_cluster_attention(*a, span), args, _ATTN_DIFF, (g, gb))


@pytest.mark.cuda
def test_local_attn_backward_kernel_matches_plain_on_card(rng, cuda):
    """Forward has a grad_fn on CUDA, and the backward kernel's gradients
    equal the plain version's autograd (n % span == 0: no padded slots)."""
    args = [_t(a).to(cuda) for a in _attn_case(rng, n=64, c=16, span=8, nnc=6)]
    g, gb = (_t(a).to(cuda) for a in _attn_cots(rng, args[0]))
    q = args[0].clone().requires_grad_()
    out, blank = sfc_cluster_attention(q, *args[1:], 8)
    assert out.grad_fn is not None and blank.grad_fn is not None
    before = la.sfc_cluster_attention_backward.launches
    got = _attn_grads_on_card(args, 8, g, gb)
    assert la.sfc_cluster_attention_backward.launches == before + 1
    with plain_versions():
        want = _attn_grads_on_card(args, 8, g, gb)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.cuda
def test_msdetrpc_backward_kernel_matches_plain_on_card(rng, cuda):
    sizes = (5, 9, 14)
    _, _, _, val, idx_s, w_s = _stacked_case(rng, sizes=sizes)
    args = [_t(a).to(cuda) for a in (idx_s, w_s, val)]
    cot = (torch.randn(idx_s.shape[0], idx_s.shape[1], val.shape[-1], device=cuda),)

    def grads():
        return _vjp_torch(lambda i, w, v: msdetrpc_levels_s(i, w, v, sizes), args, (1, 2), cot)

    before = md.msdetrpc_levels_s_backward.launches
    got = grads()
    assert md.msdetrpc_levels_s_backward.launches == before + 1
    with plain_versions():
        want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 24, 32, 5])
def test_local_attn_forward_kernel_routes_on_card(rng, cuda, c):
    """K1 on each route of its launcher (16-byte row reads at c_ 16, 24 and
    32, 4-byte at 5), n = 61 so the last cluster is cut: out, blank_prob and
    the lse the backward reads against the plain versions."""
    args = [_t(a).to(cuda) for a in _attn_case(rng, n=64, c=c, span=8, nnc=6, pad=3)]
    got = la.local_attn_forward(*args, 8)
    with plain_versions():
        want = la.local_attn_forward_plain(*args, 8)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def _morton(x, y, bits):
    """Morton code of integer grid positions (numpy)."""
    code = np.zeros_like(x)
    for i in range(bits):
        code |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1)
    return code


def _local_stacked_case(rng, bh=4, side=32, sizes_side=(8, 16, 32), p=16, c=32):
    """Stacked operands as the pixel decoder's path makes them: queries and
    every level's rows in Morton order on their grids, each query sampling p
    cells near its own position at each level."""
    ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    order = np.argsort(_morton(xs.ravel(), ys.ravel(), 5))
    qx, qy = xs.ravel()[order], ys.ravel()[order]              # queries in curve order
    idx = []
    for ls in sizes_side:
        f = ls / side
        sx = np.clip(np.round(qx[None, :, None] * f + rng.normal(0, 1.5, (bh, side * side, p))),
                     0, ls - 1).astype(np.int64)
        sy = np.clip(np.round(qy[None, :, None] * f + rng.normal(0, 1.5, (bh, side * side, p))),
                     0, ls - 1).astype(np.int64)
        idx.append(_morton(sx, sy, int(np.log2(ls))))
    idx_s = np.concatenate(idx, 2).astype(np.int32)
    w_s = rng.random(idx_s.shape).astype(np.float32)
    val = rng.standard_normal((bh, sum(s * s for s in sizes_side), c)).astype(np.float32)
    return idx_s, w_s, val, tuple(s * s for s in sizes_side)


@pytest.mark.cuda
@pytest.mark.parametrize("indices", ["morton_local", "uniform"])
def test_msdetrpc_backward_kernel_is_exact_and_deterministic_on_card(rng, cuda, indices):
    """K4 over many query tiles and value-row bands: on curve-local indices
    (the path's kind: a tile's rows at a level are few and close) and on
    uniform ones (every tile meets every band), against the plain version's
    autograd, and two calls bit for bit (the sums have a fixed order)."""
    idx_s, w_s, val, sizes = _local_stacked_case(rng)
    if indices == "uniform":
        idx_s = np.concatenate([rng.integers(0, s, (idx_s.shape[0], idx_s.shape[1], 16))
                                for s in sizes], 2).astype(np.int32)
    args = [_t(a).to(cuda) for a in (idx_s, w_s, val)]
    cot = (torch.randn(idx_s.shape[0], idx_s.shape[1], val.shape[-1], device=cuda),)
    got = _vjp_torch(lambda i, w, v: msdetrpc_levels_s(i, w, v, sizes), args, (1, 2), cot)
    with plain_versions():
        want = _vjp_torch(lambda i, w, v: msdetrpc_levels_s(i, w, v, sizes), args, (1, 2), cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    first = md.msdetrpc_levels_s_backward(*args, cot[0], sizes)
    again = md.msdetrpc_levels_s_backward(*args, cot[0], sizes)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    # indices outside their level are clamped into it (the plain version
    # indexes without clamping, so it is not asked)
    wild = args[0].clone()
    wild[0, 0, :3] = torch.tensor([-5, 10 ** 6, sizes[0]], dtype=torch.int32)
    clamped = wild.clone()
    clamped[0, 0, :3] = torch.tensor([0, sizes[0] - 1, sizes[0] - 1], dtype=torch.int32)
    for a, b in zip(md.msdetrpc_levels_s_backward(wild, *args[1:], cot[0], sizes),
                    md.msdetrpc_levels_s_backward(clamped, *args[1:], cot[0], sizes)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_point_sample_kernel_matches_plain_on_card(rng, cuda):
    masks = _t(rng.standard_normal((4, 32, 48)).astype(np.float32)).to(cuda)
    coords = _t(rng.random((4, 300, 2)).astype(np.float32)).to(cuda)
    coords[:, :4] = torch.tensor([[0, 0], [1, 1], [0, 1], [1, 0]], device=cuda)
    cot = (torch.randn(4, 300, device=cuda),)

    def run():
        return _vjp_torch(lambda m: ps.point_sample_bilinear(m, coords), [masks], (0,), cot)[0]

    out = ps.point_sample_bilinear(masks, coords)
    torch.testing.assert_close(out, point_sample(masks, coords), **TOL)
    torch.testing.assert_close(run(), _vjp_torch(lambda m: point_sample(m, coords), [masks],
                                                 (0,), cot)[0], **GRAD_TOL)


@pytest.mark.cuda
def test_lapjv_kernel_matches_plain_on_card(rng, cuda):
    """The same float operations in the same order: identical assignments,
    sentinel ties included."""
    cost = rng.standard_normal((6, 100, 100)).astype(np.float32) * 3
    cost[:, :, 60:] = 1e8
    cost = _t(cost).to(cuda)
    got = lapjv(cost)
    torch.testing.assert_close(got, hungarian_lsap(cost), rtol=0, atol=0)
