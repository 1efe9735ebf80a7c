"""The local_attn backward of the PyTorch port as a query-side and a
key-side pass: the reverse lists (which (query, slot group) pairs refer to
each key cluster), the plain version of the kernel pair, its wiring through
the backbone, and the channel-major table lookup's route rule.  On a card,
the kernels themselves.

Inputs come from numpy with a seed; both sides run fp32.  The plain backward
against PyTorch's autograd of the plain forward: rtol 1e-5, atol 1e-6 for the
per-token gradients dq, dk, dv (the same products summed in another order,
some 50 terms each), and rtol 1e-4, atol 1e-5 for dw5, db5 and dblank_k,
which sum several thousand terms of either sign over the whole batch (the
rel-pos features reach 24 here), in another order on each side.  Against the JAX package: rtol = atol = 1e-4, as the other gradient
tests (cotangents are O(1))."""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.models import aff
from autofocusformermod_torch.ops import local_attn as la
from autofocusformermod_torch.ops import window_gather as wg
from autofocusformermod_torch.ops.dispatch import plain_versions

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
DIFF = (0, 1, 2, 5, 6, 7)                      # q, k, v, w5, b5, blank_k


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _nc(rng, kind, b, n, span, nnc):
    """Neighbour cluster ids (b, n, nnc): "local" = each token's own cluster
    and the ones after it (distinct, in range); "random" = no locality,
    duplicates, ids past the last cluster; "wild" = also negative ids."""
    n_cl = -(-n // span)
    if kind == "local":
        own = np.arange(n)[None, :, None] // span
        return np.broadcast_to((own + np.arange(nnc)) % n_cl, (b, n, nnc)).astype(np.int32)
    lo = -3 if kind == "wild" else 0
    nc = rng.integers(lo, n_cl + 3, (b, n, nnc)).astype(np.int32)
    nc[:, ::5, 1] = nc[:, ::5, 0]              # a query that lists a cluster twice
    return nc


def _case(rng, kind="local", b=2, h=3, n=64, c=5, span=8, nnc=3):
    pos = rng.integers(0, 24, (b, n, 2)).astype(np.float32)
    pos[:, 1] = pos[:, 0]                      # a zero offset: all-zero features
    q = (rng.standard_normal((b, h, n, c)) * c ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, n, c)).astype(np.float32)
    v = rng.standard_normal((b, h, n, c)).astype(np.float32)
    w5 = (0.1 * rng.standard_normal((h, 5))).astype(np.float32)
    b5 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    bk = rng.standard_normal((h, c)).astype(np.float32)
    return [q, k, v, pos, _nc(rng, kind, b, n, span, nnc), w5, b5, bk]


def _cots(rng, q):
    b, h, n, c = q.shape
    return (_t(rng.standard_normal((b, h, n, c)).astype(np.float32)),
            _t(rng.standard_normal((b, h, n, 1)).astype(np.float32)))


def _grads(fn, args, cots):
    leaves = [a.clone().requires_grad_() if i in DIFF else a for i, a in enumerate(args)]
    outs = fn(*leaves)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, [leaves[i] for i in DIFF])


# ------------------------------------------------------------ reverse lists
@pytest.mark.parametrize("kind,n,span,nnc", [("local", 64, 8, 3), ("wild", 64, 8, 4),
                                              ("wild", 61, 8, 3), ("random", 37, 4, 5)])
def test_reverse_lists_hold_every_valid_reference_once(rng, kind, n, span, nnc):
    """Every (query, slot group) whose cluster id names a cluster with at
    least one token appears exactly once, under its cluster, and a cluster's
    references ascend (query, then slot group): n a multiple of the cluster
    size or not, ids local or random with duplicates and out-of-range ones."""
    nc = _nc(rng, kind, 2, n, span, nnc)
    rev = la.build_reverse_lists(_t(nc), n, span)
    n_cl = -(-n // span)
    assert rev.offsets.dtype == rev.refs.dtype == torch.int32
    assert tuple(rev.offsets.shape) == (2, n_cl + 1) and tuple(rev.refs.shape) == (2, n * nnc)
    for bi in range(2):
        off, refs = rev.offsets[bi].numpy(), rev.refs[bi].numpy()
        flat = nc[bi].reshape(-1)
        assert off[0] == 0 and (np.diff(off) >= 0).all()
        seen = []
        for cl in range(n_cl):
            mine = refs[off[cl]:off[cl + 1]]
            assert (flat[mine] == cl).all()
            assert (np.diff(mine) > 0).all()                  # ascending, none twice
            seen.append(mine)
        valid = np.flatnonzero((flat >= 0) & (flat * span < n))
        np.testing.assert_array_equal(np.sort(np.concatenate(seen)), valid)
        assert off[-1] == len(valid)
        # the whole of refs is a permutation: the left-out ones lie behind
        np.testing.assert_array_equal(np.sort(refs), np.arange(n * nnc))
    if kind == "local":
        assert (np.diff(rev.offsets[0].numpy()) == span * nnc).all()


def test_reverse_lists_give_a_doubly_listed_cluster_two_references(rng):
    nc = np.array([[[1, 1], [0, 2], [2, 2]]], dtype=np.int32)       # n = 3, span 1
    rev = la.build_reverse_lists(_t(nc), 3, 1)
    assert rev.offsets[0].tolist() == [0, 1, 3, 6]
    assert rev.refs[0].tolist() == [2, 0, 1, 3, 4, 5]


# -------------------------------------------------- the plain backward pair
@pytest.mark.parametrize("kind,n,span", [("local", 64, 8), ("local", 61, 8), ("random", 61, 8),
                                          ("random", 37, 4)])
def test_backward_plain_matches_autograd_of_plain_forward(rng, kind, n, span):
    """dq (with the blank term added as the Function adds it), dk, dv and the
    drow reductions of the plain backward pair == autograd through the plain
    forward; the wrapper on CPU tensors runs it without launching."""
    args = list(map(_t, _case(rng, kind, n=n, span=span)))
    q, k, v, pos, nc, w5, b5, bk = args
    g, gb = _cots(rng, q)
    want = _grads(lambda *a: la.sfc_cluster_attention_plain(*a, span), args, (g, gb))

    out, blank, lse = la.local_attn_forward_plain(*args, span)
    delta = (g * out).sum(-1, keepdim=True) + gb * blank
    dsb = blank * (gb - delta)
    before = la.sfc_cluster_attention_backward.launches
    dq, dk, dv, drow = la.sfc_cluster_attention_backward(q, k, v, pos, nc, w5, b5, g, lse, delta,
                                                         span)
    assert la.sfc_cluster_attention_backward.launches == before
    got = (dq + dsb * bk[None, :, None, :], dk, dv, drow[..., :5].sum((0, 2)),
           drow[..., 5].sum((0, 2)), torch.einsum("bhn,bhnc->hc", dsb[..., 0], q))
    for a, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
    for a, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    assert (drow[..., 6:] == 0).all()


def test_backward_plain_takes_given_reverse_lists(rng):
    """The lists the caller passes are the ones used: lists of another nc
    change dk and dv, and leave dq and drow (the query side) alone."""
    args = list(map(_t, _case(rng)))
    q, k, v, pos, nc, w5, b5, bk = args
    g, gb = _cots(rng, q)
    out, blank, lse = la.local_attn_forward_plain(*args, 8)
    delta = (g * out).sum(-1, keepdim=True) + gb * blank
    ops = (q, k, v, pos, nc, w5, b5, g, lse, delta, 8)
    base = la.sfc_cluster_attention_backward_plain(*ops)
    same = la.sfc_cluster_attention_backward_plain(*ops, la.build_reverse_lists(nc, 64, 8))
    other = la.sfc_cluster_attention_backward_plain(
        *ops, la.build_reverse_lists(torch.roll(nc, 8, 1), 64, 8))
    for a, s_ in zip(base, same):
        assert torch.equal(a, s_)
    assert torch.equal(base[0], other[0]) and torch.equal(base[3], other[3])
    assert not torch.allclose(base[1], other[1]) and not torch.allclose(base[2], other[2])


def test_backward_plain_matches_jax(monkeypatch, rng):
    """The autograd Function over the plain kernel pair == jax.vjp of the JAX
    package's mask formulation (distinct cluster ids: it counts a cluster a
    query lists twice once)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_tpu.ops.pallas.local_attn import sfc_attention_reference

    monkeypatch.setattr(la, "local_attn_forward", la.local_attn_forward_plain)
    monkeypatch.setattr(la, "sfc_cluster_attention_backward",
                        la.sfc_cluster_attention_backward_plain)
    args = _case(rng, "local", n=64, span=4, nnc=4)
    targs = list(map(_t, args))
    g, gb = _cots(rng, targs[0])
    got = _grads(lambda *a: la._LocalAttention.apply(*a, 4), targs, (g, gb))

    jargs = list(map(jnp.asarray, args))

    def f(*diff):
        full = list(jargs)
        for i, d in zip(DIFF, diff):
            full[i] = d
        return sfc_attention_reference(*full, 4)

    _, vjp = jax.vjp(f, *[jargs[i] for i in DIFF])
    want = vjp((jnp.asarray(g.numpy()), jnp.asarray(gb.numpy())))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)


# ------------------------------------------------------------------- wiring
def test_basic_layer_passes_one_reverse_object_to_all_blocks(monkeypatch, rng):
    """With the kernel route on (stand-ins for the launchers), a stage builds
    the reverse lists once and every block's backward gets that object; the
    gradients equal the plain route's.  Without gradients it builds none."""
    layer = aff.BasicLayer(dim=12, out_dim=None, cluster_size=8, nbhd_size=24, depth=3,
                           num_heads=2, mlp_ratio=2.0, has_downsample=False)
    gen = torch.Generator().manual_seed(0)
    for p in layer.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.2
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    pos = _t(np.stack([xs, ys], -1).reshape(1, 64, 2).astype(np.float32)).expand(2, 64, 2)
    feat = _t(rng.standard_normal((2, 64, 12)).astype(np.float32))

    def grads():
        layer.zero_grad()
        x = feat.clone().requires_grad_()
        layer(pos, x, 8, 8, stride=2)[1].square().sum().backward()
        return [x.grad] + [p.grad.clone() for p in layer.parameters()]

    want = grads()

    seen, built = [], []

    def backward(*a):
        seen.append(a[-1])
        return la.sfc_cluster_attention_backward_plain(*a)

    def build(*a):
        built.append(la.build_reverse_lists(*a))
        return built[-1]

    monkeypatch.setattr(la, "use_kernel", lambda *t: True)
    monkeypatch.setattr(aff, "use_kernel", lambda *t: True)
    monkeypatch.setattr(aff, "build_reverse_lists", build)
    monkeypatch.setattr(la, "local_attn_forward", la.local_attn_forward_plain)
    monkeypatch.setattr(la, "sfc_cluster_attention_backward", backward)
    got = grads()
    assert len(built) == 1 and len(seen) == 3
    assert all(r is built[0] for r in seen)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)
    with torch.no_grad():
        layer(pos, feat, 8, 8, stride=2)
    assert len(built) == 1


def test_function_builds_the_lists_when_given_none(monkeypatch, rng):
    """sfc_cluster_attention without reverse= hands the backward None, and
    the backward builds the lists itself."""
    seen = []

    def backward(*a):
        seen.append(a[-1])
        return la.sfc_cluster_attention_backward_plain(*a)

    monkeypatch.setattr(la, "use_kernel", lambda *t: True)
    monkeypatch.setattr(la, "local_attn_forward", la.local_attn_forward_plain)
    monkeypatch.setattr(la, "sfc_cluster_attention_backward", backward)
    args = list(map(_t, _case(rng)))
    g, gb = _cots(rng, args[0])
    got = _grads(lambda *a: la.sfc_cluster_attention(*a, 8), args, (g, gb))
    assert seen == [None]
    monkeypatch.undo()
    want = _grads(lambda *a: la.sfc_cluster_attention(*a, 8), args, (g, gb))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)


# ------------------------------------------------- the table lookup's route
@pytest.mark.parametrize("n,s,route", [
    (128 * 128, 8 * 4 * 4096, "shared"),       # the pixel decoder's call
    (57344, 57344, "shared"),                  # the largest slice that fits
    (57345, 1 << 20, "direct"),                # one row more does not
    (1024 * 1024, 1 << 21, "direct"),          # a 1024 x 1024 grid of cells
    (4096, 4095, "direct"),                    # fewer samples than rows
    (1, 1, "shared")])
def test_window_gather_route_is_a_function_of_the_shapes(n, s, route):
    assert wg.window_gather_route(n, s) == route
    before = dict(wg.windowed_row_gather.launches_by_route)
    table = torch.arange(2 * 3 * 7, dtype=torch.float32).reshape(2, 3, 7)
    idx = torch.tensor([[0, 6, 3, 3], [5, 5, 0, 1]], dtype=torch.int32)
    out = wg.windowed_row_gather(table, idx)             # CPU tensors: no launch, no route
    assert wg.windowed_row_gather.launches_by_route == before
    assert out[1, 2].tolist() == [7 * 5 + 5.0, 7 * 5 + 5.0, 7 * 5 + 0.0, 7 * 5 + 1.0]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _backward_operands(rng, dev, **kw):
    args = [_t(a).to(dev) for a in _case(rng, **kw)]
    q, k, v, pos, nc, w5, b5, bk = args
    g, gb = (t.to(dev) for t in _cots(rng, q))
    span = kw.get("span", 8)
    out, blank, lse = la.local_attn_forward(*args, span)
    delta = ((g * out).sum(-1, keepdim=True) + gb * blank).contiguous()
    return (q, k, v, pos, nc, w5, b5, g, lse, delta, span), args, (g, gb)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,c,span,nnc", [
    ("local", 64, 16, 8, 6), ("local", 200, 32, 8, 6), ("local", 64, 24, 8, 3),
    ("random", 197, 32, 8, 6), ("random", 61, 5, 8, 3), ("random", 37, 7, 4, 5),
    ("local", 96, 64, 8, 4), ("random", 90, 8, 24, 2), ("local", 300, 32, 24, 6)])
def test_backward_kernel_pair_matches_plain_pair_on_card(rng, cuda, kind, n, c, span, nnc):
    """Both kernels against the plain pair on the same operands (channel
    counts that take 16-byte and 4-byte reads, half warps, cluster sizes
    other than 8, a random nc with duplicates and ids past the end, n not a
    multiple of the cluster size, AFF-Base's 144-slot neighbourhood of 6
    clusters of 24), and two calls give the same bits."""
    ops, _, _ = _backward_operands(rng, cuda, kind=kind, n=n, c=c, span=span, nnc=nnc)
    before = la.sfc_cluster_attention_backward.launches
    got = la.sfc_cluster_attention_backward(*ops)
    again = la.sfc_cluster_attention_backward(*ops, la.build_reverse_lists(ops[4], n, span))
    assert la.sfc_cluster_attention_backward.launches == before + 2
    want = la.sfc_cluster_attention_backward_plain(*ops)
    for a, b_, w in zip(got, again, want):
        assert torch.equal(a, b_)
        torch.testing.assert_close(a, w, **GRAD_TOL)


@pytest.mark.cuda
def test_gradients_with_random_nc_match_plain_autograd_on_card(rng, cuda):
    """End to end through the Function, on a random nc with n not a multiple
    of the cluster size, against autograd of the plain version."""
    _, args, cots = _backward_operands(rng, cuda, kind="random", n=197, c=16, nnc=6)
    got = _grads(lambda *a: la.sfc_cluster_attention(*a, 8), args, cots)
    with plain_versions():
        want = _grads(lambda *a: la.sfc_cluster_attention(*a, 8), args, cots)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,route", [(4096, 8192, "shared"), (4099, 8191, "shared"),
                                        (57344, 60000, "shared"), (60000, 70000, "direct"),
                                        (4096, 1000, "direct")])
def test_window_gather_routes_are_exact_on_card(rng, cuda, n, s, route):
    table = _t(rng.standard_normal((3, 12, n)).astype(np.float32)).to(cuda)
    idx = _t(rng.integers(0, n, (3, s)).astype(np.int32)).to(cuda)
    before = wg.windowed_row_gather.launches_by_route[route]
    out = wg.windowed_row_gather(table, idx)
    assert wg.windowed_row_gather.launches_by_route[route] == before + 1
    assert torch.equal(out, wg.windowed_row_gather_plain(table, idx))
