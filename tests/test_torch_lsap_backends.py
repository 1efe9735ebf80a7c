"""The PyTorch port's assignment backends and the downsampled criterion
against scipy and the JAX package.

``auction_lsap`` (``losses/auction.py``) is held on ``tests/test_auction.py``'s
cases: its assignment a permutation, its cost within 0.05 per target of
scipy's optimum (0.5 on the 20 x 20 square case), as that file holds JAX's;
and against JAX's ``auction_lsap`` on the same costs: the same assignment
(both run the same float32 steps; a tie broken apart by the last bit would
show as a different assignment of equal cost, which the test allows).
``set_matcher_backend`` routes ``solve_lsap`` to scipy, the default solver
or the auction; ``matching_cost_downsample``, ``max_pool_to`` and
``set_criterion_downsample`` are held to JAX's on the same inputs: costs
rtol 1e-5, loss terms rtol 1e-5 (fp32 sums of a few thousand terms), every
layer matched.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from autofocusformermod_torch.losses import matcher
from autofocusformermod_torch.losses.auction import auction_lsap
from autofocusformermod_torch.losses.criterion import set_criterion_downsample
from autofocusformermod_torch.losses.matcher import (matching_cost_downsample, max_pool_to,
                                                     set_matcher_backend, solve_lsap)

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)


@pytest.fixture()
def backend():
    """Restores the default solver after the test."""
    yield set_matcher_backend
    set_matcher_backend(None)


def _cost_of(cost, assigned):
    return cost[assigned, np.arange(cost.shape[1])].sum()


def _optimum(cost):
    rows, cols = linear_sum_assignment(np.float64(cost))
    return cost[rows, cols].sum()


@pytest.mark.parametrize("case", ["rect", "square", "invalid"])
def test_auction_matches_scipy_and_jax(case):
    """tests/test_auction.py's three cases: 50 x 30 costs N(0, 25) over
    five trials, a 20 x 20 square of U(0, 10), and 20 x 10 with the last
    four columns at the matcher's 1e8 sentinel."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses.auction import auction_lsap as jauction

    if case == "rect":
        rng = np.random.default_rng(0)
        costs = [rng.standard_normal((2, 50, 30)).astype(np.float32) * 5 for _ in range(5)]
    elif case == "square":
        costs = [np.random.default_rng(1).uniform(0, 10, (1, 20, 20)).astype(np.float32)]
    else:
        cost = np.random.default_rng(2).standard_normal((1, 20, 10)).astype(np.float32)
        cost[:, :, 6:] = 1e8
        costs = [cost]
    for cost in costs:
        got = auction_lsap(torch.from_numpy(cost)).numpy()
        want = np.asarray(jauction(jnp.asarray(cost)))
        assert got.dtype == np.int64 and got.shape == want.shape
        for b in range(cost.shape[0]):
            t = cost.shape[2]
            assert len(set(got[b].tolist())) == t
            if case == "invalid":
                opt = _optimum(cost[b][:, :6])
                assert _cost_of(cost[b][:, :6], got[b][:6]) <= opt + 0.05 * t
            else:
                slack = 0.5 if case == "square" else 0.05 * t
                assert _cost_of(cost[b], got[b]) <= _optimum(cost[b]) + slack
            if not np.array_equal(got[b], want[b]):
                np.testing.assert_allclose(_cost_of(cost[b], got[b]),
                                           _cost_of(cost[b], want[b]), rtol=1e-6)


def test_auction_repairs_an_unfinished_phase():
    """With one round a phase the auction stops with persons unassigned;
    the repair gives each a distinct free query, as JAX's does."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses.auction import auction_lsap as jauction

    cost = np.random.default_rng(3).standard_normal((3, 12, 9)).astype(np.float32)
    got = auction_lsap(torch.from_numpy(cost), max_iters=1).numpy()
    want = np.asarray(jauction(jnp.asarray(cost), max_iters=1))
    np.testing.assert_array_equal(got, want)
    assert all(len(set(row.tolist())) == 9 for row in got)
    with pytest.raises(ValueError, match="more targets"):
        auction_lsap(torch.zeros(1, 3, 4))


@pytest.mark.parametrize("name", ["scipy", "jv", "auction"])
def test_set_matcher_backend_routes_solve_lsap(backend, name):
    """Each backend solves matcher-shaped costs (100 queries, 20 slots, the
    last 5 at the sentinel, a NaN and an inf among them) to the optimum of
    the valid slots (the auction within 0.05 per slot), counted under its
    name; an unknown name raises; None is the default again."""
    rng = np.random.default_rng(4)
    cost = rng.standard_normal((4, 100, 20)).astype(np.float32) * 5
    cost[:, :, 15:] = matcher._INVALID_COST
    before = dict(solve_lsap.solves_by_backend)
    backend(name)
    assert matcher._MATCHER_BACKEND == name
    got = solve_lsap(torch.from_numpy(cost)).numpy()
    assert {k: n - before[k] for k, n in solve_lsap.solves_by_backend.items()} == {
        k: int(k == name) for k in before}
    for b in range(4):
        assert len(set(got[b].tolist())) == 20
        opt = _optimum(cost[b][:, :15])
        slack = 0.05 * 20 if name == "auction" else 1e-3
        assert _cost_of(cost[b][:, :15], got[b][:15]) <= opt + slack
    with pytest.raises(ValueError, match="unknown matcher backend"):
        backend("lapjv")
    backend(None)
    assert matcher._MATCHER_BACKEND is None
    odd = cost[:1].copy()
    odd[0, 0, 0], odd[0, 1, 1] = np.nan, np.inf
    backend("scipy")
    host = solve_lsap(torch.from_numpy(odd)).numpy()
    from autofocusformermod_tpu.losses.matcher import _lsap_host

    np.testing.assert_array_equal(host, _lsap_host(odd))


def _downsample_inputs(seed=0, b=2, q=12, t=5, nc=6):
    rng = np.random.default_rng(seed)
    outputs = {"pred_logits": rng.standard_normal((b, q, nc + 1)).astype(np.float32),
               "pred_masks": rng.standard_normal((b, q, 8, 8)).astype(np.float32),
               "aux_outputs": [{"pred_logits": rng.standard_normal((b, q, nc + 1)).astype(
                   np.float32), "pred_masks": rng.standard_normal((b, q, s, s)).astype(
                   np.float32)} for s in (4, 8, 16)]}
    targets = {"labels": rng.integers(0, nc, (b, t)).astype(np.int64),
               "masks": (rng.uniform(size=(b, t, 32, 32)) > 0.7).astype(np.float32),
               "valid": np.arange(t)[None, :] < np.array([[3], [5]])}
    return outputs, targets, nc


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


def test_max_pool_and_downsample_cost_match_jax():
    """max_pool_to (a 2x2 and a 4x8 window, and none) and the downsampled
    matcher cost of each layer against JAX's."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses import matcher as jmatcher

    outputs, targets, _ = _downsample_inputs()
    masks = targets["masks"]
    for hw in ((16, 16), (8, 4), (32, 32)):
        np.testing.assert_array_equal(max_pool_to(torch.from_numpy(masks), hw).numpy(),
                                      np.asarray(jmatcher.max_pool_to(jnp.asarray(masks), hw)))
    for out in [outputs] + outputs["aux_outputs"]:
        args = (out["pred_logits"], out["pred_masks"], targets["labels"], masks, targets["valid"])
        got = matching_cost_downsample(*(torch.from_numpy(a) for a in args), 2.0, 5.0, 5.0)
        want = jmatcher.matching_cost_downsample(*(jnp.asarray(a) for a in args), 2.0, 5.0, 5.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", [None, "auction"])
def test_set_criterion_downsample_matches_jax(backend, name):
    """Every loss term, the total and each layer's matches against JAX's
    set_criterion_downsample (the default solver against JAX's "jv", the
    auction against JAX's auction); the gradients reach every output."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses import criterion as jcriterion
    from autofocusformermod_tpu.losses import matcher as jmatcher

    outputs, targets, nc = _downsample_inputs(seed=1)
    jmatcher.set_matcher_backend(name or "jv")
    try:
        jtotal, jlosses = jcriterion.set_criterion_downsample(
            jax.random.PRNGKey(0), _tree(outputs, jnp.asarray), _tree(targets, jnp.asarray), nc)
    finally:
        jmatcher.set_matcher_backend(None)
    backend(name)
    touts = _tree(outputs, lambda a: torch.from_numpy(a).requires_grad_())
    total, losses, matched = set_criterion_downsample(touts, _tree(targets, torch.from_numpy), nc)
    assert set(losses) == set(jlosses) and len(losses) == 12
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    total.backward()
    assert all(o["pred_masks"].grad.abs().max() > 0
               for o in [touts] + touts["aux_outputs"])
    assert len(matched) == 4 and all(tuple(m.shape) == (2, 5) for m in matched)
