"""The PyTorch port's data-parallel training step against the JAX package's
one program over the global batch: gloo ranks on the CPU, each holding its
rows of the batch (``tests/torch_dist_workers.py``).

  - FlaxBatchNorm2d at two ranks against flax ``BatchNorm`` on the whole
    batch: output, input gradient, running statistics (rtol 1e-5, atol
    1e-6, as ``tests/test_syncbn.py``);
  - one step of the tiny AFF MaskFormer of ``test_torch_train.py`` at two
    ranks (one image each) against ``make_train_step``'s recipe on the
    global batch of two, JAX's draws replayed (the global batch's; each rank
    keeps its rows): loss terms, every gradient, the BatchNorm statistics
    and the AdamW update, to that file's tolerances;
  - the same model at two ranks against the port's one-process step, the
    default criterion (the nearest-tap ranking's global counters), three
    steps from seeded generators;
  - the tiny OracleTeacher-BB cascade of ``test_torch_updown.py`` (the
    teacher's draws, the upsampling loss, parameters without a gradient)
    two steps at two ranks against one process, and one AMP step.

The JAX references are computed in this process; the ranks import no JAX.
Each ``run_ranks`` call has its own join timeout.
"""

import numpy as np
import pytest
import torch

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
import torch_dist_workers as W
from autofocusformermod_torch.config import CfgNode
from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

# the two-rank runs against one process: the same function of the same
# inputs, summed in another order (the BatchNorm statistics and the
# criterion's normalisers over two ranks, the gradients averaged by DDP)
SAME_LOSS = dict(rtol=1e-5, atol=1e-6)
# gradients: relative to each parameter's largest entry, plus 1e-5 (the stem
# conv's bias, whose true gradient is zero under train-mode BatchNorm, carries
# ~1e-6 of fp32 noise, as in test_torch_train.py)
SAME_GRAD = 1e-5
GRAD_NOISE = 1e-5
# each parameter's update over the steps, relative to the leaf's largest:
# two ranks part from one process by at most 5.2e-4 of it (the cascade's
# attention biases after two steps); a rank that skipped a step's update
# would part by a third to a half of it
SAME_UPDATE = 1e-2


def _close_scaled(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale + GRAD_NOISE, (
        f"{what}: max abs err {err} against largest |entry| {scale}")


# --------------------------------------------------------------- BatchNorm
def test_two_rank_batchnorm_matches_flax_on_the_whole_batch(tmp_path):
    pytest.importorskip("flax")
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    b, c, h, w = 4, 6, 5, 7
    # per-sample scales, so that each half's statistics differ from the whole's
    x = (rng.standard_normal((b, c, h, w)) * np.linspace(0.3, 3.0, b)[:, None, None, None]
         + 1.5).astype(np.float32)
    weight = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((b, c, h, w)).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5, axis=-1)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}

    def f(xin, p):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xin, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    (y, new_stats), vjp = jax.vjp(f, xh, params)
    dx, dparams = vjp((jnp.asarray(dy.transpose(0, 2, 3, 1)),
                       jax.tree.map(jnp.zeros_like, stats)))
    want = {"y": np.asarray(y).transpose(0, 3, 1, 2), "dx": np.asarray(dx).transpose(0, 3, 1, 2)}

    ranks = W.run_ranks(W.batchnorm_worker, 2, tmp_path, x, weight, bias, dy)
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, got in enumerate(ranks):
        rows = slice(r * b // 2, (r + 1) * b // 2)
        np.testing.assert_allclose(got["y"].numpy(), want["y"][rows], err_msg=f"y {r}", **tol)
        np.testing.assert_allclose(got["dx"].numpy(), want["dx"][rows], err_msg=f"dx {r}", **tol)
        np.testing.assert_allclose(got["mean"].numpy(), np.asarray(new_stats["mean"]), **tol)
        np.testing.assert_allclose(got["var"].numpy(), np.asarray(new_stats["var"]), **tol)
    # the affine parameters' gradients are each rank's share: DDP sums them
    np.testing.assert_allclose(sum(g["dweight"].numpy() for g in ranks),
                               np.asarray(dparams["scale"]), **tol)
    np.testing.assert_allclose(sum(g["dbias"].numpy() for g in ranks),
                               np.asarray(dparams["bias"]), **tol)


# --------------------------------------------------------- the step vs JAX
@pytest.fixture(scope="module")
def jax_ref():
    from test_torch_train import jax_reference_step, train_cfg

    return jax_reference_step(train_cfg(), nn_rank=False)


@pytest.fixture(scope="module")
def two_ranks_on_jax_draws(jax_ref, tmp_path_factory):
    cfg = CfgNode(jax_ref["cfg"])
    ranks = W.run_ranks(W.step_worker, 2, tmp_path_factory.mktemp("jax_step"), cfg,
                        jax_ref["sd"], jax_ref["batch"], jax_ref["draws"], False)
    return [{"total": r["total"], "losses": r["losses"], "grads": r["grads"],
             "stats": r["stats"], "grad_norm": r["metrics"][0]["grad_norm"],
             "params": r["params"]} for r in ranks]


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_loss_terms_match_jax(jax_ref, two_ranks_on_jax_draws, rank):
    from test_torch_train import check_loss_terms

    check_loss_terms(jax_ref, two_ranks_on_jax_draws[rank])


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_every_gradient_matches_jax(jax_ref, two_ranks_on_jax_draws, rank):
    from test_torch_train import check_gradients

    check_gradients(jax_ref, two_ranks_on_jax_draws[rank])


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_batchnorm_statistics_match_jax(jax_ref, two_ranks_on_jax_draws, rank):
    port = two_ranks_on_jax_draws[rank]
    assert set(port["stats"]) == {k for k in jax_ref["stats"] if "running" in k}
    for name, v in port["stats"].items():
        np.testing.assert_allclose(v.numpy(), jax_ref["stats"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_update_matches_optax(jax_ref, two_ranks_on_jax_draws, rank):
    from test_torch_train import check_update

    check_update(jax_ref, two_ranks_on_jax_draws[rank])


# ----------------------------------------------- two ranks against one process
def _tiny_maskformer():
    from test_torch_train import semantic_batch, train_cfg

    cfg = CfgNode(train_cfg())
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return cfg, sd, semantic_batch(np.random.default_rng(0))


def check_same_run(one, ranks, steps, lr, initial):
    """Every rank's run equals the one-process run on the global batch: the
    first step's loss terms, gradients and metrics to SAME_LOSS / SAME_GRAD;
    the later steps' metrics to 1e-3; each parameter's update over the
    ``steps`` steps (final less ``initial``) to SAME_UPDATE of the leaf's
    largest update plus two fp32 ulps of the parameter (the update is read
    off parameters of ~1, which round at ~6e-8 against updates of ~lr a
    step); the buffers to SAME_LOSS.  A leaf whose first gradient is fp32
    noise (below GRAD_NOISE: the stem conv's bias under BatchNorm) moves by
    +-lr a step in either run, whichever order the sums took, and is held
    to 2 * lr a step."""
    eps = np.finfo(np.float32).eps
    for r, got in enumerate(ranks):
        assert set(got["losses"]) == set(one["losses"])
        for k, v in one["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, err_msg=f"rank {r} {k}", **SAME_LOSS)
        for name, g in one["grads"].items():
            _close_scaled(got["grads"][name], g, SAME_GRAD, f"rank {r} gradient {name}")
        assert len(got["metrics"]) == steps
        for i, (m, want) in enumerate(zip(got["metrics"], one["metrics"])):
            tol = SAME_LOSS if i == 0 else dict(rtol=1e-3, atol=1e-6)
            for k, v in want.items():
                np.testing.assert_allclose(m[k], v, err_msg=f"rank {r} step {i + 1} {k}", **tol)
        for name, p in one["params"].items():
            p0 = np.asarray(initial[name], np.float64)
            want, mine = p.numpy().astype(np.float64), got["params"][name].numpy().astype(np.float64)
            err = np.abs((mine - p0) - (want - p0))
            if float(one["grads"][name].abs().max()) < GRAD_NOISE:
                bound = 2 * lr * steps
            else:
                bound = (SAME_UPDATE * np.abs(want - p0).max()
                         + 2 * eps * np.maximum(np.abs(want), np.abs(p0)))
            assert (err <= bound).all(), (
                f"rank {r} {name}: its update parts from one process's by {err.max()}")
        for name, b in one["buffers"].items():
            np.testing.assert_allclose(got["buffers"][name].numpy(), b.numpy(),
                                       err_msg=f"rank {r} {name}", **SAME_LOSS)
    # the ranks hold one model
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name


def test_two_rank_steps_equal_the_one_process_steps(tmp_path):
    """The default criterion (nearest-tap ranking: global counters, the
    global remainder), three steps from seeded generators."""
    cfg, sd, batch = _tiny_maskformer()
    one = W.step_worker(cfg, sd, batch, None, steps=3)
    ranks = W.run_ranks(W.step_worker, 2, tmp_path, cfg, sd, batch, None, None, 3)
    check_same_run(one, ranks, 3, cfg.SOLVER.BASE_LR, sd)


@pytest.fixture(scope="module")
def cascade():
    from test_torch_updown import label_maps, seeded_port, step_batch, tiny_cfg

    cfg = CfgNode(tiny_cfg(ratio=0.5))
    sd = {k: v.numpy().copy() for k, v in seeded_port(cfg).state_dict().items()}
    rng = np.random.default_rng(1)
    gt = label_maps(rng)
    x = rng.integers(0, 256, (len(gt), gt.shape[1], gt.shape[2], 3)).astype(np.uint8)
    return cfg, sd, step_batch(x, gt)


def test_two_rank_cascade_steps_equal_the_one_process_steps(cascade, tmp_path):
    """The OracleTeacher-BB cascade at ORACLE_TEACHER_RATIO 0.5 (each image's
    teacher draw from the global batch's), the upsampling loss, parameters
    that get no gradient: two steps at two ranks equal one process's, and
    the ranks end with one model."""
    cfg, sd, batch = cascade
    one = W.step_worker(cfg, sd, batch, None, steps=2)
    assert "loss_upsampling" in one["losses"] and one["losses"]["loss_upsampling"] > 0
    assert any(float(g.abs().max()) == 0 for g in one["grads"].values())
    ranks = W.run_ranks(W.step_worker, 2, tmp_path, cfg, sd, batch, None, None, 2)
    check_same_run(one, ranks, 2, cfg.SOLVER.BASE_LR, sd)


def test_two_rank_amp_step_equals_the_one_process_amp_step(tmp_path):
    """One bf16 step (SOLVER.AMP.ENABLED), then a second.  The BatchNorm
    takes flax's fp32 arithmetic in both runs, so the forward, the matches
    and the fp32 loss terms agree as in fp32 (SAME_LOSS).  The gradients are
    bf16 sums: each rank rounds its half of a sum over the batch before DDP
    averages them, where one process rounds the whole sum once, and
    LayerNorm gradients cancel heavily (their group norms part by ~1.7e-2
    on this model, the whole gradient by ~8e-3 in L2, the global norm by
    ~4e-4), so the gradient vector is held to 2e-2 in L2 and each step's
    gradient norm to 2e-3; the ranks end with one model, within 1e-5 of the
    one-process parameters (an AdamW step of this model moves a parameter
    by up to 1e-3)."""
    cfg, sd, batch = _tiny_maskformer()
    cfg.defrost()
    cfg.SOLVER.AMP.ENABLED = True
    one = W.step_worker(cfg, sd, batch, None, steps=2)
    ranks = W.run_ranks(W.step_worker, 2, tmp_path, cfg, sd, batch, None, None, 2)
    names = list(one["grads"])
    want = torch.cat([one["grads"][n].reshape(-1) for n in names])
    for r, got in enumerate(ranks):
        for k, v in one["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, err_msg=f"rank {r} {k}", **SAME_LOSS)
        g = torch.cat([got["grads"][n].reshape(-1) for n in names])
        rel = float((g - want).norm() / want.norm())
        assert rel <= 2e-2, f"rank {r}: the gradient parts from one process's by {rel} in L2"
        for i, (m, w) in enumerate(zip(got["metrics"], one["metrics"])):
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=2e-3,
                                       err_msg=f"rank {r} step {i + 1}")
        for name, p in one["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {name}")
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
