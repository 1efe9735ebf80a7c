"""The PyTorch port's training step against the JAX package: the LSAP
solver, the matching cost, the criterion, the optimizer, the BatchNorm
statistics and one whole step (loss terms, every parameter's gradient, the
update), plus the training-mode repairs of the model.

Everything runs fp32 on the CPU.  The JAX side draws its randomness from
keys as ``parallel/train_step.py`` and ``losses/criterion.py`` split them;
the port's criterion replays those draws through its ``draw`` function, in
its documented order.  Here both criteria are pinned to the reference's exact
sampler (``NN_RANK_UNCERTAINTY = False``); the default nearest-tap ranking is
held the same way in ``test_torch_trainer.py`` (the whole step) and below
(the criterion alone).  The model
is the tiny MaskFormer of ``test_torch_model.py`` (128x128, 2 images, 4
queries = 4 target slots, of which 2 or 3 are valid), with seeded random
weights carried to JAX by the JAX package's own checkpoint converter.  The
JAX step is jitted once per module (~30 s); the whole file takes ~75 s on
an 8-core CPU.

Tolerances, each stated where it is used: loss terms rtol 1e-4 (fp32 over
~20 layers); gradients rtol 1e-3 and atol 1e-4 of the parameter's largest
gradient plus 1e-5 (measured: every parameter within 2e-5 of its scale; the
stem conv's bias, whose true gradient is zero under train-mode BatchNorm,
carries ~2e-6 of fp32 noise); the optimizer to 1e-6.
"""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.engine.optimizer import (
    build_optimizer, clip_by_global_norm_, param_groups)
from autofocusformermod_torch.engine.train_step import TrainStep
from autofocusformermod_torch.losses import criterion as tcrit
from autofocusformermod_torch.losses.lapjv import hungarian_lsap
from autofocusformermod_torch.losses.matcher import matching_cost, solve_lsap
from autofocusformermod_torch.models.maskformer import init_random_weights, maskformer_from_config

from test_torch_model import tiny_cfg
from test_torch_sampler import Replay, jax_ranked_draws

B, T, NC, P = 2, 4, 4, 64        # images, target slots (= queries), classes, points
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_criterion_draws(key, nl, b, t, num_points, oversample=3.0, importance=0.75,
                        nn_rank=False):
    """What the JAX set_criterion draws from ``key``, in the port's draw
    order: each layer's matcher points, then (one mask resolution) with the
    reference's sampler the candidates and the random remainder, with the
    nearest-tap ranking the two seeds and the remainder."""
    import jax

    draws, pts_keys = [], []
    for _ in range(nl):
        key, k_match, k_pts = jax.random.split(key, 3)
        draws.append(jax.random.uniform(k_match, (b, num_points, 2)))
        pts_keys.append(k_pts)
    n = nl * b * t
    if nn_rank:
        return [np.asarray(d) for d in draws] + jax_ranked_draws(pts_keys[0], n, num_points,
                                                                 importance)
    k1, k2 = jax.random.split(pts_keys[0])
    draws.append(jax.random.uniform(k1, (n, int(num_points * oversample), 2)))
    draws.append(jax.random.uniform(k2, (n, num_points - int(importance * num_points), 2)))
    return [np.asarray(d) for d in draws]


def train_cfg():
    cfg = tiny_cfg()
    cfg.MODEL.AFF.DROP_PATH_RATE = 0.0
    cfg.MODEL.MASK_FORMER.DROPOUT = 0.0
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = P
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    return cfg


def semantic_batch(rng, b=B, t=T, size=128):
    """uint8 images and blocky label maps with 2-3 of the NC classes each;
    labels padded to t slots as the semantic mapper pads them."""
    image = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    sem = np.zeros((b, size, size), np.uint8)
    labels = np.zeros((b, t), np.int32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        classes = rng.choice(NC, 3 - i, replace=False)
        sem[i] = np.kron(rng.choice(classes, (4, 4)), np.ones((size // 4, size // 4)))
        present = np.unique(sem[i])
        labels[i, :len(present)] = present
        valid[i, :len(present)] = True
    return {"image": image, "sem_seg_map": sem, "labels": labels, "valid": valid}


def _flax_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


# ------------------------------------------------------------------ the LSAP
@pytest.mark.parametrize("q,t", [(7, 7), (9, 5), (100, 100)])
def test_plain_lsap_matches_jax_and_scipy(q, t):
    """Random costs with sentinel (1e8) columns: the plain solver gives the
    JAX solver's assignment exactly, and the optimal total cost (scipy's)."""
    pytest.importorskip("jax")
    from scipy.optimize import linear_sum_assignment

    from autofocusformermod_tpu.losses.lapjv import hungarian_lsap as jax_lsap

    rng = np.random.default_rng(q * 1000 + t)
    cost = rng.standard_normal((3, q, t)).astype(np.float32) * 5
    cost[:, :, t // 2:] = np.where(rng.random((3, 1, t - t // 2)) < 0.5, 1e8,
                                   cost[:, :, t // 2:])
    got = hungarian_lsap(_t(cost)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_lsap(cost)))
    for i in range(3):
        assert sorted(got[i]) == sorted(set(got[i]))          # distinct queries
        rows, cols = linear_sum_assignment(cost[i])
        opt = cost[i][rows, cols].sum()
        np.testing.assert_allclose(cost[i][got[i], np.arange(t)].sum(), opt, rtol=1e-6)
    np.testing.assert_array_equal(solve_lsap(_t(cost)).numpy(), got)


# --------------------------------------------------------- matcher, criterion
def _random_outputs(rng, b=2, q=5, nc=NC, hw=16, n_aux=2):
    def one():
        return {"pred_logits": rng.standard_normal((b, q, nc + 1)).astype(np.float32),
                "pred_masks": (2 * rng.standard_normal((b, q, hw, hw))).astype(np.float32)}
    out = one()
    out["aux_outputs"] = tuple(one() for _ in range(n_aux))
    return out


def _random_targets(rng, b=2, t=3, size=32):
    masks = (rng.random((b, t, size, size)) < 0.4).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, False]])[:b, :t]
    return {"labels": rng.integers(0, NC, (b, t)).astype(np.int32),
            "masks": masks * valid[..., None, None], "valid": valid}


def test_matching_cost_matches_jax():
    """Class + mask + dice cost on shared random points; rtol 1e-5."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses import matcher as jm

    rng = np.random.default_rng(0)
    out, tgt = _random_outputs(rng), _random_targets(rng)
    coords = rng.random((2, 40, 2)).astype(np.float32)
    args = (out["pred_logits"], out["pred_masks"], tgt["labels"], tgt["masks"], tgt["valid"],
            coords)
    ref = np.asarray(jm.matching_cost(*map(jnp.asarray, args), 2.0, 5.0, 5.0))
    got = matching_cost(*map(_t, args), 2.0, 5.0, 5.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (got[~np.broadcast_to(tgt["valid"][:, None], got.shape)] == 1e8).all()


def test_set_criterion_matches_jax_on_replayed_draws(monkeypatch):
    """Loss terms (rtol 1e-4) and their gradients in the predictions (atol
    1e-6) against the JAX criterion with the reference's exact sampler."""
    _check_set_criterion(monkeypatch, nn_rank=False)


def test_set_criterion_default_ranking_matches_jax_on_replayed_draws(monkeypatch):
    """The same with both packages' default, the nearest-tap ranking (on the
    CPU: i.i.d. candidates and a global top-k on both sides)."""
    from autofocusformermod_tpu.losses import criterion as jc

    assert jc.NN_RANK_UNCERTAINTY and tcrit.NN_RANK_UNCERTAINTY
    _check_set_criterion(monkeypatch, nn_rank=True)


def _check_set_criterion(monkeypatch, nn_rank):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses import criterion as jc

    monkeypatch.setattr(jc, "NN_RANK_UNCERTAINTY", nn_rank)
    monkeypatch.setattr(tcrit, "NN_RANK_UNCERTAINTY", nn_rank)
    rng = np.random.default_rng(1)
    out, tgt = _random_outputs(rng), _random_targets(rng)
    key = jax.random.PRNGKey(7)
    num_points = 24

    def jax_loss(out):
        return jc.set_criterion(key, out, jax.tree.map(jnp.asarray, tgt), NC,
                                num_points=num_points)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, out))
    # set_criterion splits the key it is given (not a train-step key), so
    # replay its draws from there: skip the train step's first split
    draws = jax_criterion_draws(key, 3, 2, 3, num_points, nn_rank=nn_rank)

    tout = jax.tree.map(lambda a: _t(a).requires_grad_(), out)
    ttgt = {k: _t(v) for k, v in tgt.items()}
    total, losses, _ = tcrit.set_criterion(tout, ttgt, NC, Replay(draws), num_points=num_points)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), **LOSS_TOL)
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), err_msg=k, **LOSS_TOL)
    for key_ in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(tout[key_].grad.numpy(), np.asarray(jgrads[key_]),
                                   rtol=1e-4, atol=1e-6)
        for a, r in zip(tout["aux_outputs"], jgrads["aux_outputs"]):
            np.testing.assert_allclose(a[key_].grad.numpy(), np.asarray(r[key_]),
                                       rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- the optimizer
def test_param_groups_match_flax_labels():
    """Each parameter's group equals make_label_fn's label of its flax leaf,
    carried through the flax_to_torch_state_dict name map."""
    pytest.importorskip("flax")
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.engine.optimizer import make_label_fn

    model = maskformer_from_config(train_cfg())
    flat, _ = convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    labels = make_label_fn()(_flax_tree(flat))
    names = sorted({lab for path, lab in _flat(labels)})
    # encode each label as a constant array so it survives the name map
    coded = _flax_tree({path: np.full(np.shape(flat[path]), names.index(lab), np.float32)
                        for path, lab in _flat(labels)})
    want = {k: v for k, v in flax_to_torch_state_dict(coded).items()}
    got = {name: label for label, named in param_groups(model).items() for name, _ in named}
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, label in got.items():
        ids = np.unique(want[name].numpy())
        assert len(ids) == 1 and names[int(ids[0])] == label, (name, label, ids)
    assert {"backbone_default", "backbone_norm", "default", "norm", "embed"} <= set(got.values())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_three_optimizer_steps_match_optax():
    """Three AdamW steps with clipping and the poly schedule on synthetic
    gradients (steps 1 and 3 clipped, step 2 under the clip value): the
    parameters agree with build_optimizer's optax chain to 1e-6."""
    pytest.importorskip("optax")
    import jax
    import optax

    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.engine.optimizer import build_optimizer as jax_build_optimizer

    cfg = train_cfg()
    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    flat, _ = convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    params = _flax_tree(flat)
    tx = jax_build_optimizer(cfg, params)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    opt, sched = build_optimizer(cfg, model)
    torch_params = dict(model.named_parameters())
    rng = np.random.default_rng(3)
    for step, scale in enumerate((1.0, 1e-5, 0.3)):
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(np.shape(p)))
                             .astype(np.float32), params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tgrads = flax_to_torch_state_dict(grads)
        for name, p in torch_params.items():
            p.grad = tgrads[name].clone()
        norm = clip_by_global_norm_([p.grad for p in torch_params.values()], 0.01)
        assert (norm.item() < 0.01) == (step == 1)
        opt.step()
        sched.step()
    want = flax_to_torch_state_dict(params)
    for name, p in torch_params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


# -------------------------------------------------------------- the whole step
def jax_reference_step(cfg, nn_rank):
    """The JAX side of one step: the tiny model's loss terms, gradients,
    mutated BatchNorm statistics and one optax update, from the port's random
    weights carried over by convert_reference_state_dict, with the criterion's
    ``NN_RANK_UNCERTAINTY`` set to ``nn_rank``."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax

    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
    from autofocusformermod_tpu.losses import criterion as jc
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from autofocusformermod_tpu.parallel.train_step import _device_masks

    model = init_random_weights(maskformer_from_config(cfg), torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    flat_p, flat_s = convert_reference_state_dict(sd)
    params, stats = _flax_tree(flat_p), _flax_tree(flat_s)
    batch = semantic_batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["image"] = jbatch["image"].astype(jnp.float32)
    jmodel = jax_maskformer(cfg)
    key = jax.random.PRNGKey(5)
    mf = cfg.MODEL.MASK_FORMER

    def loss_fn(params):            # parallel/train_step.py loss_fn, fp32
        k_drop, k_crit = jax.random.split(key)
        outputs, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                        jbatch["image"], train=True, mutable=["batch_stats"],
                                        rngs={"dropout": k_drop})
        targets = {"labels": jbatch["labels"], "masks": _device_masks(jbatch),
                   "valid": jbatch["valid"]}
        total, losses = jc.set_criterion(
            k_crit, outputs, targets, NC, eos_coef=mf.NO_OBJECT_WEIGHT,
            class_weight=mf.CLASS_WEIGHT, mask_weight=mf.MASK_WEIGHT,
            dice_weight=mf.DICE_WEIGHT, num_points=P)
        return total, (losses, mutated["batch_stats"])

    orig = jc.NN_RANK_UNCERTAINTY
    jc.NN_RANK_UNCERTAINTY = nn_rank
    try:
        (total, (losses, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        jc.NN_RANK_UNCERTAINTY = orig
    tx = jax_build_optimizer(cfg, params)
    updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)
    _, k_crit = jax.random.split(key)
    return {"cfg": cfg, "sd": sd, "batch": batch, "nn_rank": nn_rank,
            "jax": (jmodel, params, stats),
            "draws": jax_criterion_draws(k_crit, mf.DEC_LAYERS, B, T, P, nn_rank=nn_rank),
            "total": float(total), "losses": jax.tree.map(float, losses),
            "grads": flax_to_torch_state_dict(grads),
            "stats": flax_to_torch_state_dict({}, new_stats),
            "updated": flax_to_torch_state_dict(optax.apply_updates(params, updates))}


def port_step(ref):
    """The port's side of the same step, on JAX's replayed draws."""
    model = maskformer_from_config(ref["cfg"])
    model.load_state_dict({k: _t(v) for k, v in ref["sd"].items()})
    step = TrainStep(model, ref["cfg"])
    batch = {k: _t(v) for k, v in ref["batch"].items()}
    orig = tcrit.NN_RANK_UNCERTAINTY
    tcrit.NN_RANK_UNCERTAINTY = ref["nn_rank"]
    try:
        total, losses, matched = step.loss_and_grads(batch, Replay(ref["draws"]))
    finally:
        tcrit.NN_RANK_UNCERTAINTY = orig
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    grad_norm = step.apply_gradients()
    return {"total": total.item(), "losses": {k: v.item() for k, v in losses.items()},
            "grads": grads, "stats": stats, "grad_norm": grad_norm.item(),
            "params": dict(model.named_parameters()), "matched": matched, "model": model}


@pytest.fixture(scope="module")
def ref():
    return jax_reference_step(train_cfg(), nn_rank=False)


@pytest.fixture(scope="module")
def port(ref):
    return port_step(ref)


def check_loss_terms(ref, port):
    np.testing.assert_allclose(port["total"], ref["total"], **LOSS_TOL)
    assert set(port["losses"]) == set(ref["losses"])
    assert len(port["losses"]) == 3 * ref["cfg"].MODEL.MASK_FORMER.DEC_LAYERS
    for k, v in port["losses"].items():
        np.testing.assert_allclose(v, ref["losses"][k], err_msg=k, **LOSS_TOL)


def check_gradients(ref, port):
    """Every parameter's gradient: rtol 1e-3, atol 1e-4 of its largest entry
    + 1e-5 (the largest gradient entry of the model is ~24)."""
    assert set(port["grads"]) == set(ref["grads"])
    for name, g in port["grads"].items():
        want = ref["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3, atol=1e-4 * scale + 1e-5,
                                   err_msg=name)
    nonzero = {n for n, g in port["grads"].items() if g.abs().max() > 0}
    assert nonzero == {n for n, g in ref["grads"].items() if g.abs().max() > 0}


def check_update(ref, port):
    """One clipped AdamW update of the whole step's gradients; the clip
    scales the gradients to norm 0.01, so the update is Adam's normalized
    first step: lr * sign-like, 1e-6 absolute."""
    assert port["grad_norm"] > 0.01
    for name, p in port["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), ref["updated"][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_step_loss_terms_match_jax(ref, port):
    check_loss_terms(ref, port)


def test_step_every_gradient_matches_jax(ref, port):
    check_gradients(ref, port)


def test_step_batchnorm_statistics_match_jax(ref, port):
    """The stem BatchNorm's running statistics after one train-mode forward
    equal JAX's mutated batch_stats (momentum 0.99 in flax's convention,
    biased batch variance); rtol 1e-5."""
    assert set(port["stats"]) == {k for k in ref["stats"] if "running" in k}
    for name, v in port["stats"].items():
        np.testing.assert_allclose(v.numpy(), ref["stats"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_step_update_matches_optax(ref, port):
    check_update(ref, port)


# --------------------------------------------------- training-mode repairs
def test_stem_batchnorm_uses_flax_momentum():
    """Regression: the stem BatchNorm had PyTorch's momentum 0.1 where flax's
    0.99 (0.01 here) belongs, and took the unbiased batch variance."""
    from autofocusformermod_torch.models.aff import PatchEmbed

    pe = PatchEmbed(8).train()
    assert pe.bn.momentum == pytest.approx(0.01)
    x = torch.randn(2, 16, 16, 3) * 3 + 1
    pe(x)
    h = pe.proj1(x.permute(0, 3, 1, 2))
    var, mean = torch.var_mean(h, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(pe.bn.running_mean, 0.01 * mean.detach())
    torch.testing.assert_close(pe.bn.running_var, 0.99 + 0.01 * var.detach())


def test_drop_path_rate_is_read_and_refused_in_train_mode():
    """Regression: aff_from_config ignored DROP_PATH_RATE.  The rate is read
    and reaches the blocks' DropPath, which evaluates as the identity and
    trains; decoder dropout (not ported) is still refused in train mode."""
    cfg = train_cfg()
    cfg.MODEL.AFF.DROP_PATH_RATE = 0.3
    model = maskformer_from_config(cfg)
    assert model.backbone.drop_path_rate == 0.3
    assert model.backbone.layers[-1].blocks[-1].drop_path.rate == pytest.approx(0.3)
    x = torch.zeros(1, 128, 128, 3, dtype=torch.uint8)
    with torch.no_grad():
        model.eval()(x)
        model.train()(x)
    cfg = train_cfg()
    cfg.MODEL.MASK_FORMER.DROPOUT = 0.1
    with pytest.raises(NotImplementedError, match="DROPOUT"):
        maskformer_from_config(cfg).train()(x)


def test_aff_mini_preset_trains_without_drop_path():
    from autofocusformermod_torch.config import aff_mini_cfg

    cfg = aff_mini_cfg()
    assert cfg.MODEL.AFF.DROP_PATH_RATE == 0.0 and cfg.MODEL.MASK_FORMER.DROPOUT == 0.0
    assert cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE == 0.01 and cfg.TPU.MAX_GT_INSTANCES == 100
