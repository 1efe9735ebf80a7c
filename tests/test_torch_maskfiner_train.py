"""The PyTorch port's MaskFiner training step against the JAX package's
``make_maskfiner_train_step``: one whole step of the tiny cascade (loss
terms, every parameter's gradient, the clipped AdamW update), the split's
straight-through gradient alone, and the criterion over outputs of three
mask shapes.

The tiny cascade of ``tests/test_maskfiner.py`` (3 stages, 64x64, batch 2;
masks of 4x4, 8x8 and 16x16; 7 outputs: the last stage's final one and 6
rounds as aux outputs) is initialised in JAX, its parameters perturbed with
seeded noise (the class heads by more, so that the queries vote for
different classes and the disagreement that picks the split tokens, whose
gradient reaches the previous stage through the straight-through factors,
is not zero), and carried over with ``flax_to_torch_state_dict``.  Both
sides run fp32 on the CPU with the loss weights of MODEL.MASK_FINER (2, 5,
5) and the classes of MODEL.MR_SEM_SEG_HEAD (7), which differ from the
MaskFormer nodes' (1, 20, 1; 150), so a step that read the wrong node
fails.  The JAX step is jitted once per module (~40 s); it records its
gradients through an optax transform placed before the optimizer.  The
port's criterion replays the JAX criterion's draws (``Replay``): each
layer's matcher points, then per mask-shape group, in ascending shape
order, the nearest-tap ranking's two seeds and random remainder from the
key of the group's first layer.

Tolerances: loss terms rtol 1e-4 (fp32 over ~15 layers); gradients rtol
1e-3 and atol 1e-4 of the parameter's largest gradient plus 1e-5, and the
same parameters with a zero gradient; the update rtol 1e-5, atol 1e-6 (the
clip scales the gradients to norm 0.01, so the first Adam step is lr times
a sign-like factor); the split's vector-Jacobian product and the criterion
on random outputs 1e-5 and 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.engine.train_step import TrainStep
from autofocusformermod_torch.losses import criterion as tcrit
from autofocusformermod_torch.models.maskfiner import maskfiner_from_config

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_sampler import Replay, jax_ranked_draws

B, T, NC, P = 2, 4, 7, 64        # images, target slots, classes, points
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def train_cfg():
    """The tiny cascade as a MaskFiner config, trained with the published
    criterion's weights at 64 points and a full-model clip of 0.01."""
    from test_maskfiner import tiny_maskfiner_cfg

    cfg = tiny_maskfiner_cfg()
    cfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    mf = cfg.MODEL.MASK_FINER
    mf.CLASS_WEIGHT, mf.MASK_WEIGHT, mf.DICE_WEIGHT, mf.NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1
    mf.TRAIN_NUM_POINTS = P
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    return cfg


def cascade_batch(rng, size=64):
    """uint8 images and blocky label maps with 2-3 of the NC classes each;
    labels padded to T slots as the semantic mapper pads them."""
    image = rng.integers(0, 256, (B, size, size, 3)).astype(np.uint8)
    sem = np.zeros((B, size, size), np.uint8)
    labels = np.zeros((B, T), np.int32)
    valid = np.zeros((B, T), bool)
    for i in range(B):
        classes = rng.choice(NC, 3 - i, replace=False)
        sem[i] = np.kron(rng.choice(classes, (4, 4)), np.ones((size // 4, size // 4)))
        present = np.unique(sem[i])
        labels[i, :len(present)] = present
        valid[i, :len(present)] = True
    return {"image": image, "sem_seg_map": sem, "labels": labels, "valid": valid}


def jax_group_draws(key, shapes, b, t, num_points, importance=0.75):
    """What the JAX set_criterion draws from ``key`` for outputs whose mask
    shapes are ``shapes`` (the main output first), in the port's order: each
    layer's matcher points, then for each mask-shape group in ascending
    order the ranking's seeds and remainder, from the key of its first
    layer."""
    import jax

    draws, pts_keys, groups = [], [], {}
    for i, shape in enumerate(shapes):
        key, k_match, k_pts = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_match, (b, num_points, 2))))
        pts_keys.append(k_pts)
        groups.setdefault(tuple(shape), []).append(i)
    for _, idxs in sorted(groups.items()):
        draws += jax_ranked_draws(pts_keys[idxs[0]], len(idxs) * b * t, num_points, importance)
    return draws


def _record_grads():
    """An optax transform that passes the gradients on and keeps them as its
    state, so the jitted step's new state carries them."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


@pytest.fixture(scope="module")
def ref():
    """One step of JAX make_maskfiner_train_step on the perturbed tiny
    cascade: loss terms, gradients (port names), the updated parameters and
    the criterion's draws."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax

    from autofocusformermod_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jax_maskfiner
    from autofocusformermod_tpu.parallel.train_step import TrainState, make_maskfiner_train_step

    cfg = train_cfg()
    model = jax_maskfiner(cfg)
    batch = cascade_batch(np.random.default_rng(0))
    x = jnp.asarray(batch["image"].astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), x, train=False))()
    rng = np.random.default_rng(1)

    def perturb(path, p):
        scale = 1.0 if "class_embed" in jax.tree_util.keystr(path) else 0.02
        return np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    tx = optax.chain(_record_grads(), jax_build_optimizer(cfg, params))
    state = TrainState.create(params, {}, tx)
    mf = cfg.MODEL.MASK_FINER
    step = make_maskfiner_train_step(
        model, cfg.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES, eos_coef=mf.NO_OBJECT_WEIGHT,
        class_weight=mf.CLASS_WEIGHT, mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT,
        num_points=mf.TRAIN_NUM_POINTS, oversample_ratio=mf.OVERSAMPLE_RATIO,
        importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO, donate=False)
    key = jax.random.PRNGKey(5)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    out = jax.jit(lambda p: model.apply({"params": p}, x, train=True))(params)
    shapes = [out["pred_masks"].shape[-2:]] + [a["pred_masks"].shape[-2:]
                                               for a in out["aux_outputs"]]
    _, _, k_crit = jax.random.split(key, 3)
    return {"cfg": cfg, "model": model, "params": params, "batch": batch, "shapes": shapes,
            "draws": jax_group_draws(k_crit, shapes, B, T, P),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state[0]),
            "updated": flax_to_torch_state_dict(new_state.params)}


@pytest.fixture(scope="module")
def port(ref):
    """The port's TrainStep on the same weights, batch and replayed draws."""
    model = maskfiner_from_config(ref["cfg"])
    model.load_state_dict(flax_to_torch_state_dict(ref["params"]), strict=True)
    step = TrainStep(model, ref["cfg"])
    batch = {k: _t(v) for k, v in ref["batch"].items()}
    total, losses, _ = step.loss_and_grads(batch, Replay(ref["draws"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    grad_norm = step.apply_gradients()
    return {"total": total.item(), "losses": {k: v.item() for k, v in losses.items()},
            "grads": grads, "grad_norm": grad_norm.item(), "params": dict(model.named_parameters())}


# ----------------------------------------------------------------- the step
def test_cascade_outputs_cover_three_mask_shapes(ref):
    assert [tuple(s) for s in ref["shapes"]] == [(16, 16), (4, 4), (4, 4), (8, 8), (8, 8),
                                                 (16, 16), (16, 16)]


def test_step_loss_terms_match_jax(ref, port):
    want = ref["metrics"]
    np.testing.assert_allclose(port["total"], want["total_loss"], **LOSS_TOL)
    assert set(port["losses"]) == set(want) - {"total_loss", "grad_norm"}
    assert len(port["losses"]) == 3 * 7
    for k, v in port["losses"].items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(port["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_step_every_gradient_matches_jax(ref, port):
    """Every parameter's gradient: rtol 1e-3, atol 1e-4 of its largest entry
    + 1e-5; the same parameters have a zero gradient on both sides.  The
    split's straight-through factors carry the later stages' losses into
    the earlier stages' last-round mask logits (their mask embeddings and
    pixel decoders)."""
    assert set(port["grads"]) == set(ref["grads"])
    for name, g in port["grads"].items():
        want = ref["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3, atol=1e-4 * scale + 1e-5,
                                   err_msg=name)
    nonzero = {n for n, g in port["grads"].items() if g.abs().max() > 0}
    assert nonzero == {n for n, g in ref["grads"].items() if g.abs().max() > 0}


def test_step_update_matches_optax(ref, port):
    assert port["grad_norm"] > 0.01
    for name, p in port["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), ref["updated"][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ------------------------------------------------------- the split's gradient
def test_split_tokens_vjp_matches_jax(ref):
    """The straight-through split alone: the vector-Jacobian product of
    ``_split_tokens`` in the features and the scores against jax.vjp of the
    JAX one (the scores' gradient comes only from the softmaxed factors,
    which are 1 in value)."""
    import jax

    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 24, 32)).astype(np.float32)
    pos = np.concatenate([np.ones((2, 24, 1)), rng.integers(0, 16, (2, 24, 2))], 2).astype(
        np.float32)
    scores = rng.standard_normal((2, 24)).astype(np.float32)
    cot_split = rng.standard_normal((2, 7, 32)).astype(np.float32)
    cot_keep = rng.standard_normal((2, 17, 32)).astype(np.float32)
    jsplit = ref["model"].mask_predictors[1].backbone._split_tokens
    (tok_split, tok_keep), vjp = jax.vjp(
        lambda f, s: (lambda o: (o[0], o[2]))(jsplit(f, pos, s, 7)), feat, scores)
    want_feat, want_scores = vjp((cot_split, cot_keep))

    stage = maskfiner_from_config(ref["cfg"]).mask_predictors[1].backbone
    tf, ts = _t(feat).requires_grad_(), _t(scores).requires_grad_()
    got = stage._split_tokens(tf, _t(pos), ts, 7)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(tok_split))
    np.testing.assert_array_equal(got[2].detach().numpy(), np.asarray(tok_keep))
    torch.autograd.backward([got[0], got[2]], [_t(cot_split), _t(cot_keep)])
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_feat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(want_scores)).max() > 0


# ---------------------------------------------- the mixed-resolution criterion
def test_set_criterion_on_three_mask_shapes_matches_jax():
    """set_criterion on random outputs whose masks are 4x4, 8x8 and 16x16
    (the main output and 5 aux outputs, in the cascade's order): one LSAP
    per cost shape, one ranking and one point_sample pass per mask shape,
    the targets sampled once per group; loss terms rtol 1e-5 and the
    predictions' gradients atol 1e-6 against the JAX criterion on replayed
    draws (the default nearest-tap ranking, i.i.d. on the CPU)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.losses import criterion as jc

    rng = np.random.default_rng(2)
    b, q, t, num_points = 2, 5, 3, 24
    shapes = [(16, 16), (4, 4), (4, 4), (8, 8), (8, 8), (16, 16)]

    def one(hw):
        return {"pred_logits": rng.standard_normal((b, q, NC + 1)).astype(np.float32),
                "pred_masks": (2 * rng.standard_normal((b, q, *hw))).astype(np.float32)}

    out = one(shapes[0])
    out["aux_outputs"] = tuple(one(hw) for hw in shapes[1:])
    valid = np.array([[True, True, False], [True, False, False]])
    tgt = {"labels": rng.integers(0, NC, (b, t)).astype(np.int32),
           "masks": (rng.random((b, t, 64, 64)) < 0.4).astype(np.float32)
           * valid[..., None, None], "valid": valid}
    key = jax.random.PRNGKey(9)

    def jax_loss(o):
        return jc.set_criterion(key, o, jax.tree.map(jnp.asarray, tgt), NC, num_points=num_points)

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, out))
    tout = jax.tree.map(lambda a: _t(a).requires_grad_(), out)
    total, losses, matched = tcrit.set_criterion(
        tout, {k: _t(v) for k, v in tgt.items()}, NC,
        Replay(jax_group_draws(key, shapes, b, t, num_points)), num_points=num_points)
    total.backward()
    assert len(matched) == len(shapes) and set(losses) == set(jlosses)
    assert len(losses) == 3 * len(shapes) and "loss_dice_4" in losses
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    pairs = [(tout, jgrads)] + list(zip(tout["aux_outputs"], jgrads["aux_outputs"]))
    for a, r in pairs:
        for k in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(a[k].grad.numpy(), np.asarray(r[k]), rtol=1e-4, atol=1e-6)
