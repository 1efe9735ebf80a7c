"""The PyTorch port's OracleTeacher cascade (MaskFinerOracleTeacher and
MaskFinerOracle) against the JAX package: each stage's projection-only
pixel decoder (with and without its projections) and the leaky
OracleTeacher pixel decoder, ``MaskPredictorOracleTeacher``'s scores, the
whole forward with and without ground truth at ORACLE_TEACHER_RATIO 0, the
split by the oracle at ratio 1 in training, one training step against
``make_maskfiner_train_step(needs_sem_seg_gt=True)``, the preset and the
entry points.

The tiny cascade is ``tests/test_maskfiner.py``'s shape (3 stages of
patches 16, 8 and 4 at 64x64, batch 2) with stage widths 32, 24 and 16
under 32-wide heads, so stage 0's projection decoder passes its level on
and stage 1's projects both; half of the newest scale's tokens split, the
old scale kept (streams of 16, 16 + 32 and 16 + 32 + 64 tokens, clusters
of 8 in 16-token neighbourhoods); the leaky pixel decoder over res2-res4
and the dense OracleTeacher decoder on the last stage.  Its JAX parameter
tree comes from ``jax.eval_shape`` filled with the port's seeded weights
(``torch_to_flax``; no JAX init).  Inputs are made from numpy seeds; the
label maps hold void (255) pixels.  Tolerances: forward outputs within
1e-4 of their largest entry, loss terms 1e-5 relative, gradient norms per
parameter group 1e-4 relative.  The teacher's draws differ between JAX
and torch, so the cases run at ratio 0 and at ratio 1 (MaskFinerOracle),
where both draw the same.
"""

import sys

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict, torch_name
from autofocusformermod_torch.models.registry import build_model, size_divisibility

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_mrml import fast_jit, grads_only
from test_torch_sampler import Replay
from test_torch_updown import _close, label_maps, seeded_port, step_batch, torch_to_flax

B, SIZE = 2, 64
ADE = "configs/ade20k/semantic-segmentation/maskfiner/"


def tiny_cfg(ratio=0.0, arch="MaskFinerOracleTeacher"):
    """The tiny OracleTeacher cascade (JAX CfgNode)."""
    from test_maskfiner import tiny_maskfiner_cfg

    cfg = tiny_maskfiner_cfg()
    cfg.MODEL.META_ARCHITECTURE = arch
    mr = cfg.MODEL.MR
    mr.EMBED_DIM, mr.UPSCALE_RATIO, mr.DROP_PATH_RATE = [32, 24, 16], [0.0, 0.5, 0.5], 0.0
    head = cfg.MODEL.MR_SEM_SEG_HEAD
    head.NAME = "MaskPredictorOracleTeacher"
    head.PIXEL_DECODER_NAME = ["ProjMaskFinerOracleTeacher"] * 2 + [
        "MSDeformAttnPixelDecoderMaskFinerOracleTeacher"]
    mf = cfg.MODEL.MASK_FINER
    mf.TRANSFORMER_DECODER_NAME = "MultiScaleMaskFinerTransformerDecoderOracleTeacher"
    mf.DECODER_LEVELS, mf.DEC_LAYERS = [1, 2, 2], [2, 2, 3]
    mf.ORACLE_TEACHER_RATIO, mf.UPSAMPLING_WEIGHT, mf.TRAIN_NUM_POINTS = ratio, 10, 64
    mf.CLASS_WEIGHT, mf.MASK_WEIGHT, mf.DICE_WEIGHT, mf.NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    return cfg


def _unpack(stage):
    """A captured MaskPredictorOracleTeacher output, as numpy."""
    return [np.asarray(a) if a is not None else None for a in stage[1:4]]


@pytest.fixture(scope="module")
def ref():
    """The JAX side, made once: the tiny cascade's parameter tree (by
    jax.eval_shape, filled from the port's seeded weights), its eval
    forward with ground truth and every stage's pixel decoder and predictor
    outputs, the MaskFinerOracle forward in training, and one training
    step."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY
    from autofocusformermod_tpu.parallel.train_step import TrainState, make_maskfiner_train_step

    from test_torch_maskfiner_train import jax_group_draws

    cfg = tiny_cfg()
    model = META_ARCH_REGISTRY.get("MaskFinerOracleTeacher")(cfg)
    # JAX's maskfiner_oracle_from_config calls .replace, which a flax module
    # lacks; its model is this one at ratio 1
    oracle_model = model.clone(oracle_teacher_ratio=1.0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    gt = label_maps(rng)
    xf, gtj = jnp.asarray(x.astype(np.float32)), jnp.asarray(gt.astype(np.int32))
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                                "oracle": jax.random.PRNGKey(1)}, xf, gtj))
    sd = {k: v.detach().clone() for k, v in seeded_port(cfg).state_dict().items()}
    params = torch_to_flax(shapes["params"], sd)
    keys = {"oracle": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}

    def capture(mdl, method):
        return method == "__call__" and (mdl.name or "").startswith(("pixel_decoder",
                                                                      "mask_predictors_"))

    def forwards(p):
        out, state = model.apply({"params": p}, xf, gtj, train=False,
                                 capture_intermediates=capture)
        inter = state["intermediates"]
        stages = [inter[f"mask_predictors_{i}"] for i in range(3)]
        return {"out": out,
                "pixel_decoders": [s["pixel_decoder"]["__call__"][0] for s in stages],
                "predictors": [s["__call__"][0] for s in stages],
                "train1": oracle_model.apply({"params": p}, xf, gtj, train=True, rngs=keys)}

    outs = jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape") else a,
                        fast_jit(forwards, params)(params))

    batch = step_batch(x, gt)
    mf = cfg.MODEL.MASK_FINER
    step = make_maskfiner_train_step(
        model, cfg.MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES, upsampling_weight=float(mf.UPSAMPLING_WEIGHT),
        needs_sem_seg_gt=True, eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
        mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT, num_points=mf.TRAIN_NUM_POINTS,
        oversample_ratio=mf.OVERSAMPLE_RATIO, importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO,
        donate=False)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if k in ("sem_seg_map", "labels") else v)
              for k, v in batch.items()}
    jbatch["sem_seg"] = jbatch["sem_seg_map"]
    state = TrainState.create(params, {}, grads_only())
    new_state, metrics = fast_jit(step, state, jbatch, key)(state, jbatch, key)
    _, _, k_crit = jax.random.split(key, 3)
    n_out = 1 + len(outs["out"]["aux_outputs"])
    return {"cfg": cfg, "x": x, "gt": gt, "sd": sd, "params": params, "shapes": shapes,
            **outs, "batch": batch,
            "draws": jax_group_draws(k_crit, [(16, 16)] * n_out, B, 4, mf.TRAIN_NUM_POINTS),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state)}


@pytest.fixture(scope="module")
def port(ref):
    """The port's eval forwards with and without ground truth, every
    stage's pixel decoder and predictor outputs (forward hooks), and the
    MaskFinerOracle forward in training."""
    model = build_model(ref["cfg"]).eval()
    model.load_state_dict(ref["sd"], strict=True)
    x, gt = torch.from_numpy(ref["x"]), torch.from_numpy(ref["gt"])
    pixel_decoders, predictors = [], []
    hooks = [s.pixel_decoder.register_forward_hook(lambda m, a, o: pixel_decoders.append(o))
             for s in model.mask_predictors]
    hooks += [s.register_forward_hook(lambda m, a, o: predictors.append(o))
              for s in model.mask_predictors]
    with torch.no_grad():
        out = model(x, gt)
        for h in hooks:
            h.remove()
        out_no_gt = model(x)
        oracle = build_model(tiny_cfg(arch="MaskFinerOracle")).train()
        oracle.load_state_dict(ref["sd"], strict=True)
        oracle.set_oracle_generator(torch.Generator().manual_seed(0))
        train1 = oracle(x, gt)
    return {"model": model, "out": out, "out_no_gt": out_no_gt, "train1": train1,
            "pixel_decoders": pixel_decoders, "predictors": predictors}


# ------------------------------------------------------------------ forward
def test_forward_matches_jax(ref, port):
    """pred_logits, pred_masks (16x16: the dense decoder's grid), every aux
    output (the last stage's rounds only), and each earlier stage's scores
    and oracle."""
    got, want = port["out"], ref["out"]
    assert tuple(got["pred_masks"].shape) == (B, 5, 16, 16)
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 2
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            _close(a[key], w[key], what=f"aux {i} {key}")
    for key in ("upsampling_preds", "upsampling_oracles"):
        assert len(got[key]) == len(want[key]) == 2
        for i, (a, w) in enumerate(zip(got[key], want[key])):
            _close(a, w, what=f"{key} {i}")
    assert [tuple(p.shape) for p in got["upsampling_preds"]] == [(B, 16), (B, 48)]
    assert 0 < float(np.asarray(want["upsampling_oracles"][1]).mean()) < 1


def test_forward_without_ground_truth(ref, port):
    """Without ground truth no oracle and no score is returned; the
    predictions are those with it (eval mode never mixes)."""
    got, want = port["out_no_gt"], ref["out"]
    assert got["upsampling_preds"] == () and got["upsampling_oracles"] == ()
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)


def test_oracle_split_in_training_matches_jax(ref, port):
    """MaskFinerOracle in training: every stage splits by the oracle.  The
    scores and the oracles are held to JAX; the predictions are not: with
    the oracle's split, parent and child tokens share positions, and XLA's
    fused arithmetic breaks the space-filling key's exact ties otherwise
    than the op-by-op arithmetic (as the OracleTeacher-BB test finds)."""
    got, want = port["train1"], ref["train1"]
    for key in ("upsampling_preds", "upsampling_oracles"):
        assert len(got[key]) == len(want[key]) == 2
        for i, (a, w) in enumerate(zip(got[key], want[key])):
            _close(a, w, what=f"{key} {i}")
    assert torch.isfinite(got["pred_masks"]).all()
    # the oracle picked stage 1's split, not the scores
    assert not np.allclose(ref["train1"]["upsampling_oracles"][1],
                           ref["out"]["upsampling_oracles"][1])


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_pixel_decoders_match_jax(ref, port, stage):
    """Stage 0's projection decoder (its 32-wide level passed on), stage 1's
    (both 24-wide levels projected) and stage 2's leaky deformable decoder
    with its FPN level and mask features: levels, positions, scales and
    the mask features where there are any."""
    got, want = port["pixel_decoders"][stage], ref["pixel_decoders"][stage]
    mf, mf_pos, levels, poss, scales, min_ss, shapes = got
    assert (mf is None) == (want[0] is None) == (stage < 2)
    if mf is not None:
        _close(mf, want[0], what="mask_features")
    _close(mf_pos, want[1], what="mf_pos")
    assert len(levels) == len(want[2]) == stage + 1
    for i, (a, w) in enumerate(zip(levels, want[2])):
        _close(a, w, what=f"level {i}")
    for a, w in zip(poss + scales, list(want[3]) + list(want[4])):
        np.testing.assert_array_equal(a.numpy(), w)
    assert tuple(min_ss) == tuple(want[5]) and [tuple(s) for s in shapes] == [
        tuple(s) for s in want[6]]
    proj = port["model"].mask_predictors[stage].pixel_decoder
    if stage < 2:
        n_params = sum(p.numel() for p in proj.parameters())
        assert (n_params == 0) == (stage == 0)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_predictors_match_jax(ref, port, stage):
    """Each MaskPredictorOracleTeacher's concatenated levels, their (scale,
    x, y) and its scores (an MLP over the levels; none on the last
    stage)."""
    got = port["predictors"][stage]
    feat, pos_scale, scores = _unpack(ref["predictors"][stage])
    _close(got[1], feat, what="all_feat")
    np.testing.assert_array_equal(got[2].numpy(), pos_scale)
    assert (got[3] is None) == (scores is None) == (stage == 2)
    if scores is not None:
        _close(got[3], scores, what="scores")
    assert got[4] == tuple(ref["predictors"][stage][4])


def test_bridge_covers_every_leaf_and_tensor(ref, port):
    """Every JAX leaf lands on exactly one port tensor, every port tensor is
    covered, and the round trip is exact."""
    import jax

    names = [torch_name(tuple(p.key for p in path))
             for path, _ in jax.tree_util.tree_flatten_with_path(ref["shapes"]["params"])[0]]
    sd = port["model"].state_dict()
    assert set(names) == set(sd)
    packed = [n for n in names if n.endswith(("in_proj_weight", "in_proj_bias"))]
    assert len(names) - len(packed) * 2 // 3 == len(sd)
    for n in ("mask_predictors.1.upsample_out.layers.2.weight",
              "mask_predictors.1.pixel_decoder.input_proj.1.0.weight",
              "mask_predictors.1.pixel_decoder.input_proj.0.1.bias"):
        assert n in names, n
    assert not any(n.startswith("mask_predictors.0.pixel_decoder.") for n in names)
    back = flax_to_torch_state_dict(ref["params"])
    assert all(torch.equal(back[k], v) for k, v in ref["sd"].items())


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def port_step(ref):
    from autofocusformermod_torch.engine.train_step import TrainStep

    model = build_model(ref["cfg"])
    model.load_state_dict(ref["sd"], strict=True)
    step = TrainStep(model, ref["cfg"])
    assert step.with_sem_seg_gt
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    total, losses, _ = step.loss_and_grads(batch, Replay(ref["draws"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"model": model, "total": total.item(), "grads": grads,
            "losses": {k: v.item() for k, v in losses.items()},
            "grad_norm": step.apply_gradients().item()}


def test_step_loss_terms_match_jax(ref, port_step):
    """Every loss term of the 3 outputs, loss_upsampling (weight 10) and
    the total, 1e-5 relative; the global gradient norm 1e-4."""
    want = ref["metrics"]
    assert set(port_step["losses"]) == set(want) - {"total_loss", "grad_norm"}
    assert len(port_step["losses"]) == 3 * 3 + 1 and want["loss_upsampling"] > 0
    for k, v in port_step["losses"].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(port_step["total"], want["total_loss"], rtol=1e-5)
    np.testing.assert_allclose(port_step["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_step_gradient_norms_per_group_match_jax(ref, port_step):
    """The gradient norm of each optimizer parameter group within 1e-4
    relative; the score MLPs learn (from the upsampling loss and through
    the split's straight-through factors)."""
    from autofocusformermod_torch.engine.optimizer import param_groups

    groups = param_groups(port_step["model"])
    assert len(groups) >= 3
    for label, named in groups.items():
        got = float(torch.sqrt(sum((port_step["grads"][n] ** 2).sum() for n, _ in named)))
        want = float(torch.sqrt(sum((ref["grads"][n] ** 2).sum() for n, _ in named)))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=label)
    for s in (0, 1):
        head = [n for n in port_step["grads"] if n.startswith(f"mask_predictors.{s}.upsample_out")]
        got = float(torch.sqrt(sum((port_step["grads"][n] ** 2).sum() for n in head)))
        want = float(torch.sqrt(sum((ref["grads"][n] ** 2).sum() for n in head)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got > 0


# ------------------------------------------------------- presets and refusals
def test_preset_matches_yaml():
    """The preset equals the published yaml merged over its bases
    and the defaults, field by field."""
    from test_torch_resnet import check_preset_matches_yaml

    seen = check_preset_matches_yaml("maskfiner_oracle_teacher",
                                     ADE + "maskfiner_oracle_teacher_bs32_80k.yaml")
    assert {"MODEL.META_ARCHITECTURE", "MODEL.MR.EMBED_DIM", "MODEL.MR.UPSCALE_RATIO",
            "MODEL.MR.KEEP_OLD_SCALE", "MODEL.MR_SEM_SEG_HEAD.NAME",
            "MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME",
            "MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME", "MODEL.MASK_FINER.DEC_LAYERS",
            "MODEL.MASK_FINER.ORACLE_TEACHER_RATIO", "MODEL.MASK_FINER.UPSAMPLING_WEIGHT",
            "SOLVER.AMP.ENABLED"} <= seen
    assert size_divisibility(PRESETS["maskfiner_oracle_teacher"]()) == 32


@pytest.mark.parametrize("field, value", [
    ("MODEL.MASK_FINER.MASK_DECODER_ALL_LEVELS", True),
    ("MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME", "MultiScaleMaskFinerTransformerDecoderCat"),
    ("MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME", "MSDeformAttnPixelDecoderMaskFinerHierUp"),
    ("MODEL.MR_SEM_SEG_HEAD.NAME", "MaskPredictor"),
])
def test_unported_variants_raise(field, value):
    """The variants that once raised build (their forwards are held to JAX in
    ``test_torch_variants.py``): MASK_DECODER_ALL_LEVELS gives every stage
    a decoder and mask features, the Cat decoder attends to all levels, the
    HierUp pixel decoder paints the last stage's FPN level onto the grid
    (its earlier stages take no mask features, as JAX's), and under the
    plain stage head the projection decoders have mask features on the last
    stage only and every stage a decoder."""
    cfg = tiny_cfg()
    *parents, leaf = field.split(".")
    node = cfg
    for name in parents:
        node = getattr(node, name)
    setattr(node, leaf, value)
    stages = build_model(cfg).mask_predictors
    features = [p.pixel_decoder.mask_features is not None for p in stages]
    decoders = [p.mask_decoder is not None for p in stages]
    if field.endswith("MASK_DECODER_ALL_LEVELS"):
        assert features == decoders == [True, True, True]
    elif field.endswith("TRANSFORMER_DECODER_NAME"):
        assert stages[-1].mask_decoder.cat_features and decoders == [False, False, True]
    elif field.endswith("PIXEL_DECODER_NAME"):
        assert stages[-1].pixel_decoder.hierup and features == [False, False, True]
    else:
        assert features == [False, False, True] and decoders == [True, True, True]


# ------------------------------------------------------------- the entry points
# the preset cut to one block a stage, 32 wide, 2 heads, 10 queries and 8
# target slots (the plain assignment solver's steps grow with both)
TINY = ["MODEL.MASK_FINER.NUM_OBJECT_QUERIES", "10", "TPU.MAX_GT_INSTANCES", "8",
        "MODEL.MR.DEPTHS", "[1, 1, 1, 1]", "MODEL.MR.EMBED_DIM", "[32, 32, 32, 32]",
        "MODEL.MR.NUM_HEADS", "[2, 2, 2, 2]", "MODEL.MR_SEM_SEG_HEAD.CONVS_DIM", "[32, 32, 32, 32]",
        "MODEL.MR_SEM_SEG_HEAD.NHEADS", "[2, 2, 2, 2]",
        "MODEL.MR_SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "[2, 2, 4, 1]",
        "MODEL.MASK_FINER.HIDDEN_DIM", "[32, 32, 32, 32]", "MODEL.MASK_FINER.MASK_DIM",
        "[32, 32, 32, 32]", "MODEL.MASK_FINER.NHEADS", "[2, 2, 2, 2]",
        "MODEL.MASK_FINER.DIM_FEEDFORWARD", "[64, 64, 64, 64]",
        "MODEL.MASK_FINER.DEC_LAYERS", "[3, 3, 4, 3]", "MODEL.MASK_FINER.TRAIN_NUM_POINTS", "256"]


def test_train_net_trains_and_evaluates(tmp_path, monkeypatch):
    """``train_net --config maskfiner_oracle_teacher --synthetic`` (cut to
    one 32-wide block a stage) takes one step at 64x64 on the CPU (3 loss terms for each of the 3 outputs and
    loss_upsampling, all finite; the score MLPs get a gradient; the teacher
    draws from the Trainer's oracle generator); ``--eval-only`` on a tiny
    registered dataset; ``SemanticPredictor`` pads a request to the coarsest
    patch's multiple."""
    import json

    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.models.inference import SemanticPredictor

    from test_torch_trainer import tiny_dataset

    # no TensorBoard writer: importing it pulls in TensorFlow (~15 s alone,
    # minutes beside other test workers); metrics.jsonl is what is read here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = train_net.main(["--config", "maskfiner_oracle_teacher", "--device", "cpu",
                              "--synthetic", "--max-iter", "1", "INPUT.CROP.SIZE", "[64, 64]",
                              "SOLVER.IMS_PER_BATCH", "1", "OUTPUT_DIR", str(tmp_path)] + TINY)
    metrics = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    terms = {k: v for k, v in metrics.items() if k.startswith("loss_")}
    assert len(terms) == 3 * 3 + 1 and metrics["loss_upsampling"] > 0
    assert all(np.isfinite(v) for v in terms.values())
    assert set(trainer.generators) == {"criterion", "dropout", "oracle"}
    assert trainer.model.oracle_generator is trainer.generators["oracle"]
    head = trainer.model.mask_predictors[1].upsample_out.layers[2].weight
    assert head.grad is not None and head.grad.abs().sum() > 0

    data = tiny_dataset(tmp_path / "data", "oracle_teacher")
    evaluated = train_net.main(["--config", "maskfiner_oracle_teacher", "--device", "cpu",
                                "--eval-only", "OUTPUT_DIR", str(tmp_path / "eval")] + TINY + data)
    assert 0 <= evaluated.results["oracle_teacher_val"]["mIoU"] <= 100
    x = np.random.default_rng(7).integers(0, 256, (1, 50, 60, 3)).astype(np.uint8)
    labels = SemanticPredictor(evaluated.model.eval(), 32)(x)
    assert tuple(labels.shape) == (1, 50, 60) and 0 <= labels.min() and labels.max() < 150
