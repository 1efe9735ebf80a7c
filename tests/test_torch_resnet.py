"""The PyTorch port's Mask2Former-R50 baseline against the JAX package: the
ResNet, the point-cloud pixel decoder on the R50's per-stage grids, the
whole forward, one training step, the weights bridge, the optimizer's
groups and the ``r50`` preset.

A tiny R50 MaskFormer (depth 50 at a narrow width: stem 16, stages of 32,
64, 128 and 256 channels; one encoder layer, 4 decoder layers, 4 queries)
is initialised in JAX at 64x64, its parameters and its FrozenBN statistics
perturbed with seeded noise, carried over with ``flax_to_torch_state_dict``
and run on the same uint8 images (batch 2) in fp32 on the CPU.  The R50
gives each level its own (h, w) as ``res*_spatial_shape`` (16, 8, 4, 2 at
64x64) with positions on the stride-4 canvas, so every level's token count
is h * w and the decoder's ``scale_pos`` rescales positions that are already
on the canvas: both packages must do the same.  The JAX apply and the JAX
``make_train_step`` are jitted once per module; the port's criterion
replays the JAX criterion's draws (``Replay``).

Tolerances: every output, aux output, backbone feature and pixel-decoder
output within 1e-4 of its largest entry (fp32 summation order over ~60
layers); loss terms rtol 1e-4; gradients rtol 1e-3 and atol 1e-4 of the
parameter's largest gradient plus 1e-5, the same parameters with a zero
gradient; the clipped AdamW update rtol 1e-5, atol 1e-6.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS
from autofocusformermod_torch.engine.convert_checkpoint import (flax_to_torch_state_dict,
                                                                is_grid_tree, torch_name)
from autofocusformermod_torch.engine.optimizer import param_groups
from autofocusformermod_torch.engine.train_step import TrainStep
from autofocusformermod_torch.models.pixel_decoder import scale_pos
from autofocusformermod_torch.models.registry import build_model
from autofocusformermod_torch.models.resnet import FrozenBN

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_maskfiner_train import _record_grads, jax_group_draws
from test_torch_sampler import Replay
from test_torch_train import semantic_batch

REPO = Path(__file__).resolve().parents[1]
B, T, NC, P = 2, 4, 4, 64        # images, target slots (= queries), classes, points
OUT_RTOL = 1e-4                  # of each output's largest entry
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close_to_scale(got, want, rtol=OUT_RTOL, name=""):
    """|got - want| <= rtol * max|want| everywhere, shapes equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (name, err, scale)


def tiny_head(cfg):
    """The decoders of the tiny models, trained with a full-model clip of 0.01."""
    h = cfg.MODEL.SEM_SEG_HEAD
    h.NUM_CLASSES, h.TRANSFORMER_ENC_LAYERS = NC, 1
    mf = cfg.MODEL.MASK_FORMER
    mf.NUM_OBJECT_QUERIES, mf.NHEADS, mf.DIM_FEEDFORWARD, mf.DEC_LAYERS = T, 2, 32, 4
    mf.TRAIN_NUM_POINTS, mf.DROPOUT = P, 0.0
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    cfg.TPU.USE_PALLAS = False
    return cfg


def tiny_r50_cfg():
    from autofocusformermod_tpu.config import add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_maskformer2_config(cfg)
    cfg.MODEL.BACKBONE.NAME = "build_resnet_backbone"
    r = cfg.MODEL.RESNETS
    r.DEPTH, r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.STRIDE_IN_1X1 = 50, 16, 32, False
    r.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM = cfg.MODEL.SEM_SEG_HEAD.MASK_DIM = 16
    cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 16
    return tiny_head(cfg)


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_reference(cfg, build, size):
    """The JAX side, once per module: the perturbed variables, the eval
    forward with the backbone's and the pixel decoder's outputs, and one
    ``make_train_step`` step (loss terms, gradients, the update, the
    criterion's draws)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax

    from autofocusformermod_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
    from autofocusformermod_tpu.parallel.train_step import TrainState, make_train_step

    model = build(cfg)
    x = np.random.default_rng(0).integers(0, 256, (B, size, size, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), xf, train=False))()
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.random(p.shape).astype(np.float32),
        variables.get("batch_stats", {}))

    def capture(mdl, method):
        return method == "__call__" and mdl.name in ("backbone", "pixel_decoder")

    def apply(p, s, im):
        out, state = model.apply({"params": p, "batch_stats": s}, im, train=False,
                                 capture_intermediates=capture)
        feats = state["intermediates"]["backbone"]["__call__"][0]
        pd = state["intermediates"]["head"]["pixel_decoder"]["__call__"][0]
        return out, {k: v for k, v in feats.items() if not k.endswith("_spatial_shape")}, pd

    out, feats, pd = jax.jit(apply)(params, stats, xf)

    batch = semantic_batch(np.random.default_rng(2), size=size)
    tx = optax.chain(_record_grads(), jax_build_optimizer(cfg, params))
    state = TrainState.create(params, stats, tx)
    mf = cfg.MODEL.MASK_FORMER
    step = make_train_step(
        model, NC, eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
        mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT, num_points=P,
        oversample_ratio=mf.OVERSAMPLE_RATIO, importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO,
        donate=False)
    key = jax.random.PRNGKey(5)
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    _, k_crit = jax.random.split(key)
    shapes = [(size // 4, size // 4)] * mf.DEC_LAYERS
    return {"cfg": cfg, "x": x, "params": params, "stats": stats,
            "out": jax.tree.map(np.asarray, out), "feats": jax.tree.map(np.asarray, feats),
            "pd": jax.tree.map(np.asarray, pd), "batch": batch,
            "draws": jax_group_draws(k_crit, shapes, B, T, P),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state[0]),
            "updated": flax_to_torch_state_dict(new_state.params)}


def port_model(ref):
    model = build_model(ref["cfg"])
    model.load_state_dict(flax_to_torch_state_dict(ref["params"], ref["stats"]), strict=True)
    return model


def port_reference(ref):
    """The port's eval forward (with its backbone's and pixel decoder's
    outputs) and one TrainStep on the same weights, batch and draws."""
    model = port_model(ref).eval()
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        feats = model.backbone(model.normalize(x))
        pd = model.sem_seg_head.pixel_decoder(feats)
        out = model(x)
    step = TrainStep(model, ref["cfg"])
    batch = {k: _t(v) for k, v in ref["batch"].items()}
    total, losses, _ = step.loss_and_grads(batch, Replay(ref["draws"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    grad_norm = step.apply_gradients()
    return {"model": model, "out": out, "feats": feats, "pd": pd, "total": total.item(),
            "losses": {k: v.item() for k, v in losses.items()}, "grads": grads,
            "grad_norm": grad_norm.item(), "params": dict(model.named_parameters())}


# ------------------------------------------------------ checks both files run
def check_outputs(ref, port):
    for key in ("pred_logits", "pred_masks"):
        assert_close_to_scale(port["out"][key].numpy(), ref["out"][key], name=key)
    assert len(port["out"]["aux_outputs"]) == len(ref["out"]["aux_outputs"])
    for i, (a, r) in enumerate(zip(port["out"]["aux_outputs"], ref["out"]["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            assert_close_to_scale(a[key].numpy(), r[key], name=f"aux {i} {key}")


def check_features(ref, port):
    for key, want in ref["feats"].items():
        got = port["feats"][key].numpy()
        if key.endswith("_pos"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert_close_to_scale(got, want, name=key)


def check_loss_terms(ref, port):
    want = ref["metrics"]
    np.testing.assert_allclose(port["total"], want["total_loss"], **LOSS_TOL)
    assert set(port["losses"]) == set(want) - {"total_loss", "grad_norm"}
    assert len(port["losses"]) == 3 * ref["cfg"].MODEL.MASK_FORMER.DEC_LAYERS
    for k, v in port["losses"].items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(port["grad_norm"], want["grad_norm"], rtol=1e-4)


def check_gradients(ref, port):
    assert set(port["grads"]) == set(ref["grads"])
    for name, g in port["grads"].items():
        want = ref["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3, atol=1e-4 * scale + 1e-5,
                                   err_msg=name)
    nonzero = {n for n, g in port["grads"].items() if g.abs().max() > 0}
    assert nonzero == {n for n, g in ref["grads"].items() if g.abs().max() > 0}


def check_update(ref, port):
    assert port["grad_norm"] > 0.01
    for name, p in port["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), ref["updated"][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def check_bridge(ref):
    """Every JAX leaf (parameters and statistics) lands on exactly one port
    tensor, which covers the whole state dict, and the port loads the
    bridged dict with strict=True."""
    model = build_model(ref["cfg"])
    sd = model.state_dict()
    leaves = list(_walk(ref["params"]))
    grid = is_grid_tree(p for p, _ in leaves)
    names = [torch_name(path, grid) for path, _ in leaves]
    packed = [n for n in names if n.endswith(("in_proj_weight", "in_proj_bias"))]
    assert all(packed.count(n) == 3 for n in packed)
    bridged = flax_to_torch_state_dict(ref["params"], ref["stats"])
    stat_names = set(bridged) - set(names)
    assert len(stat_names) == len(list(_walk(ref["stats"])))
    assert set(names) | stat_names == set(sd)
    assert len(names) - len(packed) * 2 // 3 + len(stat_names) == len(sd)
    for k, v in sd.items():
        assert tuple(bridged[k].shape) == tuple(v.shape), k
    model.load_state_dict(bridged, strict=True)


def check_param_groups(ref):
    """Each port parameter is in the group make_label_fn gives its leaf."""
    pytest.importorskip("optax")
    from autofocusformermod_tpu.engine.optimizer import make_label_fn

    params = {k: v for k, v in ref["params"].items()}
    labels = dict(_walk(make_label_fn()(params)))
    grid = is_grid_tree(labels)
    got = {name: label for label, named in param_groups(build_model(ref["cfg"])).items()
           for name, _ in named}
    assert {torch_name(path, grid) for path in labels} == set(got)
    for path, label in labels.items():
        assert got[torch_name(path, grid)] == label, (path, label)
    assert {"backbone_default", "backbone_norm", "default", "norm", "embed"} <= set(got.values())
    return got


def check_preset_matches_yaml(preset, yaml_path):
    """The preset equals merge_from_file of the published yaml (over its
    bases and the defaults) on every field it carries; returns the fields."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / yaml_path))
    seen = []

    def walk(node_p, node, path):
        for k, v in node_p.items():
            if isinstance(v, dict):
                walk(v, node[k], path + (k,))
            elif path + (k,) != ("MODEL", "DEVICE"):   # "cuda" here, "tpu" there
                got = node[k]
                seq = (list, tuple)
                assert (list(got) if isinstance(got, seq) else got) == (
                    list(v) if isinstance(v, seq) else v), path + (k,)
                seen.append(".".join(path + (k,)))

    walk(PRESETS[preset](), cfg, ())
    return set(seen)


# ------------------------------------------------------------ this file's model
@pytest.fixture(scope="module")
def ref():
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer

    return jax_reference(tiny_r50_cfg(), jax_maskformer, 64)


@pytest.fixture(scope="module")
def port(ref):
    return port_reference(ref)


def test_r50_levels_use_their_own_grids(ref):
    """The R50's convention that the decoder has to follow: each level's own
    (h, w), positions on the stride-4 canvas, h * w tokens."""
    model = build_model(ref["cfg"])
    feats = model.backbone(torch.zeros(1, 64, 64, 3))
    for i, hw in enumerate([16, 8, 4, 2]):
        f = f"res{i + 2}"
        assert feats[f + "_spatial_shape"] == (hw, hw)
        assert feats[f].shape == (1, hw * hw, 32 * 2 ** i)
        assert feats[f + "_pos"][0, -1].tolist() == [(hw - 1) * 2 ** i] * 2


def test_r50_features_match_jax(ref, port):
    check_features(ref, port)


def test_scale_pos_on_r50_positions_matches_jax(ref):
    """The 4-NN tables and the FPN rescale R50 positions (already on the
    canvas) from each level's own grid to the canvas, as the JAX package does."""
    from autofocusformermod_tpu.models.pixel_decoder import scale_pos as jax_scale_pos

    for f, ss in (("res3", (8, 8)), ("res4", (4, 4)), ("res5", (2, 2))):
        pos = ref["feats"][f + "_pos"]
        for no_bias in (False, True):
            got = scale_pos(torch.from_numpy(pos), ss, (16, 16), no_bias=no_bias).numpy()
            np.testing.assert_array_equal(got, np.asarray(jax_scale_pos(pos, ss, (16, 16),
                                                                        no_bias=no_bias)))


def test_pixel_decoder_on_r50_levels_matches_jax(ref, port):
    """Mask features (the dense-grid PointConv at res2), the encoder's output
    and the three decoder levels, given each package's own R50 features."""
    want_mf, want_mf_pos, want_t0, want_ms, want_poss = ref["pd"]
    got_mf, got_mf_pos, got_t0, got_ms, got_poss = port["pd"]
    assert_close_to_scale(got_mf.numpy(), want_mf, name="mask_features")
    np.testing.assert_array_equal(got_mf_pos.numpy(), want_mf_pos)
    assert_close_to_scale(got_t0.numpy(), want_t0, name="transformer_out")
    for g, w in zip(got_ms, want_ms):
        assert_close_to_scale(g.numpy(), w, name="multi_scale")
    for g, w in zip(got_poss, want_poss):
        np.testing.assert_array_equal(g.numpy(), w)


def test_r50_maskformer_matches_jax(ref, port):
    check_outputs(ref, port)


def test_r50_step_loss_terms_match_jax(ref, port):
    check_loss_terms(ref, port)


def test_r50_step_every_gradient_matches_jax(ref, port):
    """FrozenBN's scale and bias get gradients (they train, as in the JAX
    package); its statistics stay."""
    check_gradients(ref, port)
    assert port["grads"]["backbone.res2.0.conv1.norm.weight"].abs().max() > 0
    stats = port["model"].backbone.res2[0].conv1.norm.running_var
    np.testing.assert_array_equal(stats.numpy(), ref["stats"]["backbone"]["res2_0"]["conv1_norm"]
                                  ["var"])


def test_r50_step_update_matches_optax(ref, port):
    check_update(ref, port)


def test_r50_bridge_covers_every_leaf_and_tensor(ref):
    check_bridge(ref)
    sd = build_model(ref["cfg"]).state_dict()
    assert "backbone.stem.conv1.norm.running_mean" in sd
    assert not any(k.startswith("backbone.") and k.endswith("num_batches_tracked") for k in sd)


def test_r50_param_groups_match_make_label_fn(ref):
    got = check_param_groups(ref)
    model = build_model(ref["cfg"])
    frozen = [n for n, m in model.named_modules() if isinstance(m, FrozenBN)]
    assert len(frozen) == 1 + 16 * 3 + 4
    for n in frozen:
        assert got[n + ".weight"] == got[n + ".bias"] == "backbone_norm"


def test_r50_preset_matches_yaml():
    seen = check_preset_matches_yaml(
        "r50", "configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml")
    assert {"MODEL.BACKBONE.NAME", "MODEL.RESNETS.DEPTH", "MODEL.RESNETS.STRIDE_IN_1X1",
            "MODEL.RESNETS.OUT_FEATURES", "MODEL.AFF.SHEPARD_POWER", "SOLVER.IMS_PER_BATCH",
            "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "INPUT.CROP.SIZE", "TEST.AUG.MIN_SIZES",
            "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME"} <= seen


def test_r50_preset_builds_at_the_published_width():
    model = build_model(PRESETS["r50"]())
    assert isinstance(model.backbone.stem.conv1.norm, FrozenBN)
    assert model.backbone.res5[2].conv3.out_channels == 2048
    assert len(model.backbone.res4) == 6
