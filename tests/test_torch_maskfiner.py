"""The PyTorch port's MaskFiner cascade (semantic inference) against the JAX
package, its preset, its weights bridge and the optimizer's parameter groups.

The tiny cascade of ``tests/test_maskfiner.py`` (3 stages, 64x64, batch 2:
16, 32 and 48 tokens, clusters of 8 with 2-cluster neighbourhoods) is
initialized in JAX, its parameters perturbed with seeded noise (the class
heads by more, so that the queries vote for different classes and the
disagreement that picks the split tokens is not zero), carried over with
``flax_to_torch_state_dict``, and both run the same uint8 images in fp32 on
the CPU.  Tolerance rtol = atol = 1e-4: fp32 summation order over ~15 layers
(measured differences ~2e-5); the last stage's token positions must be
equal.  The JAX side is computed once per module (~20 s).  The ``cuda``
tests hold K1, K3 and K9 at the shapes of the published MaskFiner-Mini's
512x512 forward (``chip_smoke.py`` phase 11 drives the whole forward)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS, maskfiner_mini_cfg
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict, torch_name
from autofocusformermod_torch.engine.optimizer import param_groups
from autofocusformermod_torch.geometry.knn import knn
from autofocusformermod_torch.geometry.rasterize import point2img
from autofocusformermod_torch.geometry.shepard import shepard_neighbours
from autofocusformermod_torch.models.inference import SemanticPredictor
from autofocusformermod_torch.models.maskfiner import gini_disagreement, maskfiner_from_config
from autofocusformermod_torch.models.maskformer import semantic_inference, upsample_masks
from autofocusformermod_torch.models.registry import build_model, size_divisibility
from autofocusformermod_torch.ops.clusten import weighted_gather
from autofocusformermod_torch.ops.dispatch import plain_versions

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
MINI_YAML = "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_mini_bs32_80k.yaml"


def _tiny_cfg():
    from test_maskfiner import tiny_maskfiner_cfg

    return tiny_maskfiner_cfg()


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: (cfg, model, images, params, outputs)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jax_maskfiner

    cfg = _tiny_cfg()
    model = jax_maskfiner(cfg)
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), xf, train=False))()
    rng = np.random.default_rng(1)

    def perturb(path, p):
        scale = 1.0 if "class_embed" in jax.tree_util.keystr(path) else 0.02
        return np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    out = jax.jit(lambda p, im: model.apply({"params": p}, im, train=False))(params, xf)
    return {"cfg": cfg, "model": model, "x": x, "params": params,
            "out": jax.tree.map(np.asarray, out)}


@pytest.fixture(scope="module")
def port(ref):
    model = maskfiner_from_config(ref["cfg"]).eval()
    model.load_state_dict(flax_to_torch_state_dict(ref["params"]), strict=True)
    with torch.no_grad():
        return {"model": model, "out": model(torch.from_numpy(ref["x"]))}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ------------------------------------------------------------ preset and build
def test_maskfiner_mini_preset_matches_yaml():
    """The preset equals merge_from_file of the published config
    (over its two bases and the defaults) on every field it carries."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / MINI_YAML))
    seen = []

    def walk(preset, node, path):
        for k, v in preset.items():
            if isinstance(v, dict):
                walk(v, node[k], path + (k,))
            elif path + (k,) != ("MODEL", "DEVICE"):   # "cuda" here, "tpu" there
                got = node[k]
                seq = (list, tuple)
                assert (list(got) if isinstance(got, seq) else got) == (
                    list(v) if isinstance(v, seq) else v), path + (k,)
                seen.append(".".join(path + (k,)))

    walk(maskfiner_mini_cfg(), cfg, ())
    assert {"MODEL.META_ARCHITECTURE", "MODEL.MR.DEPTHS", "MODEL.MR_SEM_SEG_HEAD.CONVS_DIM",
            "MODEL.MASK_FINER.DEC_LAYERS", "SOLVER.AMP.ENABLED"} <= set(seen)
    # what the cascade's training step reads
    assert {f"MODEL.MASK_FINER.{k}" for k in (
        "DEEP_SUPERVISION", "NO_OBJECT_WEIGHT", "CLASS_WEIGHT", "MASK_WEIGHT", "DICE_WEIGHT",
        "TRAIN_NUM_POINTS", "OVERSAMPLE_RATIO", "IMPORTANCE_SAMPLE_RATIO", "UPSAMPLING_WEIGHT",
        "DROPOUT")} | {"MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE",
                       "TPU.MAX_GT_INSTANCES"} <= set(seen)
    assert {"DATASETS.TRAIN", "DATASETS.TEST", "INPUT.MIN_SIZE_TRAIN", "INPUT.MAX_SIZE_TEST",
            "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "INPUT.COLOR_AUG_SSD", "INPUT.SIZE_DIVISIBILITY",
            "INPUT.DATASET_MAPPER_NAME", "TEST.EVAL_PERIOD", "TEST.EXPECTED_RESULTS",
            "TEST.AUG.MIN_SIZES", "TEST.SW_CROP_SIZE", "TEST.SAVE_EVAL_ARTIFACTS",
            "DATALOADER.NUM_WORKERS", "MODEL.SEM_SEG_HEAD.IGNORE_VALUE"} <= set(seen)
    # the cascade's base yaml sets its own multi-scale test sizes; the AFF presets keep the defaults
    aug = maskfiner_mini_cfg().TEST.AUG
    assert (aug.MIN_SIZES, aug.MAX_SIZE) == ([256, 384, 512, 640, 768, 896], 3584)
    assert PRESETS["aff_mini"]().TEST.AUG.MAX_SIZE == 4000


def test_published_cascade_builds():
    """The published MaskFiner-Mini: 4 stages, depths [2, 2, 8, 12],
    CONVS_DIM [512, 256, 128, 128], DEC_LAYERS [3, 3, 4, 9]; the registry
    dispatches on META_ARCHITECTURE and pads to the coarsest patch."""
    cfg = PRESETS["maskfiner_mini"]()
    model = build_model(cfg)
    stages = model.mask_predictors
    assert len(stages) == 4
    assert [len(s.backbone.blocks) for s in stages[:1]] == [2]
    assert [len(s.backbone.layers.blocks) for s in stages[1:]] == [2, 8, 12]
    assert [s.pixel_decoder.conv_dim for s in stages] == [512, 256, 128, 128]
    assert [len(s.pixel_decoder.transformer.encoder.layers) for s in stages] == [1, 2, 4, 6]
    assert [len(s.mask_decoder.transformer_ffn_layers) + 1 for s in stages] == [3, 3, 4, 9]
    assert [s.mask_decoder.num_feature_levels for s in stages] == [1, 2, 3, 4]
    assert size_divisibility(cfg) == 32
    assert type(build_model(PRESETS["aff_mini"]())).__name__ == "MaskFormer"


def test_train_net_trains_the_cascade(tmp_path):
    """``train_net --config maskfiner_mini`` trains the published cascade on
    the CPU (one step at 128x128, batch 1: stages of 16, 48, 112 and 240
    tokens, the clustered ones at least NBHD_SIZE): 3 loss terms for each of
    its 19 outputs, all finite, and a checkpoint with the model, the AdamW
    moments of every parameter and the schedule."""
    import json

    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.engine.checkpoint import Checkpointer

    trainer = train_net.main(["--config", "maskfiner_mini", "--device", "cpu", "--synthetic",
                              "--max-iter", "1", "INPUT.CROP.SIZE", "[128, 128]",
                              "SOLVER.IMS_PER_BATCH", "1", "OUTPUT_DIR", str(tmp_path)])
    metrics = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1]
    terms = {k: v for k, v in metrics[0].items() if k.startswith("loss_")}
    assert len(terms) == 3 * 19 and "loss_dice_17" in terms and "loss_ce_18" not in terms
    assert all(np.isfinite(v) for v in terms.values()) and np.isfinite(metrics[0]["grad_norm"])
    state = Checkpointer(str(tmp_path / "checkpoints")).restore()
    assert state["step"] == 1 and state["scheduler"]["last_epoch"] == 1
    n_params = sum(1 for _ in trainer.model.parameters())
    moments = state["optimizer"]["state"]
    assert len(moments) == n_params and all(int(m["step"]) == 1 for m in moments.values())
    assert set(state["model"]) == set(trainer.model.state_dict())


@pytest.mark.parametrize("field, value", [
    ("MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME", "MultiScaleMaskFinerTransformerDecoderCat"),
    ("MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME", "MSDeformAttnPixelDecoderMaskFinerHierUp"),
    ("MODEL.MASK_FINER.PRE_NORM", "True"),
    ("MODEL.MASK_FINER.MASK_DECODER_ALL_LEVELS", "True"),
])
def test_unported_variants_raise(field, value):
    """The variants that once raised build from the preset, with the field
    read where JAX reads it (their forwards are held to JAX in
    ``test_torch_variants.py``): the Cat decoder on every stage, the HierUp
    form of the last stage's pixel decoder (the others take the default
    decoder's name), the pre-norm decoder layers, and mask features on every
    stage under MASK_DECODER_ALL_LEVELS."""
    cfg = maskfiner_mini_cfg()
    cfg.merge_from_list([field, value])
    model = maskfiner_from_config(cfg)
    stages = model.mask_predictors
    decoders = [p.mask_decoder for p in stages]
    if value.endswith("Cat"):
        assert all(d.cat_features for d in decoders)
    elif value.endswith("HierUp"):
        assert all(p.pixel_decoder.hierup for p in stages)
        assert [p.pixel_decoder.mask_features is not None for p in stages] == [False] * (
            len(stages) - 1) + [True]
    elif field.endswith("PRE_NORM"):
        assert all(layer.pre_norm for d in decoders
                   for layer in d.transformer_self_attention_layers)
    else:
        assert all(p.pixel_decoder.mask_features is not None for p in stages)


# ------------------------------------------------------------ the bridge
def test_bridge_covers_every_leaf_and_tensor(ref):
    """Every JAX leaf lands on exactly one port tensor (an attention layer's
    three projections on its one packed in-projection), and every port
    parameter and buffer is covered."""
    model = maskfiner_from_config(ref["cfg"])
    sd = model.state_dict()
    names = [torch_name(path) for path, _ in _walk(ref["params"])]
    assert set(names) == set(sd)
    packed = [n for n in names if n.endswith(("in_proj_weight", "in_proj_bias"))]
    assert all(packed.count(n) == 3 for n in packed)
    assert len(names) - len(packed) * 2 // 3 == len(sd)
    bridged = flax_to_torch_state_dict(ref["params"])
    for k, v in sd.items():
        assert tuple(bridged[k].shape) == tuple(v.shape), k


# ------------------------------------------------------------ the cascade
@pytest.mark.parametrize("key", ["pred_logits", "pred_masks"])
def test_tiny_cascade_matches_jax(ref, port, key):
    assert port["out"][key].shape == ref["out"][key].shape
    np.testing.assert_allclose(port["out"][key].numpy(), ref["out"][key], **TOL)


def test_tiny_cascade_aux_outputs_match_jax(ref, port):
    assert len(port["out"]["aux_outputs"]) == len(ref["out"]["aux_outputs"]) == 6
    for a, r in zip(port["out"]["aux_outputs"], ref["out"]["aux_outputs"]):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(a[key].numpy(), r[key], **TOL)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_tiny_cascade_disagreement_matches_jax(ref, port, stage):
    got = port["out"]["disagreement_masks"][stage].numpy()
    want = ref["out"]["disagreement_masks"][stage]
    assert got.shape == want.shape and want.max() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_tiny_cascade_positions_equal_jax(ref, port):
    """Equal (scale, x, y) of the last stage's tokens = the same tokens split
    in the same order at every stage."""
    np.testing.assert_array_equal(port["out"]["features_pos"].numpy(), ref["out"]["features_pos"])


def test_predictor_serves_the_tiny_cascade(ref, port):
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import maskformer as jm

    rmasks = jm.upsample_masks(jnp.asarray(ref["out"]["pred_masks"]), (64, 64))
    rsem = np.stack([np.asarray(jm.semantic_inference(jnp.asarray(logits), m))
                     for logits, m in zip(ref["out"]["pred_logits"], rmasks)])
    sem = semantic_inference(port["out"]["pred_logits"],
                             upsample_masks(port["out"]["pred_masks"], (64, 64)))
    np.testing.assert_allclose(sem.numpy(), rsem, **TOL)
    predictor = SemanticPredictor(port["model"], size_divisibility(ref["cfg"]))
    labels = predictor(ref["x"])
    assert labels.shape == (2, 64, 64)
    assert labels.min() >= 0 and labels.max() < ref["cfg"].MODEL.MR_SEM_SEG_HEAD.NUM_CLASSES
    np.testing.assert_array_equal(labels.numpy(), rsem.argmax(1))


# ------------------------------------------------------------ units
def test_point2img_matches_jax_and_is_a_reshape_on_the_full_canvas():
    from autofocusformermod_tpu.geometry.rasterize import point2img as jax_point2img

    rng = np.random.default_rng(2)
    h, w = 6, 5
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    raster = np.stack([xs, ys], 2).reshape(1, -1, 2).astype(np.float32).repeat(2, 0)
    x = rng.standard_normal((2, 3, h * w)).astype(np.float32)
    got = point2img(torch.from_numpy(x), torch.from_numpy(raster), (h, w))
    torch.testing.assert_close(got, torch.from_numpy(x).reshape(2, 3, h, w), rtol=0, atol=0)
    perm = np.stack([rng.permutation(h * w) for _ in range(2)])
    shuffled = np.take_along_axis(raster, perm[..., None], 1)
    got = point2img(torch.from_numpy(x), torch.from_numpy(shuffled), (h, w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_point2img(x, shuffled, (h, w))))


def test_gini_disagreement_matches_jax():
    """Random logits, and queries voting for one class (zero impurity) with
    exact ties in the class logits (argmax to the lower index)."""
    from autofocusformermod_tpu.models.maskfiner import gini_disagreement as jax_gini

    rng = np.random.default_rng(3)
    masks = rng.standard_normal((2, 6, 20)).astype(np.float32)
    cls = rng.standard_normal((2, 6, 9)).astype(np.float32)
    cls[1, :, 4] = cls[1, :, 2] = 5.0                     # ties: class 2 wins
    got = gini_disagreement(torch.from_numpy(masks), torch.from_numpy(cls)).numpy()
    want = np.asarray(jax_gini(masks, cls))
    np.testing.assert_allclose(got, want, **TOL)
    assert want[0].max() > 0
    np.testing.assert_allclose(got[1], 0.0, atol=1e-6)


def test_split_tokens_order_and_ties_match_jax(ref, port):
    """The top k by disagreement are split in ascending order, the rest kept
    in ascending order; equal scores go by index, as jnp.argsort."""
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 24, 32)).astype(np.float32)
    pos = np.concatenate([np.ones((2, 24, 1)), rng.integers(0, 16, (2, 24, 2))], 2).astype(
        np.float32)
    scores = rng.integers(0, 4, (2, 24)).astype(np.float32) / 4         # many exact ties
    want = ref["model"].mask_predictors[1].backbone._split_tokens(feat, pos, scores, 7)
    got = port["model"].mask_predictors[1].backbone._split_tokens(
        *(torch.from_numpy(a) for a in (feat, pos, scores)), 7)
    for a, r in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_pointconv_knn_route_matches_jax(ref, port):
    """PointConv on a mixed-scale lattice point cloud (no grid: the 9-NN
    route, full of exact distance ties) with the last stage's weights."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.pixel_decoder import PointConv as JaxPointConv

    rng = np.random.default_rng(5)
    coarse = np.stack(np.meshgrid(np.arange(0, 16, 4), np.arange(0, 16, 4)), -1).reshape(-1, 2)
    fine = rng.integers(0, 16, (24, 2))
    pos = np.concatenate([coarse + 1.5, fine], 0)[None].repeat(2, 0).astype(np.float32)
    x = rng.standard_normal((2, pos.shape[1], 32)).astype(np.float32)
    p = ref["params"]["mask_predictors_2"]["pixel_decoder"]["layer_1_pointconv"]
    want = JaxPointConv(32).apply({"params": p}, jnp.asarray(x), jnp.asarray(pos))
    got = port["model"].mask_predictors[2].pixel_decoder.layer_1[0](
        torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_overlap_patch_embedding_matches_jax(ref, port):
    """Stage 0's stride-2 conv blocks with GroupNorm(1) (flax's epsilon 1e-6)
    and the output LayerNorm."""
    from autofocusformermod_tpu.models.mixres import OverlapPatchEmbedding as JaxEmbed

    im = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32) * 3
    p = ref["params"]["mask_predictors_0"]["backbone"]["patch_embed"]
    want = JaxEmbed(16, 32).apply({"params": p}, im)
    got = port["model"].mask_predictors[0].backbone.patch_embed(torch.from_numpy(im))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_add_high_res_feat_matches_jax(ref, port):
    """The raw pixels under each new token, (dy, dx, rgb) ordered and clamped
    into the image, projected and added (stage 1's weights)."""
    import flax.linen as nn

    from autofocusformermod_tpu.models.mixres import MixResNeighbour

    class Probe(MixResNeighbour):
        @nn.compact
        def __call__(self, tokens, pos_xy, im):
            return self._add_high_res_feat(tokens, pos_xy, im)

    stage = ref["model"].mask_predictors[1].backbone
    kw = {f.name: getattr(stage, f.name) for f in dataclasses.fields(stage)
          if f.init and f.name not in ("parent", "name")}
    p = ref["params"]["mask_predictors_1"]["backbone"]
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((2, 12, 32)).astype(np.float32)
    pos_xy = rng.integers(0, 17, (2, 12, 2)).astype(np.float32)       # 16 lies off the image
    im = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    sub = {k: p[k] for k in ("image_patch_projection", "high_res_norm1", "high_res_mlp",
                             "high_res_norm2")}
    want = Probe(**kw).apply({"params": sub}, tokens, pos_xy, im)
    got = port["model"].mask_predictors[1].backbone._add_high_res_feat(
        *(torch.from_numpy(a) for a in (tokens, pos_xy, im)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_cached_shepard_neighbours_match_per_round_upsamples():
    """One shepard_neighbours call reused for several features equals the JAX
    decoder's upsample_feature_shepard in every round (lattice positions:
    exact distance ties, broken by index)."""
    from autofocusformermod_tpu.geometry.shepard import upsample_feature_shepard as jax_up

    rng = np.random.default_rng(8)
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    grid = np.stack([xs, ys], 2).reshape(1, -1, 2).astype(np.float32).repeat(2, 0)
    db = np.concatenate([rng.integers(0, 8, (2, 30, 2)) * 2, rng.integers(0, 16, (2, 10, 2))],
                        1).astype(np.float32) + 0.5
    cached = shepard_neighbours(torch.from_numpy(grid), torch.from_numpy(db))
    for _ in range(3):
        f = rng.standard_normal((2, 40, 5)).astype(np.float32)
        got = weighted_gather(*cached, torch.from_numpy(f))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_up(grid, db, f)), **TOL)


# ------------------------------------------------------------ optimizer groups
def _jax_params_shape(which):
    import jax
    import jax.numpy as jnp

    if which == "maskfiner":
        from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jax_build

        cfg, size = _tiny_cfg(), 64
    else:
        from autofocusformermod_tpu.models import maskformer_from_config as jax_build
        from test_torch_model import tiny_cfg

        cfg, size = tiny_cfg(), 128
    model = jax_build(cfg)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    return cfg, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))["params"]


@pytest.mark.parametrize("which", ["maskfiner", "maskformer"])
def test_param_groups_match_make_label_fn(which):
    """Every leaf of the JAX tree, carried through the bridge's names, is in
    the port's group that make_label_fn gives it (the cascade's backbones lie
    under mask_predictors.{i}.backbone; its patch embedding has GroupNorms)."""
    pytest.importorskip("optax")
    from autofocusformermod_tpu.engine.optimizer import make_label_fn

    cfg, shapes = _jax_params_shape(which)
    labels = dict(_walk(make_label_fn()(jax_tree_to_dict(shapes))))
    model = maskfiner_from_config(cfg) if which == "maskfiner" else _maskformer(cfg)
    got = {name: label for label, named in param_groups(model).items() for name, _ in named}
    assert {torch_name(path) for path in labels} == set(got)
    for path, label in labels.items():
        assert got[torch_name(path)] == label, (path, label, got[torch_name(path)])
    assert {"backbone_default", "backbone_norm", "default", "norm", "embed"} <= set(got.values())


def jax_tree_to_dict(tree):
    return {k: jax_tree_to_dict(v) if hasattr(v, "items") else v for k, v in tree.items()}


def _maskformer(cfg):
    from autofocusformermod_torch.models.maskformer import maskformer_from_config

    return maskformer_from_config(cfg)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lattice_tokens(gen, b, counts):
    """Mixed-scale token positions on MaskFiner-Mini's 128x128 min-patch
    canvas at 512x512: per scale s (patch 32 >> s) `counts[s]` distinct cells
    of its grid, step 8 >> s."""
    parts = []
    for s, cnt in enumerate(counts):
        step = 8 >> s
        side = 128 // step
        cells = torch.stack([torch.randperm(side * side, generator=gen)[:cnt] for _ in range(b)])
        parts.append(torch.stack([cells % side, cells // side], -1).float() * step)
    return torch.cat(parts, 1)


# the stages' token counts per scale at 512x512 (stages 1-3)
MINI_STAGES = ((256, 512), (256, 512, 1024), (256, 512, 1024, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_local_attn_on_mixed_scale_clouds_on_card(cuda, stage):
    """K1 at a MaskFiner-Mini stage's shape (n 768 / 1792 / 3840, heads of
    16 channels, 6 neighbour clusters of 8) on a clustered mixed-scale cloud."""
    from autofocusformermod_torch.geometry.cluster import space_filling_cluster
    from autofocusformermod_torch.ops.local_attn import sfc_cluster_attention

    gen = torch.Generator().manual_seed(stage)
    b, h, c_ = 2, (16, 8, 4)[stage - 1], 16
    pos, means, _, _, _ = space_filling_cluster(_lattice_tokens(gen, b, MINI_STAGES[stage - 1]),
                                                8, 128, 128)
    n = pos.shape[1]
    nc = knn(pos.to(cuda), means.to(cuda), 6)
    q, k, v = (torch.randn((b, h, n, c_), generator=gen).to(cuda) for _ in range(3))
    w5, b5, bk = (torch.randn(s, generator=gen).to(cuda) * 0.1 for s in ((h, 5), (h,), (h, c_)))
    args = (q * c_ ** -0.5, k, v, pos.to(cuda).contiguous(), nc, w5, b5, bk, 8)
    got = sfc_cluster_attention(*args)
    with plain_versions():
        want = sfc_cluster_attention(*args)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("levels, c_, heads", [((256,), 32, 16), ((256, 512), 32, 8),
                                                ((256, 512, 1024), 16, 8)])
def test_msdetrpc_at_cascade_operands_on_card(cuda, levels, c_, heads):
    """K3 at the cascade's (levels, pairs, channels): one level of 16 pairs
    over the 512-wide stage-0 table (16 heads of 32), two levels of 32
    pairs, three of 48 at 16 channels."""
    from autofocusformermod_torch.ops.msdetrpc import msdetrpc_levels_s

    gen = torch.Generator().manual_seed(len(levels))
    bh, p = 2 * heads, 16
    val = torch.randn((bh, sum(levels), c_), generator=gen).to(cuda)
    for n in levels:
        idx = torch.cat([torch.randint(0, s, (bh, n, p), generator=gen) for s in levels], 2)
        w = torch.rand((bh, n, p * len(levels)), generator=gen)
        args = (idx.int().to(cuda).contiguous(), w.to(cuda), val, levels)
        got = msdetrpc_levels_s(*args)
        with plain_versions():
            want = msdetrpc_levels_s(*args)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid_to_stage3", "self_k9"])
def test_knn_at_cascade_operands_on_card(cuda, case):
    """K9 from the 128x128 grid to a centred mixed-scale token set (the 4-NN
    tables), and self-knn with k 9 on lattice positions (PointConv): exact
    ties everywhere; indices and distances equal the plain version's."""
    from autofocusformermod_torch.geometry.knn import knn_plain

    gen = torch.Generator().manual_seed(9)
    if case == "grid_to_stage3":
        ys, xs = torch.meshgrid(torch.arange(128), torch.arange(128), indexing="ij")
        query = torch.stack([xs, ys], -1).reshape(1, -1, 2).float().expand(2, -1, -1)
        db, k = _lattice_tokens(gen, 2, (0, 0, 1024)) + 0.5, 4
    else:
        query = db = _lattice_tokens(gen, 2, (0, 0, 0, 2048))
        k = 9
    query, db = query.contiguous().to(cuda), db.contiguous().to(cuda)
    got = knn(query, db, k, return_dist=True)
    want_idx, want_d2 = knn_plain(query, db, k)
    assert torch.equal(got[0], want_idx)
    assert torch.equal(got[1], torch.sqrt(want_d2))
