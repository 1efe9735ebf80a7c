"""The PyTorch port's OracleTeacher-BB cascade against the JAX package: the
GT-edge oracle, ``MLPDeepNorm``, ``UpDownBackbone`` (with and without
ground truth, and down-only), ``hierarchical_upsample_dense``, the dense
decoder, ``MaskFinerOracleTeacherBB``'s forward, one training step against
``make_maskfiner_train_step(needs_sem_seg_gt=True)``, MixResViT with
DropPath and layer scale, the presets and the published yamls' builds.

The tiny model is ``tests/test_updown.py:small_updown``'s shape (3 scales,
5 stages of patches 16, 8, 4, 8, 16 at 64x64, batch 2: streams of 16, 48
and 112 tokens, clusters of 8 with 2-cluster neighbourhoods), here with
stage widths 32, 24, 16, 24, 32 so that every concatenation's width is
checked, under a final-stage head over res2-res4 with the dense
OracleTeacher decoder.  It is initialised in JAX once (one module fixture),
its parameters perturbed with seeded noise (the class head by more) and
carried over with ``flax_to_torch_state_dict``.  Inputs are made from
numpy seeds; the label maps hold void (255) pixels.  Tolerances: forward
outputs within 1e-4 of their largest entry (fp32 summation order), loss
terms 1e-5 relative, gradient norms per parameter group 1e-4 relative.
The teacher's draws differ between JAX and torch, so the cases run at
ORACLE_TEACHER_RATIO 0 and 1 (where both draw the same) or pass the draw
in.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict, torch_name
from autofocusformermod_torch.models import oracle as toracle
from autofocusformermod_torch.models.registry import build_model

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

B, SIZE = 2, 64
REL = 1e-4
REPO = Path(__file__).resolve().parents[1]
ADE = "configs/ade20k/semantic-segmentation/maskfiner/"


def tiny_cfg(ratio=0.0):
    """The tiny OracleTeacher-BB cascade (JAX CfgNode)."""
    from autofocusformermod_tpu.config import add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_maskformer2_config(cfg)
    cfg.MODEL.META_ARCHITECTURE = "MaskFinerOracleTeacherBB"
    cfg.MODEL.BACKBONE.NAME = "UpDownBackbone"
    mr = cfg.MODEL.MR
    mr.NAME = ["MixResViT", "MixResNeighbour", "MixResNeighbour", "MixResNeighbour",
               "MixResViT"]
    mr.EMBED_DIM = [32, 24, 16, 24, 32]
    mr.DEPTHS = [1, 1, 1, 1, 1]
    mr.NUM_HEADS = [2, 2, 2, 2, 2]
    mr.PATCH_SIZES = [16, 8, 4, 8, 16]
    mr.MLP_RATIO = [1.0] * 5
    mr.DROP_RATE = [0.0] * 5
    mr.ATTN_DROP_RATE = [0.0] * 5
    mr.DROP_PATH_RATE = 0.0
    mr.UPSCALE_RATIO = [0.0, 0.5, 0.5, 0.0, 0.0]
    mr.SPLIT_RATIO = [4] * 5
    mr.CLUSTER_SIZE = [8] * 5
    mr.NBHD_SIZE = [16] * 5
    head = cfg.MODEL.MR_SEM_SEG_HEAD
    head.NUM_CLASSES = 7
    head.IN_FEATURES = ["res2", "res3", "res4"]
    head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES = ["res3", "res4"]
    head.CONVS_DIM = [32, 32, 32]
    head.TRANSFORMER_ENC_LAYERS = [1, 1, 1]
    head.NHEADS = [2, 2, 2]
    head.MLP_RATIO = [1.0, 1.0, 1.0]
    head.PIXEL_DECODER_NAME = ["ProjMaskFinerOracleTeacher", "ProjMaskFinerOracleTeacher",
                               "MSDeformAttnPixelDecoderMaskFiner"]
    mf = cfg.MODEL.MASK_FINER
    mf.NUM_RESOLUTION_SCALES = 3
    mf.TRANSFORMER_DECODER_NAME = "MultiScaleMaskFinerTransformerDecoderOracleTeacher"
    mf.HIDDEN_DIM = [32, 32, 32]
    mf.MASK_DIM = [32, 32, 32]
    mf.NHEADS = [2, 2, 2]
    mf.DIM_FEEDFORWARD = [32, 32, 32]
    mf.DEC_LAYERS = [3, 3, 4]
    mf.DECODER_LEVELS = [1, 2, 2]
    mf.NUM_OBJECT_QUERIES = 5
    mf.ORACLE_TEACHER_RATIO = ratio
    mf.CLASS_WEIGHT, mf.MASK_WEIGHT, mf.DICE_WEIGHT, mf.NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1
    mf.TRAIN_NUM_POINTS = 64
    mf.UPSAMPLING_WEIGHT = 10
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    return cfg


def label_maps(rng, b=B, size=SIZE, nc=7):
    """Blocky label maps of 2-3 classes each with a void (255) band."""
    sem = np.zeros((b, size, size), np.uint8)
    for i in range(b):
        classes = rng.choice(nc, 3 - i, replace=False)
        sem[i] = np.kron(rng.choice(classes, (4, 4)), np.ones((size // 4, size // 4)))
    sem[:, 20:26, :] = 255
    sem[0, :, 40:43] = 255
    return sem


def _close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} against largest |entry| {scale}"


def torch_to_flax(shapes, sd):
    """The JAX parameter tree of the structure ``shapes`` (leaves with a
    .shape) filled from the port's state dict ``sd``: the inverse of
    ``flax_to_torch_state_dict`` (kernels transposed back, an attention
    layer's packed in-projection split into its three)."""
    import jax

    mha = ("q_proj", "k_proj", "v_proj")

    def leaf(path, s):
        keys = tuple(p.key for p in path)
        *mod, name = keys
        v = sd[torch_name(keys)].numpy()
        if name in ("kernel", "bias") and mod[-1] in mha:
            c = s.shape[-1]
            i = mha.index(mod[-1])
            v = v[i * c:(i + 1) * c]
            v = v.T if name == "kernel" else v
        elif name == "kernel":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        assert v.shape == tuple(s.shape), (keys, v.shape, s.shape)
        return np.ascontiguousarray(v)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def seeded_port(cfg):
    """The port model of ``cfg`` from a torch seed, the class head perturbed
    by more (so that queries vote for different classes)."""
    torch.manual_seed(0)
    model = build_model(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name:
                p.add_(torch.randn(p.shape))
    return model


def step_batch(x, gt, slots=4):
    """A training batch of the images and label maps: per image its
    classes (void excluded) in the first target slots."""
    labels = np.zeros((len(gt), slots), np.int64)
    valid = np.zeros((len(gt), slots), bool)
    for i, g in enumerate(gt):
        present = [c for c in np.unique(g) if c != 255]
        labels[i, :len(present)] = present
        valid[i, :len(present)] = True
    return {"image": x, "sem_seg_map": gt, "labels": labels, "valid": valid}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, made once: the tiny cascade's parameter tree (by
    jax.eval_shape, filled from the port's seeded weights), its eval
    forward with ground truth, its backbone in eval mode, in train mode at
    ratio 1 and down-only, the dense decoder on random levels, and one
    training step."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import optax

    from autofocusformermod_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
    from autofocusformermod_tpu.models.maskfiner import build_stage_mask_decoder as jdecoder
    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY
    from autofocusformermod_tpu.models.updown import updown_from_config as jupdown
    from autofocusformermod_tpu.parallel.train_step import TrainState, make_maskfiner_train_step

    from test_torch_maskfiner_train import _record_grads, jax_group_draws

    cfg = tiny_cfg()
    model = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    gt = label_maps(rng)
    xf, gtj = jnp.asarray(x.astype(np.float32)), jnp.asarray(gt.astype(np.int32))
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                                "oracle": jax.random.PRNGKey(1)}, xf, gtj))
    port_model = seeded_port(cfg)
    sd = {k: v.detach().clone() for k, v in port_model.state_dict().items()}
    params = torch_to_flax(shapes["params"], sd)
    keys = {"oracle": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}

    # the backbone's three forms, the dense decoder on random levels
    bb_eval, bb_train = jupdown(cfg), jupdown(tiny_cfg(1.0))
    down_cfg = tiny_cfg()
    for key in ("NAME", "EMBED_DIM", "DEPTHS", "NUM_HEADS", "PATCH_SIZES", "MLP_RATIO",
                "DROP_RATE", "ATTN_DROP_RATE", "UPSCALE_RATIO", "SPLIT_RATIO",
                "CLUSTER_SIZE", "NBHD_SIZE"):
        setattr(down_cfg.MODEL.MR, key, list(getattr(down_cfg.MODEL.MR, key))[:3])
    bb_down = jupdown(down_cfg, down_only=True)
    down_params = {k: v for k, v in params["backbone"].items()
                   if k in ("backbones_0", "backbones_1", "backbones_2", "upsamplers_0",
                            "upsamplers_1")}
    dec_in = dense_decoder_inputs(np.random.default_rng(6))
    jdec = jdecoder(cfg, 2, final=True)
    mean, std = np.array(cfg.MODEL.PIXEL_MEAN), np.array(cfg.MODEL.PIXEL_STD)
    xn = jnp.asarray(((x - mean) / std).astype(np.float32))

    def forwards(p):
        return {"out": model.apply({"params": p}, xf, gtj, train=False),
                "bb_eval": bb_eval.apply({"params": p["backbone"]}, xn, gtj, train=False),
                "bb_train1": bb_train.apply({"params": p["backbone"]}, xn, gtj, train=True,
                                            rngs=keys),
                "bb_down": bb_down.apply({"params": {k: p["backbone"][k] for k in down_params}},
                                         xn, gtj, train=False),
                "decoder": jdec.apply({"params": p["mask_decoder"]},
                                      *[[jnp.asarray(a) for a in v] if isinstance(v, list)
                                        else jnp.asarray(v) for v in dec_in[:4]], *dec_in[4:])}

    outs = jax.tree.map(np.asarray, jax.jit(forwards)(params))

    # one training step
    batch = step_batch(x, gt)
    tx = optax.chain(_record_grads(), jax_build_optimizer(cfg, params))
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
    new_state, metrics = step(TrainState.create(params, {}, tx), jbatch, key)
    _, _, k_crit = jax.random.split(key, 3)
    n_out = 1 + len(outs["out"]["aux_outputs"])
    return {"cfg": cfg, "x": x, "gt": gt, "sd": sd, "params": params, "shapes": shapes,
            "dec_in": dec_in, **outs, "batch": batch,
            "draws": jax_group_draws(k_crit, [(16, 16)] * n_out, B, 4, mf.TRAIN_NUM_POINTS),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state[0])}


def dense_decoder_inputs(rng):
    """Random levels for the dense decoder alone: 16, 32 and 64 tokens at
    distinct cells of the 16x16 canvas's 4-, 2- and 1-grids, 32 wide, their
    mask features, (16, 16) and the levels' grid shapes."""
    grids = [np.stack(np.meshgrid(np.arange(0, 16, s), np.arange(0, 16, s)), -1).reshape(-1, 2)
             for s in (4, 2, 1)]
    pos = [np.stack([g[rng.permutation(len(g))[:n]] for _ in range(B)]).astype(np.float32)
           for g, n in zip(grids, (16, 32, 64))]
    x = [rng.standard_normal((B, p.shape[1], 32)).astype(np.float32) for p in pos]
    mf = rng.standard_normal((B, 112, 32)).astype(np.float32)
    return [x, pos, mf, np.concatenate(pos, 1), (16, 16), [(4, 4), (8, 8), (16, 16)]]


@pytest.fixture(scope="module")
def port(ref):
    model = build_model(ref["cfg"]).eval()
    model.load_state_dict(ref["sd"], strict=True)
    x, gt = torch.from_numpy(ref["x"]), torch.from_numpy(ref["gt"])
    with torch.no_grad():
        return {"model": model, "out": model(x, gt), "out_no_gt": model(x)}


# ------------------------------------------------------------------ forward
def test_forward_matches_jax(ref, port):
    """pred_logits, pred_masks (16x16: the dense decoder's grid), every aux
    output, and each down stage's upsampling score and oracle."""
    got, want = port["out"], ref["out"]
    assert tuple(got["pred_masks"].shape) == (B, 5, 16, 16)
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            _close(a[key], w[key], what=f"aux {i} {key}")
    for key in ("upsampling_preds", "upsampling_oracles"):
        assert len(got[key]) == len(want[key]) == 2
        for i, (a, w) in enumerate(zip(got[key], want[key])):
            _close(a, w, what=f"{key} {i}")
    assert [tuple(p.shape) for p in got["upsampling_preds"]] == [(B, 16), (B, 32)]
    assert 0 < float(np.asarray(want["upsampling_oracles"][1]).mean()) < 1


def test_forward_without_ground_truth(ref, port):
    """Without ground truth no oracle is made; in eval mode the rest is the
    forward with it."""
    got, want = port["out_no_gt"], ref["out"]
    assert got["upsampling_oracles"] == ()
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    for a, w in zip(got["upsampling_preds"], want["upsampling_preds"]):
        _close(a, w, what="upsampling_preds")


def test_predictor_and_refusals(ref, port):
    """SemanticPredictor pads a request to the coarsest patch's multiple
    and labels every pixel; a composite backbone that is not ported (an MRML
    one) raises before anything is built, while the stage names that once
    raised (XAttn and ConvNeXtV2 past stage 0) build; the head's variants
    that once raised build: the HierUp pixel decoder, the projection pixel decoder
    under the plain stage head (mask features: the head is the final
    stage's) and the Cat decoder (the lrelu pixel decoder keeps its
    mask-features head under both stage heads)."""
    from autofocusformermod_torch.models.inference import SemanticPredictor
    from autofocusformermod_torch.models.registry import size_divisibility

    assert size_divisibility(ref["cfg"]) == 32
    labels = SemanticPredictor(port["model"], size_divisibility(ref["cfg"]))(ref["x"][:, :50, :60])
    assert tuple(labels.shape) == (B, 50, 60) and 0 <= labels.min() and labels.max() < 7
    ot_decoders = ["ProjMaskFinerOracleTeacher"] * 2 + [
        "MSDeformAttnPixelDecoderMaskFinerOracleTeacher"]
    for fields in ({"MODEL.BACKBONE.NAME": "MixResMetaLoss"},
                   {"MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME":
                    ot_decoders[:2] + ["MSDeformAttnPixelDecoderMaskFinerHierUp"]},
                   {"MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME":
                    ot_decoders[:2] + ["ProjMaskFinerOracleTeacher"],
                    "MODEL.MR_SEM_SEG_HEAD.NAME": "MaskPredictor"},
                   {"MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME":
                    "MultiScaleMaskFinerTransformerDecoderCat"},
                   {"MODEL.MR.NAME": ["MixResViT", "MixResNeighbourXAttn", "ConvNeXtV2",
                                      "MixResNeighbourXAttn", "ConvNeXtV2"]}):
        cfg = tiny_cfg()
        for field, value in fields.items():
            *parents, leaf = field.split(".")
            node = cfg
            for name in parents:
                node = getattr(node, name)
            setattr(node, leaf, value)
        if "MODEL.BACKBONE.NAME" in fields:
            with pytest.raises(NotImplementedError, match="ported"):
                build_model(cfg)
            continue
        model = build_model(cfg)
        assert model.pixel_decoder.mask_features is not None
        name = cfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME[-1]
        assert getattr(model.pixel_decoder, "hierup", False) == name.endswith("HierUp")
        assert model.mask_decoder.cat_features == ("MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME"
                                                   in fields)
    cfg = tiny_cfg()
    cfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME = ot_decoders
    cfg.MODEL.MR_SEM_SEG_HEAD.NAME = "MaskPredictor"
    assert build_model(cfg).pixel_decoder.mask_features is not None


def test_updown_names_past_stage_0_build_as_jax(ref, port):
    """JAX's UpDown reads MR.NAME at stage 0 (MixResViT, asserted) and at
    the up stages (MixResViT: global attention; any other name: cluster
    attention), and builds a MixResNeighbour for every later down stage:
    with XAttn and ConvNeXtV2 names past stage 0 the port builds JAX's tree
    (its parameter names and shapes through the bridge) and, on the same
    weights, the forward of the default names; a first stage other than
    MixResViT raises."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    cfg = tiny_cfg()
    cfg.MODEL.MR.NAME = ["MixResViT", "MixResNeighbourXAttn", "ConvNeXtV2", "ConvNeXtV2",
                         "MixResViT"]
    jmodel = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
    xf = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                                 "oracle": jax.random.PRNGKey(1)}, xf))
    model = build_model(cfg).eval()
    sd = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    assert {torch_name(tuple(p.key for p in path)) for path, _ in flat} == set(sd)
    assert set(sd) == set(port["model"].state_dict())
    model.load_state_dict(ref["sd"], strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ref["x"]), torch.from_numpy(ref["gt"]))
    for key in ("pred_logits", "pred_masks"):
        assert torch.equal(got[key], port["out"][key]), key
    cfg.MODEL.MR.NAME = ["ConvNeXtV2"] + cfg.MODEL.MR.NAME[1:]
    with pytest.raises(ValueError, match="first stage must be MixResViT"):
        build_model(cfg)


def test_bridge_covers_every_leaf_and_tensor(ref, port):
    """Every JAX leaf of the cascade lands on exactly one port tensor (an
    attention layer's three projections on its one packed in-projection),
    every port tensor is covered, and the round trip is exact."""
    import jax

    names = [torch_name(tuple(p.key for p in path))
             for path, _ in jax.tree_util.tree_flatten_with_path(ref["shapes"]["params"])[0]]
    sd = port["model"].state_dict()
    assert set(names) == set(sd)
    packed = [n for n in names if n.endswith(("in_proj_weight", "in_proj_bias"))]
    assert all(packed.count(n) == 3 for n in packed)
    assert len(names) - len(packed) * 2 // 3 == len(sd)
    assert any(n.startswith("backbone.upsamplers.1.layers.2.norm") for n in names)
    assert any(n.startswith("backbone.up_token_projection.1") for n in names)
    back = flax_to_torch_state_dict(ref["params"])
    assert all(torch.equal(back[k], v) for k, v in ref["sd"].items())


# ------------------------------------------------------------------ the oracle
def test_oracle_functions_match_jax():
    """gt_edge_map (void pixels, both directions), oracle_upsampling_mask
    (patches clipped at the image edge, scales beyond the table, exact
    ties), mix_teacher_mask with a given draw and at ratio 0, and
    upsampling_mse_loss (and 0 without stages)."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import oracle as joracle

    rng = np.random.default_rng(3)
    sem = label_maps(rng, b=2, size=32)
    sem[1, 5, 7] = 255
    e_got = toracle.gt_edge_map(torch.from_numpy(sem))
    e_want = np.asarray(joracle.gt_edge_map(jnp.asarray(sem.astype(np.int32))))
    assert np.array_equal(e_got.numpy(), e_want) and 0 < e_want.mean() < 0.5
    n = 40
    pos = rng.integers(-1, 9, (2, n, 2)).astype(np.float32)
    scale = rng.integers(0, 4, (2, n)).astype(np.float32)   # 3: beyond the 3-entry table
    args = ((16, 8, 4), 4)
    o_got = toracle.oracle_upsampling_mask(e_got, torch.from_numpy(pos), torch.from_numpy(scale),
                                           *args)
    o_want = np.asarray(joracle.oracle_upsampling_mask(jnp.asarray(e_want), jnp.asarray(pos),
                                                       jnp.asarray(scale), *args))
    np.testing.assert_allclose(o_got.numpy(), o_want, rtol=1e-6, atol=1e-7)
    assert o_want.max() == 1.0 and (o_want == 0).any()
    assert len(np.unique(o_want)) < o_want.size                 # exact ties
    pred = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    use = torch.tensor([[True], [False]])
    mixed = toracle.mix_teacher_mask(None, pred, o_got, 0.5, use_oracle=use)
    assert torch.equal(mixed[0], o_got[0]) and torch.equal(mixed[1], pred[1])
    assert toracle.mix_teacher_mask(None, pred, o_got, 0.0) is pred
    assert torch.equal(toracle.mix_teacher_mask(torch.Generator().manual_seed(0), pred, o_got,
                                                1.0), o_got)
    preds = [pred, pred[:, :7] * 0.5]
    oracles = [o_got, o_got[:, :7]]
    got = toracle.upsampling_mse_loss(preds, oracles)
    want = joracle.upsampling_mse_loss([jnp.asarray(p.numpy()) for p in preds],
                                       [jnp.asarray(o.numpy()) for o in oracles])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert toracle.upsampling_mse_loss([], []).item() == 0.0 == float(
        joracle.upsampling_mse_loss([], []))


def test_upsampling_loss_stops_the_oracle_gradient():
    p = torch.randn(2, 5, requires_grad=True)
    o = torch.rand(2, 5, requires_grad=True)
    toracle.upsampling_mse_loss([p], [o]).backward()
    assert o.grad is None and p.grad.abs().sum() > 0


# ------------------------------------------------------------ backbone parts
def test_mlp_deep_norm_matches_jax(ref, port):
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.updown import MLPDeepNorm as JMLP

    x = np.random.default_rng(4).standard_normal((2, 9, 24)).astype(np.float32)
    want = JMLP(24, 1).apply({"params": ref["params"]["backbone"]["upsamplers_1"]},
                             jnp.asarray(x))
    with torch.no_grad():
        got = port["model"].backbone.upsamplers[1](torch.from_numpy(x))
    _close(got, want, what="MLPDeepNorm")


@pytest.mark.parametrize("case", ["eval_gt", "eval_no_gt", "train_ratio1", "down_only"])
def test_updown_backbone_matches_jax(ref, case):
    """Every resolution's features, positions and scales, the upsampling
    scores, their positions and the oracles: in eval mode with ground truth
    (and without it: the same but for the oracles) and down-only.  In train
    mode at ORACLE_TEACHER_RATIO 1 every down stage splits by the oracle:
    the split tokens' positions, the scores and the oracles are held to
    JAX; the features are not held to the jitted JAX run there: with the oracle's split, parent and child tokens
    share positions, and XLA's fused arithmetic on the CPU breaks the exact
    ties of the space-filling curve's sort key otherwise than IEEE
    arithmetic op by op (the op-by-op JAX run agrees with the port, 1.8e-6,
    but takes ~40 s to run here)."""
    from autofocusformermod_torch.models.updown import updown_from_config

    cfg = tiny_cfg(1.0 if case == "train_ratio1" else 0.0)
    down = case == "down_only"
    if down:
        for key in ("NAME", "EMBED_DIM", "DEPTHS", "NUM_HEADS", "PATCH_SIZES", "MLP_RATIO",
                    "DROP_RATE", "ATTN_DROP_RATE", "UPSCALE_RATIO", "SPLIT_RATIO",
                    "CLUSTER_SIZE", "NBHD_SIZE"):
            setattr(cfg.MODEL.MR, key, list(getattr(cfg.MODEL.MR, key))[:3])
    model = updown_from_config(cfg, down_only=down)
    own = {k[len("backbone."):]: v for k, v in ref["sd"].items() if k.startswith("backbone.")}
    model.load_state_dict({k: v for k, v in own.items() if k in model.state_dict()}, strict=True)
    want = ref[{"eval_gt": "bb_eval", "eval_no_gt": "bb_eval", "train_ratio1": "bb_train1",
                "down_only": "bb_down"}[case]]
    mean, std = np.array(cfg.MODEL.PIXEL_MEAN), np.array(cfg.MODEL.PIXEL_STD)
    x = torch.from_numpy(((ref["x"] - mean) / std).astype(np.float32))
    gt = None if case == "eval_no_gt" else torch.from_numpy(ref["gt"])
    model.train(case == "train_ratio1")
    model.oracle_generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = model(x, gt)
    oracles = {k for k in want if k.startswith("upsampling_mask_oracle")}
    assert set(got) == (set(want) - oracles if case == "eval_no_gt" else set(want))
    for key in set(got) & set(want):
        if isinstance(want[key], tuple):
            assert tuple(got[key]) == tuple(want[key]), key
        elif case != "train_ratio1" or not key.startswith("res") or key.endswith(("_pos",
                                                                                   "_scale")):
            _close(got[key], want[key], what=key)
    assert tuple(got["res2"].shape[:2]) == (B, 64)
    if down:
        assert [got[f"res{k}"].shape[1:] for k in (4, 3, 2)] == [(16, 16), (32, 16), (64, 16)]
    else:
        assert [got[f"res{k}"].shape[2] for k in (4, 3, 2)] == [32, 24, 16]
    if case == "train_ratio1":
        # the oracle picked the split: the new tokens differ from eval's
        assert not np.array_equal(want["res2_pos"], ref["bb_eval"]["res2_pos"])
        assert all(torch.isfinite(got[f"res{k}"]).all() for k in (2, 3, 4))


# ----------------------------------------------------------- the dense decoder
def test_hierarchical_upsample_dense_matches_jax():
    """Coarse-to-fine painting (finer tokens overwrite, blocks that pass the
    right edge wrap, cells past the end dropped) and its gradient, against
    the JAX scatter and jax.vjp: an overwritten token gets no gradient."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import hierarchical_upsample_dense as jdense

    from autofocusformermod_torch.models.maskfiner import hierarchical_upsample_dense

    rng = np.random.default_rng(5)
    shape, c = (8, 12), 3
    cells = [(np.stack(np.meshgrid(np.arange(0, 12, 4), np.arange(0, 8, 4)), -1)
              .reshape(-1, 2)), None, None]
    cells[1] = rng.permutation(np.stack(np.meshgrid(np.arange(0, 12, 2), np.arange(0, 8, 2)),
                                        -1).reshape(-1, 2))[:10]
    cells[2] = np.concatenate([rng.integers(0, [12, 8], (9, 2)), [[11, 7], [11, 3]]])
    poss = [np.broadcast_to(p.astype(np.float32), (2,) + p.shape).copy() for p in cells]
    poss[0][1, 0] = [9.0, 6.0]        # a coarse block past the right edge and the end
    feats = [rng.standard_normal((2, len(p[0]), c)).astype(np.float32) for p in poss]
    want, vjp = jax.vjp(lambda *f: jdense(list(f), [jnp.asarray(p) for p in poss], shape),
                        *[jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    got = hierarchical_upsample_dense(tf, [torch.from_numpy(p) for p in poss], shape)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    for g, w in zip(tf, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert (np.abs(np.asarray(vjp(jnp.asarray(cot))[0])).sum(-1) == 0).any()


def test_dense_decoder_matches_jax(ref, port):
    """The dense OracleTeacher decoder alone on random levels: every level's
    mask features painted on the 16x16 grid, the sine PE, the attention
    masks from the grid's Shepard neighbours, masks by reshape, no
    disagreement."""
    x, pos, mf, mf_pos, finest, shapes = ref["dec_in"]
    dec = port["model"].mask_decoder
    with torch.no_grad():
        got, dis = dec([torch.from_numpy(a) for a in x], [torch.from_numpy(p) for p in pos],
                       torch.from_numpy(mf), torch.from_numpy(mf_pos), finest, shapes)
    want, jdis = ref["decoder"]
    assert dis is None and jdis is None and dec.dense_mask_features
    _close(got["pred_logits"], want["pred_logits"], what="pred_logits")
    _close(got["pred_masks"], want["pred_masks"], what="pred_masks")
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 3
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        _close(a["pred_masks"], w["pred_masks"], what=f"aux {i}")


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def port_step(ref):
    """The port's TrainStep on the same weights, batch and replayed draws."""
    from autofocusformermod_torch.engine.train_step import TrainStep

    from test_torch_sampler import Replay

    model = build_model(ref["cfg"])
    model.load_state_dict(ref["sd"], strict=True)
    step = TrainStep(model, ref["cfg"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    total, losses, _ = step.loss_and_grads(batch, Replay(ref["draws"]))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"model": model, "total": total.item(), "grads": grads,
            "losses": {k: v.item() for k, v in losses.items()},
            "grad_norm": step.apply_gradients().item()}


def test_step_loss_terms_match_jax(ref, port_step):
    """Every loss term of the 4 outputs, loss_upsampling (weight 10) and
    the total, 1e-5 relative; the global gradient norm 1e-4."""
    want = ref["metrics"]
    assert set(port_step["losses"]) == set(want) - {"total_loss", "grad_norm"}
    assert len(port_step["losses"]) == 3 * 4 + 1 and want["loss_upsampling"] > 0
    for k, v in port_step["losses"].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(port_step["total"], want["total_loss"], rtol=1e-5)
    np.testing.assert_allclose(port_step["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_step_gradient_norms_per_group_match_jax(ref, port_step):
    """The gradient norm of each optimizer parameter group within 1e-4
    relative.  The upsampling heads' only loss is the upsampling loss, and
    their last LayerNorm normalises one channel, so their score is that
    norm's bias whatever the input: only the bias learns, on both sides."""
    from autofocusformermod_torch.engine.optimizer import param_groups

    groups = param_groups(port_step["model"])
    assert len(groups) >= 3
    for label, named in groups.items():
        got = float(torch.sqrt(sum((port_step["grads"][n] ** 2).sum() for n, _ in named)))
        want = float(torch.sqrt(sum((ref["grads"][n] ** 2).sum() for n, _ in named)))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=label)
    for s in (0, 1):
        head = {k: v for k, v in port_step["grads"].items()
                if k.startswith(f"backbone.upsamplers.{s}.")}
        bias = f"backbone.upsamplers.{s}.layers.2.norm.bias"
        # the rest is rounding: the normalised channel is 0 in the forward,
        # and the port's backward recomputes it to ~1e-6 of the bias's
        # gradient (JAX's gives 0)
        for grads in (head, ref["grads"]):
            live = float(grads[bias].abs().max())
            rest = max(float(grads[k].abs().max()) for k in head if k != bias)
            assert live > 0 and rest <= 1e-4 * live, (s, live, rest)


# -------------------------------------------------- MixResViT: DropPath, layer scale
def test_mixres_vit_layer_scale_matches_jax():
    """MixResViT with layer scale (gamma1 / gamma2, perturbed) and DropPath
    rates, in eval mode (DropPath off), against the JAX MixResViT."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mixres import MixResViT as JViT

    from autofocusformermod_torch.models.mixres import MixResViT

    kw = dict(scale=0, n_scales=3, patch_size=16, min_patch_size=4, d_model=32, n_layers=2,
              n_heads=2, mlp_ratio=2.0, drop_path=(0.1, 0.2), layer_scale=0.5)
    torch.manual_seed(1)
    model = MixResViT(**kw).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "gamma" in name:
                p.add_(0.3 * torch.randn(p.shape))
    assert {n for n, _ in model.named_parameters() if "gamma" in n} == {
        f"blocks.{i}.gamma{j}" for i in (0, 1) for j in (1, 2)}
    x = np.random.default_rng(7).standard_normal((2, 64, 48, 3)).astype(np.float32)
    jvit = JViT(**{**kw, "first_layer": True, "out_feature": "res4"})
    shapes = jax.eval_shape(lambda: jvit.init(jax.random.PRNGKey(0), jnp.asarray(x), None, None,
                                              None, ()))
    sd = {f"backbone.{k}": v for k, v in model.state_dict().items()}
    params = torch_to_flax({"backbone": shapes["params"]}, sd)["backbone"]
    (want, _), (got, tps) = (jvit.apply({"params": params}, jnp.asarray(x), None, None, None, ()),
                             model(torch.from_numpy(x)))
    assert tps == (12,)
    _close(got["res4"], want["res4"], what="res4")


def test_mixres_vit_drop_path_draws_from_the_model_generator():
    """In train mode every DropPath of the backbone draws one keep decision
    per image from the generator set_dropout_generator gives, in forward
    order (stage 0's blocks, the attention branch before the feed-forward
    one, then the later stages'): the masks equal a fresh generator's
    draws in that order, and the same seed gives the same output."""
    from autofocusformermod_torch.models.layers import DropPath, set_dropout_generator

    cfg = tiny_cfg()
    cfg.MODEL.MR.DROP_PATH_RATE = 0.5
    model = build_model(cfg).train()
    order, masks = [], []
    for name, m in model.backbone.named_modules():
        if isinstance(m, DropPath):
            def keep_mask(shape, device, real=m.keep_mask, name=name):
                out = real(shape, device)
                order.append(name)
                masks.append(out)
                return out
            m.keep_mask = keep_mask
    rates = [m.rate for m in model.backbone.modules() if isinstance(m, DropPath)]
    assert rates == pytest.approx(list(np.linspace(0, 0.5, 5)))
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (B, SIZE, SIZE, 3))
                         .astype(np.uint8))
    outs = []
    for _ in range(2):
        order.clear()
        masks.clear()
        set_dropout_generator(model, torch.Generator().manual_seed(11))
        with torch.no_grad():
            outs.append(model(x)["pred_masks"])
    # stage 0's rate is 0: it never draws
    want = [n for n in ("backbones.1.layers.blocks.0.drop_path", "backbones.2.layers.blocks.0."
                        "drop_path", "backbones.3.blocks.0.drop_path",
                        "backbones.4.blocks.0.drop_path") for _ in range(2)]
    assert order == want
    fresh = torch.Generator().manual_seed(11)
    for m, rate in zip(masks, [r for r in rates[1:] for _ in range(2)]):
        assert torch.equal(m, torch.rand(m.shape, generator=fresh) < 1.0 - rate)
    assert torch.equal(outs[0], outs[1])


# -------------------------------------------------------- presets and builds
def _merged(path):
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / path))
    return cfg


YAMLS = {
    "maskfiner_updown_mini": ADE + "maskfiner_updown_mini_bs32_80k.yaml",
    "maskfiner_updown_tiny": ADE + "maskfiner_updown_tiny_bs32_80k.yaml",
    "maskfiner_updown_small2": ADE + "maskfiner_updown_small2_bs32_80k.yaml",
    "maskfiner_updown_tiny_5s": ADE + "maskfiner_updown_tiny_5s_bs32_80k.yaml",
    "maskfiner_updown_tiny_sw": "configs/cityscapes/semantic-segmentation/maskfiner/"
                                "maskfiner_updown_tiny_sw_bs16_90k.yaml",
    "maskfiner_oracle_teacher_bb": ADE + "maskfiner_oracle_teacher_bb_bs32_80k.yaml",
}


@pytest.mark.parametrize("preset", ["maskfiner_updown_mini", "maskfiner_oracle_teacher_bb"])
def test_preset_matches_yaml(preset):
    """The preset equals merge_from_file of the published config
    (over its two bases and the defaults) on every field it carries."""
    pytest.importorskip("yaml")
    cfg = _merged(YAMLS[preset])
    seen = []

    def walk(node, ref_node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, ref_node[k], path + (k,))
            elif path + (k,) != ("MODEL", "DEVICE"):   # "cuda" here, "tpu" there
                got = ref_node[k]
                seq = (list, tuple)
                assert (list(got) if isinstance(got, seq) else got) == (
                    list(v) if isinstance(v, seq) else v), path + (k,)
                seen.append(".".join(path + (k,)))

    walk(PRESETS[preset](), cfg, ())
    assert {"MODEL.META_ARCHITECTURE", "MODEL.BACKBONE.NAME", "MODEL.MR.EMBED_DIM",
            "MODEL.MR.DROP_PATH_RATE", "MODEL.MR.UPSCALE_RATIO", "MODEL.MR.LAYER_SCALE",
            "MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME", "MODEL.MR_SEM_SEG_HEAD.IGNORE_VALUE",
            "MODEL.MASK_FINER.TRANSFORMER_DECODER_NAME", "MODEL.MASK_FINER.DEC_LAYERS",
            "MODEL.MASK_FINER.ORACLE_TEACHER_RATIO", "MODEL.MASK_FINER.UPSAMPLING_WEIGHT",
            "SOLVER.AMP.ENABLED", "TEST.SW_ENABLED"} <= set(seen)


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_published_yaml_builds_with_jax_parameter_count(name):
    """build_model on the JAX-merged yaml: the parameter count of
    jax.eval_shape(model.init) (at 64x64; build and trace only).  The 5-scale
    tiny_5s names MultiScaleMaskFinerTransformerDecoder5S, the plain
    decoder; tiny_sw is MaskFinerOracleTeacherSW; the OracleTeacher-BB
    yaml's backbone is down-only under a 0.3 DropPath ramp."""
    pytest.importorskip("yaml")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    from autofocusformermod_torch.models.registry import size_divisibility

    cfg = _merged(YAMLS[name])
    model = build_model(cfg)
    jmodel = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert type(model).__name__ == "MaskFinerOracleTeacherBB"
    assert model.mask_decoder.dense_mask_features == (name != "maskfiner_updown_tiny_5s")
    assert size_divisibility(cfg) == 32


# ------------------------------------------------------------- the entry points
TINY = ["MODEL.MR.DEPTHS", "[1, 1, 1, 1, 1, 1, 1]", "MODEL.MASK_FINER.DEC_LAYERS", "[3, 3, 4, 3]",
        "MODEL.MR_SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "[2, 2, 4, 1]",
        "MODEL.MASK_FINER.TRAIN_NUM_POINTS", "256"]


def test_train_net_trains_and_evaluates(tmp_path, monkeypatch):
    """``train_net --config maskfiner_updown_mini --synthetic`` takes one
    step at 64x64 on the CPU (3 loss terms for each of the 3 outputs and
    loss_upsampling, all finite; the upsampling heads get a gradient); then
    ``--eval-only`` on a tiny registered dataset, and the same under
    MaskFinerOracleTeacherSW, which evaluates in sliding windows whatever
    TEST.SW_ENABLED says."""
    import json

    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.engine import train as train_mod

    from test_torch_trainer import tiny_dataset

    trainer = train_net.main(["--config", "maskfiner_updown_mini", "--device", "cpu",
                              "--synthetic", "--max-iter", "1", "INPUT.CROP.SIZE", "[64, 64]",
                              "SOLVER.IMS_PER_BATCH", "1", "OUTPUT_DIR", str(tmp_path)] + TINY)
    metrics = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    terms = {k: v for k, v in metrics.items() if k.startswith("loss_")}
    assert len(terms) == 3 * 3 + 1 and metrics["loss_upsampling"] > 0
    assert all(np.isfinite(v) for v in terms.values())
    assert set(trainer.generators) == {"criterion", "dropout", "oracle"}
    assert trainer.model.backbone.oracle_generator is trainer.generators["oracle"]

    windows = []
    real = train_mod.sliding_window_semantic_scores
    monkeypatch.setattr(train_mod, "sliding_window_semantic_scores",
                        lambda *a: windows.append(a[2:]) or real(*a))
    data = tiny_dataset(tmp_path / "data", "updown")
    for arch in ("MaskFinerOracleTeacherBB", "MaskFinerOracleTeacherSW"):
        out = ["OUTPUT_DIR", str(tmp_path / arch), "MODEL.META_ARCHITECTURE", arch,
               "TEST.SW_CROP_SIZE", "[128, 128]", "TEST.SW_STRIDE", "[128, 128]"]
        evaluated = train_net.main(["--config", "maskfiner_updown_mini", "--device", "cpu",
                                    "--eval-only"] + TINY + data + out)
        assert 0 <= evaluated.results["updown_val"]["mIoU"] <= 100
        assert len(windows) == (0 if arch.endswith("BB") else 2)
