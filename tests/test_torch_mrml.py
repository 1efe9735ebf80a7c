"""The PyTorch port's MRML family against the JAX package: the three MRML
backbones (MixResMetaLoss, its MeanAct and Neighbour variants),
``metaloss_l1``, ``compute_meta_loss``, the Up pixel decoder, the
MaskFormerML forward and one ``make_train_step(metaloss_weight=0.5)``
step, the plain-decoder MaskFormer over MixResMeanAct, the presets and the
entry points (the published yamls' builds: ``test_torch_published_builds.py``).

The tiny MaskFormerML has 4 scales of patches 32, 16, 8 and 4 at 128x128
(batch 2), widths 32, 24, 16 and 16, half of the newest scale's tokens
split per scale: streams of 16, 8 + 32, 8 + 16 + 64 and 8 + 16 + 32 + 128
tokens, so the Neighbour backbone's last two scales cluster (88 and 184
tokens, clusters of 8 in 48-token neighbourhoods) and its first two attend
globally; the Up pixel decoder over res2-res5 with one encoder layer.  JAX's ``maskformer_ml_from_config``
builds the global MixResMetaLoss whatever MODEL.BACKBONE.NAME says; the
port builds the MRML backbone that the name gives (as the upstream
meta-architecture does), so the JAX side here is that model with the
backbone the JAX registry builds for the name.  Its parameter tree comes
from ``jax.eval_shape`` filled with the port's seeded weights
(``torch_to_flax``; no JAX init).  Tolerances: forward outputs within 1e-4
of their largest entry, loss terms 1e-5 relative, gradient norms per
parameter group 1e-4 relative.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict, torch_name
from autofocusformermod_torch.models import mrml as tmrml
from autofocusformermod_torch.models.maskformer import init_random_weights
from autofocusformermod_torch.models.registry import build_model, size_divisibility

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_maskfiner_train import jax_group_draws
from test_torch_resnet import check_preset_matches_yaml
from test_torch_sampler import Replay
from test_torch_updown import _close, torch_to_flax

REPO = Path(__file__).resolve().parents[1]
ADE = "configs/ade20k/semantic-segmentation/"
B, SIZE, T, NC, P = 2, 128, 4, 5, 64    # images, side, queries (= target slots), classes, points
# XLA's CPU backend without its LLVM optimisations: the same HLO compiled in
# about half the time (the JAX side's results move in the last bits)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def tiny_cfg(backbone="MixResMetaLossNeighbour", arch="MaskFormerML"):
    """The tiny MRML model (JAX CfgNode)."""
    from autofocusformermod_tpu.config import add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_maskformer2_config(cfg)
    cfg.MODEL.META_ARCHITECTURE = arch
    cfg.MODEL.BACKBONE.NAME = backbone
    m = cfg.MODEL.MRML
    m.NUM_SCALES, m.PATCH_SIZES, m.EMBED_DIM = 4, [32, 16, 8, 4], [32, 24, 16, 16]
    m.DEPTHS, m.NUM_HEADS, m.MLP_RATIO, m.UPSCALE_RATIO = [1] * 4, [2] * 4, 1.0, 0.5
    h = cfg.MODEL.SEM_SEG_HEAD
    h.NUM_CLASSES, h.CONVS_DIM, h.MASK_DIM, h.TRANSFORMER_ENC_LAYERS = NC, 16, 16, 1
    h.PIXEL_DECODER_NAME = "MSDeformAttnPixelDecoderUp"
    mf = cfg.MODEL.MASK_FORMER
    mf.HIDDEN_DIM, mf.NUM_OBJECT_QUERIES, mf.NHEADS, mf.DIM_FEEDFORWARD = 16, T, 2, 32
    mf.DEC_LAYERS, mf.TRAIN_NUM_POINTS, mf.METALOSS_WEIGHT, mf.DROPOUT = 3, P, 0.5, 0.0
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WEIGHT_DECAY = 1e-3, 100, 0.05
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE = True, "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    return cfg


def jax_model(cfg):
    """The JAX model of ``cfg``: its registry's, a MaskFormerML's backbone
    replaced by the one the registry builds for MODEL.BACKBONE.NAME."""
    from autofocusformermod_tpu.models.registry import BACKBONE_REGISTRY, META_ARCH_REGISTRY

    model = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)(cfg)
    if cfg.MODEL.META_ARCHITECTURE == "MaskFormerML" and cfg.MODEL.BACKBONE.NAME in \
            tmrml.MRML_BACKBONES:
        model = model.clone(backbone=BACKBONE_REGISTRY.get(cfg.MODEL.BACKBONE.NAME)(cfg))
    return model


def fast_jit(fn, *args):
    """``fn`` (a function, or a jitted one such as a train step) compiled
    for ``args`` with FAST_COMPILE."""
    import jax

    return (fn if hasattr(fn, "lower") else jax.jit(fn)).lower(*args).compile(
        compiler_options=FAST_COMPILE)


def grads_only():
    """An optax transform that passes the gradients on and keeps them as its
    state: the step's loss terms and gradients are compared, not an
    optimizer's update."""
    import optax

    return optax.GradientTransformation(lambda params: (), lambda g, state, params=None: (g, g))


@pytest.fixture()
def sparse_point2img(monkeypatch):
    """The JAX decoder's rasterization without its full-canvas assertion (the
    same scatter), for the plain decoder over an MRML backbone, whose finest
    level is a part of its grid."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import transformer_decoder as jtd

    def point2img(x, pos, mask_size):
        b, q, n = x.shape
        h, w = mask_size
        idx = pos[:, :, 1].astype(jnp.int32) * w + pos[:, :, 0].astype(jnp.int32)
        ret = jnp.zeros((b, q, h * w), x.dtype)
        ret = ret.at[jnp.arange(b)[:, None, None], jnp.arange(q)[None, :, None],
                     idx[:, None, :]].set(x)
        return ret.reshape(b, q, h, w)

    monkeypatch.setattr(jtd, "point2img", point2img)


def seeded_port(cfg, seed=0):
    torch.manual_seed(seed)
    model = build_model(cfg)
    return init_random_weights(model, torch.Generator().manual_seed(seed))


def step_batch(rng, b=B, size=SIZE, t=T):
    """uint8 images and blocky label maps with 2-3 classes and a void band,
    labels in the first slots."""
    image = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    sem = np.zeros((b, size, size), np.uint8)
    labels, valid = np.zeros((b, t), np.int32), np.zeros((b, t), bool)
    for i in range(b):
        sem[i] = np.kron(rng.choice(rng.choice(NC, 3 - i, replace=False), (4, 4)),
                         np.ones((size // 4, size // 4)))
    sem[:, 20:24] = 255
    for i in range(b):
        present = [c for c in np.unique(sem[i]) if c != 255]
        labels[i, :len(present)], valid[i, :len(present)] = present, True
    return {"image": image, "sem_seg_map": sem, "labels": labels, "valid": valid}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, made once: the tiny MaskFormerML's parameter tree (by
    jax.eval_shape, filled from the port's seeded weights), its eval forward
    with the backbone's and the pixel decoder's outputs, and one training
    step on the criterion's draws."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.parallel.train_step import TrainState, make_train_step

    cfg = tiny_cfg()
    model = jax_model(cfg)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), xf))
    sd = {k: v.detach().clone() for k, v in seeded_port(cfg).state_dict().items()}
    params = torch_to_flax(shapes["params"], sd)

    def capture(mdl, method):
        return method == "__call__" and mdl.name in ("backbone", "pixel_decoder")

    def apply(p):
        out, state = model.apply({"params": p}, xf, train=False, capture_intermediates=capture)
        feats = state["intermediates"]["backbone"]["__call__"][0]
        pd = state["intermediates"]["head"]["pixel_decoder"]["__call__"][0]
        return out, {k: v for k, v in feats.items() if not k.endswith("spatial_shape")}, pd

    out, feats, pd = jax.tree.map(np.asarray, fast_jit(apply, params)(params))

    batch = step_batch(np.random.default_rng(1))
    mf = cfg.MODEL.MASK_FORMER
    step = make_train_step(
        model, NC, eos_coef=mf.NO_OBJECT_WEIGHT, class_weight=mf.CLASS_WEIGHT,
        mask_weight=mf.MASK_WEIGHT, dice_weight=mf.DICE_WEIGHT, num_points=P,
        oversample_ratio=mf.OVERSAMPLE_RATIO, importance_sample_ratio=mf.IMPORTANCE_SAMPLE_RATIO,
        metaloss_weight=mf.METALOSS_WEIGHT, ml_min_patch_size=min(cfg.MODEL.MRML.PATCH_SIZES),
        donate=False)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.uint8 and k != "image" else v)
              for k, v in batch.items()}
    state = TrainState.create(params, {}, grads_only())
    new_state, metrics = fast_jit(step, state, jbatch, key)(state, jbatch, key)
    _, k_crit = jax.random.split(key)
    return {"cfg": cfg, "x": x, "sd": sd, "params": params, "shapes": shapes, "out": out,
            "feats": feats, "pd": pd, "batch": batch,
            "draws": jax_group_draws(k_crit, [(SIZE // 4, SIZE // 4)] * mf.DEC_LAYERS, B, T, P),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": flax_to_torch_state_dict(new_state.opt_state)}


@pytest.fixture(scope="module")
def port(ref):
    model = build_model(ref["cfg"]).eval()
    model.load_state_dict(ref["sd"], strict=True)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        feats = model.backbone(model.normalize(x))
        pd = model.sem_seg_head.pixel_decoder(feats)
        return {"model": model, "feats": feats, "pd": pd, "out": model(x)}


# ------------------------------------------------------------------ forward
def test_maskformer_ml_forward_matches_jax(ref, port):
    """pred_logits, pred_masks (32x32: res2's grid), every aux output, and
    the metaloss predictions and their positions."""
    got, want = port["out"], ref["out"]
    assert tuple(got["pred_masks"].shape) == (B, T, SIZE // 4, SIZE // 4)
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], want[key], what=key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 2
    for i, (a, w) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
        for key in ("pred_logits", "pred_masks"):
            _close(a[key], w[key], what=f"aux {i} {key}")
    for key in ("metaloss_preds", "metaloss_pos"):
        assert len(got[key]) == len(want[key]) == 3
        for i, (a, w) in enumerate(zip(got[key], want[key])):
            _close(a, w, what=f"{key} {i}")
    assert [tuple(p.shape) for p in got["metaloss_preds"]] == [(B, 16), (B, 32), (B, 64)]


def test_neighbour_backbone_matches_jax(ref, port):
    """Every scale's features, positions (on the scale's own grid, equal)
    and scales, and the metaloss predictions: 8, 16, 32 and 128 tokens at
    the end, the last two scales through the clustered attention."""
    got, want = port["feats"], ref["feats"]
    assert set(want) <= set(got)
    for key, w in want.items():
        if key.endswith(("_pos", "_scale")):
            np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
        else:
            _close(got[key], w, what=key)
    assert [got[f"res{k}"].shape[1] for k in (5, 4, 3, 2)] == [8, 16, 32, 128]
    assert all(got[f"res{k}"].shape[2] == 16 for k in (2, 3, 4, 5))


def test_up_pixel_decoder_matches_jax(ref, port):
    """The Up decoder: mask features Shepard-upsampled from every level
    onto the whole 32x32 grid, at the grid's positions; the transformer
    levels and their positions."""
    mf, mf_pos, tout, ms, ms_pos = port["pd"]
    wmf, wpos, wtout, wms, wms_pos = ref["pd"]
    assert tuple(mf.shape) == (B, (SIZE // 4) ** 2, 16)
    _close(mf, wmf, what="mask_features")
    np.testing.assert_array_equal(mf_pos.numpy(), wpos)
    _close(tout, wtout, what="transformer_out")
    for i, (a, w) in enumerate(zip(ms, wms)):
        _close(a, w, what=f"level {i}")
    for a, w in zip(ms_pos, wms_pos):
        np.testing.assert_array_equal(a.numpy(), w)


@pytest.mark.parametrize("variant", ["MixResMetaLoss", "MixResMeanAct",
                                     "MixResMetaLossNeighbour"])
def test_mrml_backbones_match_jax(variant):
    """Each MRML backbone at ``tests/test_mrml.py``'s shapes (3 scales of
    patches 16, 8, 4 at 64x64, width 32, a quarter split: 12, 12 and 16
    tokens at the end; 40 tokens at most, so the Neighbour variant attends
    globally here, its clusters are held above), its outputs against the
    JAX module's: features,
    positions and scales equal in order (the kept tokens ascending, the
    split ones descending by score), the scores."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mrml import MixResMetaLoss as JMRML

    kw = dict(n_scales=3, patch_sizes=(16, 8, 4), embed_dims=(32, 32, 32), depths=(1, 1, 1),
              num_heads=(2, 2, 2), mlp_ratio=1.0)
    cluster, mean_act = tmrml.MRML_BACKBONES[variant]
    model = tmrml.MixResMetaLoss(**kw, use_cluster_attention=cluster,
                                 mean_activation_scores=mean_act)
    init_random_weights(model, torch.Generator().manual_seed(3))
    jmodel = JMRML(**kw, use_cluster_attention=cluster, mean_activation_scores=mean_act)
    x = np.random.default_rng(2).standard_normal((B, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    sd = {f"backbone.{k}": v for k, v in model.state_dict().items()}
    params = torch_to_flax({"backbone": shapes["params"]}, sd)["backbone"]
    want = fast_jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x)), params)(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, tuple):
            assert tuple(got[key]) == w, key
        elif key.endswith(("_pos", "_scale")):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w), err_msg=key)
        else:
            _close(got[key], np.asarray(w), what=key)
    assert [got[f"res{k}"].shape[1] for k in (4, 3, 2)] == [12, 12, 16]


# ---------------------------------------------------------------- the meta loss
def test_metaloss_l1_matches_jax():
    """``tests/test_mrml.py``'s error map (the top-left quarter), its two
    cases, and random predictions at clipped, fractional and past-the-edge
    positions and three patch sizes."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mrml import metaloss_l1 as jl1

    err = np.zeros((1, 8, 8), np.float32)
    err[:, :4, :4] = 1.0
    pos = np.asarray([[[0, 0], [4, 4]]], np.float32)
    for pred in ([[1.0, 0.0]], [[0.0, 1.0]]):
        got = tmrml.metaloss_l1(torch.tensor(pred), torch.from_numpy(pos), torch.from_numpy(err), 4)
        want = jl1(jnp.asarray(pred), jnp.asarray(pos), jnp.asarray(err), 4)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert tmrml.metaloss_l1(torch.tensor([[1.0, 0.0]]), torch.from_numpy(pos),
                             torch.from_numpy(err), 4).item() < 1e-6
    rng = np.random.default_rng(4)
    emap = rng.random((2, 8, 12)).astype(np.float32)
    pos = rng.uniform(-1, 13, (2, 30, 2)).astype(np.float32)
    pred = rng.random((2, 30)).astype(np.float32)
    for p in (1, 2, 4):
        got = tmrml.metaloss_l1(torch.from_numpy(pred), torch.from_numpy(pos),
                                torch.from_numpy(emap), p)
        want = jl1(jnp.asarray(pred), jnp.asarray(pos), jnp.asarray(emap), p)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_compute_meta_loss_matches_jax():
    """The meta loss on given outputs and targets: 32x32 mask logits resized
    up to 128x128, label maps with void pixels (class 0 in the composed map)
    and a label past the class count (clamped), three scales; the loss and
    its gradient to the predictions (none to the logits)."""
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.mrml import compute_meta_loss as jml

    rng = np.random.default_rng(5)
    batch = step_batch(rng)
    batch["labels"][1, 2], batch["valid"][1, 2] = NC + 1, True
    masks = (batch["sem_seg_map"][:, None] == batch["labels"][:, :, None, None]) \
        & batch["valid"][:, :, None, None]
    masks[1, 2, :8, :8] = True
    outputs = {"pred_logits": rng.standard_normal((B, T, NC + 1)).astype(np.float32),
               "pred_masks": 3 * rng.standard_normal((B, T, 32, 32)).astype(np.float32),
               "metaloss_preds": tuple(rng.random((B, n)).astype(np.float32) for n in (4, 8, 9)),
               "metaloss_pos": tuple(rng.integers(0, 32, (B, n, 2)).astype(np.float32)
                                     for n in (4, 8, 9))}
    args = (batch["labels"], masks.astype(np.float32), batch["valid"], 4)

    def jloss(preds):
        return jml({**{k: jnp.asarray(v) for k, v in outputs.items() if k.startswith("pred_")},
                    "metaloss_preds": preds,
                    "metaloss_pos": tuple(jnp.asarray(p) for p in outputs["metaloss_pos"])},
                   *[jnp.asarray(a) for a in args[:3]], 4)

    preds = tuple(jnp.asarray(p) for p in outputs["metaloss_preds"])
    want, wgrad = fast_jit(jax.value_and_grad(jloss), preds)(preds)
    tout = {k: (tuple(torch.from_numpy(a).requires_grad_() for a in v) if isinstance(v, tuple)
                else torch.from_numpy(v).requires_grad_()) for k, v in outputs.items()}
    got = tmrml.compute_meta_loss(tout, *[torch.from_numpy(a) for a in args[:3]], 4)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip(tout["metaloss_preds"], wgrad):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    assert tout["pred_logits"].grad is None and tout["pred_masks"].grad is None


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def port_step(ref):
    from autofocusformermod_torch.engine.train_step import TrainStep

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
    """Every loss term of the 3 outputs, meta_loss (weight 0.5) and the
    total, 1e-5 relative; the global gradient norm 1e-4."""
    want = ref["metrics"]
    assert set(port_step["losses"]) == set(want) - {"total_loss", "grad_norm"}
    assert len(port_step["losses"]) == 3 * 3 + 1 and want["meta_loss"] > 0
    for k, v in port_step["losses"].items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(port_step["total"], want["total_loss"], rtol=1e-5)
    np.testing.assert_allclose(port_step["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_step_gradient_norms_per_group_match_jax(ref, port_step):
    """The gradient norm of each optimizer parameter group within 1e-4
    relative; the metaloss heads learn from the meta loss alone."""
    from autofocusformermod_torch.engine.optimizer import param_groups

    groups = param_groups(port_step["model"])
    assert len(groups) >= 3
    for label, named in groups.items():
        got = float(torch.sqrt(sum((port_step["grads"][n] ** 2).sum() for n, _ in named)))
        want = float(torch.sqrt(sum((ref["grads"][n] ** 2).sum() for n, _ in named)))
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=label)
    head = [n for n in port_step["grads"] if n.startswith("backbone.metalosses.")]
    got = float(torch.sqrt(sum((port_step["grads"][n] ** 2).sum() for n in head)))
    want = float(torch.sqrt(sum((ref["grads"][n] ** 2).sum() for n in head)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0


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
    for n in ("backbone.metalosses.1.fc2.weight", "backbone.rel_pos_embs_1",
              "backbone.scale_embs_0", "backbone.high_res_patchers.1.weight",
              "backbone.downsamplers_norm.0.weight", "backbone.layers.2.blocks.0.attn.blank_k"):
        assert n in names, n
    back = flax_to_torch_state_dict(ref["params"])
    assert all(torch.equal(back[k], v) for k, v in ref["sd"].items())


# --------------------------------------------------- MaskFormer over MixResMeanAct
def test_maskformer_over_mean_act_matches_jax(sparse_point2img):
    """MaskFormer over MixResMeanAct builds the plain pixel decoder (the
    JAX package reads no PIXEL_DECODER_NAME there): its mask features are
    res2's 128 tokens, scattered onto the 32x32 canvas (the other cells 0),
    the attention masks from their Shepard neighbours; the forward against
    JAX's, whose scatter is given the same 128 tokens."""
    import jax
    import jax.numpy as jnp

    cfg = tiny_cfg("MixResMeanAct", "MaskFormer")
    model = seeded_port(cfg, 1).eval()
    assert not model.sem_seg_head.pixel_decoder.mask_on_full_grid
    jmodel = jax_model(cfg)
    x = np.random.default_rng(6).integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), xf))
    params = torch_to_flax(shapes["params"], model.state_dict())
    want = fast_jit(lambda p: jmodel.apply({"params": p}, xf), params)(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("pred_logits", "pred_masks"):
        _close(got[key], np.asarray(want[key]), what=key)
    covered = (got["pred_masks"][0, 0] != 0).sum().item()
    assert covered == 128


# ----------------------------------------------------- presets and builds
@pytest.mark.parametrize("preset,path", [
    ("mrml_mini", ADE + "mixres-metaloss/maskformer2_mrml_mini_bs32_80k.yaml"),
    ("mrmlnb_mini", ADE + "mixres-metaloss-nb/maskformer2_mrmlnb_mini_bs32_80k.yaml"),
    ("mrmean_mini", ADE + "mixres-activation/maskformer2_mrmean_mini_bs32_80k.yaml")])
def test_preset_matches_yaml(preset, path):
    """The preset equals the published yaml merged over its bases
    and the defaults, field by field."""
    seen = check_preset_matches_yaml(preset, path)
    assert {"MODEL.META_ARCHITECTURE", "MODEL.BACKBONE.NAME", "MODEL.MRML.EMBED_DIM",
            "MODEL.MRML.UPSCALE_RATIO", "MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME",
            "MODEL.MASK_FORMER.METALOSS_WEIGHT", "SOLVER.BASE_LR"} <= seen
    assert size_divisibility(PRESETS[preset]()) == 32


# ---------------------------------------------------------- the entry points
# the preset cut to one block a scale, 32 wide, 2 heads, 10 queries and 8
# target slots (the plain assignment solver's steps grow with both)
TINY = ["MODEL.MASK_FORMER.NUM_OBJECT_QUERIES", "10", "TPU.MAX_GT_INSTANCES", "8",
        "MODEL.MRML.DEPTHS", "[1, 1, 1, 1]", "MODEL.MRML.EMBED_DIM", "[32, 32, 32, 32]",
        "MODEL.MRML.NUM_HEADS", "[2, 2, 2, 2]", "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32",
        "MODEL.SEM_SEG_HEAD.MASK_DIM", "32", "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
        "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.MASK_FORMER.NHEADS", "2",
        "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64", "MODEL.MASK_FORMER.DEC_LAYERS", "3",
        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "256"]


def test_train_net_trains_and_evaluates(tmp_path, monkeypatch):
    """``train_net --config mrmlnb_mini --synthetic`` (cut to one 32-wide
    block a scale) takes one step at 128x128 on the CPU (3 loss terms for each of the 3 outputs and meta_loss, all
    finite, the metaloss heads get a gradient); ``--eval-only`` on a tiny
    registered dataset; ``SemanticPredictor`` pads a request to the
    coarsest patch's multiple."""
    import json

    from autofocusformermod_torch import train_net
    from autofocusformermod_torch.models.inference import SemanticPredictor

    from test_torch_trainer import tiny_dataset

    # no TensorBoard writer: importing it pulls in TensorFlow (~15 s alone,
    # minutes beside other test workers); metrics.jsonl is what is read here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = train_net.main(["--config", "mrmlnb_mini", "--device", "cpu", "--synthetic",
                              "--max-iter", "1", "INPUT.CROP.SIZE", "[128, 128]",
                              "SOLVER.IMS_PER_BATCH", "1", "OUTPUT_DIR", str(tmp_path)] + TINY)
    metrics = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    terms = {k: v for k, v in metrics.items() if k.startswith("loss_") or k == "meta_loss"}
    assert len(terms) == 3 * 3 + 1 and metrics["meta_loss"] > 0
    assert all(np.isfinite(v) for v in terms.values())
    head = trainer.model.backbone.metalosses[0].fc2.weight
    assert head.grad is not None and head.grad.abs().sum() > 0

    data = tiny_dataset(tmp_path / "data", "mrml")
    evaluated = train_net.main(["--config", "mrmlnb_mini", "--device", "cpu", "--eval-only",
                                "OUTPUT_DIR", str(tmp_path / "eval")] + TINY + data)
    assert 0 <= evaluated.results["mrml_val"]["mIoU"] <= 100
    assert type(trainer.model).__name__ == "MaskFormerML"
    x = np.random.default_rng(7).integers(0, 256, (1, 100, 120, 3)).astype(np.uint8)
    labels = SemanticPredictor(evaluated.model.eval(), 32)(x)
    assert tuple(labels.shape) == (1, 100, 120) and 0 <= labels.min() and labels.max() < 150
