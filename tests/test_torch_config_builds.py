"""The config system's entry points against the JAX package: published
yamls read by the port build with the parameter counts of
``jax.eval_shape(model.init)`` (traces of ~2-15 s each, hence a file of
their own), the MaskFiner cascade with the lrelu OracleTeacher pixel
decoder under the plain stage head (``configs/maskfiner_ade20k_semantic
.yaml``'s combination) forward-equal to JAX at a tiny width,
``train_net --config-file`` taking a CPU step, the demo's
``run_on_image`` against JAX's ``VisualizationDemo.run_on_image`` on the
same image and weights, and the analysis tool's parameter count.

Tolerances: parameter counts exact; the cascade's outputs rtol = atol =
1e-4 (fp32 summation order, as ``test_torch_maskfiner.py``); the demo's
label maps equal at 99.9% of the pixels or more (an argmax over class
scores that agree to ~1e-5 flips only where two classes tie that
closely).
"""

import copy
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import CfgNode, published_cfg
from autofocusformermod_torch.models.maskformer import init_random_weights
from autofocusformermod_torch.models.registry import build_model

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
# (the published yaml, the canvas JAX traces at, the parameter count)
COUNTS = {
    "coco_panoptic_maskfiner_R50": (
        "configs/coco/panoptic-segmentation/maskfiner_R50_bs16_50ep.yaml", 128, 41_665_184),
    "maskfiner_large": (
        "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_large_bs32_80k.yaml", 128,
        94_428_140),
    "maskfiner_reversed": (
        "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_reversed_bs32_80k.yaml", 128,
        44_428_393),
    "maskfiner_single": (
        "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_single_bs32_80k.yaml", 128,
        37_175_837),
    "aff_tiny": ("configs/ade20k/maskformer2_aff_tiny_bs32_80k.yaml", 128, 45_979_236),
    "cityscapes_swin_small": (
        "configs/cityscapes/semantic-segmentation/swin/maskformer2_swin_small_bs16_90k.yaml", 128,
        68_724_382),
    "ade20k_maskfiner_R50": (
        "configs/ade20k/semantic-segmentation/maskfiner_R50_bs16_160k.yaml", 128, 26_321_892),
    "maskfiner_updown_base": (
        "configs/ade20k/semantic-segmentation/maskfiner/maskfiner_updown_base_bs32_80k.yaml", 128,
        111_070_390),
    # JAX cannot trace it at 128x128 (a 64-token stage under 144-token
    # neighbourhoods)
    "cityscapes_aff_base_384": (
        "configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_base_384_bs16_90k.yaml", 512,
        94_077_733),
    "maskfiner_ade20k_semantic": ("configs/maskfiner_ade20k_semantic.yaml", 128, 76_370_068),
    "cityscapes_updown_base_sw": (
        "configs/cityscapes/semantic-segmentation/maskfiner/maskfiner_updown_base_sw_bs16_90k.yaml",
        128, 111_036_723),
}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Importing TensorBoard costs ~15 s here; the logger goes without it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def jax_cfg(path):
    from autofocusformermod_tpu.config import add_deeplab_config, add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(path))
    return cfg


def jax_param_shapes(model, arch, size):
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1, size, size, 3))
    if arch.startswith("MaskFinerOracle"):
        return jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "oracle": jax.random.PRNGKey(1)}, x,
            jnp.zeros((1, size, size), jnp.int32)))["params"]
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))["params"]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_published_yaml_has_jax_parameter_count(name):
    import jax

    from autofocusformermod_tpu.models.registry import META_ARCH_REGISTRY

    path, size, count = COUNTS[name]
    with torch.device("meta"):
        model = build_model(published_cfg(str(REPO / path)))
    assert sum(p.numel() for p in model.parameters()) == count
    ref = jax_cfg(REPO / path)
    arch = ref.MODEL.META_ARCHITECTURE
    shapes = jax_param_shapes(META_ARCH_REGISTRY.get(arch)(ref), arch, size)
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == count


# ------------------------------------------- the lrelu decoder under MaskPredictor
@pytest.fixture(scope="module")
def lrelu_cascade():
    """The tiny cascade of ``tests/test_maskfiner.py`` with every stage's
    pixel decoder the lrelu OracleTeacher form under the plain stage head:
    the port's seeded weights carried into JAX's parameter tree, both run on
    the same images."""
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jax_maskfiner
    from test_maskfiner import tiny_maskfiner_cfg
    from test_torch_mrml import fast_jit
    from test_torch_updown import torch_to_flax

    jcfg = tiny_maskfiner_cfg()
    jcfg.MODEL.META_ARCHITECTURE = "MaskFiner"
    jcfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME = "MSDeformAttnPixelDecoderMaskFinerOracleTeacher"
    cfg = CfgNode(copy.deepcopy(dict(jcfg)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg).eval()
    init_random_weights(model, torch.Generator().manual_seed(1))
    jmodel = jax_maskfiner(jcfg)
    params = torch_to_flax(jax_param_shapes(jmodel, "MaskFiner", 64), model.state_dict())
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    out = fast_jit(lambda p, im: jmodel.apply({"params": p}, im, train=False), params, xf)(
        params, xf)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return {"model": model, "want": out, "got": got}


def test_lrelu_decoder_under_the_plain_head_is_built_as_jax_builds_it(lrelu_cascade):
    """Every stage's decoder is leaky and keeps its mask-features head (JAX's
    ``final_layer = final or not (OracleTeacher name and OracleTeacher
    head)``), and each stage has a mask decoder."""
    from autofocusformermod_torch.models.maskfiner import MaskFinerPixelDecoder

    for p in lrelu_cascade["model"].mask_predictors:
        assert isinstance(p.pixel_decoder, MaskFinerPixelDecoder)
        assert p.pixel_decoder.act(torch.tensor([-1.0])).item() == pytest.approx(-0.01)
        assert p.pixel_decoder.mask_features is not None
        assert p.mask_decoder is not None


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks"])
def test_lrelu_cascade_forward_matches_jax(lrelu_cascade, key):
    got, want = lrelu_cascade["got"], lrelu_cascade["want"]
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"])
    for a, w in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(a[key].numpy(), np.asarray(w[key]), **TOL)


# ------------------------------------------------------------- the entry points
TINY_AFF = """_BASE_: {base}
MODEL:
  AFF:
    EMBED_DIM: [8, 12, 16, 20]
    DEPTHS: [1, 1, 1, 1]
    NUM_HEADS: [2, 2, 2, 2]
    NBHD_SIZE: [16, 16, 16, 16]
    DROP_PATH_RATE: 0.0
  SEM_SEG_HEAD:
    CONVS_DIM: 16
    MASK_DIM: 16
    TRANSFORMER_ENC_LAYERS: 1
    NUM_CLASSES: 4
  MASK_FORMER:
    HIDDEN_DIM: 16
    DIM_FEEDFORWARD: 32
    DEC_LAYERS: 3
    NUM_OBJECT_QUERIES: 4
    TRAIN_NUM_POINTS: 64
  WEIGHTS: ""
TPU:
  MAX_GT_INSTANCES: 4
INPUT:
  CROP:
    SIZE: (128, 128)
  MIN_SIZE_TEST: 96
  MAX_SIZE_TEST: 160
SOLVER:
  IMS_PER_BATCH: 2
  BASE_LR: 0.001
"""


@pytest.fixture()
def tiny_yaml(tmp_path):
    """AFF + Mask2Former at a tiny width over the published AFF-Mini yaml."""
    path = tmp_path / "tiny_aff.yaml"
    path.write_text(TINY_AFF.format(base=REPO / "configs/ade20k/maskformer2_aff_mini_bs32_80k.yaml"))
    return path


def test_train_net_config_file_takes_a_cpu_step(tiny_yaml, tmp_path, monkeypatch):
    from autofocusformermod_torch import train_net

    out = tmp_path / "out"
    trainer = train_net.main(["--config-file", str(tiny_yaml), "--synthetic", "--device", "cpu",
                              "--max-iter", "1", "OUTPUT_DIR", str(out)])
    cfg = trainer.cfg
    assert cfg.is_frozen() and cfg.MODEL.DEVICE == "cuda"
    assert cfg.MODEL.AFF.EMBED_DIM == [8, 12, 16, 20] and cfg.INPUT.CROP.SIZE == (128, 128)
    assert cfg.SOLVER.MAX_ITER == 80000 and cfg.OUTPUT_DIR == str(out)     # from the base yaml
    metrics = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in metrics] == [1] and np.isfinite(metrics[0]["total_loss"])
    with pytest.raises(SystemExit):               # the yaml and a preset exclude each other
        train_net.main(["--config-file", str(tiny_yaml), "--config", "aff_mini", "--device", "cpu"])
    with monkeypatch.context() as m:              # more GPUs than the machine has refuse
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="asks for 2 GPUs"):
            train_net.main(["--config-file", str(tiny_yaml), "--num-gpus", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            train_net.main(["--config-file", str(tiny_yaml), "--synthetic"])


def _jax_demo_module():
    spec = importlib.util.spec_from_file_location("jax_demo", REPO / "demo" / "demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_demo_run_on_image_matches_jax(tiny_yaml):
    """The port's ``run_on_image`` (short-edge resize, zero padding, forward,
    semantic inference, crop, argmax, nearest resize back) against the JAX
    demo's on one 70x90 image, the port's seeded weights carried over; and
    ``visualize`` with the JAX demo's colours."""
    pytest.importorskip("cv2")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_torch.demo import VisualizationDemo, color_map
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from test_torch_train import _flax_tree

    cfg = published_cfg(str(tiny_yaml))
    cfg.freeze()
    demo = VisualizationDemo(cfg)
    init_random_weights(demo.model, torch.Generator().manual_seed(3))
    img = np.random.default_rng(5).integers(0, 256, (70, 90, 3)).astype(np.uint8)
    # at random initialisation every query votes for one class; the class
    # head is set so that query q votes for class q on this image (its final
    # query features taken from a first run), so the map has several classes
    head, seen = demo.model.sem_seg_head.predictor.class_embed, []
    hook = head.register_forward_hook(lambda m, args, out: seen.append(args[0].detach()))
    demo.run_on_image(img)
    hook.remove()
    feats = seen[-1][0].T                                  # (hidden, queries)
    q, votes = feats.shape[1], torch.full((head.out_features, feats.shape[1]), -4.0)
    votes[torch.arange(q) % (head.out_features - 1), torch.arange(q)] = 4.0
    with torch.no_grad():
        head.weight.copy_(votes @ torch.linalg.pinv(feats))
        head.bias.zero_()
    jmod = _jax_demo_module()
    jcfg = jax_cfg(tiny_yaml)
    jdemo = jmod.VisualizationDemo(jcfg)
    flat_p, flat_s = convert_reference_state_dict(
        {k: v.numpy().copy() for k, v in demo.model.state_dict().items()})
    jdemo._variables = {"params": _flax_tree(flat_p), "batch_stats": _flax_tree(flat_s)}
    real = jdemo.model
    apply = jax.jit(lambda v, x: real.apply(v, x, train=False))
    jdemo.model = SimpleNamespace(apply=lambda v, x, train: apply(v, jnp.asarray(x)))

    got, want = demo.run_on_image(img), jdemo.run_on_image(img)
    assert got.shape == want.shape == (70, 90) and demo.div == jdemo.div == 32
    assert (got == want).mean() >= 0.999, (got != want).sum()
    assert len(np.unique(got)) == 4
    np.testing.assert_array_equal(color_map(4), jmod.color_map(4))
    np.testing.assert_array_equal(demo.visualize(img, got), jdemo.visualize(img, got))


def test_analysis_counts_the_build(tiny_yaml, capsys):
    from autofocusformermod_torch.tools import analyze_model

    out = analyze_model.main(["--config-file", str(tiny_yaml), "--tasks", "param", "structure",
                              "flop", "memory", "--device", "cpu", "--input-size", "128"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(published_cfg(str(tiny_yaml)))
    names = [n for n, _ in model.named_parameters()]
    assert out["parameters"] == sum(p.numel() for p in model.parameters())
    assert out["flops"] > 0 and "peak_bytes" not in out
    text = capsys.readouterr().out
    assert f"({out['parameters']})" in text and all(n in text for n in names)
    assert "aten" in text and "memory: not measured" in text
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            analyze_model.main(["--config-file", str(tiny_yaml), "--tasks", "param"])


def test_chip_smoke_holds_the_counts_held_here():
    """chip_smoke.py phase 20 holds its four yamls' builds on the card to
    these counts."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    assert {label: path for label, path, *_ in chip_smoke.YAML_RUNS} == {
        label: COUNTS[label][0] for label in chip_smoke.YAML_PARAMS}
    assert chip_smoke.YAML_PARAMS == {label: COUNTS[label][2] for label in chip_smoke.YAML_PARAMS}
