"""The PyTorch port's whole inference slice against the JAX package, and the
weights bridge.

A tiny MaskFormer at 128x128 (AFF with 2-cluster neighbourhoods at stages
1-3 and global attention at stage 4, one encoder layer, 3 decoder layers) is
initialized in JAX, its parameters perturbed with seeded noise (so every
bias and BatchNorm statistic is non-trivial), carried over with
``flax_to_torch_state_dict``, and both models run the same uint8 image in
fp32 on the CPU.  Tolerance rtol = atol = 1e-4: fp32 summation order over
~20 layers (measured differences are ~3e-6); kept-token positions must be
equal."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import aff_mini_cfg
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.models.inference import SemanticPredictor
from autofocusformermod_torch.models.maskformer import (
    init_random_weights, maskformer_from_config, semantic_inference, upsample_masks)
from autofocusformermod_torch.ops import build

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def tiny_cfg():
    from autofocusformermod_tpu.config import add_maskformer2_config, get_cfg

    cfg = get_cfg()
    add_maskformer2_config(cfg)
    a = cfg.MODEL.AFF
    a.EMBED_DIM, a.DEPTHS = [8, 12, 16, 20], [1, 1, 1, 1]
    a.NUM_HEADS, a.NBHD_SIZE = [2, 2, 2, 2], [16, 16, 16, 16]
    h = cfg.MODEL.SEM_SEG_HEAD
    h.CONVS_DIM = h.MASK_DIM = cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 16
    h.TRANSFORMER_ENC_LAYERS, h.NUM_CLASSES = 1, 4
    cfg.MODEL.MASK_FORMER.DEC_LAYERS = 3
    cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES = 4
    cfg.MODEL.PIXEL_MEAN = [123.675, 116.28, 103.53]
    cfg.MODEL.PIXEL_STD = [58.395, 57.12, 57.375]
    cfg.TPU.USE_PALLAS = False
    return cfg


@pytest.fixture(scope="module")
def ref():
    """The JAX side, computed once: (cfg, image, params, stats, outputs,
    backbone outputs)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer

    cfg = tiny_cfg()
    model = jax_maskformer(cfg)
    x = np.random.default_rng(0).integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), xf, train=False))()
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.random(p.shape).astype(np.float32),
        variables["batch_stats"])
    out, state = model.apply(
        {"params": params, "batch_stats": stats}, xf, train=False,
        capture_intermediates=lambda mdl, method: mdl.name == "backbone" and method == "__call__")
    out = jax.tree.map(np.asarray, out)
    feats = jax.tree.map(np.asarray, state["intermediates"]["backbone"]["__call__"][0])
    return {"cfg": cfg, "x": x, "params": params, "stats": stats, "out": out, "feats": feats}


@pytest.fixture(scope="module")
def port(ref):
    model = maskformer_from_config(ref["cfg"]).eval()
    model.load_state_dict(flax_to_torch_state_dict(ref["params"], ref["stats"]), strict=True)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        return {"model": model, "out": model(x), "feats": model.backbone(model.normalize(x))}


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks"])
def test_tiny_maskformer_matches_jax(ref, port, key):
    assert port["out"][key].shape == ref["out"][key].shape
    np.testing.assert_allclose(port["out"][key].numpy(), ref["out"][key], **TOL)


def test_tiny_aux_outputs_match_jax(ref, port):
    for a, r in zip(port["out"]["aux_outputs"], ref["out"]["aux_outputs"]):
        np.testing.assert_allclose(a["pred_masks"].numpy(), r["pred_masks"], **TOL)


@pytest.mark.parametrize("stage", [2, 3, 4, 5])
def test_kept_tokens_and_features_match_jax(ref, port, stage):
    """Equal positions at every stage = equal kept tokens in equal order."""
    pos = port["feats"][f"res{stage}_pos"].numpy()
    np.testing.assert_array_equal(pos, np.broadcast_to(ref["feats"][f"res{stage}_pos"], pos.shape))
    np.testing.assert_allclose(port["feats"][f"res{stage}"].numpy(),
                               ref["feats"][f"res{stage}"], **TOL)


def test_semantic_inference_and_predictor_match_jax(ref, port):
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import maskformer as jm

    rmasks = jm.upsample_masks(jnp.asarray(ref["out"]["pred_masks"]), (128, 128))
    rsem = np.asarray(jm.semantic_inference(jnp.asarray(ref["out"]["pred_logits"][0]), rmasks[0]))
    masks = upsample_masks(port["out"]["pred_masks"], (128, 128))
    sem = semantic_inference(port["out"]["pred_logits"][0], masks[0])
    np.testing.assert_allclose(sem.numpy(), rsem, **TOL)
    labels = SemanticPredictor(port["model"], 32)(ref["x"])
    assert labels.shape == (1, 128, 128)
    np.testing.assert_array_equal(labels[0].numpy(), rsem.argmax(0))


def test_weights_round_trip():
    """port state_dict -> convert_reference_state_dict -> flax_to_torch_state_dict
    gives back identical tensors, with no missing or unexpected keys."""
    pytest.importorskip("flax")
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict

    model = init_random_weights(maskformer_from_config(tiny_cfg()), torch.Generator().manual_seed(3))
    sd = model.state_dict()
    flat_params, flat_stats = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})

    def unflatten(flat):
        tree = {}
        for path, v in flat.items():
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        return tree

    back = flax_to_torch_state_dict(unflatten(flat_params), unflatten(flat_stats))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    result = maskformer_from_config(tiny_cfg()).load_state_dict(back, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_import_is_jax_free():
    code = (
        "import sys, pkgutil, importlib, autofocusformermod_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, interleaved_ab, nearest_ab\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'yaml', 'cv2',"
        " 'PIL', 'autofocusformermod_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_aff_mini_preset_matches_yaml():
    """The preset equals merge_from_file of the published config on
    every field the slice reads."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / "configs/ade20k/maskformer2_aff_mini_bs32_80k.yaml"))
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

    walk(aff_mini_cfg(), cfg, ())
    assert cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM == 256
    assert {"DATASETS.TRAIN", "DATASETS.TEST", "INPUT.MIN_SIZE_TRAIN", "INPUT.MAX_SIZE_TEST",
            "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "INPUT.COLOR_AUG_SSD", "INPUT.SIZE_DIVISIBILITY",
            "INPUT.DATASET_MAPPER_NAME", "TEST.EVAL_PERIOD", "TEST.EXPECTED_RESULTS",
            "TEST.AUG.MIN_SIZES", "TEST.SW_CROP_SIZE", "TEST.SAVE_EVAL_ARTIFACTS",
            "DATALOADER.NUM_WORKERS", "MODEL.SEM_SEG_HEAD.IGNORE_VALUE"} <= set(seen)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernels raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()
    build.load_kernels.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_kernels()
    build.load_kernels.cache_clear()
