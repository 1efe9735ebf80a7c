"""The published 1/5 preset (AFF-Mini-1/5: cluster merging keeps a fifth of
the tokens per stage) in the PyTorch port against the JAX package.

The preset against the merged yaml, and a tiny MaskFormer at ``DS_RATE`` 0.2
(the widths of ``test_torch_model.py``'s tiny model at 128x128: stages of
1024, 204, 40 and 8 tokens, so clusters are cut by n and the decoder's
levels, 204, 40 and 8 tokens, are no multiples of 128), initialized in JAX,
its parameters perturbed with seeded noise, carried over with
``flax_to_torch_state_dict``; both run the same uint8 image in fp32 on the
CPU.  The port runs it twice: in the default layout (``msdetrpc_levels_s``)
and with ``USE_STACKED_GLUE`` off, where the level sizes send the sampling
to the interleaved ``ops/clusten.msdetrpc``.  On the CPU the JAX module
takes its XLA composition, ``ops/clusten.msdetrpc``, on either flag.
Tolerance rtol = atol = 1e-4, as ``test_torch_model.py``: fp32 summation
order over ~20 layers; kept-token positions must be equal."""

from pathlib import Path

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import PRESETS, aff_mini_15_cfg, aff_mini_cfg
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.models import pixel_decoder as tpd
from autofocusformermod_torch.models.maskformer import maskformer_from_config

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)
from test_torch_model import tiny_cfg

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny model's decoder levels (res3, res4, res5) at 128x128 and DS_RATE 0.2
LEVELS = (204, 40, 8)


def test_aff_mini_15_preset_matches_yaml():
    """The preset equals merge_from_file of the published config on
    every field it carries, and differs from AFF-Mini's only in DS_RATE and
    the weights file."""
    pytest.importorskip("yaml")
    from autofocusformermod_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                               get_cfg)

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(str(REPO / "configs/ade20k/maskformer2_aff_mini_15_bs32_80k.yaml"))
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

    preset = PRESETS["aff_mini_15"]()
    walk(preset, cfg, ())
    assert {"MODEL.AFF.DS_RATE", "MODEL.WEIGHTS", "SOLVER.IMS_PER_BATCH", "INPUT.CROP.SIZE",
            "MODEL.SEM_SEG_HEAD.CONVS_DIM"} <= set(seen)
    assert {"DATASETS.TRAIN", "DATASETS.TEST", "INPUT.MIN_SIZE_TRAIN", "INPUT.MAX_SIZE_TEST",
            "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "INPUT.COLOR_AUG_SSD", "INPUT.SIZE_DIVISIBILITY",
            "INPUT.DATASET_MAPPER_NAME", "TEST.EVAL_PERIOD", "TEST.EXPECTED_RESULTS",
            "TEST.AUG.MIN_SIZES", "TEST.SW_CROP_SIZE", "TEST.SAVE_EVAL_ARTIFACTS",
            "DATALOADER.NUM_WORKERS", "MODEL.SEM_SEG_HEAD.IGNORE_VALUE"} <= set(seen)
    assert (preset.MODEL.AFF.DS_RATE, preset.MODEL.WEIGHTS) == (0.2, "aff_mini_15.pth")
    mini = aff_mini_cfg()
    mini.MODEL.AFF.DS_RATE, mini.MODEL.WEIGHTS = 0.2, "aff_mini_15.pth"
    assert mini == preset
    assert aff_mini_cfg().MODEL.AFF.DS_RATE == 0.25              # the presets share no state


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: (cfg, image, params, stats, outputs, backbone
    outputs) of the tiny model at DS_RATE 0.2."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer

    cfg = tiny_cfg()
    cfg.MODEL.AFF.DS_RATE = aff_mini_15_cfg().MODEL.AFF.DS_RATE
    model = jax_maskformer(cfg)
    x = np.random.default_rng(20).integers(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(2), xf, train=False))()
    rng = np.random.default_rng(21)
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
def port_model(ref):
    model = maskformer_from_config(ref["cfg"]).eval()
    model.load_state_dict(flax_to_torch_state_dict(ref["params"], ref["stats"]), strict=True)
    return model


@pytest.mark.parametrize("stacked,op", [(True, "msdetrpc_levels_s"), (False, "msdetrpc")])
def test_tiny_mini15_matches_jax(monkeypatch, ref, port_model, stacked, op):
    """The whole tiny 1/5 model in the default layout and with
    USE_STACKED_GLUE off against the JAX model: equal kept tokens at every
    stage, the decoder's levels not multiples of 128, its sampling through
    the layout's op (3 calls: one encoder layer, three levels), outputs and
    auxiliary masks within TOL."""
    monkeypatch.setattr(tpd, "USE_STACKED_GLUE", stacked)
    calls = {"msdetrpc_levels_s": 0, "msdetrpc": 0, "msdetrpc_levels": 0}
    for name in calls:
        real = getattr(tpd, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tpd, name, counted)
    x = torch.from_numpy(ref["x"])
    with torch.no_grad():
        feats = port_model.backbone(port_model.normalize(x))
        out = port_model(x)
    assert tuple(feats[f"res{i}"].shape[1] for i in (3, 4, 5)) == LEVELS
    assert not tpd._levels_ok(LEVELS, sum(LEVELS))
    assert calls == {**dict.fromkeys(calls, 0), op: 3}
    for stage in (2, 3, 4, 5):
        pos = feats[f"res{stage}_pos"].numpy()
        np.testing.assert_array_equal(pos, np.broadcast_to(ref["feats"][f"res{stage}_pos"],
                                                           pos.shape))
        np.testing.assert_allclose(feats[f"res{stage}"].numpy(), ref["feats"][f"res{stage}"],
                                   **TOL)
    for key in ("pred_logits", "pred_masks"):
        assert out[key].shape == ref["out"][key].shape
        np.testing.assert_allclose(out[key].numpy(), ref["out"][key], **TOL)
    for a, r in zip(out["aux_outputs"], ref["out"]["aux_outputs"]):
        np.testing.assert_allclose(a["pred_masks"].numpy(), r["pred_masks"], **TOL)
