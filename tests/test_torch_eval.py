"""The PyTorch port's semantic evaluation against the JAX package: the
evaluator, the sliding window, test-time augmentation, the evaluator's
padding, ``Trainer.test()`` as a whole on non-square images, the
TEST.EVAL_PERIOD call in the train loop, ``verify_results``, and the
MaskFiner cascade on a non-square canvas.

Tolerances: the evaluator, the window grid, the padding and
``verify_results`` are exact.  Scores that went through a model are held to
1e-4 of the largest |score| (fp32 summation order over ~20 layers); the
stitched and averaged toy scores to 1e-6 (OpenCV's float resize against
``F.interpolate``).  ``Trainer.test()`` runs the tiny MaskFormer of
``tests/test_torch_model.py`` on three JPEG + PNG pairs written here; its
seeded port weights reach JAX through ``convert_reference_state_dict`` and
come back through ``flax_to_torch_state_dict``, so no JAX init runs.  The
JAX side is composed from the pieces its ``Trainer._eval_sem_seg`` calls
(its own mapper, ``_pad_eval_image``, the model, ``upsample_masks``,
``semantic_inference``, ``sem_seg_postprocess``, OpenCV's nearest resize of
the ground truth, its evaluator); with no pixel whose top two scores lie
within the tolerance, the metrics must be equal.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import aff_mini_cfg
from autofocusformermod_torch.data.catalog import DatasetCatalog
from autofocusformermod_torch.data.datasets import register_sem_seg
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.engine.train import Trainer
from autofocusformermod_torch.evaluation.sem_seg_evaluation import (
    MaskFinerSemSegEvaluator, MetaLossSemSegEvaluator, SemSegEvaluator)
from autofocusformermod_torch.models.inference import (sliding_window_grid,
                                                       sliding_window_semantic_scores)
from autofocusformermod_torch.models.maskformer import (init_random_weights, maskformer_from_config,
                                                        semantic_inference, upsample_masks)
from autofocusformermod_torch.models.tta import SemanticSegmentorWithTTA

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

SCORE_RTOL = 1e-4
TOY_ATOL = 1e-6


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# ------------------------------------------------------------- the evaluator
@pytest.fixture(scope="module")
def jeval():
    from autofocusformermod_tpu.evaluation import sem_seg_evaluation

    return sem_seg_evaluation


def _seeded_maps(seed, nc, n=3, shape=(37, 53)):
    """Predictions with out-of-range ids (-2, nc, nc + 4) and ground truth
    with the ignore label and out-of-range ids."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        pred = rng.integers(-2, nc + 5, shape)
        gt = rng.integers(0, nc + 2, shape)
        gt[rng.random(shape) < 0.2] = 255
        gt[:, :3] = rng.integers(0, nc, (shape[0], 3))      # some ground truth right
        pred[:, :3] = gt[:, :3]
        yield pred, gt


@pytest.mark.parametrize("nc", [1, 6, 150])
def test_evaluator_matches_jax(jeval, nc):
    names = [f"c{i}" for i in range(nc)]
    port, ref = SemSegEvaluator(nc, class_names=names), jeval.SemSegEvaluator(nc, class_names=names)
    other, ref_other = SemSegEvaluator(nc), jeval.SemSegEvaluator(nc)
    for i, (pred, gt) in enumerate(_seeded_maps(nc, nc)):
        (port if i % 2 else other).process(pred, gt)
        (ref if i % 2 else ref_other).process(pred, gt)
    port.merge(other)
    ref.merge(ref_other)
    np.testing.assert_array_equal(port._conf, ref._conf)
    assert port._conf.sum() == 3 * 37 * 53
    got, want = port.evaluate(), ref.evaluate()
    assert got == want and {"mIoU", "fwIoU", "mACC", "pACC"} <= set(got)
    port.reset()
    assert port._conf.sum() == 0 and port.evaluate()["mIoU"] == 0.0


@pytest.mark.parametrize("which", ["SemSegEvaluator", "MaskFinerSemSegEvaluator",
                                   "MetaLossSemSegEvaluator"])
def test_saved_artifacts_match_jax(jeval, tmp_path, which):
    pytest.importorskip("PIL")
    from PIL import Image

    port_cls = {"SemSegEvaluator": SemSegEvaluator,
                "MaskFinerSemSegEvaluator": MaskFinerSemSegEvaluator,
                "MetaLossSemSegEvaluator": MetaLossSemSegEvaluator}[which]
    port = port_cls(9, output_dir=str(tmp_path / "a"), save_predictions=True)
    ref = getattr(jeval, which)(9, output_dir=str(tmp_path / "b"), save_predictions=True)
    pred, gt = next(_seeded_maps(1, 9))
    extras = {"meta_loss_candidates_scale_2": np.linspace(-5, 300, 37 * 53).reshape(37, 53),
              "disagreement_mask_0": np.full((37, 53), 77.7)}
    port.process(pred, gt, "dir/img_1.jpg", extras)
    ref.process(pred, gt, "dir/img_1.jpg", extras)
    np.testing.assert_array_equal(port._color_map(), ref._color_map())
    a, b = tmp_path / "a" / "inference_output", tmp_path / "b" / "inference_output"
    files = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == files and len(files) == 5
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a / f), np.load(b / f))
        else:
            np.testing.assert_array_equal(np.asarray(Image.open(a / f)),
                                          np.asarray(Image.open(b / f)))


# --------------------------------------------------------- the sliding window
GRIDS = [((1024, 2048), (1024, 1024), (768, 768)), ((512, 512), (1024, 1024), (768, 768)),
         ((512, 1024), (1024, 1024), (768, 768)), ((800, 800), (400, 400), (400, 400)),
         ((333, 777), (128, 256), (96, 192))]


def _toy_scores(crop, nc=4):
    crop = np.asarray(crop, np.float32)
    base = crop.mean(axis=-1)
    return np.stack([base * (k + 1) + crop[..., k % 3] for k in range(nc)])


@pytest.mark.parametrize("img_hw, crop_hw, stride_hw", GRIDS)
def test_sliding_window_matches_jax(img_hw, crop_hw, stride_hw):
    from autofocusformermod_tpu.models import inference as ji

    assert sliding_window_grid(img_hw, crop_hw, stride_hw) == ji.sliding_window_grid(
        img_hw, crop_hw, stride_hw)
    scale = 8                                       # the stitching at an eighth of the size
    small = [tuple(v // scale for v in t) for t in (img_hw, crop_hw, stride_hw)]
    img = np.random.default_rng(sum(img_hw)).integers(0, 256, small[0] + (3,)).astype(np.uint8)
    want = ji.sliding_window_semantic_scores(_toy_scores, img, small[1], small[2])
    got = sliding_window_semantic_scores(lambda c: torch.from_numpy(_toy_scores(c)), img,
                                         small[1], small[2])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOY_ATOL * np.abs(want).max())


def test_tta_matches_jax():
    pytest.importorskip("cv2")
    from autofocusformermod_tpu.models.tta import SemanticSegmentorWithTTA as JaxTTA

    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3)).astype(np.uint8)
    kw = dict(min_sizes=(24, 40, 56), max_size=70, flip=True)
    want = JaxTTA(_toy_scores, **kw)(img)
    got = SemanticSegmentorWithTTA(lambda x: torch.from_numpy(_toy_scores(x)), **kw)(img)
    assert got.shape == want.shape == (4, 40, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOY_ATOL * np.abs(want).max())


# -------------------------------------------------------------- the padding
def _jax_trainer():
    from autofocusformermod_tpu.engine.train import Trainer as JaxTrainer

    return JaxTrainer


@pytest.mark.parametrize("hw, div", [((64, 96), 32), ((50, 90), 32), ((129, 31), 32),
                                     ((7, 5), 4)])
def test_pad_eval_image_matches_jax_and_pads_with_the_mean(hw, div):
    pytest.importorskip("jax")
    cfg = aff_mini_cfg()
    cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY = div
    img = np.random.default_rng(div).integers(0, 256, hw + (3,)).astype(np.uint8)
    stand_in = SimpleNamespace(cfg=cfg)
    got = Trainer._pad_eval_image(stand_in, img)
    np.testing.assert_array_equal(got, _jax_trainer()._pad_eval_image(stand_in, img))
    assert got.shape[0] % div == 0 and got.shape[1] % div == 0 and got.dtype == np.uint8
    np.testing.assert_array_equal(got[: hw[0], : hw[1]], img)
    fringe = np.concatenate([got[hw[0]:].reshape(-1, 3), got[:, hw[1]:].reshape(-1, 3)])
    ph, pw = got.shape[:2]
    assert len(fringe) == (ph - hw[0]) * pw + ph * (pw - hw[1])      # the corner twice
    assert (fringe == [124, 116, 104]).all()


# ------------------------------------------------------- verify_results
RESULTS = {"ds_a": {"mIoU": 40.0, "pACC": 80.0}, "ds_b": {"mIoU": 20.0}}


@pytest.mark.parametrize("expected, ok", [
    ([], True),
    ([["ds_a", "mIoU", 40.5, 0.5]], True),
    ([["ds_a", "mIoU", 40.5, 0.4]], False),
    ([["ds_b", "mIoU", 20.0, 0.0], ["ds_a", "pACC", 79.0, 1.0]], True),
    ([["sem_seg", "pACC", 80.0, 1e-9]], True),             # any task name: the metric alone
    ([["ds_a", "fwIoU", 0.0, 100.0]], False),              # a metric that is not there
])
def test_verify_results_passes_and_fails_as_jax(expected, ok):
    pytest.importorskip("jax")
    cfg = aff_mini_cfg()
    cfg.TEST.EXPECTED_RESULTS = expected
    outcomes = []
    for fn, stand_in in ((Trainer.verify_results, SimpleNamespace(cfg=cfg)),
                         (_jax_trainer().verify_results, SimpleNamespace(cfg=cfg, is_main=True))):
        try:
            outcomes.append(fn(stand_in, RESULTS))
        except AssertionError:
            outcomes.append(False)
    assert outcomes == [ok, ok]


# --------------------------------------------------------- Trainer.test()
EVAL_SIZES = [(64, 96), (50, 90), (150, 90)]     # mapped to 64x96, 64x115, 107x64


def _port_cfg(jcfg, out_dir, dataset):
    """The AFF-Mini preset with every field the JAX CfgNode has taken from
    it, the test set and the test sizes set."""
    cfg = aff_mini_cfg()

    def copy(node, jnode):
        for k, v in node.items():
            if isinstance(v, dict):
                copy(v, jnode[k])
            elif k in jnode:
                got = jnode[k]
                node[k] = list(got) if isinstance(got, (list, tuple)) else got

    copy(cfg, jcfg)
    cfg.merge_from_list(["DATASETS.TEST", f"('{dataset}',)", "OUTPUT_DIR", str(out_dir),
                         "DATALOADER.NUM_WORKERS", "1"])
    return cfg


@pytest.fixture(scope="module")
def evalrun(tmp_path_factory):
    """The port's Trainer.test() on three non-square images and the JAX
    composition on the same files, with the same weights."""
    pytest.importorskip("jax")
    pytest.importorskip("cv2")
    from PIL import Image
    import cv2
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.data.mapper_semantic import (
        MaskFormerSemanticDatasetMapper as JaxMapper)
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.evaluation.sem_seg_evaluation import (
        SemSegEvaluator as JaxEvaluator)
    from autofocusformermod_tpu.models import maskformer as jm
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from autofocusformermod_tpu.models.inference import sem_seg_postprocess as jax_postprocess
    from test_torch_model import tiny_cfg
    from test_torch_train import _flax_tree

    tmp = tmp_path_factory.mktemp("eval")
    jcfg = tiny_cfg()
    jcfg.INPUT.MIN_SIZE_TEST, jcfg.INPUT.MAX_SIZE_TEST = 64, 128
    rng = np.random.default_rng(0)
    for d in ("img", "gt"):
        os.makedirs(tmp / d)
    for i, (h, w) in enumerate(EVAL_SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(tmp / "img" /
                                                                             f"{i}.jpg")
        lab = rng.integers(0, 4, (h // 8 + 1, w // 8 + 1)).repeat(8, 0).repeat(8, 1)[:h, :w]
        lab[h // 2: h // 2 + 3] = 255
        Image.fromarray(lab.astype(np.uint8)).save(tmp / "gt" / f"{i}.png")
    name = "torch_eval_tiny"
    if name not in DatasetCatalog.list():
        register_sem_seg(name, str(tmp / "img"), str(tmp / "gt"), ["a", "b", "c", "d"])

    weights = init_random_weights(maskformer_from_config(jcfg), torch.Generator().manual_seed(0))
    flat_p, flat_s = convert_reference_state_dict(
        {k: v.numpy().copy() for k, v in weights.state_dict().items()})
    params, stats = _flax_tree(flat_p), _flax_tree(flat_s)

    cfg = _port_cfg(jcfg, tmp / "out", name)
    trainer = Trainer(cfg, torch.device("cpu"))
    trainer.model.load_state_dict(flax_to_torch_state_dict(params, stats), strict=True)
    inputs, scores = [], []
    hook = trainer.model.register_forward_pre_hook(lambda m, args: inputs.append(args[0].clone()))
    real = Trainer.eval_scores

    def capture(self, image, out_hw):
        scores.append(real(self, image, out_hw))
        return scores[-1]

    Trainer.eval_scores = capture
    try:
        trainer.model.train()
        results = trainer.test()
        assert trainer.model.training                       # back in train mode
        zero_scores = []
        scores, kept = zero_scores, scores

        def zero_pad(self, img):
            div = self.cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY
            h, w = img.shape[:2]
            out = np.zeros((-(-h // div) * div, -(-w // div) * div, 3), img.dtype)
            out[:h, :w] = img
            return out

        real_pad, Trainer._pad_eval_image = Trainer._pad_eval_image, zero_pad
        try:
            trainer.test()
        finally:
            Trainer._pad_eval_image = real_pad
        scores = kept
    finally:
        Trainer.eval_scores = real
        hook.remove()

    # the JAX side, composed as its Trainer._eval_sem_seg composes it
    jmodel = jax_maskformer(jcfg)
    apply = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x, train=False))
    stand_in = SimpleNamespace(cfg=jcfg)
    evaluator = JaxEvaluator(4, class_names=["a", "b", "c", "d"])
    ref_scores, samples = [], []
    mapper = JaxMapper.from_config(jcfg, is_train=False)
    for d in DatasetCatalog.get(name):
        sample = mapper(d)
        img = sample["image"]
        h, w = img.shape[:2]
        padded = _jax_trainer()._pad_eval_image(stand_in, img)
        out = apply(params, stats, jnp.asarray(padded, jnp.float32)[None])
        masks = jm.upsample_masks(out["pred_masks"], padded.shape[:2])[0]
        sem = jm.semantic_inference(out["pred_logits"][0], masks)[:, :h, :w]
        sem = np.asarray(jax_postprocess(sem, (h, w), (sample["height"], sample["width"])))
        pred = sem.argmax(0)
        gt = sample["sem_seg"]
        if gt.shape != pred.shape:
            gt = cv2.resize(gt.astype(np.int32), (pred.shape[1], pred.shape[0]),
                            interpolation=cv2.INTER_NEAREST)
        evaluator.process(pred, gt)
        ref_scores.append(sem)
        samples.append(sample)
    return {"results": results[name], "scores": scores, "zero_scores": zero_scores,
            "inputs": inputs, "ref_scores": ref_scores, "ref_results": evaluator.evaluate(),
            "samples": samples, "trainer": trainer}


def test_eval_scores_match_jax_on_non_square_images(evalrun):
    assert len(evalrun["scores"]) == len(EVAL_SIZES)
    for got, want, hw in zip(evalrun["scores"], evalrun["ref_scores"], EVAL_SIZES):
        assert tuple(got.shape) == (4,) + hw == want.shape
        err = np.abs(got.numpy() - want).max()
        assert err <= SCORE_RTOL * np.abs(want).max(), (hw, err)


def test_eval_metrics_match_jax(evalrun):
    """No pixel's top two scores lie within the tolerance (so the argmax is
    the same on both sides), and every metric is equal."""
    for want in evalrun["ref_scores"]:
        top2 = np.sort(want, axis=0)[-2:]
        assert (top2[1] - top2[0] > 2 * SCORE_RTOL * np.abs(want).max()).all()
    assert evalrun["results"] == evalrun["ref_results"]
    assert set(evalrun["results"]) >= {"mIoU", "fwIoU", "mACC", "pACC", "IoU-a"}


def test_eval_input_is_padded_with_the_rounded_mean(evalrun):
    """The model's input in test(): each mapped image, padded to 32 with
    [124, 116, 104] (two of the three need padding); zero padding gives
    other scores."""
    padded = 0
    for x, sample in zip(evalrun["inputs"], evalrun["samples"]):
        h, w = sample["image"].shape[:2]
        assert tuple(x.shape) == (1, -(-h // 32) * 32, -(-w // 32) * 32, 3)
        np.testing.assert_array_equal(x[0, :h, :w].numpy(), sample["image"])
        fringe = torch.cat([x[0, h:].reshape(-1, 3), x[0, :, w:].reshape(-1, 3)])
        assert (fringe == torch.tensor([124, 116, 104], dtype=torch.uint8)).all()
        padded += len(fringe) > 0
    assert padded == 2
    diffs = [float((a - z).abs().max()) for a, z in zip(evalrun["scores"],
                                                        evalrun["zero_scores"])]
    assert diffs[0] == 0.0 and min(diffs[1:]) > 1e-3, diffs


# ------------------------------------------------------------ the train loop
def test_train_calls_test_every_eval_period(tmp_path, monkeypatch):
    from autofocusformermod_torch.data.synthetic import synthetic_batches
    from test_torch_trainer import tiny_trainer_cfg

    cfg = tiny_trainer_cfg(tmp_path, "TEST.EVAL_PERIOD", "2", "SOLVER.CHECKPOINT_PERIOD", "3")
    trainer = Trainer(cfg, torch.device("cpu"))
    calls = []
    monkeypatch.setattr(Trainer, "test", lambda self: calls.append(
        (self.start_step, self.checkpointer.steps(), self.model.training)))
    trainer.train(synthetic_batches(cfg, trainer.device), max_iter=5)
    assert calls == [(2, [], True), (4, [3], True)]       # after the step and its checkpoint
    cfg = tiny_trainer_cfg(tmp_path / "b", "TEST.EVAL_PERIOD", "0")
    trainer = Trainer(cfg, torch.device("cpu"))
    trainer.train(synthetic_batches(cfg, trainer.device), max_iter=2)
    assert len(calls) == 2


# ------------------------------------------------- the cascade, non-square
@pytest.fixture(scope="module")
def cascade():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.models.maskfiner import maskfiner_from_config as jax_maskfiner
    from autofocusformermod_torch.models.maskfiner import maskfiner_from_config
    from test_maskfiner import tiny_maskfiner_cfg

    cfg = tiny_maskfiner_cfg()
    model = jax_maskfiner(cfg)
    x = np.random.default_rng(2).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    xf = jnp.asarray(x.astype(np.float32))
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), xf, train=False))()
    rng = np.random.default_rng(1)

    def perturb(path, p):
        scale = 1.0 if "class_embed" in jax.tree_util.keystr(path) else 0.02
        return np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, variables["params"])
    ref = jax.tree.map(np.asarray, jax.jit(lambda p, im: model.apply({"params": p}, im,
                                                                      train=False))(params, xf))
    port = maskfiner_from_config(cfg).eval()
    port.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    return ref, out


@pytest.mark.parametrize("key", ["pred_logits", "pred_masks", "features_pos"])
def test_tiny_cascade_matches_jax_on_a_non_square_canvas(cascade, key):
    """64x96: the cascade's grid, split and rasterization with h != w."""
    ref, out = cascade
    assert tuple(out[key].shape) == ref[key].shape
    if key == "features_pos":
        np.testing.assert_array_equal(out[key].numpy(), ref[key])
    else:
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=SCORE_RTOL, atol=SCORE_RTOL)
    if key == "pred_masks":
        assert ref[key].shape[-2:] == (16, 24)
        sem = semantic_inference(out["pred_logits"], upsample_masks(out[key], (64, 96)))
        assert tuple(sem.shape) == (2, 7, 64, 96)
