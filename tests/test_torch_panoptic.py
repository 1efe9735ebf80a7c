"""The PyTorch port's panoptic and instance inference and evaluation
against the JAX package: ``panoptic_inference``, ``instance_inference``,
the PQ and mask-AP evaluators, the RLE helpers, and ``Trainer.test()`` on
in-memory panoptic and instance datasets.

Tolerances: the segment maps, segments_info, instance labels and masks and
every evaluator's metrics are exact (the evaluators are numpy on both
sides; 1e-12 stated for the metrics); instance scores agree within 1e-6
(fp32 sums over the mask in another order).  ``Trainer.test()`` runs the
tiny MaskFormer of ``tests/test_torch_model.py`` (its seeded port weights
reach JAX through ``convert_reference_state_dict`` and come back through
``flax_to_torch_state_dict``); the JAX side is composed from the pieces its
``Trainer._eval_panoptic`` / ``_eval_instance`` call, in their order.  The
ground truth is made from the port's own predictions (moved, merged, cut,
crowd and void regions added), so PQ and AP are neither 0 nor 100.  The
panoptic maps may differ only at pixels whose two best prob masks lie
within twice the two sides' difference, and no instance mask logit does;
the metrics of these images are equal.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autofocusformermod_torch.config import CfgNode as Cfg, aff_mini_cfg
from autofocusformermod_torch.data.catalog import DatasetCatalog, MetadataCatalog
from autofocusformermod_torch.data.mapper_panoptic_instance import (
    _decode_compressed_rle_counts, rle_decode)
from autofocusformermod_torch.engine.convert_checkpoint import flax_to_torch_state_dict
from autofocusformermod_torch.engine.train import Trainer
from autofocusformermod_torch.evaluation import (CityscapesInstanceEvaluator, InstanceSegEvaluator,
                                                 LVISInstanceSegEvaluator, PanopticEvaluator)
from autofocusformermod_torch.evaluation.instance_evaluation import (rle_area, rle_decode_bool,
                                                                     rle_encode, rle_iou)
from autofocusformermod_torch.models.inference import (instance_inference, panoptic_inference,
                                                       sem_seg_postprocess, thing_lookup)

import share_cores  # noqa: F401 (each test worker's share of the CPU cores)

SCORE_ATOL = 1e-6
METRIC_ATOL = 1e-12


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def jinf():
    pytest.importorskip("jax")
    from autofocusformermod_tpu.models import inference

    return inference


# ------------------------------------------------------- panoptic inference
def _panoptic_case(kind, q=8, nc=5, hw=(24, 32), seed=0):
    """(mask_cls, mask_pred) with the case's structure built in."""
    rng = np.random.default_rng(seed)
    cls = rng.normal(0, 1, (q, nc + 1)).astype(np.float32)
    masks = rng.normal(0, 3, (q,) + hw).astype(np.float32)
    labels = rng.integers(0, nc, q)
    if kind == "none_kept":
        cls[:, nc] += 12.0                          # every query: no object
    else:
        cls[np.arange(q), labels] += 6.0            # confident: scores ~0.98
    if kind == "stuff_merging":
        cls[:, :nc] = -4.0
        cls[np.arange(q), np.array([2, 3, 2, 2, 4, 3, 0, 1])] = 6.0
    if kind == "overlap_filter":
        masks[1:4] = masks[0] - 0.5                  # three queries under query 0's mask
    if kind == "ties":
        cls[3], masks[3] = cls[1], masks[1]           # duplicate queries: exact ties
        cls[6], masks[6] = cls[2], masks[2]
        masks[:, :4] = 40.0                          # saturated: sigmoid 1.0 for all
    if kind == "some_excluded":
        cls[::2, nc] += 12.0
    return cls, masks


PAN_CASES = ["all_kept", "none_kept", "stuff_merging", "overlap_filter", "ties", "some_excluded"]


@pytest.mark.parametrize("kind", PAN_CASES)
@pytest.mark.parametrize("thresholds", [(0.8, 0.8), (0.5, 0.3)])
def test_panoptic_inference_matches_jax(jinf, kind, thresholds):
    cls, masks = _panoptic_case(kind)
    things, nc = {0, 1, 7}, 5
    got, got_info = panoptic_inference(torch.from_numpy(cls), torch.from_numpy(masks), things, nc,
                                       *thresholds)
    want, want_info = jinf.panoptic_inference(cls, masks, things, nc, *thresholds)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_info == want_info
    if kind == "none_kept":
        assert not got.any() and got_info == []
    if kind == "stuff_merging":
        assert len({s["category_id"] for s in got_info if not s["isthing"]}) == len(
            [s for s in got_info if not s["isthing"]])          # one segment per stuff class
    if kind == "all_kept" and thresholds == (0.5, 0.3):
        assert len(got_info) >= 2


# ------------------------------------------------------- instance inference
@pytest.mark.parametrize("topk", [30, 10])
@pytest.mark.parametrize("panoptic_on", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_instance_inference_matches_jax(jinf, topk, panoptic_on, ties):
    import jax.numpy as jnp

    rng = np.random.default_rng(topk + 2 * panoptic_on + 4 * ties)
    q, nc, hw = 6, 5, (20, 28)
    cls = rng.normal(0, 2, (q, nc + 1)).astype(np.float32)
    masks = rng.normal(0, 3, (q,) + hw).astype(np.float32)
    if ties:
        cls[4], cls[5] = cls[1], cls[1]             # equal scores across queries
        cls[2, 1] = cls[2, 3]                        # and within one query
    is_thing = np.array([True, False, True, False, True])
    got = instance_inference(torch.from_numpy(cls), torch.from_numpy(masks),
                             torch.from_numpy(is_thing), nc, topk=topk, panoptic_on=panoptic_on)
    want = jinf.instance_inference(jnp.asarray(cls), jnp.asarray(masks), jnp.asarray(is_thing), nc,
                                   topk=topk, panoptic_on=panoptic_on)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=SCORE_ATOL)
    assert got["labels"].dtype == torch.int32 and got["masks"].dtype == torch.bool
    if panoptic_on:
        assert (got["scores"][~got["valid"]] == 0).all() and not got["valid"].all()


def test_thing_lookup_ignores_ids_out_of_range():
    assert thing_lookup({0, 3, 9, -1}, 5).tolist() == [True, False, False, True, False]


# --------------------------------------------------------------- evaluators
@pytest.fixture(scope="module")
def jev():
    pytest.importorskip("jax")
    from autofocusformermod_tpu.evaluation import instance_evaluation, panoptic_evaluation

    return SimpleNamespace(pan=panoptic_evaluation, inst=instance_evaluation)


def _panoptic_pairs(seed, n=4, hw=(40, 56), nc=6):
    """(pred map, pred info, gt map, gt info): block maps; predictions are
    the ground truth with blocks relabelled, moved and merged; crowd and
    void regions in the ground truth."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        blocks = rng.integers(1, 9, (hw[0] // 8, hw[1] // 8))
        gt = (blocks.repeat(8, 0).repeat(8, 1) * 1000 + 7).astype(np.int32)
        gt[rng.random(hw) < 0.05] = 0                                   # void
        ids = [int(i) for i in np.unique(gt) if i]
        gt_info = [{"id": i, "category_id": int(rng.integers(0, nc)),
                    "iscrowd": int(rng.random() < 0.15)} for i in ids]
        pred = np.roll(gt, int(rng.integers(0, 4)), axis=1).copy()
        pred[pred == ids[0]] = ids[1] if len(ids) > 1 else ids[0]       # a merge
        pred[: hw[0] // 4] = np.where(rng.random((hw[0] // 4, hw[1])) < 0.3, 0,
                                      pred[: hw[0] // 4])
        pids = [int(i) for i in np.unique(pred) if i]
        by_id = {s["id"]: s["category_id"] for s in gt_info}
        pred_info = [{"id": i, "isthing": bool(by_id.get(i, 0) < 3),
                      "category_id": by_id.get(i, 0) if rng.random() < 0.8
                      else int(rng.integers(0, nc))} for i in pids]
        yield pred, pred_info, gt, gt_info


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_panoptic_evaluator_matches_jax(jev, seed):
    things, nc = {0, 1, 2}, 6
    port, ref = PanopticEvaluator(things, nc), jev.pan.PanopticEvaluator(things, nc)
    other, ref_other = PanopticEvaluator(things, nc), jev.pan.PanopticEvaluator(things, nc)
    for i, args in enumerate(_panoptic_pairs(seed)):
        (port if i % 2 else other).process(*args)
        (ref if i % 2 else ref_other).process(*args)
    port.merge(other)
    ref.merge(ref_other)
    got, want = port.evaluate(), ref.evaluate()
    _assert_metrics_equal(got, want)
    assert 0 < got["PQ"] < 100 and got["PQ_th"] != got["PQ_st"]


def _instance_images(seed, n=4, hw=(30, 40), nc=5, n_pred=12):
    """Per image: (image id, pred masks, classes, scores, gt masks, classes,
    iscrowd): predictions are ground-truth masks shifted, others random."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        m = int(rng.integers(2, 7))
        gts = np.zeros((m,) + hw, bool)
        for j in range(m):
            y, x = rng.integers(0, hw[0] - 8), rng.integers(0, hw[1] - 8)
            gts[j, y: y + int(rng.integers(4, 14)), x: x + int(rng.integers(4, 14))] = True
        gcls = rng.integers(0, nc, m)
        crowd = (rng.random(m) < 0.2).astype(int)
        preds = rng.random((n_pred,) + hw) < 0.1
        pcls = rng.integers(0, nc, n_pred)
        for j in range(min(m, n_pred)):
            preds[j] = np.roll(gts[j], int(rng.integers(-2, 3)), axis=1)
            pcls[j] = gcls[j] if rng.random() < 0.8 else pcls[j]
        preds[-1] = False                                              # an empty prediction
        scores = rng.random(n_pred).astype(np.float32)
        scores[3] = scores[2]                                          # a score tie
        yield f"img{i}", preds, pcls, scores, gts, gcls, crowd


@pytest.mark.parametrize("which", ["coco", "cityscapes", "lvis"])
def test_instance_evaluators_match_jax(jev, tmp_path, which):
    nc = 5
    cls_port, cls_ref = {"coco": (InstanceSegEvaluator, jev.inst.InstanceSegEvaluator),
                         "cityscapes": (CityscapesInstanceEvaluator,
                                        jev.inst.CityscapesInstanceEvaluator),
                         "lvis": (LVISInstanceSegEvaluator,
                                  jev.inst.LVISInstanceSegEvaluator)}[which]
    ids = {c: 10 + 3 * c for c in range(nc)}
    port = cls_port(nc, output_dir=str(tmp_path / "port"), contiguous_id_to_dataset_id=ids)
    ref = cls_ref(nc, output_dir=str(tmp_path / "jax"), contiguous_id_to_dataset_id=ids)
    other, ref_other = cls_port(nc), cls_ref(nc)
    rng = np.random.default_rng(7)
    for k, (img, pm, pc, ps, gm, gc, crowd) in enumerate(_instance_images(len(which))):
        extra = {}
        if which == "cityscapes":
            extra["void_mask"] = rng.random(gm.shape[1:]) < 0.1
        if which == "lvis":
            extra = {"neg_categories": [int(c) for c in rng.integers(0, nc, 2)],
                     "not_exhaustive_categories": [int(rng.integers(0, nc))]}
        (port if k % 2 else other).process(img, pm, pc, ps, gm, gc, crowd, **extra)
        (ref if k % 2 else ref_other).process(img, pm, pc, ps, gm, gc, crowd, **extra)
    port.merge(other)
    ref.merge(ref_other)
    got, want = port.evaluate(), ref.evaluate()
    _assert_metrics_equal(got, want)
    assert 0 < got["AP"] < 100
    port.save_coco_results()
    ref.save_coco_results()
    name = "coco_instances_results.json"
    got_json = json.loads((tmp_path / "port" / name).read_text())
    assert got_json == json.loads((tmp_path / "jax" / name).read_text()) and got_json
    assert {r["category_id"] for r in got_json} <= set(ids.values())


# -------------------------------------------------------------- RLE helpers
def _encode_compressed(counts):
    """pycocotools' rleToString (the inverse of the decoder)."""
    out = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return "".join(out)


@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (33, 65)])
def test_rle_helpers_match_jax(jev, hw):
    from autofocusformermod_tpu.data import mapper_panoptic_instance as jmap

    rng = np.random.default_rng(hw[0])
    masks = [np.zeros(hw, bool), np.ones(hw, bool), rng.random(hw) < 0.3, rng.random(hw) < 0.7]
    for a in masks:
        enc, want = rle_encode(a), jev.inst.rle_encode(a)
        assert enc["size"] == want["size"]
        np.testing.assert_array_equal(enc["counts"], want["counts"])
        np.testing.assert_array_equal(rle_decode_bool(enc), a)
        assert rle_area(enc) == jev.inst.rle_area(want) == int(a.sum())
        for b in masks:
            for crowd in (False, True):
                assert rle_iou(enc, rle_encode(b), crowd) == jev.inst.rle_iou(
                    want, jev.inst.rle_encode(b), crowd)
        coco = {"size": list(hw), "counts": [int(c) for c in enc["counts"]]}
        np.testing.assert_array_equal(rle_decode(coco), jmap.rle_decode(coco))
        np.testing.assert_array_equal(rle_decode(coco), a.astype(np.uint8))
        packed = _encode_compressed(coco["counts"])
        assert _decode_compressed_rle_counts(packed) == jmap._decode_compressed_rle_counts(
            packed) == coco["counts"]
        for c in ({"size": list(hw), "counts": packed},
                  {"size": list(hw), "counts": packed.encode()}):
            np.testing.assert_array_equal(rle_decode(c), a.astype(np.uint8))


# ---------------------------------------------------------- Trainer.test()
PAN_SIZES = [(64, 96), (64, 96)]
INST_SIZES = [(48, 64), (48, 72)]                # mapped to 64x85 and 64x96


def _write_png(path, arr):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _id_png(ids):
    ids = ids.astype(np.int64)
    return np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)


def _gt_from_panoptic(pan, info, rng, nc):
    """A ground truth made from a panoptic prediction: each segment's id
    times 1000 plus 300 (ids past 255), one segment moved down by 3 rows,
    one split into two, a crowd segment, a void band and a segment the
    prediction does not have."""
    gt = np.where(pan > 0, pan.astype(np.int64) * 1000 + 300, 0)
    segs = [{"id": s["id"] * 1000 + 300, "category_id": s["category_id"], "iscrowd": 0}
            for s in info]
    if segs:
        first = segs[0]["id"]
        gt[3:][gt[:-3] == first] = first
        if len(segs) > 1:
            sid = segs[1]["id"]
            gt[(gt == sid) & (np.arange(gt.shape[1])[None] < gt.shape[1] // 2)] = sid + 1
            segs.append({"id": sid + 1, "category_id": segs[1]["category_id"], "iscrowd": 0})
        if len(segs) > 2:
            segs[2]["iscrowd"] = 1
    gt[:, -5:] = 0                                                       # void
    gt[-6:, :10] = 999_999
    segs.append({"id": 999_999, "category_id": int(rng.integers(0, nc)), "iscrowd": 0})
    present = set(np.unique(gt).tolist())
    return gt, [s for s in segs if s["id"] in present]


def _coco_rle(mask):
    """COCO's uncompressed RLE of an (h, w) bool mask."""
    return {"size": list(mask.shape), "counts": [int(c) for c in rle_encode(mask)["counts"]]}


@pytest.fixture(scope="module")
def testrun(tmp_path_factory):
    """Trainer.test() of the port over a panoptic, a COCO-instance and a
    Cityscapes-instance dataset, and the JAX pieces composed as its
    Trainer composes them, with the same weights and files."""
    pytest.importorskip("jax")
    pytest.importorskip("PIL")
    import jax
    import jax.numpy as jnp

    from autofocusformermod_tpu.data.mapper_panoptic_instance import (
        MaskFormerInstanceDatasetMapper as JaxInstMapper,
        MaskFormerPanopticDatasetMapper as JaxPanMapper, polygons_to_mask as jax_poly,
        rle_decode as jax_rle)
    from autofocusformermod_tpu.engine.convert_checkpoint import convert_reference_state_dict
    from autofocusformermod_tpu.engine.train import Trainer as JaxTrainer
    from autofocusformermod_tpu.evaluation import (
        CityscapesInstanceEvaluator as JaxCityEval, InstanceSegEvaluator as JaxInstEval,
        PanopticEvaluator as JaxPanEval)
    from autofocusformermod_tpu.models import maskformer as jm
    from autofocusformermod_tpu.models import maskformer_from_config as jax_maskformer
    from autofocusformermod_tpu.models.inference import (
        instance_inference as jax_instance, panoptic_inference as jax_panoptic,
        sem_seg_postprocess as jax_postprocess)
    from autofocusformermod_torch.models.maskformer import (init_random_weights,
                                                            maskformer_from_config)
    from test_torch_eval import _port_cfg
    from test_torch_model import tiny_cfg
    from test_torch_train import _flax_tree

    tmp = tmp_path_factory.mktemp("pan")
    jcfg = tiny_cfg()
    jcfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES = 6
    jcfg.INPUT.MIN_SIZE_TEST, jcfg.INPUT.MAX_SIZE_TEST = 64, 128
    t = jcfg.MODEL.MASK_FORMER.TEST
    t.OBJECT_MASK_THRESHOLD, t.OVERLAP_THRESHOLD, t.PANOPTIC_ON = 0.25, 0.5, False
    jcfg.TEST.DETECTIONS_PER_IMAGE = 10
    nc = jcfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    things = {0: 0, 1: 1}

    weights = init_random_weights(maskformer_from_config(jcfg), torch.Generator().manual_seed(2))
    flat_p, flat_s = convert_reference_state_dict(
        {k: v.numpy().copy() for k, v in weights.state_dict().items()})
    params, stats = _flax_tree(flat_p), _flax_tree(flat_s)
    names = {"pan": "torch_pan_tiny", "coco": "torch_coco_inst_tiny",
             "city": "torch_city_inst_tiny"}
    cfg = _port_cfg(jcfg, tmp / "out", names["pan"])
    cfg.MODEL.MASK_FORMER.TEST = Cfg({k: t[k] for k in (
        "OBJECT_MASK_THRESHOLD", "OVERLAP_THRESHOLD", "PANOPTIC_ON", "SEMANTIC_ON",
        "INSTANCE_ON")})
    trainer = Trainer(cfg, torch.device("cpu"))
    trainer.model.load_state_dict(flax_to_torch_state_dict(params, stats), strict=True)
    rng = np.random.default_rng(0)

    # images, and ground truth made from the port's predictions on them
    pan_files, inst_files = [], []
    with trainer._eval_mode():
        for i, (h, w) in enumerate(PAN_SIZES + INST_SIZES):
            coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
            img = coarse.repeat(8, 0).repeat(8, 1)[:h, :w].astype(np.uint8)
            path = str(tmp / "img" / f"{i}.png")
            _write_png(path, img)
            if i < len(PAN_SIZES):
                logits, masks = trainer._predict_image(img)
                pan, info = panoptic_inference(logits, masks, set(things.values()), nc, 0.25, 0.5)
                gt, segs = _gt_from_panoptic(pan.numpy(), info, rng, nc)
                pan_path = str(tmp / "pan" / f"{i}.png")
                _write_png(pan_path, _id_png(gt))
                pan_files.append({"file_name": path, "pan_seg_file_name": pan_path,
                                  "image_id": i, "height": h, "width": w,
                                  "segments_info": segs})
            else:
                mh, mw = 64, int(round(w * 64 / h))
                logits, masks = trainer._predict_image(
                    trainer_resize(img, (mh, mw)))
                masks = torch.nn.functional.interpolate(masks[None], (h, w), mode="bilinear",
                                                        antialias=True)[0]
                annos = [{"category_id": int(c), "iscrowd": 0, "segmentation": _coco_rle(m)}
                         for c, m in zip(logits[:, :nc].argmax(1).tolist(), (masks > 0).numpy())
                         if m.any()][:3]
                annos.append({"category_id": 1, "iscrowd": 0,
                              "segmentation": [[2, 2, 20.4, 3, 18, 30.6, 1, 25]]})
                annos.append({"category_id": 0, "iscrowd": 1,
                              "segmentation": [[30, 30, 40, 30, 40, 40]]})
                inst_files.append({"file_name": path, "image_id": 100 + i, "height": h,
                                   "width": w, "annotations": annos})
    for key, files in (("pan", pan_files), ("coco", inst_files), ("city", inst_files)):
        DatasetCatalog.remove(names[key])
        DatasetCatalog.register(names[key], lambda files=files: [dict(d) for d in files])
    MetadataCatalog.get(names["pan"]).set(evaluator_type="cityscapes_panoptic_seg",
                                          thing_dataset_id_to_contiguous_id=things)
    MetadataCatalog.get(names["coco"]).set(evaluator_type="coco_instance",
                                           thing_dataset_id_to_contiguous_id={
                                               i: i for i in range(nc)})
    MetadataCatalog.get(names["city"]).set(evaluator_type="cityscapes_instance",
                                           thing_dataset_id_to_contiguous_id={
                                               i: i for i in range(nc)})
    cfg.DATASETS.TEST = [names["pan"], names["coco"], names["city"]]
    captured = []
    real = Trainer._predict_image

    def capture(self, image):
        captured.append(real(self, image))
        return captured[-1]

    Trainer._predict_image = capture
    try:
        trainer.model.train()
        results = trainer.test()
        assert trainer.model.training
    finally:
        Trainer._predict_image = real

    # the JAX side, composed as its Trainer composes it
    jmodel = jax_maskformer(jcfg)
    apply = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x, train=False))
    stand_in = SimpleNamespace(cfg=jcfg)

    def predict(img):
        h, w = img.shape[:2]
        padded = JaxTrainer._pad_eval_image(stand_in, img)
        out = apply(params, stats, jnp.asarray(padded, jnp.float32)[None])
        masks = jm.upsample_masks(out["pred_masks"], padded.shape[:2])[0]
        return out["pred_logits"][0], masks[:, :h, :w]

    ref, ref_outputs = {}, []
    evaluator = JaxPanEval(set(things.values()), nc)
    mapper = JaxPanMapper.from_config(jcfg, is_train=False)
    for d in pan_files:
        sample = mapper(d)
        logits, masks = predict(sample["image"])
        ref_outputs.append((np.asarray(logits), np.asarray(masks)))
        pan, info = jax_panoptic(logits, masks, set(things.values()), nc, 0.25, 0.5)
        evaluator.process(pan, info, sample["pan_seg"], sample["segments_info"])
    ref[names["pan"]] = evaluator.evaluate()
    is_thing = np.zeros(nc, bool)
    is_thing[list(range(nc))] = True
    for key, ev_cls in (("coco", JaxInstEval), ("city", JaxCityEval)):
        evaluator = ev_cls(nc, output_dir=str(tmp / f"jax_{key}"),
                           contiguous_id_to_dataset_id={i: i for i in range(nc)})
        mapper = JaxInstMapper(is_train=False, min_size_test=64, max_size_test=128)
        for d in inst_files:
            sample = mapper(d)
            logits, masks = predict(sample["image"])
            ref_outputs.append((np.asarray(logits), np.asarray(masks)))
            masks = jax_postprocess(masks, masks.shape[-2:], (d["height"], d["width"]))
            inst = jax_instance(logits, masks, jnp.asarray(is_thing), nc, topk=10,
                                panoptic_on=False)
            gl, gm = [], []
            for a in d["annotations"]:
                if a["iscrowd"]:
                    continue
                seg = a["segmentation"]
                gm.append(jax_poly(seg, d["height"], d["width"]).astype(bool)
                          if isinstance(seg, list) else jax_rle(seg).astype(bool))
                gl.append(a["category_id"])
            evaluator.process(d["image_id"], np.asarray(inst["masks"]),
                              np.asarray(inst["labels"]), np.asarray(inst["scores"]),
                              np.stack(gm), np.asarray(gl))
        ref[names[key]] = evaluator.evaluate()
    return {"results": results, "ref": ref, "names": names, "captured": captured,
            "ref_outputs": ref_outputs, "out": tmp / "out", "nc": nc}


def trainer_resize(img, hw):
    from autofocusformermod_torch.data.transforms import resize_image

    return resize_image(img, hw)


def _prob_masks(logits, masks, nc, threshold=0.25):
    """The panoptic inference's per-query prob masks (-1 where excluded)."""
    probs = torch.softmax(torch.as_tensor(np.asarray(logits)), -1)
    keep = (probs.argmax(1) != nc) & (probs.max(1).values > threshold)
    return torch.where(keep[:, None, None], probs.max(1).values[:, None, None]
                       * torch.sigmoid(torch.as_tensor(np.asarray(masks))), -1.0)


def test_trainer_test_predictions_match_jax(testrun):
    """The model outputs of every test() image against the JAX model's; the
    panoptic maps equal but at pixels whose two best prob masks, or whose
    winning mask logit, lie within twice the two sides' difference (few);
    no instance mask logit at the original size lies that close to 0."""
    from autofocusformermod_tpu.models.inference import panoptic_inference as jax_panoptic
    from autofocusformermod_tpu.models.inference import sem_seg_postprocess as jax_postprocess

    got, ref, nc = testrun["captured"], testrun["ref_outputs"], testrun["nc"]
    assert len(got) == len(PAN_SIZES) + 2 * len(INST_SIZES) == len(ref)
    for (logits, masks), (rl, rm) in zip(got, ref):
        assert tuple(masks.shape) == rm.shape
        np.testing.assert_allclose(logits.numpy(), rl, rtol=0, atol=1e-4 * np.abs(rl).max())
        np.testing.assert_allclose(masks.numpy(), rm, rtol=0, atol=1e-4 * np.abs(rm).max())
    for (logits, masks), (rl, rm) in zip(got[: len(PAN_SIZES)], ref):
        pm, rpm = _prob_masks(logits, masks, nc), _prob_masks(rl, rm, nc)
        err = float((pm - rpm).abs().max())
        logit_err = float(np.abs(masks.numpy() - rm).max())
        top2 = rpm.topk(2, dim=0)
        win_logit = torch.as_tensor(rm).gather(0, top2.indices[:1])[0]
        tied = ((top2.values[0] - top2.values[1]) <= 2 * err) | (win_logit.abs() <= 2 * logit_err)
        pan, _ = panoptic_inference(logits, masks, {0, 1}, nc, 0.25, 0.5)
        want, _ = jax_panoptic(rl, rm, {0, 1}, nc, 0.25, 0.5)
        differ = pan.numpy() != want
        assert not (differ & ~tied.numpy()).any() and tied.float().mean() < 0.01, (
            int(differ.sum()), int(tied.sum()))
    for (logits, masks), (rl, rm), hw in zip(got[len(PAN_SIZES):], ref[len(PAN_SIZES):],
                                             INST_SIZES * 2):
        resized = sem_seg_postprocess(masks, masks.shape[-2:], hw)
        want = np.asarray(jax_postprocess(rm, rm.shape[-2:], hw))
        err = float(np.abs(resized.numpy() - want).max())
        assert err < 1e-4 * np.abs(want).max() and (np.abs(want) > 2 * err).all(), err


def test_trainer_test_metrics_match_jax(testrun):
    names, results, ref = testrun["names"], testrun["results"], testrun["ref"]
    assert set(results) == set(names.values())
    pq = results[names["pan"]]
    assert set(pq) == {"PQ", "SQ", "RQ", "PQ_th", "SQ_th", "RQ_th", "PQ_st", "SQ_st", "RQ_st"}
    assert 0 < pq["PQ"] < 100, pq
    assert 0 < results[names["coco"]]["AP"] < 100, results[names["coco"]]
    for name in names.values():
        _assert_metrics_equal(results[name], ref[name])
    saved = json.loads((testrun["out"] / "coco_instances_results.json").read_text())
    assert saved and {"image_id", "category_id", "score", "segmentation"} == set(saved[0])


def test_trainer_test_dispatches_by_evaluator_type(monkeypatch):
    """cityscapes_panoptic_seg and coco_panoptic_seg -> _eval_panoptic;
    coco_instance -> _eval_instance; the rest -> _eval_sem_seg."""
    cfg = aff_mini_cfg()
    stand_in = Trainer.__new__(Trainer)
    stand_in.cfg = cfg
    calls = []
    for kind in ("panoptic", "instance", "sem_seg"):
        monkeypatch.setattr(Trainer, f"_eval_{kind}",
                            lambda self, name, kind=kind: calls.append((name, kind)) or {})
    cases = {"d_city_pan": "cityscapes_panoptic_seg", "d_coco_pan": "coco_panoptic_seg",
             "d_coco_inst": "coco_instance", "d_sem": "sem_seg", "d_city_sem": "cityscapes_sem_seg"}
    for name, etype in cases.items():
        MetadataCatalog.get(name).set(evaluator_type=etype)
    cfg.DATASETS.TEST = list(cases)
    Trainer.test(stand_in)
    assert calls == [("d_city_pan", "panoptic"), ("d_coco_pan", "panoptic"),
                     ("d_coco_inst", "instance"), ("d_sem", "sem_seg"),
                     ("d_city_sem", "sem_seg")]
