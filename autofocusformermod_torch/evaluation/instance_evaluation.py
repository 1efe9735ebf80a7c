"""Instance-segmentation mask AP in numpy, on run-length-encoded masks:
the COCO protocol (``InstanceSegEvaluator``), the Cityscapes protocol
(``CityscapesInstanceEvaluator``) and LVIS's federated one
(``LVISInstanceSegEvaluator``), and the RLE helpers they share.

Counterpart of ``autofocusformermod_tpu/evaluation/instance_evaluation.py``
(no pycocotools, cityscapesscripts or lvis-api): COCO segm AP matches each
class's detections greedily by score at IoU .50:.05:.95, crowd-aware, with
101-point interpolated precision and 100 detections an image.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 100


def rle_encode(mask: np.ndarray) -> Dict:
    flat = np.asarray(mask, np.uint8).reshape(-1, order="F")
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(runs)
    if flat[0] == 1:
        counts = np.concatenate([[0], counts])
    return {"size": mask.shape, "counts": counts.astype(np.int64)}


def rle_area(rle: Dict) -> int:
    return int(rle["counts"][1::2].sum())


def rle_iou(a: Dict, b: Dict, crowd: bool = False) -> float:
    """IoU of two RLE masks (decode-free intersection via run merging is
    overkill here; decode the smaller extent instead)."""
    am = rle_decode_bool(a)
    bm = rle_decode_bool(b)
    inter = np.logical_and(am, bm).sum()
    if crowd:
        denom = am.sum()
    else:
        denom = am.sum() + bm.sum() - inter
    return float(inter) / float(denom) if denom > 0 else 0.0


def rle_decode_bool(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        if val:
            flat[pos : pos + c] = True
        pos += int(c)
        val = not val
    return flat.reshape((h, w), order="F")


class InstanceSegEvaluator:
    def __init__(self, num_classes: int, class_names=None,
                 output_dir=None, contiguous_id_to_dataset_id=None):
        self.num_classes = num_classes
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.output_dir = output_dir
        # contiguous model class -> dataset category id, for COCO-json output
        # (upstream instance_evaluation.py's reverse_id_mapping)
        self.contiguous_id_to_dataset_id = contiguous_id_to_dataset_id or {}
        self.reset()

    def save_coco_results(self):
        """Write coco_instances_results.json (upstream
        instance_evaluation.py:54-60): one record per detection with RLE
        segmentation, loadable by pycocotools."""
        import json
        import os

        if not self.output_dir:
            return None
        results = []
        for img_id, cls, score, rle in self._dets:
            h, w = rle["size"]
            results.append({
                "image_id": img_id,
                "category_id": self.contiguous_id_to_dataset_id.get(cls, cls),
                "score": score,
                "segmentation": {
                    "size": [int(h), int(w)],
                    "counts": [int(c) for c in rle["counts"]],
                },
            })
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "coco_instances_results.json")
        with open(path, "w") as f:
            json.dump(results, f)
        return path

    def reset(self):
        # per (image, class): matching results at each IoU threshold
        self._dets: List = []   # (img_id, cls, score, rle)
        self._gts: List = []    # (img_id, cls, rle, iscrowd)
        self._img_ids = set()

    def process(self, image_id, pred_masks, pred_classes, pred_scores,
                gt_masks, gt_classes, gt_iscrowd=None):
        """pred_masks: (n, h, w) bool; gt_masks: (m, h, w) bool."""
        self._img_ids.add(image_id)
        order = np.argsort(-np.asarray(pred_scores))[:MAX_DETS]
        for i in order:
            if pred_masks[i].sum() == 0:
                continue
            self._dets.append(
                (image_id, int(pred_classes[i]), float(pred_scores[i]),
                 rle_encode(pred_masks[i]))
            )
        gt_iscrowd = gt_iscrowd if gt_iscrowd is not None else [0] * len(gt_classes)
        for j in range(len(gt_classes)):
            self._gts.append(
                (image_id, int(gt_classes[j]), rle_encode(gt_masks[j]),
                 int(gt_iscrowd[j]))
            )

    def merge(self, other: "InstanceSegEvaluator"):
        self._dets += other._dets
        self._gts += other._gts
        self._img_ids |= other._img_ids

    def _det_ignorable(self, img, cls) -> bool:
        """Whether an UNMATCHED detection of `cls` on `img` is dropped
        instead of counted FP (LVIS not-exhaustive rule; COCO: never)."""
        return False

    def evaluate(self) -> Dict[str, float]:
        T = len(IOU_THRS)
        ap_per_class = []
        ap50_per_class = []
        ap75_per_class = []
        for cls in range(self.num_classes):
            dets = [d for d in self._dets if d[1] == cls]
            gts = [g for g in self._gts if g[1] == cls]
            n_gt = sum(1 for g in gts if not g[3])
            if n_gt == 0:
                continue
            dets.sort(key=lambda d: -d[2])

            gt_by_img: Dict = {}
            for g in gts:
                gt_by_img.setdefault(g[0], []).append(g)

            nd = len(dets)
            tps = np.zeros((T, nd), bool)
            fps = np.zeros((T, nd), bool)
            matched: Dict = {t: set() for t in range(T)}
            for di, (img, _, score, rle) in enumerate(dets):
                cands = gt_by_img.get(img, [])
                ious = [rle_iou(rle, g[2], crowd=bool(g[3])) for g in cands]
                for t, thr in enumerate(IOU_THRS):
                    best, best_j = thr, -1
                    for j, (g, iou) in enumerate(zip(cands, ious)):
                        key = (img, j)
                        if not g[3] and key in matched[t]:
                            continue
                        if iou >= best:
                            # prefer non-crowd matches (COCO protocol)
                            if best_j >= 0 and not cands[best_j][3] and g[3]:
                                continue
                            best, best_j = iou, j
                    if best_j >= 0:
                        if cands[best_j][3]:
                            continue  # matched to crowd: neither TP nor FP
                        matched[t].add((img, best_j))
                        tps[t, di] = True
                    elif not self._det_ignorable(img, cls):
                        fps[t, di] = True

            ap_t = np.zeros(T)
            for t in range(T):
                tp_cum = np.cumsum(tps[t])
                fp_cum = np.cumsum(fps[t])
                recall = tp_cum / n_gt
                precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
                # monotone precision envelope + 101-pt interpolation
                for i in range(len(precision) - 2, -1, -1):
                    precision[i] = max(precision[i], precision[i + 1])
                prec_at = np.zeros(len(RECALL_THRS))
                inds = np.searchsorted(recall, RECALL_THRS, side="left")
                for ri, pi in enumerate(inds):
                    if pi < len(precision):
                        prec_at[ri] = precision[pi]
                ap_t[t] = prec_at.mean()
            ap_per_class.append(ap_t.mean())
            ap50_per_class.append(ap_t[0])
            ap75_per_class.append(ap_t[5])

        if not ap_per_class:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        return {
            "AP": float(np.mean(ap_per_class) * 100),
            "AP50": float(np.mean(ap50_per_class) * 100),
            "AP75": float(np.mean(ap75_per_class) * 100),
        }


class CityscapesInstanceEvaluator(InstanceSegEvaluator):
    """Official cityscapes instance-AP protocol, transcribed from
    cityscapesscripts evalInstanceLevelSemanticLabeling.py (upstream
    Mask2Former evaluates through that library in a subprocess).

    Differences from the COCO protocol (InstanceSegEvaluator):

    - matching is NOT greedy-exclusive: every prediction with IoU strictly
      ABOVE the overlap threshold matches a ground truth; when several
      predictions match one gt, the highest-confidence one carries the TP
      and the others are appended as false positives with their own scores
      (evaluateMatches, "matched_gt" duplicate handling)
    - unmatched gts count as HARD false negatives added to the denominator
      of recall at every score threshold
    - unmatched predictions are dropped (not FPs) when more than overlapTh
      of their pixels lie on ignore regions: void pixels, crowd/group
      instances, or gt instances below minRegionSize=100 px
    - average precision integrates the EXACT score-thresholded PR curve
      (trapezoid via the [-0.5, 0, 0.5] convolution over recall), not the
      COCO 101-point interpolation; no monotone envelope
    - headline AP averages over overlaps 0.50:0.05:0.95 and classes,
      ignoring classes without ground truth (nan-mean); AP50 is the 0.5
      column

    process() takes the same arguments as the base class; gt_iscrowd marks
    group instances, and ``void_mask`` (optional per image) marks unlabeled
    pixels for the ignore-proportion rule."""

    MIN_REGION_SIZE = 100

    def __init__(self, num_classes: int, class_names=None, output_dir=None,
                 contiguous_id_to_dataset_id=None):
        super().__init__(num_classes, class_names, output_dir,
                         contiguous_id_to_dataset_id)
        self._void: Dict = {}

    def process(self, image_id, pred_masks, pred_classes, pred_scores,
                gt_masks, gt_classes, gt_iscrowd=None, void_mask=None):
        if void_mask is not None:
            self._void[image_id] = rle_encode(void_mask)
        # no per-image det cap in the cityscapes protocol: bypass the COCO
        # MAX_DETS truncation in the base process()
        self._img_ids.add(image_id)
        for i in range(len(pred_classes)):
            if pred_masks[i].sum() == 0:
                continue
            self._dets.append(
                (image_id, int(pred_classes[i]), float(pred_scores[i]),
                 rle_encode(pred_masks[i]))
            )
        gt_iscrowd = gt_iscrowd if gt_iscrowd is not None else [0] * len(gt_classes)
        for j in range(len(gt_classes)):
            self._gts.append(
                (image_id, int(gt_classes[j]), rle_encode(gt_masks[j]),
                 int(gt_iscrowd[j]))
            )

    def merge(self, other):
        super().merge(other)
        self._void.update(getattr(other, "_void", {}))

    @staticmethod
    def _rle_intersection(a: Dict, b: Dict) -> int:
        return int(np.logical_and(rle_decode_bool(a), rle_decode_bool(b)).sum())

    def _ap_curve(self, y_true, y_score, hard_fns):
        """Exact PR integration (evalInstanceLevelSemanticLabeling.py
        "compute precision recall curve" block)."""
        y_true = np.asarray(y_true, float)
        y_score = np.asarray(y_score, float)
        if len(y_score) == 0:
            return 0.0
        order = np.argsort(y_score, kind="mergesort")
        y_score = y_score[order]
        y_true = y_true[order]
        cumsum = np.cumsum(y_true)
        thresholds, unique_idx = np.unique(y_score, return_index=True)
        nb = len(unique_idx) + 1
        precision = np.zeros(nb)
        recall = np.zeros(nb)
        nb_examples = len(y_score)
        nb_true = cumsum[-1]
        for res_i, idx in enumerate(unique_idx):
            cum = cumsum[idx - 1] if idx > 0 else 0.0
            tp = nb_true - cum
            fp = nb_examples - idx - tp
            fn = cum + hard_fns
            precision[res_i] = tp / (tp + fp) if (tp + fp) > 0 else 0.0
            recall[res_i] = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        precision[-1] = 1.0
        recall[-1] = 0.0
        r_conv = np.concatenate([[recall[0]], recall, [0.0]])
        steps = np.convolve(r_conv, [-0.5, 0.0, 0.5], "valid")
        return float(np.dot(precision, steps))

    def evaluate(self) -> Dict[str, float]:
        overlaps = np.arange(0.5, 1.0, 0.05)
        ap = np.full((self.num_classes, len(overlaps)), np.nan)

        dets_by = {}
        for d in self._dets:
            dets_by.setdefault((d[0], d[1]), []).append(d)
        gts_by = {}
        gts_ignore_by = {}   # per image: crowd or too-small gts, ANY class
        for g in self._gts:
            if g[3] or rle_area(g[2]) < self.MIN_REGION_SIZE:
                gts_ignore_by.setdefault(g[0], []).append(g)
            else:
                gts_by.setdefault((g[0], g[1]), []).append(g)

        for cls in range(self.num_classes):
            have_gt = any(k[1] == cls for k in gts_by)
            if not have_gt:
                continue
            imgs = sorted({k[0] for k in list(gts_by) + list(dets_by)
                           if k[1] == cls},
                          key=lambda x: str(x))
            for oi, th in enumerate(overlaps):
                y_true, y_score = [], []
                hard_fns = 0
                for img in imgs:
                    gts = gts_by.get((img, cls), [])
                    dts = sorted(dets_by.get((img, cls), []),
                                 key=lambda d: -d[2])
                    ious = np.zeros((len(dts), len(gts)))
                    for di, d in enumerate(dts):
                        for gi, g in enumerate(gts):
                            ious[di, gi] = rle_iou(d[3], g[2])
                    for gi in range(len(gts)):
                        m = [di for di in range(len(dts))
                             if ious[di, gi] > th]
                        if not m:
                            hard_fns += 1
                            continue
                        scores = sorted((dts[di][2] for di in m),
                                        reverse=True)
                        y_true.append(1.0)
                        y_score.append(scores[0])
                        for s in scores[1:]:     # duplicate matches -> FPs
                            y_true.append(0.0)
                            y_score.append(s)
                    # unmatched predictions: FP unless mostly on ignore
                    for di, d in enumerate(dts):
                        if len(gts) and (ious[di] > th).any():
                            continue
                        area = rle_area(d[3])
                        n_ignore = 0
                        if img in self._void:
                            n_ignore += self._rle_intersection(
                                d[3], self._void[img])
                        for g in gts_ignore_by.get(img, []):
                            n_ignore += self._rle_intersection(d[3], g[2])
                        if area > 0 and n_ignore / area <= th:
                            y_true.append(0.0)
                            y_score.append(d[2])
                if y_score:
                    ap[cls, oi] = self._ap_curve(y_true, y_score, hard_fns)
                else:
                    ap[cls, oi] = 0.0

        valid = ~np.all(np.isnan(ap), axis=1)
        if not valid.any():
            return {"AP": 0.0, "AP50": 0.0}
        o50 = int(np.argmin(np.abs(overlaps - 0.5)))
        return {
            "AP": float(np.nanmean(ap[valid]) * 100),
            "AP50": float(np.nanmean(ap[valid][:, o50]) * 100),
        }


class LVISInstanceSegEvaluator(InstanceSegEvaluator):
    """LVIS federated mask AP, transcribed from the lvis-api LVISEval
    semantics (upstream Mask2Former evaluates cocofied LVIS through
    LVISEvaluator).

    Differences from the COCO protocol (InstanceSegEvaluator):

    - FEDERATED evaluation: for each category c, only images where c is
      positively annotated (c appears in the gt) or explicitly negative
      (``neg_categories``) are scored; detections of c on any other image
      are DROPPED — neither TP nor FP (LVIS does not exhaustively annotate
      every image, so absence of gt is not evidence of absence)
    - detections on images where c is marked not-exhaustively annotated
      (``not_exhaustive_categories``) are likewise only matched against the
      existing gts; unmatched ones are dropped rather than counted FP
    - per-image detection cap 300 ACROSS categories (COCO: 100)

    The accumulation (10 IoU thresholds, 101-point interpolation) is
    identical to COCO — for exhaustively annotated synthetic data the two
    protocols coincide exactly (pinned by
    tests/test_evaluator_protocol.py)."""

    MAX_DETS_PER_IMAGE = 300

    def __init__(self, num_classes: int, class_names=None, output_dir=None,
                 contiguous_id_to_dataset_id=None):
        super().__init__(num_classes, class_names, output_dir,
                         contiguous_id_to_dataset_id)
        self._neg: Dict = {}
        self._not_exhaustive: Dict = {}

    def process(self, image_id, pred_masks, pred_classes, pred_scores,
                gt_masks, gt_classes, gt_iscrowd=None,
                neg_categories=(), not_exhaustive_categories=()):
        self._neg[image_id] = set(int(c) for c in neg_categories)
        self._not_exhaustive[image_id] = set(
            int(c) for c in not_exhaustive_categories)
        self._img_ids.add(image_id)
        order = np.argsort(-np.asarray(pred_scores))[: self.MAX_DETS_PER_IMAGE]
        for i in order:
            if pred_masks[i].sum() == 0:
                continue
            self._dets.append(
                (image_id, int(pred_classes[i]), float(pred_scores[i]),
                 rle_encode(pred_masks[i]))
            )
        gt_iscrowd = gt_iscrowd if gt_iscrowd is not None else [0] * len(gt_classes)
        for j in range(len(gt_classes)):
            self._gts.append(
                (image_id, int(gt_classes[j]), rle_encode(gt_masks[j]),
                 int(gt_iscrowd[j]))
            )

    def merge(self, other):
        super().merge(other)
        self._neg.update(getattr(other, "_neg", {}))
        self._not_exhaustive.update(getattr(other, "_not_exhaustive", {}))

    def _det_ignorable(self, img, cls) -> bool:
        return cls in self._not_exhaustive.get(img, set())

    def evaluate(self) -> Dict[str, float]:
        # federated filter: keep detections of class c only on images where
        # c is positive or explicitly negative; then reuse the COCO-protocol
        # matching/accumulation (identical in LVISEval) on the filtered set.
        pos: Dict[int, set] = {}
        for img, cls, _, _ in self._gts:
            pos.setdefault(cls, set()).add(img)
        kept_dets = []
        for d in self._dets:
            img, cls = d[0], d[1]
            if img in pos.get(cls, set()):
                kept_dets.append(d)
            elif cls in self._neg.get(img, set()):
                kept_dets.append(d)
            # else: unannotated for this category -> dropped (federated)
        saved = self._dets
        self._dets = kept_dets
        try:
            return super().evaluate()
        finally:
            self._dets = saved
