"""Semantic-segmentation evaluation: a confusion matrix over predictions
against ground truth, and mIoU / fwIoU / mACC / pACC with the IoU of each
class from it; optional prediction and error-map dumps.

Counterpart of ``autofocusformermod_tpu/evaluation/sem_seg_evaluation.py``,
numpy only (PIL is imported where the dumps are written).  A run of one
process has no merge step; ``merge`` adds another evaluator's matrix.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class SemSegEvaluator:
    """``process(pred, gt)`` per image, then ``evaluate()``.  The matrix has
    a row and a column beyond the classes: ground truth equal to
    ``ignore_label`` lands in that row, and out-of-range ids of either side
    are clipped into [0, num_classes]; ``evaluate`` reads the classes'
    block only."""

    def __init__(self, num_classes: int, ignore_label: int = 255, class_names=None,
                 output_dir: Optional[str] = None, save_predictions: bool = False):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.output_dir = output_dir
        self.save_predictions = save_predictions
        self.reset()

    def reset(self) -> None:
        self._conf = np.zeros((self.num_classes + 1, self.num_classes + 1), dtype=np.int64)

    def _color_map(self) -> np.ndarray:
        """(num_classes, 3) uint8: evenly spaced hues at saturation and value
        0.75, shuffled with Random(1337)."""
        import colorsys
        import random

        hsv = [(i / self.num_classes, 0.75, 0.75) for i in range(self.num_classes)]
        random.Random(1337).shuffle(hsv)
        return (np.array([colorsys.hsv_to_rgb(*c) for c in hsv]) * 255).astype(np.uint8)

    def save_artifacts(self, pred, gt, file_name: str, extras: Optional[Dict] = None) -> None:
        """Under ``<output_dir>/inference_output``: the colorized prediction
        (``<name>_sem_seg.png``), its raw ids (``_sem_seg_raw.npy``), a red
        error map where a non-ignored pixel is wrong (``_error.png``), and a
        grayscale PNG of each extra map."""
        from PIL import Image

        out_dir = os.path.join(self.output_dir, "inference_output")
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.splitext(os.path.basename(file_name or "pred"))[0]

        pred = np.asarray(pred, np.int64)
        rgb = self._color_map()[np.clip(pred, 0, self.num_classes - 1)]
        Image.fromarray(rgb, "RGB").save(os.path.join(out_dir, fn + "_sem_seg.png"))
        np.save(os.path.join(out_dir, fn + "_sem_seg_raw.npy"), pred)

        if gt is not None and np.asarray(gt).shape == pred.shape:
            gt = np.asarray(gt, np.int64)
            err = np.zeros(pred.shape + (3,), np.uint8)
            err[..., 0] = np.where((pred != gt) & (gt != self.ignore_label), 255, 0)
            Image.fromarray(err, "RGB").save(os.path.join(out_dir, fn + "_error.png"))

        for k, v in (extras or {}).items():
            arr = np.clip(np.asarray(v, np.float32), 0, 255).astype(np.uint8)
            Image.fromarray(arr, "L").save(os.path.join(out_dir, f"{fn}_{k}.png"))

    def process(self, pred: np.ndarray, gt: np.ndarray, file_name: str = "",
                extras: Optional[Dict] = None) -> None:
        """pred: (h, w) class ids; gt: (h, w) ids, ``ignore_label`` where
        unlabeled; extras: named (h, w) maps saved beside the prediction."""
        if self.save_predictions and self.output_dir:
            self.save_artifacts(pred, gt, file_name, extras)
        n = self.num_classes
        pred = np.clip(np.asarray(pred, np.int64).reshape(-1), 0, n)
        gt = np.asarray(gt, np.int64).reshape(-1)
        gt = np.clip(np.where(gt == self.ignore_label, n, gt), 0, n)
        self._conf += np.bincount(gt * (n + 1) + pred, minlength=(n + 1) ** 2).reshape(n + 1, n + 1)

    def merge(self, other: "SemSegEvaluator") -> None:
        self._conf += other._conf

    def evaluate(self) -> Dict[str, float]:
        """{'mIoU', 'fwIoU', 'mACC', 'pACC', 'IoU-<class>' for each class that
        has ground truth}, in percent."""
        conf = self._conf[: self.num_classes, : self.num_classes].astype(np.float64)
        tp = np.diag(conf)
        gt_total = conf.sum(axis=1)
        pred_total = conf.sum(axis=0)
        union = gt_total + pred_total - tp
        valid = gt_total > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1), 0.0)
        acc = np.where(valid, tp / np.maximum(gt_total, 1), 0.0)

        miou = float(iou[valid].mean() * 100) if valid.any() else 0.0
        macc = float(acc[valid].mean() * 100) if valid.any() else 0.0
        freq = gt_total / max(gt_total.sum(), 1)
        fwiou = float((freq[valid] * iou[valid]).sum() * 100) if valid.any() else 0.0
        pacc = float(tp.sum() / max(gt_total.sum(), 1) * 100)

        results = {"mIoU": miou, "fwIoU": fwiou, "mACC": macc, "pACC": pacc}
        for i, name in enumerate(self.class_names):
            if valid[i]:
                results[f"IoU-{name}"] = float(iou[i] * 100)
        return results


class MaskFinerSemSegEvaluator(SemSegEvaluator):
    """SemSegEvaluator that also saves the cascade's per-stage disagreement
    maps, passed as ``extras``, as grayscale PNGs beside the prediction."""


class MetaLossSemSegEvaluator(SemSegEvaluator):
    """SemSegEvaluator that saves predicted meta-loss maps, passed as
    ``meta_loss_candidates_scale_<s>`` extras, as ``<name>_meta_loss_scale_<s>.png``."""

    def process(self, pred, gt, file_name="", extras=None):
        extras = {(f"meta_loss_scale_{k[-1]}" if k.startswith("meta_loss_candidates_scale_")
                   else k): v for k, v in (extras or {}).items()}
        super().process(pred, gt, file_name, extras)
