"""Panoptic Quality (PQ, SQ, RQ) in numpy, with panopticapi's semantics:
a predicted and a ground-truth segment of one category match where their
IoU passes 0.5, the union discounting only the prediction's VOID pixels;
an unmatched prediction is no false positive where more than half of it
lies on VOID or on crowd regions of its own category.  Reported over all
classes and over things and stuff apart.

Counterpart of ``autofocusformermod_tpu/evaluation/panoptic_evaluation.py``
(no panopticapi).  ``merge`` adds another evaluator's per-class sums.
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

VOID = 0


class PanopticEvaluator:
    def __init__(self, thing_ids: Set[int], num_classes: int):
        self.thing_ids = set(thing_ids)
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.iou_sum = np.zeros(self.num_classes)
        self.tp = np.zeros(self.num_classes, np.int64)
        self.fp = np.zeros(self.num_classes, np.int64)
        self.fn = np.zeros(self.num_classes, np.int64)

    def process(
        self,
        pred_seg: np.ndarray,
        pred_info: List[Dict],
        gt_seg: np.ndarray,
        gt_info: List[Dict],
    ):
        """pred/gt_seg: (h, w) segment-id maps (0 = void);
        *_info: [{'id', 'category_id', 'isthing'[, 'iscrowd']}]."""
        pred_cat = {s["id"]: s["category_id"] for s in pred_info}
        gt_cat = {
            s["id"]: s["category_id"] for s in gt_info if not s.get("iscrowd", 0)
        }
        # joint histogram of (gt_id, pred_id) pairs
        combined = gt_seg.astype(np.int64) * (2**32) + pred_seg.astype(np.int64)
        ids, counts = np.unique(combined, return_counts=True)
        inter = {}
        for v, c in zip(ids, counts):
            inter[(int(v // 2**32), int(v % 2**32))] = int(c)

        gt_area = {}
        for gid in gt_cat:
            gt_area[gid] = int((gt_seg == gid).sum())
        pred_area = {}
        for pid in pred_cat:
            pred_area[pid] = int((pred_seg == pid).sum())
        # panopticapi semantics: the match union discounts ONLY true-VOID
        # pixels; the FP check additionally discounts crowd regions of the
        # prediction's own category (panopticapi pq_compute_single_core).
        crowd_cat = {s["id"]: s["category_id"] for s in gt_info if s.get("iscrowd", 0)}
        void_only_inter = {pid: inter.get((0, pid), 0) for pid in pred_cat}
        fp_void_inter = {
            pid: void_only_inter[pid]
            + sum(
                inter.get((cid, pid), 0)
                for cid, ccat in crowd_cat.items()
                if ccat == pred_cat[pid]
            )
            for pid in pred_cat
        }

        matched_gt, matched_pred = set(), set()
        for (gid, pid), c in inter.items():
            if gid not in gt_cat or pid not in pred_cat:
                continue
            if gt_cat[gid] != pred_cat[pid]:
                continue
            union = (
                gt_area[gid] + pred_area[pid] - c - void_only_inter.get(pid, 0)
            )
            iou = c / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_cat[gid]
                self.iou_sum[cat] += iou
                self.tp[cat] += 1
                matched_gt.add(gid)
                matched_pred.add(pid)

        for gid, cat in gt_cat.items():
            if gid not in matched_gt:
                self.fn[cat] += 1
        for pid, cat in pred_cat.items():
            if pid in matched_pred:
                continue
            # predictions mostly covering void/same-category-crowd don't count as FP
            if pred_area[pid] > 0 and fp_void_inter.get(pid, 0) / pred_area[pid] > 0.5:
                continue
            self.fp[cat] += 1

    def merge(self, other: "PanopticEvaluator"):
        self.iou_sum += other.iou_sum
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn

    def evaluate(self) -> Dict[str, float]:
        def pq_of(sel):
            denom = self.tp[sel] + 0.5 * self.fp[sel] + 0.5 * self.fn[sel]
            valid = denom > 0
            if not valid.any():
                return 0.0, 0.0, 0.0
            pq = (self.iou_sum[sel][valid] / denom[valid]).mean() * 100
            sq = (
                self.iou_sum[sel][valid]
                / np.maximum(self.tp[sel][valid], 1)
            ).mean() * 100
            rq = (self.tp[sel][valid] / denom[valid]).mean() * 100
            return float(pq), float(sq), float(rq)

        all_sel = np.ones(self.num_classes, bool)
        th_sel = np.zeros(self.num_classes, bool)
        for t in self.thing_ids:
            if 0 <= t < self.num_classes:
                th_sel[t] = True
        pq, sq, rq = pq_of(all_sel)
        pq_th, sq_th, rq_th = pq_of(th_sel)
        pq_st, sq_st, rq_st = pq_of(~th_sel)
        return {
            "PQ": pq, "SQ": sq, "RQ": rq,
            "PQ_th": pq_th, "SQ_th": sq_th, "RQ_th": rq_th,
            "PQ_st": pq_st, "SQ_st": sq_st, "RQ_st": rq_st,
        }
