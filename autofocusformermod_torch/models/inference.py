"""Inference post-processing -- semantic, panoptic and instance --,
sliding-window stitching and a semantic predictor.

Counterpart of ``autofocusformermod_tpu/models/inference.py`` and of
``demo/demo.py``'s ``VisualizationDemo`` predict path.  The panoptic and
instance post-processing run as tensor operations on the device of the
model's outputs; only ``segments_info`` is assembled on the host, from
(q,)-sized results.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.gather import topk_indices
from ..parallel import precision
from .maskformer import semantic_inference, upsample_masks


def sem_seg_postprocess(result: torch.Tensor, img_hw: Tuple[int, int],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop the padded (c, H_pad, W_pad) prediction to the image and resize it
    bilinearly to out_hw (antialiased when shrinking, as jax.image.resize)."""
    result = result[:, : img_hw[0], : img_hw[1]]
    shrink = out_hw[0] < result.shape[1] or out_hw[1] < result.shape[2]
    return nn.functional.interpolate(result[None], size=tuple(out_hw), mode="bilinear",
                                     align_corners=False, antialias=shrink)[0]


def panoptic_inference_arrays(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                              is_thing: torch.Tensor, num_classes: int,
                              object_mask_threshold: float = 0.8,
                              overlap_threshold: float = 0.8) -> Tuple[torch.Tensor, ...]:
    """Panoptic inference of one image, vectorised over the queries.

    mask_cls (q, nc+1) logits, mask_pred (q, h, w) mask logits, is_thing
    (nc,) bool.  Each pixel goes to the query of the largest prob mask
    (score x sigmoid; excluded queries -1, ties to the lowest index); a
    kept query opens a segment when it wins pixels, its mask has pixels and
    its won pixels inside its mask are at least ``overlap_threshold`` of its
    mask; the valid stuff queries of one class join the segment of the
    earliest of them; segment ids count up from 1 in query order.

    Returns (panoptic (h, w) int32, is_new (q,) bool: the query opened a
    segment, seg_id (q,) int32, seg_class (q,) int32, seg_isthing (q,)
    bool).  No (q, h, w) integer tensor is made: the areas come from
    counts of the winning query per pixel."""
    q = mask_cls.shape[0]
    dev = mask_cls.device
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores = probs.max(dim=-1).values
    labels = probs.argmax(dim=-1)
    keep = (labels != num_classes) & (scores > object_mask_threshold)
    cur_masks = torch.sigmoid(mask_pred.float())                          # (q, h, w)
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * cur_masks,
                             cur_masks.new_tensor(-1.0))
    ids = prob_masks.argmax(dim=0)                                        # (h, w)
    del prob_masks
    binary = cur_masks >= 0.5
    del cur_masks
    won_inside = binary.gather(0, ids[None])[0]                           # (h, w)
    flat = ids.reshape(-1)
    mask_area = torch.bincount(flat, minlength=q).float()
    original_area = binary.sum(dim=(1, 2)).float()
    inter = torch.bincount(flat[won_inside.reshape(-1)], minlength=q)
    del binary
    valid = (keep & (mask_area > 0) & (original_area > 0) & (inter > 0)
             & (mask_area / original_area.clamp(min=1.0) >= overlap_threshold) & keep.any())

    cls = labels.clamp(0, num_classes - 1)
    isthing = is_thing.to(dev)[cls] & (labels != num_classes)
    qi = torch.arange(q, device=dev)
    same_class_valid = valid[None, :] & (labels[None, :] == labels[:, None])
    earlier = qi[None, :] <= qi[:, None]
    first_same = (same_class_valid.long() * earlier.long() * (q - qi[None, :])).argmax(dim=1)
    rep = torch.where(isthing, qi, torch.where(valid, first_same, qi))
    is_new = valid & (rep == qi)
    seg_num = torch.cumsum(is_new.int(), 0)
    seg_id_own = torch.where(is_new, seg_num, torch.zeros_like(seg_num))
    seg_id = torch.where(valid, seg_id_own[rep], torch.zeros_like(seg_num)).int()

    pix_valid = valid[ids] & won_inside
    panoptic = torch.where(pix_valid, seg_id[ids], torch.zeros_like(ids, dtype=torch.int32))
    return panoptic.int(), is_new, seg_id, cls.int(), isthing


def thing_lookup(thing_ids: Iterable[int], num_classes: int) -> torch.Tensor:
    """(num_classes,) bool: True at the thing classes in range."""
    is_thing = torch.zeros(num_classes, dtype=torch.bool)
    for t in thing_ids:
        if 0 <= t < num_classes:
            is_thing[t] = True
    return is_thing


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, thing_ids,
                       num_classes: int, object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8) -> Tuple[torch.Tensor, List[Dict]]:
    """(panoptic (h, w) int32 on the outputs' device, segments_info
    [{'id', 'isthing', 'category_id'}] in segment order)."""
    panoptic, is_new, seg_id, cls, isthing = panoptic_inference_arrays(
        mask_cls, mask_pred, thing_lookup(thing_ids, num_classes), num_classes,
        object_mask_threshold, overlap_threshold)
    is_new, seg_id, cls, isthing = (t.cpu().numpy() for t in (is_new, seg_id, cls, isthing))
    segments_info = [{"id": int(seg_id[k]), "isthing": bool(isthing[k]),
                      "category_id": int(cls[k])} for k in np.nonzero(is_new)[0]]
    return panoptic, segments_info


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, is_thing: torch.Tensor,
                       num_classes: int, topk: int = 100,
                       panoptic_on: bool = False) -> Dict[str, torch.Tensor]:
    """Instance inference of one image: the topk (query, class) pairs by
    class probability (ties to the lowest flat index, as jax.lax.top_k),
    each with its query's mask thresholded at logit 0 and the score times
    the mean sigmoid inside that mask.  With ``panoptic_on`` a pair of a
    stuff class is kept with score 0 and ``valid`` False (fixed shapes).
    Returns {'scores' (topk,), 'labels' (topk,) int32, 'masks' (topk, h, w)
    bool, 'valid' (topk,) bool}."""
    scores = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]             # (q, nc)
    flat = scores.reshape(-1)
    top_idx = topk_indices(flat[None], topk)[0]
    top_scores = flat[top_idx]
    labels = top_idx % num_classes
    masks = mask_pred.float()[top_idx // num_classes]                   # (topk, h, w)
    valid = (is_thing.to(mask_cls.device)[labels] if panoptic_on
             else torch.ones_like(top_scores, dtype=torch.bool))
    binary = masks > 0
    fbin = binary.float()
    mask_scores = (torch.sigmoid(masks) * fbin).sum(dim=(1, 2)) / (fbin.sum(dim=(1, 2)) + 1e-6)
    final = torch.where(valid, top_scores * mask_scores, torch.zeros_like(top_scores))
    return {"scores": final, "labels": labels.int(), "masks": binary, "valid": valid}


def sliding_window_grid(img_hw, crop_hw, stride_hw) -> List[Tuple[int, int, int, int]]:
    """Crop windows (y1, x1, y2, x2) covering the image: a crop larger than
    the image collapses crop and stride to min(h, w), and the last window of
    a row or column is shifted inward, so every window has the crop's size."""
    h_img, w_img = int(img_hw[0]), int(img_hw[1])
    h_crop, w_crop = int(crop_hw[0]), int(crop_hw[1])
    h_stride, w_stride = int(stride_hw[0]), int(stride_hw[1])
    if h_crop > h_img or w_crop > w_img:
        h_crop = w_crop = h_stride = w_stride = min(h_img, w_img)
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    windows = []
    for h_idx in range(h_grids):
        for w_idx in range(w_grids):
            y2 = min(h_idx * h_stride + h_crop, h_img)
            x2 = min(w_idx * w_stride + w_crop, w_img)
            windows.append((max(y2 - h_crop, 0), max(x2 - w_crop, 0), y2, x2))
    return windows


def sliding_window_semantic_scores(score_fn: Callable, image: np.ndarray, crop_hw,
                                   stride_hw) -> torch.Tensor:
    """Sliding-window semantic inference: ``score_fn(crop (hc, wc, 3)) ->
    (nc, hc, wc)`` class scores per window, summed into an fp32 canvas on
    the scores' device and divided by how many windows cover each pixel."""
    h_img, w_img = image.shape[:2]
    preds = count = None
    for (y1, x1, y2, x2) in sliding_window_grid((h_img, w_img), crop_hw, stride_hw):
        crop_scores = torch.as_tensor(score_fn(image[y1:y2, x1:x2])).float()
        if preds is None:
            preds = crop_scores.new_zeros((crop_scores.shape[0], h_img, w_img))
            count = crop_scores.new_zeros((1, h_img, w_img))
        preds[:, y1:y2, x1:x2] += crop_scores
        count[:, y1:y2, x1:x2] += 1.0
    assert bool((count > 0).all())
    return preds / count


class SemanticPredictor:
    """uint8 RGB images (b, H, W, 3) -> per-pixel class labels (b, H, W).

    Pads to the size divisibility, then normalize -> forward ->
    upsample_masks -> semantic_inference -> argmax on the model's device,
    and crops the padding off again.  The model is a MaskFormer or a
    MaskFiner (``models/registry.py:build_model``; ``size_divisibility``
    gives the padding each needs)."""

    def __init__(self, model: nn.Module, size_divisibility: int = 32):
        self.model = model.eval()
        self.div = size_divisibility
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, images: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.device)
        b, h, w, _ = x.shape
        ph, pw = -(-h // self.div) * self.div, -(-w // self.div) * self.div
        if (ph, pw) != (h, w):
            x = nn.functional.pad(x, (0, 0, 0, pw - w, 0, ph - h))
        out = precision.apply(self.model, x)
        masks = upsample_masks(out["pred_masks"], (ph, pw))
        sem = semantic_inference(out["pred_logits"], masks)
        return sem[:, :, :h, :w].argmax(dim=1)
