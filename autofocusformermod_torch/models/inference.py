"""Semantic-segmentation inference: post-processing, sliding-window
stitching and a predictor.

Counterpart of the semantic part of ``autofocusformermod_tpu/models/
inference.py`` and of ``demo/demo.py``'s ``VisualizationDemo`` predict path.
"""

from __future__ import annotations

from typing import Callable, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from .maskformer import semantic_inference, upsample_masks


def sem_seg_postprocess(result: torch.Tensor, img_hw: Tuple[int, int],
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop the padded (c, H_pad, W_pad) prediction to the image and resize it
    bilinearly to out_hw (antialiased when shrinking, as jax.image.resize)."""
    result = result[:, : img_hw[0], : img_hw[1]]
    shrink = out_hw[0] < result.shape[1] or out_hw[1] < result.shape[2]
    return nn.functional.interpolate(result[None], size=tuple(out_hw), mode="bilinear",
                                     align_corners=False, antialias=shrink)[0]


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
        out = self.model(x)
        masks = upsample_masks(out["pred_masks"], (ph, pw))
        sem = semantic_inference(out["pred_logits"], masks)
        return sem[:, :, :h, :w].argmax(dim=1)
