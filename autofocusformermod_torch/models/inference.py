"""Semantic-segmentation inference: post-processing and a predictor.

Counterpart of the semantic part of ``autofocusformermod_tpu/models/
inference.py`` and of ``demo/demo.py``'s ``VisualizationDemo`` predict path.
"""

from __future__ import annotations

from typing import Tuple, Union

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
