"""Test-time augmentation: the class scores of several scales and their
horizontal flips, each resized back to the image, averaged.

Counterpart of ``autofocusformermod_tpu/models/tta.py``
(``SemanticSegmentorWithTTA``): the image is resized by OpenCV's 8-bit
bilinear rule (``data/transforms.py:resize_image``), the scores, on their
device, by ``F.interpolate`` (half-pixel bilinear without antialiasing,
OpenCV's INTER_LINEAR on float data).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..data.transforms import resize_image


class SemanticSegmentorWithTTA:
    def __init__(self, predict_fn: Callable[[np.ndarray], torch.Tensor],
                 min_sizes: Sequence[int] = (256, 384, 512, 640, 768, 896),
                 max_size: int = 3584, flip: bool = True):
        """predict_fn(image (h, w, 3) uint8) -> (nc, h, w) class scores."""
        self.predict_fn = predict_fn
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip

    def __call__(self, image: np.ndarray) -> torch.Tensor:
        """(nc, h, w) mean class scores of the image (h, w, 3) uint8."""
        h, w = image.shape[:2]
        total, count = None, 0
        for short in self.min_sizes:
            scale = short / min(h, w)
            if max(h, w) * scale > self.max_size:
                scale = self.max_size / max(h, w)
            resized = resize_image(image, (int(round(h * scale)), int(round(w * scale))))
            variants = [resized] + ([np.ascontiguousarray(resized[:, ::-1])] if self.flip else [])
            for vi, img in enumerate(variants):
                sem = torch.as_tensor(self.predict_fn(img)).float()
                if vi == 1:
                    sem = sem.flip(-1)
                sem = nn.functional.interpolate(sem[None], size=(h, w), mode="bilinear",
                                                align_corners=False)[0]
                total = sem if total is None else total + sem
                count += 1
        return total / count
