"""The MaskFormer semantic dataset mapper: read an image and its label map,
then (training) a multi-scale shortest-edge resize, the category-constrained
random crop, the SSD colour jitter, a flip, padding to the crop size (image
128, label map the ignore label) and the per-class target slots; (testing)
the shortest-edge resize to the test size.

Counterpart of ``autofocusformermod_tpu/data/mapper_semantic.py``
(``MaskFormerSemanticDatasetMapper``, ``_pack_class_targets``).  The
COCO-stuff remap and the LSJ mapper wait for ROADMAP.md section 1 item 5.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from . import transforms as T


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading an image or a label map needs PIL (Pillow), which is not "
                          "installed; MaskFormerSemanticDatasetMapper.map_arrays takes arrays "
                          "read by other means") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """(h, w, 3) uint8 RGB."""
    return np.asarray(_pil_image().open(path).convert("RGB"))


def read_sem_seg(path: str) -> np.ndarray:
    """(h, w) int64 class ids as stored in the PNG."""
    return np.asarray(_pil_image().open(path)).astype(np.int64)


class MaskFormerSemanticDatasetMapper:
    """``mapper(dataset_dict) -> sample``.  Training samples carry 'image'
    (H, W, 3) uint8 padded to the crop size, 'sem_seg_map' (H, W) uint8,
    'labels' (max_gt,) int32 and 'valid' (max_gt,) bool; test samples the
    resized 'image' and 'sem_seg' (h, w).  Both carry 'height' and 'width'
    (the original size), 'image_hw' and 'file_name'.  ``self.rng`` draws the
    training augmentations."""

    def __init__(self, is_train: bool = True, *, min_size_train: Sequence[int] = (512,),
                 max_size_train: int = 2048, min_size_test: int = 512, max_size_test: int = 2048,
                 crop_enabled: bool = True, crop_size=(512, 512),
                 single_category_max_area: float = 1.0, color_aug_ssd: bool = True,
                 size_divisibility: int = 512, ignore_label: int = 255, max_gt: int = 100,
                 seed: int = 0):
        self.is_train = is_train
        self.min_size_train = list(min_size_train)
        self.max_size_train = max_size_train
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test
        self.crop_enabled = crop_enabled
        self.crop_size = tuple(crop_size)
        self.single_category_max_area = single_category_max_area
        self.color_aug_ssd = color_aug_ssd
        self.size_divisibility = size_divisibility
        self.ignore_label = ignore_label
        self.max_gt = max_gt
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        return cls(is_train=is_train, min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
                   max_size_train=cfg.INPUT.MAX_SIZE_TRAIN, min_size_test=cfg.INPUT.MIN_SIZE_TEST,
                   max_size_test=cfg.INPUT.MAX_SIZE_TEST, crop_enabled=cfg.INPUT.CROP.ENABLED,
                   crop_size=cfg.INPUT.CROP.SIZE,
                   single_category_max_area=cfg.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA,
                   color_aug_ssd=cfg.INPUT.COLOR_AUG_SSD,
                   size_divisibility=cfg.INPUT.SIZE_DIVISIBILITY,
                   ignore_label=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
                   max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed)

    def __call__(self, dataset_dict: Dict) -> Dict:
        return self.map_arrays(read_image(dataset_dict["file_name"]),
                               read_sem_seg(dataset_dict["sem_seg_file_name"]), dataset_dict)

    def map_arrays(self, img: np.ndarray, sem_seg: np.ndarray, dataset_dict: Dict) -> Dict:
        """Everything after reading: img (h, w, 3) uint8, sem_seg (h, w) ids."""
        orig_h, orig_w = img.shape[:2]
        if self.is_train:
            short = int(self.rng.choice(self.min_size_train))
            img, sem_seg = T.resize_shortest_edge(img, sem_seg, short, self.max_size_train)
            if self.crop_enabled:
                img, sem_seg = T.random_crop_with_category_constraint(
                    self.rng, img, sem_seg, self.crop_size, self.single_category_max_area,
                    self.ignore_label)
            if self.color_aug_ssd:
                img = T.color_aug_ssd(self.rng, img)
            img, sem_seg = T.hflip(self.rng, img, sem_seg)
            if self.size_divisibility > 0:
                # the fixed crop size, so every batch has one shape
                img, sem_seg = T.pad_to_size(
                    img, sem_seg, (max(self.crop_size[0], self.size_divisibility),
                                   max(self.crop_size[1], self.size_divisibility)),
                    128, self.ignore_label)
        else:
            img, sem_seg = T.resize_shortest_edge(img, sem_seg, self.min_size_test,
                                                  self.max_size_test)
        out = {"image": np.ascontiguousarray(img),
               "height": dataset_dict.get("height", orig_h),
               "width": dataset_dict.get("width", orig_w),
               "image_hw": img.shape[:2],
               "file_name": dataset_dict["file_name"]}
        if not self.is_train:
            out["sem_seg"] = sem_seg
            return out
        out.update(_pack_class_targets(sem_seg, self.ignore_label, self.max_gt))
        return out


def _pack_class_targets(sem_seg: np.ndarray, ignore_label: int, max_gt: int) -> Dict:
    """The classes present (ignore label excluded, ascending) in max_gt
    slots with a validity mask, and the label map; the (t, H, W) masks are
    made from these on the device (``engine/train_step.py:device_masks``)."""
    classes = np.unique(sem_seg)
    classes = classes[classes != ignore_label][:max_gt]
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    labels[:len(classes)] = classes
    valid[:len(classes)] = True
    return {"labels": labels, "valid": valid,
            "sem_seg_map": sem_seg.astype(np.uint8 if ignore_label <= 255 else np.int32)}
