"""The semantic dataset mappers: read an image and its label map, then
(training) a multi-scale shortest-edge resize, the category-constrained
random crop, the SSD colour jitter, a flip, padding to the crop size (image
128, label map the ignore label) and the per-class target slots; (testing)
the shortest-edge resize to the test size.  The COCO LSJ semantic mapper
(``coco_semantic2``) flips, jitters the scale 0.1-2.0 and crops a fixed
square instead.  The coco_semantic* mappers first remap COCO-stuff's
dataset ids to contiguous train ids.

Counterpart of ``autofocusformermod_tpu/data/mapper_semantic.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


# caffe-shifted COCO-stuff dataset ids the COCO semantic mappers send to
# ignore (upstream coco_semantic_dataset_mapper2.py: street sign, hat, shoe,
# eye glasses, plate, mirror, window, desk, door, blender, hair brush)
_COCO_STUFF_REMOVED_DATASET_IDS = (11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90)


def stuff_remap_lut(data_id_to_cont_id: Dict[int, int], ignore_label: int = 255) -> np.ndarray:
    """(256,) int64: COCO-stuff PNG value (a caffe-shifted dataset id) ->
    contiguous train id; unknown values, the removed classes and the ignore
    label itself -> ignore_label."""
    lut = np.full(256, ignore_label, np.int64)
    for did, cid in data_id_to_cont_id.items():
        if 0 <= did < 256:
            lut[did] = cid
    for did in _COCO_STUFF_REMOVED_DATASET_IDS:
        lut[did] = ignore_label
    lut[ignore_label] = ignore_label
    return lut


def _remap_lut_from_cfg(cfg, is_train: bool) -> Optional[np.ndarray]:
    """The remap of the first training (or test) dataset's metadata where a
    coco_semantic* mapper is configured and that metadata has
    stuff_dataset_id_to_contiguous_id; else None."""
    if not cfg.INPUT.DATASET_MAPPER_NAME.startswith("coco_semantic"):
        return None
    from .catalog import MetadataCatalog

    names = cfg.DATASETS.TRAIN if is_train else cfg.DATASETS.TEST
    if not names:
        return None
    meta = MetadataCatalog.get(names[0])
    mapping = meta.get("stuff_dataset_id_to_contiguous_id")
    if not mapping:
        return None
    return stuff_remap_lut(mapping, meta.get("ignore_label", 255))


class MaskFormerSemanticDatasetMapper:
    """``mapper(dataset_dict) -> sample``.  Training samples carry 'image'
    (H, W, 3) uint8 padded to the crop size, 'sem_seg_map' (H, W) uint8,
    'labels' (max_gt,) int32 and 'valid' (max_gt,) bool; test samples the
    resized 'image' and 'sem_seg' (h, w).  Both carry 'height' and 'width'
    (the original size), 'image_hw' and 'file_name'.  ``self.rng`` draws the
    training augmentations; ``dataset_id_remap`` (a 256-entry lookup table)
    maps the label map's values before anything else."""

    def __init__(self, is_train: bool = True, *, min_size_train: Sequence[int] = (512,),
                 max_size_train: int = 2048, min_size_test: int = 512, max_size_test: int = 2048,
                 crop_enabled: bool = True, crop_size=(512, 512),
                 single_category_max_area: float = 1.0, color_aug_ssd: bool = True,
                 size_divisibility: int = 512, ignore_label: int = 255, max_gt: int = 100,
                 seed: int = 0, dataset_id_remap: Optional[np.ndarray] = None):
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
        self.dataset_id_remap = dataset_id_remap

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        return cls(is_train=is_train, dataset_id_remap=_remap_lut_from_cfg(cfg, is_train),
                   min_size_train=cfg.INPUT.MIN_SIZE_TRAIN,
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
        if self.dataset_id_remap is not None:
            sem_seg = self.dataset_id_remap[np.clip(sem_seg, 0, 255)]
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


class COCOSemanticLSJDatasetMapper:
    """The coco_semantic2 mapper (training only): flip, the large-scale
    jitter to INPUT.IMAGE_SIZE (scales MIN_SCALE-MAX_SCALE, a fixed square
    crop, padding) and padding to the size divisibility, after the dataset
    ids are remapped to contiguous train ids."""

    def __init__(self, *, image_size: int = 1024, min_scale: float = 0.1, max_scale: float = 2.0,
                 random_flip: str = "horizontal", size_divisibility: int = 32,
                 ignore_label: int = 255, max_gt: int = 100, seed: int = 0,
                 dataset_id_remap: Optional[np.ndarray] = None):
        self.is_train = True
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.random_flip = random_flip
        self.size_divisibility = size_divisibility
        self.ignore_label = ignore_label
        self.max_gt = max_gt
        self.rng = np.random.default_rng(seed)
        self.dataset_id_remap = dataset_id_remap

    @classmethod
    def from_config(cls, cfg, is_train: bool = True, seed: int = 0):
        assert is_train, "coco_semantic2 only supports training augmentation"
        return cls(image_size=cfg.INPUT.IMAGE_SIZE, min_scale=cfg.INPUT.MIN_SCALE,
                   max_scale=cfg.INPUT.MAX_SCALE, random_flip=cfg.INPUT.RANDOM_FLIP,
                   size_divisibility=cfg.INPUT.SIZE_DIVISIBILITY,
                   ignore_label=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
                   max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed,
                   dataset_id_remap=_remap_lut_from_cfg(cfg, is_train))

    def __call__(self, dataset_dict: Dict) -> Dict:
        return self.map_arrays(read_image(dataset_dict["file_name"]),
                               read_sem_seg(dataset_dict["sem_seg_file_name"]), dataset_dict)

    def map_arrays(self, img: np.ndarray, sem_seg: np.ndarray, dataset_dict: Dict) -> Dict:
        if self.dataset_id_remap is not None:
            sem_seg = self.dataset_id_remap[np.clip(sem_seg, 0, 255)]
        orig_h, orig_w = img.shape[:2]
        if self.random_flip != "none":
            img, sem_seg = T.hflip(self.rng, img, sem_seg)
        img, sem_seg = T.large_scale_jitter(self.rng, img, sem_seg, self.image_size,
                                            self.min_scale, self.max_scale,
                                            seg_value=self.ignore_label)
        if self.size_divisibility > 0:
            img, sem_seg = T.pad_to_divisibility(img, sem_seg, self.size_divisibility, 128,
                                                 self.ignore_label)
        out = {"image": np.ascontiguousarray(img),
               "height": dataset_dict.get("height", orig_h),
               "width": dataset_dict.get("width", orig_w),
               "image_hw": img.shape[:2],
               "file_name": dataset_dict["file_name"]}
        out.update(_pack_class_targets(sem_seg, self.ignore_label, self.max_gt))
        return out
