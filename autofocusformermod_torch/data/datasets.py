"""Registration of the builtin datasets under $DETECTRON2_DATASETS:
ADE20K-150 and Cityscapes semantic, any folder of images paired with a
folder of label PNGs, and (``datasets_coco.py``) COCO instance, panoptic
and stuff, cocofied LVIS and Cityscapes panoptic.

Counterpart of ``autofocusformermod_tpu/data/datasets.py``.  Registering
reads no file: a dataset's directories are walked when
``DatasetCatalog.get`` asks for it.
"""

from __future__ import annotations

import os
from typing import Dict, List

from .catalog import DatasetCatalog, MetadataCatalog

ADE20K_SEM_SEG_CATEGORIES = [
    "wall", "building", "sky", "floor", "tree", "ceiling", "road, route", "bed",
    "window ", "grass", "cabinet", "sidewalk, pavement", "person", "earth, ground",
    "door", "table", "mountain, mount", "plant", "curtain", "chair", "car",
    "water", "painting, picture", "sofa", "shelf", "house", "sea", "mirror",
    "rug", "field", "armchair", "seat", "fence", "desk", "rock, stone",
    "wardrobe, closet, press", "lamp", "tub", "rail", "cushion", "base, pedestal, stand",
    "box", "column, pillar", "signboard, sign", "chest of drawers, chest, bureau, dresser",
    "counter", "sand", "sink", "skyscraper", "fireplace", "refrigerator, icebox",
    "grandstand, covered stand", "path", "stairs", "runway",
    "case, display case, showcase, vitrine",
    "pool table, billiard table, snooker table", "pillow",
    "screen door, screen", "stairway, staircase", "river", "bridge, span",
    "bookcase", "blind, screen", "coffee table",
    "toilet, can, commode, crapper, pot, potty, stool, throne",
    "flower", "book", "hill", "bench", "countertop",
    "stove", "palm, palm tree", "kitchen island",
    "computer", "swivel chair", "boat", "bar", "arcade machine",
    "hovel, hut, hutch, shack, shanty", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning, sunshade, sunblind", "street lamp", "booth",
    "tv", "plane", "dirt track", "clothes", "pole",
    "land, ground, soil", "bannister, banister, balustrade, balusters, handrail",
    "escalator, moving staircase, moving stairway",
    "ottoman, pouf, pouffe, puff, hassock", "bottle",
    "buffet, counter, sideboard",
    "poster, posting, placard, notice, bill, card", "stage", "van", "ship",
    "fountain",
    "conveyer belt, conveyor belt, conveyer, conveyor, transporter", "canopy",
    "washer, automatic washer, washing machine", "plaything, toy", "pool",
    "stool", "barrel, cask", "basket, handbasket", "falls", "tent", "bag",
    "minibike, motorbike", "cradle", "oven", "ball", "food, solid food",
    "step, stair", "tank, storage tank", "trade name", "microwave", "pot",
    "animal", "bicycle", "lake", "dishwasher", "screen", "blanket, cover",
    "sculpture", "hood, exhaust hood", "sconce", "vase", "traffic light",
    "tray", "trash can", "fan", "pier", "crt screen", "plate", "monitor",
    "bulletin board", "shower", "radiator", "glass, drinking glass", "clock",
    "flag",
]

CITYSCAPES_SEM_SEG_CATEGORIES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]


def load_sem_seg(gt_root: str, image_root: str, gt_ext="png", image_ext="jpg") -> List[Dict]:
    """[{'file_name', 'sem_seg_file_name'}] for each image under image_root
    whose path relative to it, without its extension, has a label map under
    gt_root (detectron2's load_sem_seg pairing); sorted by image path."""

    def strip(path, root, ext):
        rel = os.path.normpath(os.path.relpath(path, root))
        return rel[: -len(ext) - 1]

    def walk(root, ext):
        out = []
        for dirpath, _, files in os.walk(root):
            out += [os.path.join(dirpath, f) for f in files if f.endswith(ext)]
        return sorted(out)

    gt_by_base = {strip(g, gt_root, gt_ext): g for g in walk(gt_root, gt_ext)}
    dataset = []
    for img in walk(image_root, image_ext):
        base = strip(img, image_root, image_ext)
        if base in gt_by_base:
            dataset.append({"file_name": img, "sem_seg_file_name": gt_by_base[base]})
    return dataset


def register_sem_seg(name, image_root, gt_root, classes, ignore_label=255,
                     image_ext="jpg", gt_ext="png", evaluator_type="sem_seg") -> None:
    DatasetCatalog.register(name, lambda: load_sem_seg(gt_root, image_root, gt_ext, image_ext))
    MetadataCatalog.get(name).set(
        stuff_classes=list(classes), image_root=image_root, sem_seg_root=gt_root,
        ignore_label=ignore_label, evaluator_type=evaluator_type,
        thing_dataset_id_to_contiguous_id={})


def register_all_ade20k(root: str) -> None:
    """ade20k_sem_seg_{train,val}: ADEChallengeData2016's images and its
    annotations_detectron2 label maps (ids 0-149, 255 unlabeled)."""
    base = os.path.join(root, "ADEChallengeData2016")
    for name, split in [("train", "training"), ("val", "validation")]:
        register_sem_seg(f"ade20k_sem_seg_{name}",
                         image_root=os.path.join(base, "images", split),
                         gt_root=os.path.join(base, "annotations_detectron2", split),
                         classes=ADE20K_SEM_SEG_CATEGORIES, ignore_label=255)


def register_all_cityscapes_semantic(root: str) -> None:
    base = os.path.join(root, "cityscapes")
    for split in ["train", "val"]:
        register_sem_seg(f"cityscapes_fine_sem_seg_{split}",
                         image_root=os.path.join(base, "leftImg8bit", split),
                         gt_root=os.path.join(base, "gtFine", split),
                         classes=CITYSCAPES_SEM_SEG_CATEGORIES, ignore_label=255,
                         image_ext="png", evaluator_type="cityscapes_sem_seg")


_REGISTERED = False


def register_all_builtin(root: str = "") -> None:
    """Register the builtin datasets under ``root`` (default
    $DETECTRON2_DATASETS, else ``datasets``) once per process."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    register_all_ade20k(root)
    register_all_cityscapes_semantic(root)
    from .datasets_coco import (register_cityscapes_panoptic, register_coco,
                                register_coco_stuff_171, register_coco_stuff_semseg)

    register_coco(root)
    register_coco_stuff_semseg(root)
    register_coco_stuff_171(root)
    register_cityscapes_panoptic(root)
