"""Registration of the COCO instance, panoptic and stuff datasets (with the
cocofied LVIS splits) and of Cityscapes panoptic under
$DETECTRON2_DATASETS, and their JSON loaders.

Counterpart of ``autofocusformermod_tpu/data/datasets_coco.py``: the JSON
files are parsed directly (no pycocotools).  Registering reads no file; a
dataset's JSON is read when ``DatasetCatalog.get`` asks for it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from .catalog import DatasetCatalog, MetadataCatalog

COCO_CATEGORIES_THING_IDS = list(range(1, 91))  # raw COCO ids (80 valid)


def load_coco_instances(json_file: str, image_root: str) -> List[Dict]:
    with open(json_file) as f:
        data = json.load(f)
    id_map = {c["id"]: i for i, c in enumerate(sorted(data["categories"], key=lambda c: c["id"]))}
    imgs = {im["id"]: im for im in data["images"]}
    anns_by_img: Dict[int, List] = {}
    for a in data.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)
    out = []
    for img_id, im in imgs.items():
        annos = []
        for a in anns_by_img.get(img_id, []):
            annos.append(
                {
                    "category_id": id_map[a["category_id"]],
                    "segmentation": a.get("segmentation"),
                    "iscrowd": a.get("iscrowd", 0),
                    "bbox": a.get("bbox"),
                }
            )
        out.append(
            {
                "file_name": os.path.join(image_root, im["file_name"]),
                "image_id": img_id,
                "height": im["height"],
                "width": im["width"],
                "annotations": annos,
            }
        )
    return out


def load_coco_panoptic(json_file: str, image_root: str, pan_root: str) -> List[Dict]:
    with open(json_file) as f:
        data = json.load(f)
    id_map = {c["id"]: i for i, c in enumerate(sorted(data["categories"], key=lambda c: c["id"]))}
    imgs = {im["id"]: im for im in data["images"]}
    out = []
    for ann in data["annotations"]:
        im = imgs[ann["image_id"]]
        segments = [
            {
                "id": s["id"],
                "category_id": id_map[s["category_id"]],
                "iscrowd": s.get("iscrowd", 0),
            }
            for s in ann["segments_info"]
        ]
        out.append(
            {
                "file_name": os.path.join(
                    image_root, im["file_name"].replace(".png", ".jpg")
                    if im["file_name"].endswith(".png") else im["file_name"]
                ),
                "image_id": ann["image_id"],
                "height": im["height"],
                "width": im["width"],
                "pan_seg_file_name": os.path.join(pan_root, ann["file_name"]),
                "segments_info": segments,
            }
        )
    return out


def register_coco(root: str) -> None:
    base = os.path.join(root, "coco")
    for split in ["train2017", "val2017"]:
        name = f"coco_2017_{split[:-4]}"
        jf = os.path.join(base, "annotations", f"instances_{split}.json")
        ir = os.path.join(base, split)
        DatasetCatalog.register(
            name, lambda jf=jf, ir=ir: load_coco_instances(jf, ir)
        )
        MetadataCatalog.get(name).set(
            evaluator_type="coco_instance",
            thing_dataset_id_to_contiguous_id={i: i for i in range(80)},
            json_file=jf,
        )
        pan_name = f"coco_2017_{split[:-4]}_panoptic"
        pj = os.path.join(base, "annotations", f"panoptic_{split}.json")
        pr = os.path.join(base, f"panoptic_{split}")
        DatasetCatalog.register(
            pan_name, lambda pj=pj, ir=ir, pr=pr: load_coco_panoptic(pj, ir, pr)
        )
        MetadataCatalog.get(pan_name).set(
            evaluator_type="coco_panoptic_seg",
            thing_dataset_id_to_contiguous_id={i: i for i in range(80)},
        )
    # cocofied LVIS (same schema; upstream registers lvis_v1_cocofied)
    for lv_split, jfname in [
        ("lvis_v1_train_cocofied", "lvis_v1_train_cocofied.json"),
        ("lvis_v1_val_cocofied", "lvis_v1_val_cocofied.json"),
    ]:
        jf = os.path.join(base, "annotations", jfname)
        DatasetCatalog.register(
            lv_split,
            lambda jf=jf, ir=os.path.join(root, "coco"): load_coco_instances(jf, ir),
        )
        MetadataCatalog.get(lv_split).set(evaluator_type="coco_instance")


CITYSCAPES_THING_IDS = {11, 12, 13, 14, 15, 16, 17, 18}

# Cityscapes labelId -> contiguous trainId (labels with trainId < 255 only).
# The panoptic GT json stores raw labelIds (0-33); the model/config uses the
# 19 contiguous trainIds (NUM_CLASSES=19), so segments must be remapped here —
# mirrors detectron2's cityscapes_panoptic _convert_category_id.
CITYSCAPES_LABELID_TO_TRAINID = {
    7: 0,   # road
    8: 1,   # sidewalk
    11: 2,  # building
    12: 3,  # wall
    13: 4,  # fence
    17: 5,  # pole
    19: 6,  # traffic light
    20: 7,  # traffic sign
    21: 8,  # vegetation
    22: 9,  # terrain
    23: 10,  # sky
    24: 11,  # person
    25: 12,  # rider
    26: 13,  # car
    27: 14,  # truck
    28: 15,  # bus
    31: 16,  # train
    32: 17,  # motorcycle
    33: 18,  # bicycle
}


def load_cityscapes_panoptic(image_dir: str, gt_json: str, gt_dir: str) -> List[Dict]:
    with open(gt_json) as f:
        data = json.load(f)
    out = []
    for ann in data["annotations"]:
        city = ann["image_id"].rsplit("_", 2)[0]
        segments = [
            {**s, "category_id": CITYSCAPES_LABELID_TO_TRAINID[s["category_id"]]}
            for s in ann["segments_info"]
            if s["category_id"] in CITYSCAPES_LABELID_TO_TRAINID
        ]
        out.append(
            {
                "file_name": os.path.join(
                    image_dir, city, ann["image_id"] + "_leftImg8bit.png"
                ),
                "image_id": ann["image_id"],
                "height": 1024,
                "width": 2048,
                "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
                "segments_info": segments,
            }
        )
    return out


# COCO-stuff-171 category table (upstream register_coco_stuff_semseg.py:
# COCO_CATEGORIES — 80 things + 91 stuff, raw ids 1..182 with the 11 unused
# thing ids absent).  PNG pixel values are caffe-shifted: dataset_id = id-1.
COCO_STUFF_171_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
    60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80,
    81, 82, 84, 85, 86, 87, 88, 89, 90, 92, 93, 94, 95, 96, 97, 98, 99,
    100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112, 113,
    114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 126, 127,
    128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138, 139, 140, 141,
    142, 143, 144, 145, 146, 147, 148, 149, 150, 151, 152, 153, 154, 155,
    156, 157, 158, 159, 160, 161, 162, 163, 164, 165, 166, 167, 168, 169,
    170, 171, 172, 173, 174, 175, 176, 177, 178, 179, 180, 181, 182,
]
COCO_STUFF_171_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush", "banner",
    "blanket", "branch", "bridge", "building-other", "bush", "cabinet",
    "cage", "cardboard", "carpet", "ceiling-other", "ceiling-tile",
    "cloth", "clothes", "clouds", "counter", "cupboard", "curtain",
    "desk-stuff", "dirt", "door-stuff", "fence", "floor-marble",
    "floor-other", "floor-stone", "floor-tile", "floor-wood", "flower",
    "fog", "food-other", "fruit", "furniture-other", "grass", "gravel",
    "ground-other", "hill", "house", "leaves", "light", "mat", "metal",
    "mirror-stuff", "moss", "mountain", "mud", "napkin", "net", "paper",
    "pavement", "pillow", "plant-other", "plastic", "platform",
    "playingfield", "railing", "railroad", "river", "road", "rock",
    "roof", "rug", "salad", "sand", "sea", "shelf", "sky-other",
    "skyscraper", "snow", "solid-other", "stairs", "stone", "straw",
    "structural-other", "table", "tent", "textile-other", "towel", "tree",
    "vegetable", "wall-brick", "wall-concrete", "wall-other",
    "wall-panel", "wall-stone", "wall-tile", "wall-wood", "water-other",
    "waterdrops", "window-blind", "window-other", "wood",
]


def register_coco_stuff_171(root: str) -> None:
    """True COCO-stuff semantic datasets (upstream
    register_coco_stuff_semseg.py:201-223): 171 classes over semseg_*2017
    pngs whose pixel values are caffe-shifted raw ids (id-1), consumed by
    the coco_semantic/coco_semantic2 mappers which remap them to contiguous
    [0, 171) and send removed classes to ignore."""
    from .datasets import register_sem_seg

    base = os.path.join(root, "coco")
    data_id_to_cont_id = {k - 1: i for i, k in enumerate(COCO_STUFF_171_IDS)}
    for split in ["train2017", "val2017"]:
        name = f"coco_2017_{split[:-4]}_stuff_sem_seg"
        try:
            register_sem_seg(
                name,
                image_root=os.path.join(base, split),
                gt_root=os.path.join(base, f"semseg_{split}"),
                classes=COCO_STUFF_171_NAMES,
                ignore_label=255,
            )
            MetadataCatalog.get(name).set(
                stuff_dataset_id_to_contiguous_id=dict(data_id_to_cont_id),
                evaluator_type="coco_sem_seg",
            )
        except KeyError:
            pass


def register_coco_stuff_semseg(root: str) -> None:
    """COCO panoptic-derived semantic segmentation (upstream's
    register_coco_stuff_semseg / COCOSemanticDatasetMapper targets), pairing
    val/train images with panoptic_semseg_* pngs produced by
    datasets/prepare_coco_semantic_annos_from_panoptic_annos.py."""
    from .datasets import register_sem_seg

    base = os.path.join(root, "coco")
    for split in ["train2017", "val2017"]:
        name = f"coco_2017_{split[:-4]}_panoptic_semseg"
        try:
            register_sem_seg(
                name,
                image_root=os.path.join(base, split),
                gt_root=os.path.join(base, f"panoptic_semseg_{split}"),
                classes=[str(i) for i in range(133)],
                ignore_label=255,
            )
        except KeyError:
            pass


def register_cityscapes_panoptic(root: str) -> None:
    base = os.path.join(root, "cityscapes")
    for split in ["train", "val"]:
        name = f"cityscapes_fine_panoptic_{split}"
        gt_json = os.path.join(base, "gtFine", f"cityscapes_panoptic_{split}.json")
        gt_dir = os.path.join(base, "gtFine", f"cityscapes_panoptic_{split}")
        img_dir = os.path.join(base, "leftImg8bit", split)
        DatasetCatalog.register(
            name,
            lambda img_dir=img_dir, gt_json=gt_json, gt_dir=gt_dir:
                load_cityscapes_panoptic(img_dir, gt_json, gt_dir),
        )
        MetadataCatalog.get(name).set(
            evaluator_type="cityscapes_panoptic_seg",
            thing_dataset_id_to_contiguous_id={i: i for i in CITYSCAPES_THING_IDS},
            ignore_label=255,
        )
