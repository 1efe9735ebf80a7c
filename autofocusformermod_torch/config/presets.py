"""Presets: short names for the published yamls that the port's tests, its
chip check and ``train_net --config NAME`` use most.  ``PRESETS[name]()``
is ``published_cfg`` of the preset's yaml under ``configs/`` (its bases
merged over the default tree, read by the port's own yaml reader) with the
preset's overrides, a fresh unfrozen tree on every call.

The one override: the COCO-panoptic UpDown-Tiny yaml leaves
MODEL.SEM_SEG_HEAD.NUM_CLASSES at the default 150, which evaluation reads
for the class count; the preset sets the model's 133.
"""

from __future__ import annotations

import functools
from pathlib import Path

from .cfg_node import CfgNode
from .defaults import published_cfg

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
_ADE = "ade20k/semantic-segmentation/"

# name -> the yaml under configs/
PRESET_YAMLS = {
    # AFF + Mask2Former, ADE20K semantic at 512x512 (Mini-1/5: DS_RATE 0.2)
    "aff_mini": "ade20k/maskformer2_aff_mini_bs32_80k.yaml",
    "aff_mini_15": "ade20k/maskformer2_aff_mini_15_bs32_80k.yaml",
    "aff_small": "ade20k/maskformer2_aff_small_bs32_80k.yaml",
    # the MixRes cascade (MaskFiner) and the OracleTeacher cascades
    "maskfiner_mini": _ADE + "maskfiner/maskfiner_mini_bs32_80k.yaml",
    "maskfiner_updown_mini": _ADE + "maskfiner/maskfiner_updown_mini_bs32_80k.yaml",
    "maskfiner_oracle_teacher_bb": _ADE + "maskfiner/maskfiner_oracle_teacher_bb_bs32_80k.yaml",
    "maskfiner_oracle_teacher": _ADE + "maskfiner/maskfiner_oracle_teacher_bs32_80k.yaml",
    # COCO panoptic, LSJ 1024x1024, bf16 mixed precision
    "maskfiner_updown_tiny_coco_panoptic":
        "coco/panoptic-segmentation/maskfiner/maskfiner_updown_tiny_bs16_50ep.yaml",
    # MRML: MaskFormerML over MixResMetaLoss(Neighbour), MaskFormer over MixResMeanAct
    "mrml_mini": _ADE + "mixres-metaloss/maskformer2_mrml_mini_bs32_80k.yaml",
    "mrmlnb_mini": _ADE + "mixres-metaloss-nb/maskformer2_mrmlnb_mini_bs32_80k.yaml",
    "mrmean_mini": _ADE + "mixres-activation/maskformer2_mrmean_mini_bs32_80k.yaml",
    # AFF-Mini for Cityscapes panoptic (512x1024 crops, tested at 1024x2048)
    # and COCO instance segmentation (LSJ 1024x1024)
    "aff_mini_cityscapes_panoptic":
        "cityscapes/panoptic-segmentation/aff/maskformer2_aff_mini_bs32_45k.yaml",
    "aff_mini_coco_instance": "coco/instance-segmentation/aff/maskformer2_aff_mini_bs64_50ep.yaml",
    # the grid baselines: Mask2Former-R50, Swin-T, Swin-B-384 at 640x640
    "r50": _ADE + "maskformer2_R50_bs16_160k.yaml",
    "swin_tiny": _ADE + "swin/maskformer2_swin_tiny_bs16_160k.yaml",
    "swin_base_384_res640": _ADE + "swin/maskformer2_swin_base_384_bs16_160k_res640.yaml",
}
# name -> KEY VALUE pairs merged after the yaml
PRESET_OVERRIDES = {
    "maskfiner_updown_tiny_coco_panoptic": ("MODEL.SEM_SEG_HEAD.NUM_CLASSES", "133"),
}


def preset_cfg(name: str) -> CfgNode:
    """The preset's yaml merged over the default tree, then its overrides."""
    return published_cfg(CONFIGS / PRESET_YAMLS[name], PRESET_OVERRIDES.get(name, ()))


def train_image_size(cfg) -> tuple:
    """(H, W) of a training batch: the LSJ mappers' fixed INPUT.IMAGE_SIZE
    square, else INPUT.CROP.SIZE."""
    if cfg.INPUT.DATASET_MAPPER_NAME in ("coco_instance_lsj", "coco_panoptic_lsj",
                                         "coco_semantic2"):
        return (cfg.INPUT.IMAGE_SIZE, cfg.INPUT.IMAGE_SIZE)
    return tuple(cfg.INPUT.CROP.SIZE)


PRESETS = {name: functools.partial(preset_cfg, name) for name in PRESET_YAMLS}
aff_mini_cfg = PRESETS["aff_mini"]
aff_mini_15_cfg = PRESETS["aff_mini_15"]
aff_small_cfg = PRESETS["aff_small"]
maskfiner_mini_cfg = PRESETS["maskfiner_mini"]
maskfiner_updown_mini_cfg = PRESETS["maskfiner_updown_mini"]
maskfiner_oracle_teacher_bb_cfg = PRESETS["maskfiner_oracle_teacher_bb"]
maskfiner_oracle_teacher_cfg = PRESETS["maskfiner_oracle_teacher"]
maskfiner_updown_tiny_coco_panoptic_cfg = PRESETS["maskfiner_updown_tiny_coco_panoptic"]
mrml_mini_cfg = PRESETS["mrml_mini"]
mrmlnb_mini_cfg = PRESETS["mrmlnb_mini"]
mrmean_mini_cfg = PRESETS["mrmean_mini"]
aff_mini_cityscapes_panoptic_cfg = PRESETS["aff_mini_cityscapes_panoptic"]
aff_mini_coco_instance_cfg = PRESETS["aff_mini_coco_instance"]
r50_cfg = PRESETS["r50"]
swin_tiny_cfg = PRESETS["swin_tiny"]
swin_base_384_res640_cfg = PRESETS["swin_base_384_res640"]
