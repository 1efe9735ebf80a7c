"""Yaml-free presets of the published AFF-Mini, AFF-Mini-1/5, AFF-Small,
MaskFiner-Mini, MaskFiner-UpDown-Mini, MaskFiner-OracleTeacher-BB,
MaskFiner-OracleTeacher, MRML-Mini, MRML-NB-Mini and MRMean-Mini models
(ADE20K semantic), of AFF-Mini for Cityscapes
panoptic and COCO instance segmentation, of MaskFiner-UpDown-Tiny for COCO
panoptic segmentation (bf16 mixed precision), and of the grid baselines
Mask2Former-R50, Swin-T and Swin-B-384 at 640 (ADE20K semantic).

``configs/ade20k/maskformer2_aff_{mini,mini_15,small}_bs32_80k.yaml`` merged
over the defaults give the published AFF + Mask2Former ADE20K models and
their training recipe; ``configs/cityscapes/panoptic-segmentation/aff/
maskformer2_aff_mini_bs32_45k.yaml`` and ``configs/coco/
instance-segmentation/aff/maskformer2_aff_mini_bs64_50ep.yaml`` the
Cityscapes-panoptic and COCO-instance ones; ``configs/ade20k/
semantic-segmentation/maskformer2_R50_bs16_160k.yaml`` and ``swin/
maskformer2_swin_{tiny_bs16_160k,base_384_bs16_160k_res640}.yaml`` the grid
baselines.  Reading those files needs PyYAML; these presets carry the
same values for every field the port's ``*_from_config`` functions, its
optimizer, its training step, its trainer, its data mapper and loader and
its evaluation read, so a machine without PyYAML can build, train and
evaluate the models.  Those functions also accept the JAX
package's ``CfgNode`` (same attribute paths).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Sequence


class Cfg(dict):
    """Nested dict with attribute access (the subset of CfgNode the port reads)."""

    def __init__(self, d: Dict[str, Any] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = Cfg(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def merge_from_list(self, opts: Sequence[str]) -> None:
        """KEY VALUE pairs over existing fields, as the JAX package's CfgNode
        takes them: dotted keys, values read as Python literals where they
        parse (else kept as strings) and held to the field's type."""
        if len(opts) % 2:
            raise ValueError(f"overrides come as KEY VALUE pairs, got {list(opts)}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            *parents, leaf = key.split(".")
            node = self
            for p in parents:
                node = node.get(p) if isinstance(node, Cfg) else None
            if not isinstance(node, Cfg) or leaf not in node or isinstance(node[leaf], Cfg):
                raise KeyError(f"no config field {key}")
            try:
                value = ast.literal_eval(raw) if isinstance(raw, str) else raw
            except (ValueError, SyntaxError):
                value = raw
            old = node[leaf]
            if isinstance(old, float) and isinstance(value, int):
                value = float(value)
            if isinstance(old, list) and isinstance(value, tuple):
                value = list(value)
            if type(value) is not type(old):
                raise TypeError(f"{key}: expected {type(old).__name__}, got {raw!r}")
            node[leaf] = value


def ade20k_semantic_nodes(aug_min_sizes: Sequence[int], aug_max_size: int,
                          size: int = 512) -> Dict[str, Any]:
    """The DATASETS, INPUT, TEST and DATALOADER nodes of the ADE20K semantic
    recipe (``configs/ade20k/base_ade20k_semantic.yaml`` and
    ``semantic-segmentation/Base-ADE20K-SemanticSegmentation.yaml`` over the
    defaults; they differ only in the multi-scale test sizes) at crop
    ``size``: training short edges [int(x * 0.1 * size) for x in range(5,
    21)], long edges up to 4 * size, testing at short edge ``size``, images
    padded to a multiple of ``size`` (the Swin-B res640 yaml sets 640)."""
    return {
        "DATASETS": {"TRAIN": ["ade20k_sem_seg_train"], "TEST": ["ade20k_sem_seg_val"]},
        "INPUT": {
            "MIN_SIZE_TRAIN": [int(x * 0.1 * size) for x in range(5, 21)],
            "MAX_SIZE_TRAIN": 4 * size,
            "MIN_SIZE_TEST": size,
            "MAX_SIZE_TEST": 4 * size,
            "CROP": {"ENABLED": True, "SIZE": [size, size], "SINGLE_CATEGORY_MAX_AREA": 1.0},
            "COLOR_AUG_SSD": True,
            "SIZE_DIVISIBILITY": size,
            "DATASET_MAPPER_NAME": "mask_former_semantic",
        },
        "TEST": {
            "EVAL_PERIOD": 5000,
            "EXPECTED_RESULTS": [],
            "AUG": {"ENABLED": False, "MIN_SIZES": list(aug_min_sizes), "MAX_SIZE": aug_max_size,
                    "FLIP": True},
            "SW_ENABLED": False,
            "SW_CROP_SIZE": [1024, 1024],
            "SW_STRIDE": [768, 768],
            "SAVE_EVAL_ARTIFACTS": False,
            "DETECTIONS_PER_IMAGE": 100,
        },
        "DATALOADER": {"NUM_WORKERS": 8},
    }


def aff_mini_cfg(num_classes: int = 150) -> Cfg:
    """AFF-Mini + Mask2Former, ADE20K semantic segmentation at 512x512
    (``configs/ade20k/maskformer2_aff_mini_bs32_80k.yaml``)."""
    return Cfg({
        "MODEL": {
            "BACKBONE": {"NAME": "AutoFocusFormer"},
            "WEIGHTS": "aff_mini.pth",
            "AFF": {
                "EMBED_DIM": [32, 128, 256, 384],
                "DEPTHS": [2, 2, 6, 2],
                "NUM_HEADS": [2, 4, 8, 16],
                "MLP_RATIO": 2.0,
                "CLUSTER_SIZE": 8,
                "NBHD_SIZE": [48, 48, 48, 48],
                "ALPHA": 4.0,
                "DS_RATE": 0.25,
                "RESERVE": True,
                "LAYER_SCALE": 0.0,
                "PATCH_NORM": True,
                "SHEPARD_POWER": 6.0,
                "SHEPARD_POWER_LEARNABLE": True,
                "DROP_PATH_RATE": 0.0,
            },
            "SEM_SEG_HEAD": {
                "NUM_CLASSES": num_classes,
                "IGNORE_VALUE": 255,
                "IN_FEATURES": ["res2", "res3", "res4", "res5"],
                "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": ["res3", "res4", "res5"],
                "CONVS_DIM": 256,
                "MASK_DIM": 256,
                "COMMON_STRIDE": 4,
                "TRANSFORMER_ENC_LAYERS": 6,
            },
            "MASK_FORMER": {
                "TRANSFORMER_DECODER_NAME": "MultiScaleMaskedTransformerDecoder",
                "HIDDEN_DIM": 256,
                "NUM_OBJECT_QUERIES": 100,
                "NHEADS": 8,
                "DIM_FEEDFORWARD": 2048,
                "DEC_LAYERS": 10,
                "PRE_NORM": False,
                "ENFORCE_INPUT_PROJ": False,
                "SIZE_DIVISIBILITY": 32,
                "DROPOUT": 0.0,
                "NO_OBJECT_WEIGHT": 0.1,
                "CLASS_WEIGHT": 2.0,
                "MASK_WEIGHT": 5.0,
                "DICE_WEIGHT": 5.0,
                "TRAIN_NUM_POINTS": 12544,
                "OVERSAMPLE_RATIO": 3.0,
                "IMPORTANCE_SAMPLE_RATIO": 0.75,
            },
            "PIXEL_MEAN": [123.675, 116.28, 103.53],
            "PIXEL_STD": [58.395, 57.12, 57.375],
        },
        "SOLVER": {
            "IMS_PER_BATCH": 32,
            "BASE_LR": 0.0002,
            "MAX_ITER": 80000,
            "CHECKPOINT_PERIOD": 2500,
            "WEIGHT_DECAY": 0.05,
            "WEIGHT_DECAY_NORM": 0.0,
            "WEIGHT_DECAY_EMBED": 0.0,
            "BACKBONE_MULTIPLIER": 0.1,
            "BETAS": [0.9, 0.999],
            "EPSILON": 1e-08,
            "WARMUP_FACTOR": 1.0,
            "WARMUP_ITERS": 0,
            "POLY_LR_POWER": 0.9,
            "POLY_LR_CONSTANT_ENDING": 0.0,
            "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "full_model", "CLIP_VALUE": 0.01},
        },
        **ade20k_semantic_nodes((400, 500, 600, 700, 800, 900, 1000, 1100, 1200), 4000),
        "SEED": 0,
        "OUTPUT_DIR": "./output",
        # target slots per image (the JAX package pads to TPU.MAX_GT_INSTANCES)
        "TPU": {"MAX_GT_INSTANCES": 100},
    })


def aff_small_cfg(num_classes: int = 150) -> Cfg:
    """AFF-Small + Mask2Former, ADE20K semantic segmentation at 512x512
    (``configs/ade20k/maskformer2_aff_small_bs32_80k.yaml``): wider and
    deeper than AFF-Mini, with DropPath and layer scale."""
    cfg = aff_mini_cfg(num_classes)
    cfg.MODEL.WEIGHTS = "aff_small.pth"
    cfg.MODEL.AFF.update({
        "EMBED_DIM": [96, 192, 384, 768],
        "DEPTHS": [3, 4, 18, 2],
        "NUM_HEADS": [3, 6, 12, 24],
        "MLP_RATIO": 3.0,
        "DROP_PATH_RATE": 0.3,
        "LAYER_SCALE": 1e-5,
    })
    return cfg


def aff_mini_15_cfg(num_classes: int = 150) -> Cfg:
    """AFF-Mini-1/5 + Mask2Former, ADE20K semantic segmentation at 512x512
    (``configs/ade20k/maskformer2_aff_mini_15_bs32_80k.yaml``): AFF-Mini
    whose cluster merging keeps a fifth of the tokens per stage, so at
    512x512 the decoder's levels hold 3276, 655 and 131 tokens (no multiples
    of 128: with ``USE_STACKED_GLUE`` off the interleaved sampling runs)."""
    cfg = aff_mini_cfg(num_classes)
    cfg.MODEL.WEIGHTS = "aff_mini_15.pth"
    cfg.MODEL.AFF.DS_RATE = 0.2
    return cfg


def maskfiner_mini_cfg(num_classes: int = 150) -> Cfg:
    """MaskFiner-Mini, the MixRes cascade, ADE20K semantic segmentation at
    512x512 (``configs/ade20k/semantic-segmentation/maskfiner/
    maskfiner_mini_bs32_80k.yaml`` over ``../maskfiner_R50_bs16_160k.yaml``,
    ``Base-ADE20K-SemanticSegmentation.yaml`` and the defaults): four stages
    of patch 32, 16, 8 and 4, each splitting half of the newest scale's
    tokens; fp32 (``SOLVER.AMP.ENABLED`` False)."""
    return Cfg({
        "MODEL": {
            "META_ARCHITECTURE": "MaskFiner",
            "BACKBONE": {"NAME": "MixRes"},
            "WEIGHTS": "aff_mini.pkl",
            "MR": {
                "NAME": ["MixResViT", "MixResNeighbour", "MixResNeighbour", "MixResNeighbour"],
                "EMBED_DIM": [512, 256, 128, 64],
                "DEPTHS": [2, 2, 8, 12],
                "NUM_HEADS": [32, 16, 8, 4],
                "PATCH_SIZES": [32, 16, 8, 4],
                "DROP_RATE": [0.0, 0.0, 0.0, 0.0],
                "DROP_PATH_RATE": [0.0, 0.0, 0.0, 0.0],
                "ATTN_DROP_RATE": [0.0, 0.0, 0.0, 0.0],
                "UPSCALE_RATIO": [0.5, 0.5, 0.5, 0.5],
                "SPLIT_RATIO": [4, 4, 4, 4],
                "MLP_RATIO": [2.0, 2.0, 2.0, 2.0],
                "CLUSTER_SIZE": [8, 8, 8, 8],
                "NBHD_SIZE": [48, 48, 48, 48],
                "OUT_FEATURES": ["res2", "res3", "res4", "res5"],
                "KEEP_OLD_SCALE": True,
                "LAYER_SCALE": 0.0,
                "NUM_REGISTER_TOKENS": 0,
            },
            "MR_SEM_SEG_HEAD": {
                "NAME": "MaskPredictor",
                "NUM_CLASSES": num_classes,
                "PIXEL_DECODER_NAME": "MSDeformAttnPixelDecoderMaskFiner",
                "IN_FEATURES": ["res2", "res3", "res4", "res5"],
                "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": ["res3", "res4", "res5"],
                "CONVS_DIM": [512, 256, 128, 128],
                "TRANSFORMER_ENC_LAYERS": [1, 2, 4, 6],
                "MLP_RATIO": [4.0, 4.0, 4.0, 4.0],
                "NHEADS": [16, 8, 8, 8],
                "DROPOUT": 0.0,
            },
            "MASK_FINER": {
                "TRANSFORMER_DECODER_NAME": "MultiScaleMaskFinerTransformerDecoder",
                "NUM_RESOLUTION_SCALES": 4,
                "DEC_LAYERS": [3, 3, 4, 9],
                "DECODER_LEVELS": [1, 2, 3, 4],
                "DIM_FEEDFORWARD": [1024, 1024, 1024, 1024],
                "HIDDEN_DIM": [256, 256, 256, 256],
                "MASK_DIM": [256, 256, 256, 256],
                "NHEADS": [8, 8, 8, 8],
                "NUM_OBJECT_QUERIES": 100,
                "PRE_NORM": False,
                "ENFORCE_INPUT_PROJ": False,
                "MASK_DECODER_ALL_LEVELS": False,
                "SHEPARD_POWER": 6.0,
                "SHEPARD_POWER_LEARNABLE": True,
                "SIZE_DIVISIBILITY": 32,
                # the criterion (maskfiner_R50_bs16_160k.yaml) and the
                # OracleTeacher's upsampling loss (the default weight)
                "DEEP_SUPERVISION": True,
                "NO_OBJECT_WEIGHT": 0.1,
                "CLASS_WEIGHT": 2.0,
                "MASK_WEIGHT": 5.0,
                "DICE_WEIGHT": 5.0,
                "TRAIN_NUM_POINTS": 12544,
                "OVERSAMPLE_RATIO": 3.0,
                "IMPORTANCE_SAMPLE_RATIO": 0.75,
                "UPSAMPLING_WEIGHT": 10,
                "DROPOUT": 0.0,
            },
            # what evaluation reads of the MaskFormer nodes: the class count,
            # the ignore label and the padding of a test image
            "SEM_SEG_HEAD": {"NUM_CLASSES": num_classes, "IGNORE_VALUE": 255},
            "MASK_FORMER": {"SIZE_DIVISIBILITY": 32},
            "PIXEL_MEAN": [123.675, 116.28, 103.53],
            "PIXEL_STD": [58.395, 57.12, 57.375],
        },
        "SOLVER": {
            "IMS_PER_BATCH": 32,
            "BASE_LR": 0.0002,
            "MAX_ITER": 80000,
            "CHECKPOINT_PERIOD": 2500,
            "WEIGHT_DECAY": 0.05,
            "WEIGHT_DECAY_NORM": 0.0,
            "WEIGHT_DECAY_EMBED": 0.0,
            "BACKBONE_MULTIPLIER": 0.1,
            "BETAS": [0.9, 0.999],
            "EPSILON": 1e-08,
            "WARMUP_FACTOR": 1.0,
            "WARMUP_ITERS": 0,
            "POLY_LR_POWER": 0.9,
            "POLY_LR_CONSTANT_ENDING": 0.0,
            "CLIP_GRADIENTS": {"ENABLED": True, "CLIP_TYPE": "full_model", "CLIP_VALUE": 1.0},
            "AMP": {"ENABLED": False},
        },
        **ade20k_semantic_nodes((256, 384, 512, 640, 768, 896), 3584),
        "SEED": 0,
        "OUTPUT_DIR": "./output",
        "TPU": {"MAX_GT_INSTANCES": 100},
    })


def maskfiner_updown_mini_cfg(num_classes: int = 150) -> Cfg:
    """MaskFiner-UpDown-Mini (MaskFinerOracleTeacherBB), ADE20K semantic
    segmentation at 512x512 (``configs/ade20k/semantic-segmentation/
    maskfiner/maskfiner_updown_mini_bs32_80k.yaml`` over the bases of
    ``maskfiner_mini_cfg``): an UpDownBackbone of 7 MixRes stages (patches
    32, 16, 8, 4 down and 8, 16, 32 up; 85, 70 and 60 % of the newest
    scale's tokens split), the final stage's pixel decoder over res2-res5
    and the dense OracleTeacher decoder; the upsampling loss at weight 10,
    no oracle teaching (ORACLE_TEACHER_RATIO 0); fp32."""
    cfg = maskfiner_mini_cfg(num_classes)
    cfg.MODEL.META_ARCHITECTURE = "MaskFinerOracleTeacherBB"
    cfg.MODEL.BACKBONE.NAME = "UpDownBackbone"
    cfg.MODEL.SEM_SEG_HEAD.NAME = "MaskFinerOTHead"
    cfg.MODEL.MR.update({
        "NAME": ["MixResViT"] + ["MixResNeighbour"] * 5 + ["MixResViT"],
        "EMBED_DIM": [256, 192, 128, 64, 128, 192, 256],
        "DEPTHS": [1, 1, 1, 4, 2, 8, 2],
        "NUM_HEADS": [8, 6, 4, 2, 4, 6, 8],
        "PATCH_SIZES": [32, 16, 8, 4, 8, 16, 32],
        "DROP_RATE": [0.0] * 7,
        "DROP_PATH_RATE": 0.0,
        "ATTN_DROP_RATE": [0.0] * 7,
        "UPSCALE_RATIO": [0.0, 0.85, 0.7, 0.6, 0.0, 0.0, 0.0],
        "SPLIT_RATIO": [4] * 7,
        "MLP_RATIO": [2.0] * 7,
        "CLUSTER_SIZE": [8] * 7,
        "NBHD_SIZE": [48] * 7,
    })
    cfg.MODEL.MR_SEM_SEG_HEAD.update({
        "NAME": "MaskPredictorOracleTeacher",
        "IGNORE_VALUE": 255,
        "PIXEL_DECODER_NAME": ["ProjMaskFinerOracleTeacher"] * 3
                              + ["MSDeformAttnPixelDecoderMaskFiner"],
        "CONVS_DIM": [256, 256, 256, 256],
        "TRANSFORMER_ENC_LAYERS": [2, 2, 4, 6],
        "NHEADS": [8, 8, 8, 8],
    })
    cfg.MODEL.MASK_FINER.update({
        "TRANSFORMER_DECODER_NAME": "MultiScaleMaskFinerTransformerDecoderOracleTeacher",
        "DECODER_LEVELS": [1, 2, 3, 3],
        "DEC_LAYERS": [3, 3, 4, 10],
        "DIM_FEEDFORWARD": [1024, 1024, 1024, 2048],
        "HIDDEN_DIM": [256, 256, 256, 256],
        "MASK_DIM": [256, 256, 256, 256],
        "NHEADS": [8, 8, 8, 8],
        "ORACLE_TEACHER_RATIO": 0.0,
        "UPSAMPLING_WEIGHT": 10,
    })
    return cfg


def maskfiner_updown_tiny_coco_panoptic_cfg(num_classes: int = 133) -> Cfg:
    """MaskFiner-UpDown-Tiny (MaskFinerOracleTeacherBB), COCO panoptic
    segmentation (``configs/coco/panoptic-segmentation/maskfiner/
    maskfiner_updown_tiny_bs16_50ep.yaml`` over ``../maskfiner_R50_bs16_50ep.yaml``,
    ``../Base-COCO-PanopticSegmentation.yaml`` and the defaults): 133
    classes (80 things), an UpDownBackbone of 7 MixRes stages 512, 256,
    128, 64, 128, 256 and 512 wide (depths 1, 1, 1, 4, 4, 16, 4; 80, 70 and
    60 % of the newest scale's tokens split; DropPath to 0.3), the head of
    ``maskfiner_updown_mini_cfg``; training on the LSJ recipe's 1024x1024
    canvas (scales 0.1-2.0) at batch 16 for 368,750 steps, clipped at 0.01,
    in bf16 mixed precision (SOLVER.AMP.ENABLED); testing at short edge 800
    (long at most 1333) with panoptic inference.  The yaml leaves
    SEM_SEG_HEAD.NUM_CLASSES at the default 150, which evaluation reads for
    the class count: here it is the model's 133.  SOLVER.STEPS (a
    multi-step schedule) is not read: both packages train on the poly
    schedule."""
    cfg = maskfiner_updown_mini_cfg(num_classes)
    cfg.MODEL.MR.update({
        "EMBED_DIM": [512, 256, 128, 64, 128, 256, 512],
        "DEPTHS": [1, 1, 1, 4, 4, 16, 4],
        "NUM_HEADS": [16, 8, 4, 2, 4, 8, 16],
        "DROP_PATH_RATE": 0.3,
        "UPSCALE_RATIO": [0.0, 0.8, 0.7, 0.6, 0.0, 0.0, 0.0],
        "MLP_RATIO": [3.0] * 7,
    })
    test = {"SEMANTIC_ON": True, "INSTANCE_ON": True, "PANOPTIC_ON": True,
            "OVERLAP_THRESHOLD": 0.8, "OBJECT_MASK_THRESHOLD": 0.8}
    cfg.MODEL.MASK_FINER.TEST = Cfg(test)
    cfg.MODEL.MASK_FORMER.TEST = Cfg(test)
    cfg.SOLVER.update({"IMS_PER_BATCH": 16, "BASE_LR": 0.0002, "MAX_ITER": 368750,
                       "CHECKPOINT_PERIOD": 5000, "WARMUP_ITERS": 10,
                       "AMP": Cfg({"ENABLED": True})})
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    for k, v in {
        "DATASETS": {"TRAIN": ["coco_2017_train_panoptic"],
                     "TEST": ["coco_2017_val_panoptic_with_sem_seg"]},
        "INPUT": {
            "MIN_SIZE_TRAIN": [800],
            "MAX_SIZE_TRAIN": 1333,
            "MIN_SIZE_TEST": 800,
            "MAX_SIZE_TEST": 1333,
            "CROP": {"ENABLED": False, "SIZE": [0.9, 0.9], "SINGLE_CATEGORY_MAX_AREA": 1.0},
            "COLOR_AUG_SSD": False,
            "SIZE_DIVISIBILITY": -1,
            "DATASET_MAPPER_NAME": "coco_panoptic_lsj",
            "IMAGE_SIZE": 1024,
            "MIN_SCALE": 0.1,
            "MAX_SCALE": 2.0,
            "RANDOM_FLIP": "horizontal",
        },
        "TEST": {
            "EVAL_PERIOD": 5000,
            "EXPECTED_RESULTS": [],
            "AUG": {"ENABLED": False, "MIN_SIZES": [400, 500, 600, 700, 800, 900, 1000, 1100, 1200],
                    "MAX_SIZE": 4000, "FLIP": True},
            "SW_ENABLED": False,
            "SW_CROP_SIZE": [1024, 1024],
            "SW_STRIDE": [768, 768],
            "SAVE_EVAL_ARTIFACTS": False,
            "DETECTIONS_PER_IMAGE": 100,
        },
        "DATALOADER": {"NUM_WORKERS": 10},
    }.items():
        cfg[k] = Cfg(v)
    return cfg


def maskfiner_oracle_teacher_bb_cfg(num_classes: int = 150) -> Cfg:
    """MaskFinerOracleTeacherBB with the down-only OracleTeacherBackbone
    (``configs/ade20k/semantic-segmentation/maskfiner/
    maskfiner_oracle_teacher_bb_bs32_80k.yaml``): 4 MixRes stages of depths
    5, 17, 5 and 4 under a DropPath ramp to 0.3, every resolution read from
    the last stage; the head of ``maskfiner_updown_mini_cfg``."""
    cfg = maskfiner_updown_mini_cfg(num_classes)
    cfg.MODEL.BACKBONE.NAME = "OracleTeacherBackbone"
    cfg.MODEL.MR.update({
        "NAME": ["MixResViT"] + ["MixResNeighbour"] * 3,
        "EMBED_DIM": [512, 256, 128, 64],
        "DEPTHS": [5, 17, 5, 4],
        "NUM_HEADS": [16, 8, 4, 2],
        "PATCH_SIZES": [32, 16, 8, 4],
        "DROP_RATE": [0.0] * 4,
        "DROP_PATH_RATE": 0.3,
        "ATTN_DROP_RATE": [0.0] * 4,
        "UPSCALE_RATIO": [0.0, 0.85, 0.7, 0.6],
        "SPLIT_RATIO": [4] * 4,
        "MLP_RATIO": [3.0] * 4,
        "CLUSTER_SIZE": [8] * 4,
        "NBHD_SIZE": [48] * 4,
    })
    return cfg


def maskfiner_oracle_teacher_cfg(num_classes: int = 150) -> Cfg:
    """MaskFiner-OracleTeacher (MaskFinerOracleTeacher), ADE20K semantic
    segmentation at 512x512 (``configs/ade20k/semantic-segmentation/
    maskfiner/maskfiner_oracle_teacher_bs32_80k.yaml`` over the bases of
    ``maskfiner_mini_cfg``): four MixRes stages 256 wide (depths 4, 4, 6,
    8; 16 heads; 60 % of the newest scale's tokens split, the old scale
    kept), the projection-only pixel decoder and a score MLP on stages 0-2,
    the leaky OracleTeacher pixel decoder and the dense decoder on the
    last; in training each image's scores are the GT-edge oracle's with
    probability 0.8, the upsampling loss at weight 10; fp32."""
    cfg = maskfiner_mini_cfg(num_classes)
    cfg.MODEL.META_ARCHITECTURE = "MaskFinerOracleTeacher"
    cfg.MODEL.MR.update({
        "EMBED_DIM": [256, 256, 256, 256],
        "DEPTHS": [4, 4, 6, 8],
        "NUM_HEADS": [16, 16, 16, 16],
        "UPSCALE_RATIO": [0.0, 0.6, 0.6, 0.6],
        "MLP_RATIO": [3.0, 3.0, 3.0, 3.0],
    })
    cfg.MODEL.MR_SEM_SEG_HEAD.update({
        "NAME": "MaskPredictorOracleTeacher",
        "IGNORE_VALUE": 255,
        "PIXEL_DECODER_NAME": ["ProjMaskFinerOracleTeacher"] * 3
                              + ["MSDeformAttnPixelDecoderMaskFinerOracleTeacher"],
        "CONVS_DIM": [256, 256, 256, 256],
        "TRANSFORMER_ENC_LAYERS": [2, 2, 4, 6],
        "NHEADS": [8, 8, 8, 8],
    })
    cfg.MODEL.MASK_FINER.update({
        "TRANSFORMER_DECODER_NAME": "MultiScaleMaskFinerTransformerDecoderOracleTeacher",
        "DECODER_LEVELS": [1, 2, 3, 3],
        "DEC_LAYERS": [3, 3, 4, 10],
        "DIM_FEEDFORWARD": [1024, 1024, 1024, 2048],
        "ORACLE_TEACHER_RATIO": 0.8,
        "UPSAMPLING_WEIGHT": 10,
    })
    return cfg


def _aff_mini_task_cfg(num_classes: int, nodes: Dict[str, Any], weights: str,
                       mask_former_test: Dict[str, Any]) -> Cfg:
    """AFF-Mini + Mask2Former with another task's dataset, input and test
    nodes and MODEL.MASK_FORMER.TEST (the thresholds and the outputs the
    upstream model makes)."""
    cfg = aff_mini_cfg(num_classes)
    cfg.MODEL.WEIGHTS = weights
    cfg.MODEL.MASK_FORMER.TEST = Cfg(mask_former_test)
    for k, v in nodes.items():
        cfg[k] = Cfg(v)
    return cfg


def aff_mini_cityscapes_panoptic_cfg(num_classes: int = 19) -> Cfg:
    """AFF-Mini + Mask2Former, Cityscapes panoptic segmentation
    (``configs/cityscapes/panoptic-segmentation/aff/maskformer2_aff_mini_
    bs32_45k.yaml`` over ``../maskformer2_R50_bs16_90k.yaml``,
    ``../Base-Cityscapes-PanopticSegmentation.yaml`` and the defaults):
    19 classes, the neighbourhood's ALPHA 8; training on 512x1024 crops of
    images resized to short edges 512-2048 (16 sizes), testing at
    1024x2048 (131,072 first-stage tokens); 45k steps at batch 32."""
    cfg = _aff_mini_task_cfg(num_classes, {
        "DATASETS": {"TRAIN": ["cityscapes_fine_panoptic_train"],
                     "TEST": ["cityscapes_fine_panoptic_val"]},
        "INPUT": {
            "MIN_SIZE_TRAIN": [int(x * 0.1 * 1024) for x in range(5, 21)],
            "MAX_SIZE_TRAIN": 4096,
            "MIN_SIZE_TEST": 1024,
            "MAX_SIZE_TEST": 2048,
            "CROP": {"ENABLED": True, "SIZE": [512, 1024], "SINGLE_CATEGORY_MAX_AREA": 1.0},
            "COLOR_AUG_SSD": True,
            "SIZE_DIVISIBILITY": -1,
            "DATASET_MAPPER_NAME": "mask_former_panoptic",
        },
        "TEST": {
            "EVAL_PERIOD": 5000,
            "EXPECTED_RESULTS": [],
            "AUG": {"ENABLED": False, "MIN_SIZES": [512, 768, 1024, 1280, 1536, 1792],
                    "MAX_SIZE": 4096, "FLIP": True},
            "SW_ENABLED": False,
            "SW_CROP_SIZE": [1024, 1024],
            "SW_STRIDE": [768, 768],
            "SAVE_EVAL_ARTIFACTS": False,
            "DETECTIONS_PER_IMAGE": 100,
        },
        "DATALOADER": {"NUM_WORKERS": 4},
    }, "aff_mini.pkl", {"SEMANTIC_ON": True, "INSTANCE_ON": True, "PANOPTIC_ON": True,
                        "OVERLAP_THRESHOLD": 0.8, "OBJECT_MASK_THRESHOLD": 0.8})
    cfg.MODEL.AFF.ALPHA = 8.0
    cfg.SOLVER.MAX_ITER = 45000
    return cfg


def aff_mini_coco_instance_cfg(num_classes: int = 80) -> Cfg:
    """AFF-Mini + Mask2Former, COCO instance segmentation
    (``configs/coco/instance-segmentation/aff/maskformer2_aff_mini_bs64_
    50ep.yaml`` over ``../maskformer2_R50_bs16_50ep.yaml``,
    ``../Base-COCO-InstanceSegmentation.yaml`` and the defaults): 80
    classes, a fixed Shepard power of 4; training on the LSJ recipe's
    1024x1024 canvas (scales 0.1-2.0), testing at short edge 800 (long at
    most 1333) with 100 detections an image; 92,188 steps at batch 64.  The
    yaml's multi-step schedule (SOLVER.STEPS) is not read: both packages
    train on the poly schedule."""
    cfg = _aff_mini_task_cfg(num_classes, {
        "DATASETS": {"TRAIN": ["coco_2017_train"], "TEST": ["coco_2017_val"]},
        "INPUT": {
            "MIN_SIZE_TRAIN": [800],
            "MAX_SIZE_TRAIN": 1333,
            "MIN_SIZE_TEST": 800,
            "MAX_SIZE_TEST": 1333,
            "CROP": {"ENABLED": False, "SIZE": [0.9, 0.9], "SINGLE_CATEGORY_MAX_AREA": 1.0},
            "COLOR_AUG_SSD": False,
            "SIZE_DIVISIBILITY": -1,
            "DATASET_MAPPER_NAME": "coco_instance_lsj",
            "IMAGE_SIZE": 1024,
            "MIN_SCALE": 0.1,
            "MAX_SCALE": 2.0,
            "RANDOM_FLIP": "horizontal",
        },
        "TEST": {
            "EVAL_PERIOD": 2500,
            "EXPECTED_RESULTS": [],
            "AUG": {"ENABLED": False, "MIN_SIZES": [400, 500, 600, 700, 800, 900, 1000, 1100, 1200],
                    "MAX_SIZE": 4000, "FLIP": True},
            "SW_ENABLED": False,
            "SW_CROP_SIZE": [1024, 1024],
            "SW_STRIDE": [768, 768],
            "SAVE_EVAL_ARTIFACTS": False,
            "DETECTIONS_PER_IMAGE": 100,
        },
        "DATALOADER": {"NUM_WORKERS": 8},
    }, "aff_mini.pkl", {"SEMANTIC_ON": False, "INSTANCE_ON": True, "PANOPTIC_ON": False,
                        "OVERLAP_THRESHOLD": 0.8, "OBJECT_MASK_THRESHOLD": 0.8})
    cfg.MODEL.AFF.update({"SHEPARD_POWER": 4.0, "SHEPARD_POWER_LEARNABLE": False})
    cfg.SOLVER.update({"IMS_PER_BATCH": 64, "MAX_ITER": 92188, "WARMUP_ITERS": 3})
    return cfg


def r50_cfg(num_classes: int = 150) -> Cfg:
    """Mask2Former-R50, ADE20K semantic segmentation at 512x512
    (``configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml``
    over ``Base-ADE20K-SemanticSegmentation.yaml`` and the defaults): the
    ResNet-50 with FrozenBN under the point-cloud pixel decoder (which reads
    the AFF node's Shepard power, at its default) and the masked decoder;
    160k steps at batch 16, clipped at 1.0."""
    cfg = aff_mini_cfg(num_classes)
    del cfg.MODEL["AFF"]
    cfg.MODEL.update(Cfg({
        "META_ARCHITECTURE": "MaskFormer",
        "BACKBONE": {"NAME": "build_resnet_backbone"},
        "WEIGHTS": "detectron2://ImageNetPretrained/torchvision/R-50.pkl",
        "RESNETS": {"DEPTH": 50, "STEM_OUT_CHANNELS": 64, "RES2_OUT_CHANNELS": 256,
                    "STRIDE_IN_1X1": False, "OUT_FEATURES": ["res2", "res3", "res4", "res5"]},
        "AFF": {"SHEPARD_POWER": 6.0, "SHEPARD_POWER_LEARNABLE": True},
    }))
    cfg.SOLVER.update({"IMS_PER_BATCH": 16, "BASE_LR": 0.0001, "MAX_ITER": 160000,
                       "AMP": Cfg({"ENABLED": False})})
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.TEST.AUG.update({"MIN_SIZES": [256, 384, 512, 640, 768, 896], "MAX_SIZE": 3584})
    return cfg


def _swin_cfg(num_classes: int, swin: Dict[str, Any], weights: str, size: int,
              aug_min_sizes: Sequence[int], aug_max_size: int) -> Cfg:
    """MaskFormerSwin over ``semantic-segmentation/maskformer2_swin_bs16_
    160k.yaml``: Swin, the grid pixel decoder and the decoder with the grid
    attention mask, trained as the R50 baseline."""
    cfg = r50_cfg(num_classes)
    for node in ("RESNETS", "AFF"):
        del cfg.MODEL[node]
    cfg.MODEL.update(Cfg({
        "META_ARCHITECTURE": "MaskFormerSwin",
        "BACKBONE": {"NAME": "D2SwinTransformer"},
        "WEIGHTS": weights,
        "SWIN": {"PATCH_SIZE": 4, "MLP_RATIO": 4.0, "APE": False, "PATCH_NORM": True,
                 "DROP_PATH_RATE": 0.3, **swin},
    }))
    cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME = "MultiScaleMaskedTransformerDecoderSwin"
    for k, v in ade20k_semantic_nodes(aug_min_sizes, aug_max_size, size).items():
        cfg[k] = Cfg(v)
    return cfg


def swin_tiny_cfg(num_classes: int = 150) -> Cfg:
    """MaskFormerSwin with Swin-T, ADE20K semantic segmentation at 512x512
    (``configs/ade20k/semantic-segmentation/swin/maskformer2_swin_tiny_
    bs16_160k.yaml``): window 7, so a 128-wide first stage pads to 133."""
    return _swin_cfg(num_classes, {"EMBED_DIM": 96, "DEPTHS": [2, 2, 6, 2],
                                   "NUM_HEADS": [3, 6, 12, 24], "WINDOW_SIZE": 7,
                                   "PRETRAIN_IMG_SIZE": 224},
                     "swin_tiny_patch4_window7_224.pkl", 512, (256, 384, 512, 640, 768, 896), 3584)


def swin_base_384_res640_cfg(num_classes: int = 150) -> Cfg:
    """MaskFormerSwin with Swin-B (384 pretraining), ADE20K semantic
    segmentation at 640x640 (``configs/ade20k/semantic-segmentation/swin/
    maskformer2_swin_base_384_bs16_160k_res640.yaml``): window 12, which
    divides none of the stages' 160, 80, 40 and 20, so every stage pads;
    crops, short test edges and the padding multiple are 640."""
    return _swin_cfg(num_classes, {"EMBED_DIM": 128, "DEPTHS": [2, 2, 18, 2],
                                   "NUM_HEADS": [4, 8, 16, 32], "WINDOW_SIZE": 12,
                                   "PRETRAIN_IMG_SIZE": 384},
                     "swin_base_patch4_window12_384.pkl", 640,
                     (320, 480, 640, 800, 960, 1120), 4480)


def _mrml_cfg(num_classes: int, arch: str, backbone: str, mrml: Dict[str, Any],
              base_lr: float) -> Cfg:
    """An MRML model over ``semantic-segmentation/maskformer2_{ml,act}_R50_
    bs16_160k.yaml`` (the R50 baseline's recipe, the Up pixel decoder's
    name, METALOSS_WEIGHT 0.5) at the published EMBED_DIM [256, 128, 128,
    64], 80k steps at batch 32.  ``arch``: MaskFormerML (the meta loss) or
    MaskFormer (which builds the plain pixel decoder whatever
    PIXEL_DECODER_NAME says, as the JAX package does); ``backbone``: the
    MRML backbone's name; ``mrml``: the MODEL.MRML fields of the yaml.  The
    JAX package does not read DROP_PATH_RATE, CLUSTER_SIZE or NBHD_SIZE."""
    cfg = r50_cfg(num_classes)
    del cfg.MODEL["RESNETS"]
    cfg.MODEL.update(Cfg({
        "META_ARCHITECTURE": arch,
        "BACKBONE": {"NAME": backbone},
        "WEIGHTS": "mrml_mini.pkl",
        "MRML": {"EMBED_DIM": [256, 128, 128, 64], "PATCH_SIZES": [32, 16, 8, 4],
                 "SPLIT_RATIO": 4, "MLP_RATIO": 4.0, "NUM_SCALES": 4, **mrml},
    }))
    cfg.MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME = "MSDeformAttnPixelDecoderUp"
    cfg.MODEL.MASK_FORMER.METALOSS_WEIGHT = 0.5
    cfg.SOLVER.update({"IMS_PER_BATCH": 32, "BASE_LR": base_lr, "MAX_ITER": 80000})
    return cfg


def mrml_mini_cfg(num_classes: int = 150) -> Cfg:
    """MRML-Mini (MaskFormerML over MixResMetaLoss), ADE20K semantic
    segmentation at 512x512 (``configs/ade20k/semantic-segmentation/
    mixres-metaloss/maskformer2_mrml_mini_bs32_80k.yaml``): global attention
    in blocks of depths 12, 4, 4, 12; a quarter of the newest scale's
    tokens split per scale (256, 448, 640 and 832 tokens at 512x512); the
    Up pixel decoder; the meta loss at weight 0.5."""
    return _mrml_cfg(num_classes, "MaskFormerML", "MixResMetaLoss", {
        "DEPTHS": [12, 4, 4, 12], "NUM_HEADS": [16, 8, 8, 4], "UPSCALE_RATIO": 0.25,
        "DROP_PATH_RATE": 0.0}, 0.0002)


def mrmlnb_mini_cfg(num_classes: int = 150) -> Cfg:
    """MRML-NB-Mini (MaskFormerML over MixResMetaLossNeighbour), ADE20K
    semantic segmentation at 512x512 (``configs/ade20k/semantic-segmentation/
    mixres-metaloss-nb/maskformer2_mrmlnb_mini_bs32_80k.yaml``): cluster
    attention (clusters of 8, 48-token neighbourhoods) in blocks of depths
    12, 4, 4, 12; three quarters of the newest scale's tokens split per
    scale (256, 832, 2560 and 7744 tokens at 512x512); the Up pixel decoder;
    the meta loss at weight 0.5."""
    return _mrml_cfg(num_classes, "MaskFormerML", "MixResMetaLossNeighbour", {
        "DEPTHS": [12, 4, 4, 12], "NUM_HEADS": [16, 8, 8, 4], "UPSCALE_RATIO": 0.75,
        "DROP_PATH_RATE": 0.3, "CLUSTER_SIZE": 8, "NBHD_SIZE": [48, 48, 48, 48]}, 0.00005)


def mrmean_mini_cfg(num_classes: int = 150) -> Cfg:
    """MRMean-Mini (MaskFormer over MixResMeanAct), ADE20K semantic
    segmentation at 512x512 (``configs/ade20k/semantic-segmentation/
    mixres-activation/maskformer2_mrmean_mini_bs32_80k.yaml`` over
    ``../maskformer2_act_R50_bs16_160k.yaml``): MRML-Mini's backbone
    splitting by the mean absolute activation, the plain pixel decoder (its
    finest level, 256 of 128x128 cells at 512x512, scattered onto the mask
    canvas), no meta loss."""
    return _mrml_cfg(num_classes, "MaskFormer", "MixResMeanAct", {
        "DEPTHS": [12, 4, 4, 12], "NUM_HEADS": [16, 8, 8, 4], "UPSCALE_RATIO": 0.25,
        "DROP_PATH_RATE": 0.0}, 0.0002)


def train_image_size(cfg) -> tuple:
    """(H, W) of a training batch: the LSJ mappers' fixed INPUT.IMAGE_SIZE
    square, else INPUT.CROP.SIZE."""
    if cfg.INPUT.DATASET_MAPPER_NAME in ("coco_instance_lsj", "coco_panoptic_lsj",
                                         "coco_semantic2"):
        return (cfg.INPUT.IMAGE_SIZE, cfg.INPUT.IMAGE_SIZE)
    return tuple(cfg.INPUT.CROP.SIZE)


PRESETS = {"aff_mini": aff_mini_cfg, "aff_mini_15": aff_mini_15_cfg, "aff_small": aff_small_cfg,
           "maskfiner_mini": maskfiner_mini_cfg,
           "maskfiner_updown_mini": maskfiner_updown_mini_cfg,
           "maskfiner_updown_tiny_coco_panoptic": maskfiner_updown_tiny_coco_panoptic_cfg,
           "maskfiner_oracle_teacher_bb": maskfiner_oracle_teacher_bb_cfg,
           "maskfiner_oracle_teacher": maskfiner_oracle_teacher_cfg,
           "mrml_mini": mrml_mini_cfg, "mrmlnb_mini": mrmlnb_mini_cfg,
           "mrmean_mini": mrmean_mini_cfg,
           "aff_mini_cityscapes_panoptic": aff_mini_cityscapes_panoptic_cfg,
           "aff_mini_coco_instance": aff_mini_coco_instance_cfg, "r50": r50_cfg,
           "swin_tiny": swin_tiny_cfg, "swin_base_384_res640": swin_base_384_res640_cfg}
