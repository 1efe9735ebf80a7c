"""A yaml-free AFF-Mini preset.

``configs/ade20k/maskformer2_aff_mini_bs32_80k.yaml`` merged over the defaults
gives the published AFF-Mini + Mask2Former ADE20K model and its training
recipe.  Reading that file needs PyYAML; this preset carries the same values
for every field the port's ``*_from_config`` functions, its optimizer and its
training step read, so a machine without PyYAML can build and train the
model.  Those functions also accept the JAX package's ``CfgNode`` (same
attribute paths).
"""

from __future__ import annotations

from typing import Any, Dict


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


def aff_mini_cfg(num_classes: int = 150) -> Cfg:
    """AFF-Mini + Mask2Former, ADE20K semantic segmentation at 512x512."""
    return Cfg({
        "MODEL": {
            "BACKBONE": {"NAME": "AutoFocusFormer"},
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
            "BASE_LR": 0.0002,
            "MAX_ITER": 80000,
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
        # target slots per image (the JAX package pads to TPU.MAX_GT_INSTANCES)
        "TPU": {"MAX_GT_INSTANCES": 100},
    })
