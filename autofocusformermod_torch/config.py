"""Yaml-free presets of the published AFF-Mini and AFF-Small models.

``configs/ade20k/maskformer2_aff_{mini,small}_bs32_80k.yaml`` merged over the
defaults give the published AFF + Mask2Former ADE20K models and their
training recipe.  Reading those files needs PyYAML; these presets carry the
same values for every field the port's ``*_from_config`` functions, its
optimizer, its training step and its trainer read, so a machine without
PyYAML can build and train the models.  Those functions also accept the JAX
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
        "INPUT": {"CROP": {"ENABLED": True, "SIZE": [512, 512]}},
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


PRESETS = {"aff_mini": aff_mini_cfg, "aff_small": aff_small_cfg}
