"""Build the configured meta-architecture.

Counterpart of ``autofocusformermod_tpu/models/registry.py:build_model``
for the ported ones: ``MaskFormer`` (AFF, R50, Swin or an MRML backbone +
Mask2Former), ``MaskFormerML`` (an MRML backbone with its meta loss),
``MaskFormerSwin`` (Swin + the grid pixel decoder), ``MaskFiner`` (the
MixRes cascade), ``MaskFinerOracleTeacher`` / ``MaskFinerOracle`` (its
OracleTeacher form) and ``MaskFinerOracleTeacherBB`` / ``...SW`` (the
UpDownBackbone or OracleTeacherBackbone and one final-stage head; SW is
evaluated in sliding windows).
"""

from __future__ import annotations

from torch import nn

from .maskfiner import maskfiner_from_config
from .maskformer import maskformer_from_config
from .meta_arch_variants import (maskfiner_oracle_from_config,
                                 maskfiner_oracle_teacher_bb_from_config,
                                 maskfiner_oracle_teacher_from_config, maskformer_swin_from_config)
from .mrml import MRML_BACKBONES, maskformer_ml_from_config

META_ARCHITECTURES = {"MaskFormer": maskformer_from_config,
                      "MaskFormerML": maskformer_ml_from_config,
                      "MaskFormerSwin": maskformer_swin_from_config,
                      "MaskFiner": maskfiner_from_config,
                      "MaskFinerOracleTeacher": maskfiner_oracle_teacher_from_config,
                      "MaskFinerOracle": maskfiner_oracle_from_config,
                      "MaskFinerOracleTeacherBB": maskfiner_oracle_teacher_bb_from_config,
                      "MaskFinerOracleTeacherSW": maskfiner_oracle_teacher_bb_from_config}


def meta_architecture(cfg) -> str:
    """MODEL.META_ARCHITECTURE, MaskFormer where the config has none."""
    return getattr(cfg.MODEL, "META_ARCHITECTURE", "MaskFormer")


def build_model(cfg) -> nn.Module:
    """The model MODEL.META_ARCHITECTURE names (MaskFormer when unset)."""
    name = meta_architecture(cfg)
    if name not in META_ARCHITECTURES:
        raise NotImplementedError(f"meta-architecture {name!r} is not ported; ported: "
                                  f"{sorted(META_ARCHITECTURES)}")
    return META_ARCHITECTURES[name](cfg)


def uses_mrml(cfg) -> bool:
    """Whether the model's backbone is of the MRML family: every MaskFormerML,
    and a MaskFormer whose MODEL.BACKBONE.NAME is one of them."""
    arch = meta_architecture(cfg)
    return arch == "MaskFormerML" or (arch == "MaskFormer"
                                      and cfg.MODEL.BACKBONE.NAME in MRML_BACKBONES)


def size_divisibility(cfg) -> int:
    """What the predictor pads an image to a multiple of: the MaskFormer's
    SIZE_DIVISIBILITY; for every MaskFiner architecture also its coarsest
    patch (the JAX package's demo), and for an MRML backbone its coarsest
    patch."""
    if meta_architecture(cfg).startswith("MaskFiner"):
        return max(cfg.MODEL.MASK_FINER.SIZE_DIVISIBILITY, max(cfg.MODEL.MR.PATCH_SIZES))
    if uses_mrml(cfg):
        return max(cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY, max(cfg.MODEL.MRML.PATCH_SIZES))
    return cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY
