"""Meta-architecture variants:

- MaskFormerSwin: the MaskFormer meta-architecture with the Swin backbone,
  the grid deformable pixel decoder and the shared masked transformer
  decoder (here with the grid attention mask of
  MultiScaleMaskedTransformerDecoderSwin);
- MaskFinerOracleTeacher (and MaskFinerOracle, the same model that always
  splits by the oracle): the MaskFiner cascade of OracleTeacher stages,
  whose scores for the next split are held to the ground-truth-edge oracle
  and, in training, replaced by it with probability ORACLE_TEACHER_RATIO;
- MaskFinerOracleTeacherBB (and ...SW, the same model evaluated in sliding
  windows): one composite backbone (UpDownBackbone, or its down-only form
  OracleTeacherBackbone) and a single final-stage head, the MaskFiner
  pixel decoder and the dense OracleTeacher decoder.

Counterpart of ``GridHead``, ``maskformer_swin_from_config``,
``MaskFinerOracleTeacher``, ``maskfiner_oracle_teacher_from_config``,
``maskfiner_oracle_from_config``, ``MaskFinerOracleTeacherBB`` and
``maskfiner_oracle_teacher_bb_from_config`` in
``autofocusformermod_tpu/models/meta_arch_variants.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..parallel.precision import compute_dtype, f32_outputs, refuse_islands
from .maskfiner import (MaskFiner, build_mask_predictors, build_stage_mask_decoder,
                        build_stage_pixel_decoder, refuse_unported_heads)
from .maskformer import MaskFormer
from .oracle import gt_edge_map, mix_teacher_mask, oracle_upsampling_mask
from .pixel_decoder_grid import MSDeformAttnPixelDecoderGrid, grid_pixel_decoder_from_config
from .swin import swin_from_config
from .transformer_decoder import MultiScaleMaskedTransformerDecoder, transformer_decoder_from_config
from .updown import UpDownBackbone, updown_from_config


class GridHead(nn.Module):
    """The grid pixel decoder -> the transformer predictor, which reads the
    levels' (h, w) for its attention masks."""

    def __init__(self, pixel_decoder: MSDeformAttnPixelDecoderGrid,
                 predictor: MultiScaleMaskedTransformerDecoder):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor

    def forward(self, features: Dict) -> Dict:
        mask_features, mf_pos, _, ms_feats, ms_poss, ms_shapes = self.pixel_decoder(features)
        return self.predictor(ms_feats, ms_poss, mask_features, mf_pos,
                              features["res2_spatial_shape"], level_shapes=ms_shapes)


def maskformer_swin_from_config(cfg) -> MaskFormer:
    """MaskFormerSwin: Swin + the grid pixel decoder + the decoder that
    MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME names."""
    c = cfg.MODEL.SWIN.EMBED_DIM
    channels = {f"res{i + 2}": c * 2 ** i for i in range(4)}
    # the head first, as maskformer_from_config builds it
    head = GridHead(grid_pixel_decoder_from_config(cfg, channels),
                    transformer_decoder_from_config(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM))
    return MaskFormer(swin_from_config(cfg), head, tuple(cfg.MODEL.PIXEL_MEAN),
                      tuple(cfg.MODEL.PIXEL_STD))


class MaskFinerOracleTeacher(MaskFiner):
    """forward(raw NHWC RGB images, uint8 or float; sem_seg_gt (b, H, W)
    int, optional) -> {'pred_logits', 'pred_masks' (b, q, H/p, W/p) with p
    the finest patch, 'aux_outputs' (the final stage's earlier rounds),
    'upsampling_preds' (each stage before the last: its scores of the
    stream's tokens), 'upsampling_oracles' (their GT-edge oracles)}; both
    empty without ``sem_seg_gt``.  In training with ground truth, each
    image's scores are replaced by the oracle's with probability
    ``oracle_teacher_ratio`` before the next stage splits by them (one draw
    per image and stage from the oracle generator).  ``compute_dtype`` as
    ``MaskFiner``'s."""

    def __init__(self, mask_predictors, patch_sizes: Sequence[int], min_patch_size: int,
                 oracle_teacher_ratio: float = 0.5, ignore_label: int = 255,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(mask_predictors, pixel_mean, pixel_std, compute_dtype)
        self.patch_sizes, self.min_patch_size = tuple(patch_sizes), min_patch_size
        self.oracle_teacher_ratio, self.ignore_label = oracle_teacher_ratio, ignore_label
        self.oracle_generator: Optional[torch.Generator] = None

    def set_oracle_generator(self, generator: Optional[torch.Generator]) -> None:
        """The teacher draws come from ``generator`` (on the model's device)."""
        self.oracle_generator = generator

    def forward(self, images: torch.Tensor, sem_seg_gt: Optional[torch.Tensor] = None,
                use_oracle: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        """``use_oracle``: the teacher's draws given, one (b, 1) bool per stage
        before the last, in place of the generator's."""
        with self.dtype_scope():
            x = self.normalize(images)
            edges = None if sem_seg_gt is None else gt_edge_map(sem_seg_gt, self.ignore_label)
            features = features_pos = scores = tokens_per_scale = None
            aux, preds, oracles = (), [], []
            last = len(self.mask_predictors) - 1
            for li, predictor in enumerate(self.mask_predictors):
                outs, features, features_pos, scores, tokens_per_scale = predictor(
                    x, features, features_pos, scores, tokens_per_scale)
                aux = aux + tuple(outs["aux_outputs"])
                if li < last and edges is not None:
                    oracle = oracle_upsampling_mask(edges, features_pos[:, :, 1:],
                                                    features_pos[:, :, 0], self.patch_sizes,
                                                    self.min_patch_size)
                    preds.append(scores)
                    oracles.append(oracle)
                    if self.training:
                        scores = mix_teacher_mask(self.oracle_generator, scores, oracle,
                                                  self.oracle_teacher_ratio,
                                                  None if use_oracle is None else use_oracle[li])
        return f32_outputs({"pred_logits": outs["pred_logits"], "pred_masks": outs["pred_masks"],
                            "aux_outputs": aux, "upsampling_preds": tuple(preds),
                            "upsampling_oracles": tuple(oracles)})


def maskfiner_oracle_teacher_from_config(cfg, oracle_teacher_ratio: Optional[float] = None
                                         ) -> MaskFinerOracleTeacher:
    """MaskFinerOracleTeacher: the cascade of ``build_mask_predictors``
    (OracleTeacher stages under MR_SEM_SEG_HEAD.NAME
    MaskPredictorOracleTeacher), MODEL.MASK_FINER.ORACLE_TEACHER_RATIO
    unless ``oracle_teacher_ratio`` is given."""
    n_scales = cfg.MODEL.MASK_FINER.NUM_RESOLUTION_SCALES
    ratio = (cfg.MODEL.MASK_FINER.ORACLE_TEACHER_RATIO if oracle_teacher_ratio is None
             else oracle_teacher_ratio)
    refuse_islands(cfg, cfg.MODEL.META_ARCHITECTURE)
    return MaskFinerOracleTeacher(
        build_mask_predictors(cfg), tuple(cfg.MODEL.MR.PATCH_SIZES),
        cfg.MODEL.MR.PATCH_SIZES[n_scales - 1], ratio, cfg.MODEL.MR_SEM_SEG_HEAD.IGNORE_VALUE,
        tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD), compute_dtype(cfg))


def maskfiner_oracle_from_config(cfg) -> MaskFinerOracleTeacher:
    """MaskFinerOracle: the OracleTeacher cascade at ratio 1 (training always
    splits by the oracle)."""
    return maskfiner_oracle_teacher_from_config(cfg, 1.0)


class MaskFinerOracleTeacherBB(nn.Module):
    """forward(raw NHWC RGB images, uint8 or float; sem_seg_gt (b, H, W)
    int, optional) -> {'pred_logits' (b, q, nc+1), 'pred_masks' (b, q, H/p,
    W/p) with p the finest patch, 'aux_outputs' (the decoder's earlier
    rounds), 'upsampling_preds' (each down stage's predicted upsampling
    scores), 'upsampling_oracles' (their GT-edge oracles; empty without
    ``sem_seg_gt``)}.  In training with ground truth, the backbone may
    split by the oracle instead of the prediction (ORACLE_TEACHER_RATIO).
    ``compute_dtype`` bf16 (SOLVER.AMP.ENABLED): the normalized images are
    cast to bf16 and the outputs come back fp32."""

    def __init__(self, backbone: UpDownBackbone, pixel_decoder: nn.Module,
                 mask_decoder: nn.Module, n_scales: int,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.compute_dtype = compute_dtype
        self.pixel_decoder = pixel_decoder
        self.mask_decoder = mask_decoder
        self.n_scales = n_scales
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images in the compute dtype."""
        return ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def set_oracle_generator(self, generator: Optional[torch.Generator]) -> None:
        """The teacher draws (one per image and down stage, in training with
        ground truth and ORACLE_TEACHER_RATIO above 0) come from
        ``generator`` (on the model's device)."""
        self.backbone.oracle_generator = generator

    def forward(self, images: torch.Tensor, sem_seg_gt: Optional[torch.Tensor] = None) -> Dict:
        feats = self.backbone(self.normalize(images), sem_seg_gt)
        (mask_features, mf_pos, ms_feats, ms_poss, _, finest_input_shape,
         input_shapes) = self.pixel_decoder(feats)
        predictions, _ = self.mask_decoder(ms_feats, ms_poss, mask_features, mf_pos,
                                           finest_input_shape, input_shapes)
        n_up = self.n_scales - 1
        return f32_outputs({
            "pred_logits": predictions["pred_logits"], "pred_masks": predictions["pred_masks"],
            "aux_outputs": tuple(predictions["aux_outputs"]),
            "upsampling_preds": tuple(feats[f"upsampling_mask_pred_{i}"] for i in range(n_up)),
            "upsampling_oracles": (tuple(feats[f"upsampling_mask_oracle_{i}"] for i in range(n_up))
                                   if sem_seg_gt is not None else ())})


# MODEL.BACKBONE.NAME -> the composite backbone
COMPOSITE_BACKBONES = {"UpDownBackbone": updown_from_config,
                       "OracleTeacherBackbone": lambda cfg: updown_from_config(cfg, down_only=True)}


def maskfiner_oracle_teacher_bb_from_config(cfg) -> MaskFinerOracleTeacherBB:
    """MaskFinerOracleTeacherBB / ...SW: the composite backbone MODEL.BACKBONE.NAME
    names, then the final stage's (index NUM_RESOLUTION_SCALES - 1 of the
    per-stage lists) pixel decoder over every level of
    MR_SEM_SEG_HEAD.IN_FEATURES and decoder."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in COMPOSITE_BACKBONES:
        raise NotImplementedError(f"backbone {name!r} of {cfg.MODEL.META_ARCHITECTURE} is not "
                                  f"ported; ported: {sorted(COMPOSITE_BACKBONES)}")
    n_scales = cfg.MODEL.MASK_FINER.NUM_RESOLUTION_SCALES
    final = n_scales - 1
    names = cfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME
    refuse_unported_heads(cfg, [names if isinstance(names, str) else names[final]])
    refuse_islands(cfg, cfg.MODEL.META_ARCHITECTURE)
    backbone = COMPOSITE_BACKBONES[name](cfg)
    return MaskFinerOracleTeacherBB(
        backbone, build_stage_pixel_decoder(cfg, final, True, backbone.out_channels),
        build_stage_mask_decoder(cfg, final, True), n_scales, tuple(cfg.MODEL.PIXEL_MEAN),
        tuple(cfg.MODEL.PIXEL_STD), compute_dtype(cfg))
