"""MaskFormer meta-architecture: AFF backbone -> pixel decoder -> masked
transformer decoder, plus semantic-inference helpers.

Counterpart of ``autofocusformermod_tpu/models/maskformer.py`` (fp32 only).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .aff import AFF, aff_from_config
from .pixel_decoder import MSDeformAttnPixelDecoder, pixel_decoder_from_config
from .transformer_decoder import MultiScaleMaskedTransformerDecoder, transformer_decoder_from_config


class MaskFormerHead(nn.Module):
    """pixel_decoder -> transformer predictor."""

    def __init__(self, pixel_decoder: MSDeformAttnPixelDecoder,
                 predictor: MultiScaleMaskedTransformerDecoder):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor

    def forward(self, features: Dict) -> Dict:
        mask_features, mf_pos, _, ms_feats, ms_poss = self.pixel_decoder(features)
        mask_size = features[self.pixel_decoder.in_features[0] + "_spatial_shape"]
        return self.predictor(ms_feats, ms_poss, mask_features, mf_pos, mask_size)


class MaskFormer(nn.Module):
    """forward(raw NHWC RGB images, uint8 or float) -> {'pred_logits' (b, q,
    nc+1), 'pred_masks' (b, q, H/4, W/4), 'aux_outputs'}.

    Dropout in the decoders is not ported: a model with dropout > 0 runs in
    eval mode and refuses train mode."""

    def __init__(self, backbone: AFF, sem_seg_head: MaskFormerHead,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 dropout: float = 0.0):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.dropout = dropout
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        return (images.float() - self.pixel_mean) / self.pixel_std

    def forward(self, images: torch.Tensor) -> Dict:
        if self.training and self.dropout > 0:
            raise NotImplementedError(
                f"decoder dropout is not ported: train with MODEL.MASK_FORMER.DROPOUT 0, "
                f"not {self.dropout} (the published Mask2Former configs set 0.0)")
        return self.sem_seg_head(self.backbone(self.normalize(images)))


def maskformer_from_config(cfg) -> MaskFormer:
    """MaskFormer with the AFF backbone, from the JAX package's CfgNode or
    the yaml-free preset (``autofocusformermod_torch.config``)."""
    if cfg.MODEL.BACKBONE.NAME != "AutoFocusFormer":
        raise NotImplementedError(f"backbone {cfg.MODEL.BACKBONE.NAME} is not ported")
    channels = {f"res{i + 2}": int(c) for i, c in enumerate(cfg.MODEL.AFF.EMBED_DIM)}
    head = MaskFormerHead(pixel_decoder_from_config(cfg, channels),
                          transformer_decoder_from_config(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM))
    return MaskFormer(aff_from_config(cfg), head, tuple(cfg.MODEL.PIXEL_MEAN),
                      tuple(cfg.MODEL.PIXEL_STD), cfg.MODEL.MASK_FORMER.DROPOUT)


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random weights from a CPU generator: matrices ~ N(0,
    1/fan_in), norm scales ~ 1 + N(0, 0.01), other vectors ~ N(0, 0.01);
    BatchNorm statistics near (0, 1).  The deformable-offset bias grid and
    the Shepard power and the layer scales keep their constructor values."""
    def randn(shape):
        return torch.randn(shape, generator=generator)

    for name, p in model.named_parameters():
        if name.endswith(("shepard_power", "sampling_offsets.bias", "gamma1", "gamma2")):
            continue
        if p.dim() >= 2:
            val = randn(p.shape) * p[0].numel() ** -0.5
        elif name.endswith(".weight"):
            val = 1.0 + 0.1 * randn(p.shape)
        else:
            val = 0.1 * randn(p.shape)
        p.copy_(val)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * randn(buf.shape))
        elif name.endswith("running_var"):
            buf.copy_(1.0 + 0.1 * torch.rand(buf.shape, generator=generator))
    return model


def upsample_masks(mask_pred: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize (b, q, h, w) mask logits up to out_hw (half-pixel
    centres, no antialiasing: jax.image.resize's bilinear when upsampling)."""
    return nn.functional.interpolate(mask_pred, size=tuple(out_hw), mode="bilinear",
                                     align_corners=False, antialias=False)


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """(..., q, nc+1) logits + (..., q, h, w) mask logits -> (..., nc, h, w)."""
    cls = torch.softmax(mask_cls, dim=-1)[..., :-1]
    return torch.einsum("...qc,...qhw->...chw", cls, torch.sigmoid(mask_pred))
