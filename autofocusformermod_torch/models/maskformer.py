"""MaskFormer meta-architecture: backbone (AFF, the R50 or Swin of the
baselines, or an MRML backbone) -> pixel decoder -> masked transformer
decoder, plus semantic-inference helpers.

Counterpart of ``autofocusformermod_tpu/models/maskformer.py``.  Under
SOLVER.AMP.ENABLED the model computes in bf16 (``compute_dtype``; called on
the bf16 view of its parameters, ``parallel/precision.py:apply``) with fp32
positions and fp32 outputs; the active fp32 islands (``f32_islands``:
backbone, pixel decoder, decoder) take fp32 activations.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..parallel.precision import amp_islands, compute_dtype, f32_outputs
from .aff import aff_from_config
from .pixel_decoder import MSDeformAttnPixelDecoder, pixel_decoder_from_config
from .transformer_decoder import MultiScaleMaskedTransformerDecoder, transformer_decoder_from_config


class MaskFormerHead(nn.Module):
    """pixel_decoder -> transformer predictor.  Under AMP, the fp32 island
    "pixel_decoder" takes fp32 features and hands its levels on in bf16 (its
    mask features stay fp32, so the mask logits are not rounded); the island
    "decoder" takes fp32 levels and mask features."""

    def __init__(self, pixel_decoder: MSDeformAttnPixelDecoder,
                 predictor: MultiScaleMaskedTransformerDecoder,
                 f32_islands: Tuple[str, ...] = (), compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor
        self.f32_islands, self.compute_dtype = tuple(f32_islands), compute_dtype

    def forward(self, features: Dict) -> Dict:
        amp = self.compute_dtype != torch.float32
        if amp and "pixel_decoder" in self.f32_islands:
            mask_features, mf_pos, _, ms_feats, ms_poss = self.pixel_decoder(
                f32_outputs(features))
            if "decoder" not in self.f32_islands:
                ms_feats = [f.to(self.compute_dtype) for f in ms_feats]
        else:
            mask_features, mf_pos, _, ms_feats, ms_poss = self.pixel_decoder(features)
        if amp and "decoder" in self.f32_islands:
            ms_feats, mask_features = f32_outputs(ms_feats), mask_features.float()
        mask_size = features[self.pixel_decoder.in_features[0] + "_spatial_shape"]
        return self.predictor(ms_feats, ms_poss, mask_features, mf_pos, mask_size)


class MaskFormer(nn.Module):
    """forward(raw NHWC RGB images, uint8 or float) -> {'pred_logits' (b, q,
    nc+1), 'pred_masks' (b, q, H/4, W/4), 'aux_outputs'}.

    MODEL.MASK_FORMER.DROPOUT is the point-cloud pixel decoder's (its
    encoder layers'); the grid pixel decoder has none, as in the JAX
    package.  ``compute_dtype`` bf16 (SOLVER.AMP.ENABLED):
    the normalized images are cast to bf16 (the island "backbone": its
    features are, positions excepted) and the outputs come back fp32."""

    def __init__(self, backbone: nn.Module, sem_seg_head: nn.Module,
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 compute_dtype: torch.dtype = torch.float32,
                 f32_islands: Tuple[str, ...] = ()):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.compute_dtype, self.f32_islands = compute_dtype, tuple(f32_islands)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        return (images.float() - self.pixel_mean) / self.pixel_std

    def forward(self, images: torch.Tensor) -> Dict:
        if self.compute_dtype == torch.float32:
            return self.sem_seg_head(self.backbone(self.normalize(images)))
        if "backbone" in self.f32_islands:
            features = self.backbone(self.normalize(images))
            if "pixel_decoder" not in self.f32_islands:
                features = {k: v.to(self.compute_dtype) if torch.is_tensor(v)
                            and v.dtype == torch.float32 and not k.endswith("_pos") else v
                            for k, v in features.items()}
        else:
            features = self.backbone(self.normalize(images).to(self.compute_dtype))
        return f32_outputs(self.sem_seg_head(features))


def feature_channels(cfg) -> Dict[str, int]:
    """The backbone's channels per feature for MODEL.BACKBONE.NAME: AFF's
    EMBED_DIM, the R50's and Swin's c * 2**i (the JAX package's
    ``maskformer_from_config``), an MRML backbone's last EMBED_DIM."""
    name = cfg.MODEL.BACKBONE.NAME
    if name == "AutoFocusFormer":
        return {f"res{i + 2}": int(c) for i, c in enumerate(cfg.MODEL.AFF.EMBED_DIM)}
    from .mrml import MRML_BACKBONES, mrml_feature_channels

    if name in MRML_BACKBONES:
        return mrml_feature_channels(cfg)
    if name == "build_resnet_backbone":
        c = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
    elif name == "D2SwinTransformer":
        c = cfg.MODEL.SWIN.EMBED_DIM
    else:
        raise NotImplementedError(f"backbone {name} is not ported")
    return {f"res{i + 2}": c * 2 ** i for i in range(4)}


def backbone_from_config(cfg) -> nn.Module:
    """The backbone MODEL.BACKBONE.NAME names: AutoFocusFormer,
    build_resnet_backbone, D2SwinTransformer or one of the MRML family
    (MixResMetaLoss, MixResMeanAct, MixResMetaLossNeighbour: its meta-loss
    outputs go unread)."""
    name = cfg.MODEL.BACKBONE.NAME
    if name == "AutoFocusFormer":
        return aff_from_config(cfg)
    from .mrml import MRML_BACKBONES, mixres_metaloss_from_config

    if name in MRML_BACKBONES:
        return mixres_metaloss_from_config(cfg, name)
    if name == "build_resnet_backbone":
        from .resnet import resnet_from_config

        return resnet_from_config(cfg)
    if name == "D2SwinTransformer":
        from .swin import swin_from_config

        return swin_from_config(cfg)
    raise NotImplementedError(f"backbone {name} is not ported")


def maskformer_from_config(cfg) -> MaskFormer:
    """MaskFormer with the point-cloud pixel decoder over the backbone
    MODEL.BACKBONE.NAME, from the JAX package's CfgNode or the port's
    preset (``autofocusformermod_torch.config``).  The head is built before
    the backbone, so a seeded default initialisation does not depend on
    the backbone.  SOLVER.AMP.ENABLED: bf16 compute with the active fp32
    islands (``parallel/precision.py``)."""
    dtype, islands = compute_dtype(cfg), amp_islands(cfg)
    head = MaskFormerHead(pixel_decoder_from_config(cfg, feature_channels(cfg)),
                          transformer_decoder_from_config(cfg, cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM,
                                                          f32_mask_head="mask_head" in islands),
                          islands, dtype)
    return MaskFormer(backbone_from_config(cfg), head, tuple(cfg.MODEL.PIXEL_MEAN),
                      tuple(cfg.MODEL.PIXEL_STD), dtype, islands)


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
