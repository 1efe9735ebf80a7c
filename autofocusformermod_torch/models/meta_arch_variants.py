"""MaskFormerSwin: the MaskFormer meta-architecture with the Swin backbone,
the grid deformable pixel decoder and the shared masked transformer decoder
(here with the grid attention mask of MultiScaleMaskedTransformerDecoderSwin).

Counterpart of ``GridHead`` and ``maskformer_swin_from_config`` in
``autofocusformermod_tpu/models/meta_arch_variants.py``.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from .maskformer import MaskFormer
from .pixel_decoder_grid import MSDeformAttnPixelDecoderGrid, grid_pixel_decoder_from_config
from .swin import swin_from_config
from .transformer_decoder import MultiScaleMaskedTransformerDecoder, transformer_decoder_from_config


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
                      tuple(cfg.MODEL.PIXEL_STD), cfg.MODEL.MASK_FORMER.DROPOUT)
