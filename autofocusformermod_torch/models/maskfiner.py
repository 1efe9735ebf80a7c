"""MaskFiner: cascaded mixed-resolution mask prediction.

Counterpart of ``autofocusformermod_tpu/models/maskfiner.py`` for the base
cascade's semantic inference and training.  Each stage is a ``MaskPredictor`` -- a MixRes
backbone (``models/mixres.py``), a point-cloud deformable pixel decoder and a
masked transformer decoder -- and hands the next stage its features, their
(scale, x, y) positions and the decoder's per-token disagreement, from which
the next backbone picks the tokens to split.

The pixel decoder reuses ``models/pixel_decoder.py``'s encoder layers (the
``msdetrpc`` kernels on CUDA) with every level on the min-patch canvas; the
decoder reuses ``models/transformer_decoder.py``'s attention layers.  Its
attention masks and rasterized masks Shepard-upsample the mask logits from
the mask features' positions; the neighbours and weights of each pair of
point sets are found once per forward (``shepard_neighbours``) where the
JAX module calls ``upsample_feature_shepard`` in every round and leaves the
repeats to XLA.  The dense (OracleTeacher) decoder paints the mask features
onto the finest grid (``hierarchical_upsample_dense``) and gives no
disagreement; the OracleTeacher-BB cascades
(``models/meta_arch_variants.py``) build their one head with
``build_stage_pixel_decoder`` and ``build_stage_mask_decoder``.

The OracleTeacher cascade (``MaskFinerOracleTeacher`` in
``models/meta_arch_variants.py``) is built of ``MaskPredictorOracleTeacher``
stages: before the last, a backbone and the projection-only pixel decoder
(``ProjPixelDecoderMaskFiner``) whose levels an MLP scores for the next
split, with no mask decoder; its pixel decoders' OracleTeacher form has a
leaky-ReLU and a mask-features head only where a decoder reads it.

Ported: the relu and lrelu pixel decoders, their HierUp form (each FPN
level painted onto the whole min-patch grid, the mask features from that
dense level alone) and the projection decoder, each with the stage's
dropout; the decoder post-norm or pre-norm, with or without dense mask
features, cycling over the levels or attending to all of them at once (the
Cat decoder); MASK_DECODER_ALL_LEVELS (mask features, and under the
OracleTeacher head a decoder, on every stage).  Each stage's backbone is
the one MODEL.MR.NAME names (``build_backbone_indexed``): MixResViT,
MixResNeighbour, MixResNeighbourXAttn or ConvNeXtV2
(``models/convnextv2.py``), first or later.  ``maskfiner_dynamic_eval``
runs the cascade with the eval-time dynamic split ratios: stage by stage,
each stage's split count from its predecessor's disagreement on the host
(``mixres.dynamic_k_split``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..dtypes import flax_promotion, promoted
from ..geometry.gridnn import grid_shepard_neighbours
from ..geometry.knn import knn
from ..geometry.rasterize import point2img
from ..geometry.shepard import shepard_neighbours, upsample_feature_shepard
from ..ops.clusten import weighted_gather
from ..ops.gather import take_rows
from ..parallel.precision import compute_dtype, f32_outputs, refuse_islands
from .convnextv2 import ConvNeXtV2Stage
from .layers import MLP, layer_norm, position_embedding_sine
from .mixres import MixResNeighbour, MixResViT, dynamic_k_split
from .pixel_decoder import (MSDeformAttnPixelDecoder, pack_neighbor_table, raster_grid,
                            scale_pos)
from .transformer_decoder import MultiScaleMaskedTransformerDecoder


def fix_pos_no_bias(pos: torch.Tensor, current_ss, finest_ss) -> torch.Tensor:
    """Centre coarse-scale token positions within their footprint on the
    finest canvas."""
    sh = (finest_ss[0] / current_ss[0]) / 2 - 0.5
    sw = (finest_ss[1] / current_ss[1]) / 2 - 0.5
    return pos + torch.tensor([sw, sh], dtype=pos.dtype, device=pos.device)


def attention_mask(logits: torch.Tensor) -> torch.Tensor:
    """Where a query may not attend: sigmoid(logit) < 0.5 (True = blocked)."""
    return torch.sigmoid(logits) < 0.5


def hierarchical_upsample_dense(feats: Sequence[torch.Tensor], poss: Sequence[torch.Tensor],
                                finest_shape) -> torch.Tensor:
    """Paint each level's tokens (coarsest first) onto the whole finest
    grid: a level-i token of L covers the r x r block, r = 2^(L-1-i), whose
    top-left corner is its truncated position (cells counted in raster
    order, so a block that passes the right edge continues on the next row;
    cells past the last one are dropped), and a finer level's token takes
    the cells it covers from a coarser one.  Cells no token covers are 0.
    feats: [(b, n_i, c)], poss: [(b, n_i, 2)] -> (b, H*W, c) in raster
    order.  A gather by each cell's last writer, so the gradient reaches only
    the token that holds a cell."""
    H, W = int(finest_shape[0]), int(finest_shape[1])
    L, b = len(feats), feats[0].shape[0]
    dev = feats[0].device
    src = torch.cat([feats[0].new_zeros(b, 1, feats[0].shape[2]), *feats], dim=1)
    # each cell's writer as a row of src (0: the zero row); a last column
    # takes the dropped cells
    owner = torch.zeros((b, H * W + 1), dtype=torch.long, device=dev)
    first = 1
    for i, p in enumerate(poss):
        r, n = 2 ** (L - 1 - i), p.shape[1]
        d = torch.arange(r, device=dev)
        off = (d[:, None] * W + d[None, :]).reshape(-1)                  # (dy, dx) raster
        cell = ((p[..., 1].long() * W + p[..., 0].long())[:, :, None] + off).reshape(b, -1)
        cell = torch.where((cell >= 0) & (cell < H * W), cell, torch.full_like(cell, H * W))
        rows = torch.arange(first, first + n, device=dev).repeat_interleave(r * r)
        owner.scatter_(1, cell, rows.expand(b, -1))
        first += n
    return take_rows(src, owner[:, :H * W])


def predicted_classes(outputs_class: torch.Tensor) -> torch.Tensor:
    """Each query's class (b, q, nc+1) -> (b, q), ties to the lower index."""
    return torch.argmax(outputs_class, dim=-1)


def gini_terms(outputs_mask: torch.Tensor, classes: torch.Tensor, ncp1: int):
    """The parts of ``gini_disagreement`` for queries voting ``classes`` (b,
    q) among ncp1: (each class's summed mask logits (b, nc+1, n), zero for
    a class no query votes; the mean of the present classes' sigmoids (b,
    n); their mean absolute difference over all pairs (b, n))."""
    onehot = nn.functional.one_hot(classes, ncp1).to(outputs_mask.dtype)
    per_class = torch.einsum("bqn,bqc->bcn", outputs_mask, onehot)          # (b, nc+1, n)
    x = torch.sigmoid(per_class)
    pm = (onehot.amax(dim=1) > 0).to(x.dtype)[:, :, None]                  # present classes
    cnt = torch.clamp(pm.sum(dim=1), min=1.0)                                # (b, 1)
    mean = (x * pm).sum(dim=1) / cnt
    diff = (x[:, :, None, :] - x[:, None, :, :]).abs()                      # (b, c, c, n)
    mad = (diff * (pm[:, :, None, :] * pm[:, None, :, :])).sum(dim=(1, 2))
    return per_class, mean, mad / torch.clamp(cnt * cnt, min=1.0)


def gini_disagreement(outputs_mask: torch.Tensor, outputs_class: torch.Tensor) -> torch.Tensor:
    """Token-level disagreement that drives the next stage's split: the Gini
    impurity of the sigmoids of each present class's summed mask logits.
    outputs_mask: (b, q, n); outputs_class: (b, q, nc+1) -> (b, n)."""
    _, mean, mad = gini_terms(outputs_mask, predicted_classes(outputs_class),
                              outputs_class.shape[-1])
    return 0.5 * mad / torch.clamp(mean, min=1e-6)


class MaskFinerPixelDecoder(MSDeformAttnPixelDecoder):
    """One stage's pixel decoder: per-level Linear+LN projections, deformable
    encoder layers over the transformer levels, then the extra FPN levels
    (Shepard upsample + the knn PointConv); every position is centred on the
    min-patch canvas (``fix_pos_no_bias``).  The mask features are the
    concatenation of all levels.  forward(features) -> (mask_features,
    mf_pos, levels, level positions (uncentred), level scales, min canvas,
    level canvases), levels coarse to fine.  Parameters as
    ``pixel_decoder.MSDeformAttnPixelDecoder``'s, with an FPN level for each
    of ``in_features`` that is not a transformer level.  The OracleTeacher
    form: ``activation`` "lrelu" (the encoder layers' FFN and the FPN), and
    without ``mask_features`` no mask-features head (mask features None).
    ``hierup`` (the HierUp form): each FPN level's lateral and every level
    before it are painted onto the whole min-patch grid
    (``hierarchical_upsample_dense``) before the previous level's Shepard
    upsample is added there, so the FPN level covers the grid, and the mask
    features are that last level's alone.  ``dropout``: the encoder layers'."""

    def __init__(self, feature_channels: Dict[str, int], in_features: Sequence[str],
                 transformer_in_features: Sequence[str], conv_dim: int = 256,
                 mask_dim: int = 256, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024, transformer_enc_layers: int = 6,
                 n_points: int = 4, shepard_power: float = 3.0,
                 shepard_power_learnable: bool = True, activation: str = "relu",
                 mask_features: bool = True, hierup: bool = False, dropout: float = 0.0):
        super().__init__(feature_channels, in_features, transformer_in_features,
                         conv_dim=conv_dim, mask_dim=mask_dim,
                         transformer_nheads=transformer_nheads,
                         transformer_dim_feedforward=transformer_dim_feedforward,
                         transformer_enc_layers=transformer_enc_layers, n_points=n_points,
                         shepard_power=shepard_power,
                         shepard_power_learnable=shepard_power_learnable,
                         num_fpn_levels=len(in_features) - len(transformer_in_features),
                         activation=activation, dropout=dropout)
        self.hierup = hierup
        if not mask_features:
            self.mask_features = None

    def forward(self, features: Dict):
        min_ss = features["min_spatial_shape"]
        b = features[self.in_features[0]].shape[0]
        grid = raster_grid(min_ss, b, features[self.in_features[0]].device)

        srcs, poss, scales, fixed_poss, pos_embed, nb_packed = [], [], [], [], [], []
        for idx, f in enumerate(self.transformer_in_features[::-1]):      # coarse first
            pos = features[f + "_pos"].float()
            fixed = fix_pos_no_bias(pos, features[f + "_spatial_shape"], min_ss)
            srcs.append(self.input_proj[idx](features[f]))
            poss.append(pos)
            scales.append(features[f + "_scale"].float())
            fixed_poss.append(fixed)
            # fp32 geometry, cast down to the compute dtype
            pos_embed.append(position_embedding_sine(fixed, self.conv_dim // 2).to(srcs[-1].dtype))
            nb_packed.append(pack_neighbor_table(knn(grid, fixed, 4), fixed))
        lvl_pos = [pe + self.transformer.level_embed[i][None, None]
                   for i, pe in enumerate(pos_embed)]
        # every level on the min-patch canvas
        span_shapes = [min_ss] * (len(srcs) + 1)
        out = srcs
        for layer in self.transformer.encoder.layers:
            out = layer(out, fixed_poss, span_shapes, lvl_pos, nb_packed)
        out = list(out)

        for idx, f in enumerate(self.in_features[:self.num_fpn_levels][::-1]):
            pos = features[f + "_pos"].float()
            fixed = fix_pos_no_bias(pos, features[f + "_spatial_shape"], min_ss)
            poss.append(pos)
            scales.append(features[f + "_scale"].float())
            y = getattr(self, f"adapter_{idx + 1}")(features[f])
            if self.hierup:
                y = hierarchical_upsample_dense(out + [y], fixed_poss + [fixed], min_ss)
                fixed = grid
            y = y + upsample_feature_shepard(fixed, fixed_poss[-1], out[-1]).to(y.dtype)
            conv, norm = getattr(self, f"layer_{idx + 1}")
            out.append(self.act(norm(conv(y, fixed))))
            fixed_poss.append(fixed)

        mf = out[-1] if self.hierup else torch.cat(out, dim=1)
        mask_features = None if self.mask_features is None else self.mask_features(mf)
        mf_pos = fixed_poss[-1] if self.hierup else torch.cat(fixed_poss, dim=1)
        input_shapes = [features[f + "_spatial_shape"] for f in self.in_features[::-1]]
        return mask_features, mf_pos, out, poss, scales, min_ss, input_shapes


class ProjPixelDecoderMaskFiner(nn.Module):
    """The projection-only stage pixel decoder (``ProjMaskFinerOracleTeacher``):
    per level (coarse first) a Linear+LN to ``conv_dim`` where the level is
    narrower or wider, else the level itself; positions centred on the
    min-patch canvas; the mask features (the concatenated levels' Linear)
    only with ``mask_features``; no transformer.  forward(features) -> the
    7-tuple of ``MaskFinerPixelDecoder``."""

    def __init__(self, feature_channels: Dict[str, int], in_features: Sequence[str],
                 conv_dim: int = 256, mask_dim: int = 256, mask_features: bool = False):
        super().__init__()
        self.in_features = tuple(in_features)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Linear(feature_channels[f], conv_dim), layer_norm(conv_dim))
            if feature_channels[f] != conv_dim else nn.Identity()
            for f in self.in_features[::-1])
        self.mask_features = nn.Linear(conv_dim, mask_dim) if mask_features else None

    def forward(self, features: Dict):
        min_ss = features["min_spatial_shape"]
        srcs, poss, scales, fixed_poss = [], [], [], []
        for proj, f in zip(self.input_proj, self.in_features[::-1]):
            pos = features[f + "_pos"].float()
            # the levels are cast to fp32 here, as the JAX decoder casts them:
            # under AMP every later layer of the cascade that they reach
            # computes in fp32 with the bf16 view of its weights
            # (``MaskFiner.dtype_scope``)
            srcs.append(proj(features[f].float()))
            poss.append(pos)
            scales.append(features[f + "_scale"].float())
            fixed_poss.append(fix_pos_no_bias(pos, features[f + "_spatial_shape"], min_ss))
        mask_features = (None if self.mask_features is None
                         else self.mask_features(torch.cat(srcs, dim=1)))
        input_shapes = [features[f + "_spatial_shape"] for f in self.in_features[::-1]]
        return mask_features, torch.cat(fixed_poss, dim=1), srcs, poss, scales, min_ss, input_shapes


class MaskFinerTransformerDecoder(MultiScaleMaskedTransformerDecoder):
    """One stage's masked transformer decoder: rounds of cross-attention
    (cycling over the stage's ``num_feature_levels`` levels), self-attention
    and FFN, with the prediction heads before the first round and after
    each.  Mask logits live at the mask features' positions; they are
    rasterized on the finest level's grid and, for the attention masks,
    upsampled to the next level's token positions.  The last round's masks
    give the stage's disagreement (``gini_disagreement``).  A stage whose
    one level is the mask features itself attends unmasked.  Parameters as
    ``MultiScaleMaskedTransformerDecoder``'s; ``final_layer``: the last
    stage, whose last round is the cascade's prediction.  ``cat_features``
    (the Cat decoder): every round attends to all the levels at once, their
    tokens concatenated, with the attention masks at all their positions."""

    def __init__(self, *args, final_layer: bool = False, dense_mask_features: bool = False,
                 cat_features: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.final_layer = final_layer
        self.dense_mask_features = dense_mask_features
        self.cat_features = cat_features

    def _prediction_heads(self, output, mask_features, to_level):
        """-> (class logits (b, q, nc+1), mask logits (b, q, n_mf), attention
        mask (b, heads, q, n_level) or None); to_level: the Shepard
        neighbours from the next level's tokens to the mask features."""
        dec = self.decoder_norm(output)
        outputs_class = self.class_embed(dec)
        outputs_mask = torch.einsum("bqc,bnc->bqn", *promoted(self.mask_embed(dec), mask_features))
        if to_level is None:
            return outputs_class, outputs_mask, None
        am = attention_mask(weighted_gather(*to_level, outputs_mask.transpose(1, 2)).transpose(1, 2))
        return outputs_class, outputs_mask, am[:, None].expand(am.shape[0], self.nheads,
                                                               *am.shape[1:])

    def forward(self, x: List, pos: List, mask_features, mf_pos, finest_input_shape,
                input_shapes):
        finest_feat_shape = input_shapes[-1]
        nl = self.num_feature_levels
        if self.dense_mask_features:
            # every level's mask features painted onto the finest grid
            mask_features = hierarchical_upsample_dense(
                mask_features.split([xi.shape[1] for xi in x], dim=1), pos, finest_input_shape)
        x, pos, shapes = x[:nl], pos[:nl], input_shapes[:nl]
        b = x[0].shape[0]
        masked = not (len(pos) == 1 and pos[0].shape == mf_pos.shape)
        mf_pos_scaled = scale_pos(mf_pos, finest_input_shape, finest_feat_shape)
        poss_scaled = [scale_pos(fix_pos_no_bias(p, s, finest_input_shape), finest_input_shape,
                                 finest_feat_shape) for p, s in zip(pos, shapes)]
        finest_pos = raster_grid(finest_feat_shape, b, mf_pos.device)
        # where the attention masks are read: each level's tokens, or all of
        # them at once for the Cat decoder
        targets = [torch.cat(poss_scaled, dim=1)] if self.cat_features else poss_scaled
        if self.dense_mask_features:
            if tuple(finest_input_shape) != tuple(finest_feat_shape):
                raise ValueError(f"dense mask features need the finest level on the min-patch "
                                 f"canvas: {finest_feat_shape} != {finest_input_shape}")
            h, w = finest_feat_shape
            mask_features = mask_features + position_embedding_sine(
                finest_pos, self.mask_embed.layers[-1].out_features // 2).to(mask_features.dtype)
            # the masks live on the grid: their neighbours are cells, found
            # in a window; rasterizing is a reshape
            to_levels = ([grid_shepard_neighbours(p, h, w) for p in targets] if masked
                         else [None] * len(targets))

            def rasterize(pred_mask):
                return pred_mask.reshape(b, -1, h, w)
        else:
            # the Shepard neighbours of every level's tokens and of the finest
            # grid among the mask features, once for all rounds
            to_levels = ([shepard_neighbours(p, mf_pos_scaled) for p in targets] if masked
                         else [None] * len(targets))
            to_grid = shepard_neighbours(finest_pos, mf_pos_scaled)

            def rasterize(pred_mask):
                up = weighted_gather(*to_grid, pred_mask.transpose(1, 2)).transpose(1, 2)
                return point2img(up, finest_pos, finest_feat_shape)

        hidden = self.query_feat.weight.shape[1]
        src, pos_emb = [], []
        for i in range(nl):
            pos_emb.append(position_embedding_sine(poss_scaled[i], hidden // 2).to(x[i].dtype))
            s = self.input_proj[i](x[i]) if self.has_input_proj else x[i]
            src.append(s + self.level_embed.weight[i][None, None, :])
        if self.cat_features:
            # one memory of every level, attended to in every round
            src, pos_emb, nl = [torch.cat(src, dim=1)], [torch.cat(pos_emb, dim=1)], 1
        query_embed = self.query_embed.weight[None].expand(b, -1, -1)
        output = self.query_feat.weight[None].expand(b, -1, -1)

        preds_class, preds_mask = [], []
        outputs_class, pred_mask, attn_mask = self._prediction_heads(output, mask_features,
                                                                     to_levels[0])
        preds_class.append(outputs_class)
        preds_mask.append(rasterize(pred_mask))
        for i, (cross, self_attn, ffn) in enumerate(zip(
                self.transformer_cross_attention_layers,
                self.transformer_self_attention_layers, self.transformer_ffn_layers)):
            level = i % nl
            if attn_mask is not None:
                attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = cross(output, src[level], attn_mask, pos_emb[level], query_embed)
            output = ffn(self_attn(output, query_embed))
            outputs_class, pred_mask, attn_mask = self._prediction_heads(
                output, mask_features, to_levels[(i + 1) % nl])
            preds_class.append(outputs_class)
            preds_mask.append(rasterize(pred_mask))

        # the dense (OracleTeacher) decoder gives no disagreement: its
        # backbone scores the tokens to split itself
        disagreement = (None if self.dense_mask_features
                        else gini_disagreement(pred_mask, outputs_class))
        aux = tuple({"pred_logits": a, "pred_masks": m} for a, m in zip(preds_class, preds_mask))
        if self.final_layer:
            return {"pred_logits": preds_class[-1], "pred_masks": preds_mask[-1],
                    "aux_outputs": aux[:-1]}, disagreement
        # earlier stages supervise every round as aux outputs
        return {"aux_outputs": aux}, disagreement


class MaskPredictor(nn.Module):
    """One cascade stage: backbone -> pixel decoder -> mask decoder.
    forward(im, features, features_pos, upsampling_mask, tokens_per_scale,
    k_split) -> (predictions, the pixel decoder's levels concatenated, their
    (scale, x, y), the disagreement, the levels' sizes); ``k_split``: the
    backbone's split count where not its static ratio's."""

    def __init__(self, backbone: nn.Module, pixel_decoder: MaskFinerPixelDecoder,
                 mask_decoder: MaskFinerTransformerDecoder):
        super().__init__()
        self.backbone = backbone
        self.pixel_decoder = pixel_decoder
        self.mask_decoder = mask_decoder

    def forward(self, im, features, features_pos, upsampling_mask, tokens_per_scale,
                k_split: Optional[int] = None):
        feats, _ = self.backbone(im, features, features_pos, upsampling_mask, tokens_per_scale,
                                 k_split=k_split)
        (mask_features, mf_pos, ms_feats, ms_poss, ms_scales, finest_input_shape,
         input_shapes) = self.pixel_decoder(feats)
        predictions, upsampling_mask = self.mask_decoder(
            ms_feats, ms_poss, mask_features, mf_pos, finest_input_shape, input_shapes)
        pos_scale = torch.cat([torch.cat(ms_scales, dim=1)[..., None], torch.cat(ms_poss, dim=1)],
                              dim=2)
        return (predictions, torch.cat(ms_feats, dim=1), pos_scale, upsampling_mask,
                tuple(f.shape[1] for f in ms_feats))


class MaskPredictorOracleTeacher(MaskPredictor):
    """One OracleTeacher cascade stage: backbone -> pixel decoder, then the
    mask decoder on the final stage (and only there); before the final
    stage an MLP (``upsample_out``: 2 * hidden, 3 layers) scores every
    token of the pixel decoder's concatenated levels for the next split.
    forward(...) -> (predictions ({'aux_outputs': ()} without a decoder),
    the levels concatenated, their (scale, x, y), the scores (None on the
    final stage), the levels' sizes)."""

    def __init__(self, backbone: nn.Module, pixel_decoder: nn.Module, mask_decoder,
                 hidden_dim: int, final_layer: bool):
        super().__init__(backbone, pixel_decoder, mask_decoder)
        self.upsample_out = None if final_layer else MLP(hidden_dim, 2 * hidden_dim, 1, 3)

    def forward(self, im, features, features_pos, upsampling_mask, tokens_per_scale,
                k_split: Optional[int] = None):
        feats, _ = self.backbone(im, features, features_pos, upsampling_mask, tokens_per_scale,
                                 k_split=k_split)
        (mask_features, mf_pos, ms_feats, ms_poss, ms_scales, finest_input_shape,
         input_shapes) = self.pixel_decoder(feats)
        predictions = {"aux_outputs": ()}
        if self.mask_decoder is not None:
            predictions, _ = self.mask_decoder(ms_feats, ms_poss, mask_features, mf_pos,
                                               finest_input_shape, input_shapes)
        pos_scale = torch.cat([torch.cat(ms_scales, dim=1)[..., None], torch.cat(ms_poss, dim=1)],
                              dim=2)
        all_feat = torch.cat(ms_feats, dim=1)
        scores = None if self.upsample_out is None else self.upsample_out(all_feat)[..., 0]
        return predictions, all_feat, pos_scale, scores, tuple(f.shape[1] for f in ms_feats)


class MaskFiner(nn.Module):
    """The cascade.  forward(raw NHWC RGB images, uint8 or float) ->
    {'pred_logits' (b, q, nc+1), 'pred_masks' (b, q, H/p, W/p) with p the
    last stage's patch size, 'aux_outputs' (every stage's rounds),
    'disagreement_masks' (one per stage), 'features_pos' (the last stage's
    (scale, x, y))}.  ``compute_dtype`` bf16 (SOLVER.AMP.ENABLED): the
    normalized images are cast to bf16 and the outputs come back fp32.
    ``k_splits``: each stage's split count where not its static ratio's
    (None for a stage, or for all, keeps it)."""

    def __init__(self, mask_predictors: Sequence[MaskPredictor],
                 pixel_mean: Sequence[float] = (123.675, 116.28, 103.53),
                 pixel_std: Sequence[float] = (58.395, 57.12, 57.375),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_predictors = nn.ModuleList(mask_predictors)
        self.compute_dtype = compute_dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images in the compute dtype."""
        return ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def dtype_scope(self):
        """The context of a forward: under bf16 compute with a projection
        decoder in the cascade, ``flax_promotion`` (its fp32 levels meet
        the later layers' bf16 weights, and JAX computes those layers in
        fp32 with the weights widened); else none."""
        if self.compute_dtype != torch.float32 and any(
                isinstance(p.pixel_decoder, ProjPixelDecoderMaskFiner)
                for p in self.mask_predictors):
            return flax_promotion()
        return contextlib.nullcontext()

    def forward(self, images: torch.Tensor, k_splits: Optional[Sequence] = None) -> Dict:
        with self.dtype_scope():
            x = self.normalize(images)
            features = features_pos = upsampling_mask = tokens_per_scale = None
            aux, disagreements = (), []
            for li, predictor in enumerate(self.mask_predictors):
                outs, features, features_pos, upsampling_mask, tokens_per_scale = predictor(
                    x, features, features_pos, upsampling_mask, tokens_per_scale,
                    None if k_splits is None else k_splits[li])
                disagreements.append(upsampling_mask)
                aux = aux + tuple(outs["aux_outputs"])
        return f32_outputs({"pred_logits": outs["pred_logits"], "pred_masks": outs["pred_masks"],
                            "aux_outputs": aux, "disagreement_masks": tuple(disagreements),
                            "features_pos": features_pos})


@torch.no_grad()
def maskfiner_dynamic_eval(model: MaskFiner, images: torch.Tensor, threshold: float = 0.5,
                           cap_ratio: float = 1.0,
                           buckets: Sequence[float] = (0.1, 0.25, 0.5, 0.75, 1.0)) -> Dict:
    """The cascade's eval forward with the eval-time dynamic split ratios:
    stage by stage, the previous stage's disagreement (over the newest
    scale's tokens) is brought to the host and each later stage splits
    ``dynamic_k_split(scores, n_curr, threshold, cap_ratio, buckets)``
    tokens.  The images are normalised in fp32 and the model's own
    parameters run, as the JAX function runs the variables it is given.
    -> the forward's dict plus 'k_splits' (None for the first stage)."""
    x = (images.float() - model.pixel_mean) / model.pixel_std
    features = features_pos = upsampling_mask = tokens_per_scale = None
    aux, disagreements, k_splits = (), [], []
    for li, predictor in enumerate(model.mask_predictors):
        k_split = None
        if li > 0 and upsampling_mask is not None:
            n_curr, n_old = tokens_per_scale[-1], sum(tokens_per_scale[:-1])
            scores = upsampling_mask.float().cpu().numpy()
            scores = scores if scores.shape[1] == n_curr else scores[:, n_old:]
            k_split = dynamic_k_split(scores, n_curr, threshold, cap_ratio, buckets)
        outs, features, features_pos, upsampling_mask, tokens_per_scale = predictor(
            x, features, features_pos, upsampling_mask, tokens_per_scale, k_split)
        k_splits.append(k_split)
        disagreements.append(upsampling_mask)
        aux = aux + tuple(outs["aux_outputs"])
    return {"pred_logits": outs["pred_logits"], "pred_masks": outs["pred_masks"],
            "aux_outputs": aux, "disagreement_masks": tuple(disagreements),
            "features_pos": features_pos, "k_splits": tuple(k_splits)}


# the decoder names that build the plain decoder (5S: the 5-scale yamls';
# SingleScale the same class under another name; Cat the decoder that
# attends to all levels at once), and the dense one's
PLAIN_DECODERS = ("MultiScaleMaskFinerTransformerDecoder",
                  "MultiScaleMaskFinerTransformerDecoder5S",
                  "MultiScaleMaskFinerTransformerDecoderCat",
                  "MultiScaleMaskFinerTransformerDecoderSingleScale")
DENSE_DECODER = "MultiScaleMaskFinerTransformerDecoderOracleTeacher"
# the stage heads and the stage pixel decoders
PLAIN_HEAD, OT_HEAD = "MaskPredictor", "MaskPredictorOracleTeacher"
PROJ_PIXEL_DECODER = "ProjMaskFinerOracleTeacher"
HIERUP_PIXEL_DECODER = "MSDeformAttnPixelDecoderMaskFinerHierUp"
PIXEL_DECODERS = ("MSDeformAttnPixelDecoderMaskFiner",
                  "MSDeformAttnPixelDecoderMaskFinerOracleTeacher", HIERUP_PIXEL_DECODER,
                  PROJ_PIXEL_DECODER)
WHERE = "(ROADMAP.md section 1)"


def stage_pixel_decoder_names(cfg, n_stages: int) -> List[str]:
    """Each stage's MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME (one name: every stage)."""
    names = cfg.MODEL.MR_SEM_SEG_HEAD.PIXEL_DECODER_NAME
    return [names] * n_stages if isinstance(names, str) else list(names)


def refuse_unported_heads(cfg, pixel_decoders: Sequence[str]) -> None:
    """Raise where a stage's pixel decoder (of ``pixel_decoders``) or the
    configured decoder is not one of the stage builders' names
    (``PIXEL_DECODERS``, ``PLAIN_DECODERS`` and ``DENSE_DECODER``)."""
    mfr, head = cfg.MODEL.MASK_FINER, cfg.MODEL.MR_SEM_SEG_HEAD
    for name in pixel_decoders:
        if name not in PIXEL_DECODERS:
            raise NotImplementedError(f"pixel decoder {name!r} under {head.NAME} is not ported "
                                      f"{WHERE}")
    if mfr.TRANSFORMER_DECODER_NAME not in PLAIN_DECODERS + (DENSE_DECODER,):
        raise NotImplementedError(f"decoder {mfr.TRANSFORMER_DECODER_NAME!r} is not ported {WHERE}")


def _refuse(cfg) -> None:
    head = cfg.MODEL.MR_SEM_SEG_HEAD
    if head.NAME not in (PLAIN_HEAD, OT_HEAD):
        raise NotImplementedError(f"cascade stage {head.NAME!r} is not ported {WHERE}")
    refuse_unported_heads(cfg, stage_pixel_decoder_names(cfg, len(cfg.MODEL.MR.NAME)))


def build_backbone_indexed(cfg, li: int, name: Optional[str] = None) -> nn.Module:
    """Cascade stage li's backbone as MODEL.MR.NAME[li] (or ``name``) names
    it: MixResViT, MixResNeighbour, MixResNeighbourXAttn or ConvNeXtV2, the
    first stage embedding the image and a later one taking the stream of
    width MR_SEM_SEG_HEAD.CONVS_DIM[li - 1].  Any other name raises
    KeyError."""
    mr = cfg.MODEL.MR
    n_scales = cfg.MODEL.MASK_FINER.NUM_RESOLUTION_SCALES
    name = name or mr.NAME[li]
    common = dict(scale=li, n_scales=n_scales, min_patch_size=mr.PATCH_SIZES[n_scales - 1],
                  d_model=mr.EMBED_DIM[li], n_layers=mr.DEPTHS[li],
                  in_channels=3 if li == 0 else cfg.MODEL.MR_SEM_SEG_HEAD.CONVS_DIM[li - 1],
                  first_layer=li == 0)
    if name == "ConvNeXtV2":
        return ConvNeXtV2Stage(patch_size=mr.PATCH_SIZES[li], **common)
    # a scalar DROP_PATH_RATE is the end of one ramp over the whole depth; a
    # per-stage list gives stage li its own end on that ramp (the JAX rule)
    rate = mr.DROP_PATH_RATE
    max_rate = float(rate[li]) if isinstance(rate, (list, tuple)) else float(rate)
    dpr = np.linspace(0, max_rate, sum(mr.DEPTHS))
    lo = sum(mr.DEPTHS[:li])
    common.update(n_heads=mr.NUM_HEADS[li], mlp_ratio=mr.MLP_RATIO[li],
                  drop_path=tuple(float(d) for d in dpr[lo:lo + mr.DEPTHS[li]]),
                  layer_scale=mr.LAYER_SCALE, dropout=mr.DROP_RATE[li])
    if name == "MixResViT":
        return MixResViT(patch_size=mr.PATCH_SIZES[li], num_register_tokens=mr.NUM_REGISTER_TOKENS,
                         **common)
    if name in ("MixResNeighbour", "MixResNeighbourXAttn"):
        return MixResNeighbour(
            patch_sizes=tuple(mr.PATCH_SIZES[:li + 1]), cluster_size=mr.CLUSTER_SIZE[li],
            nbhd_size=mr.NBHD_SIZE[li], split_ratio=mr.SPLIT_RATIO[li],
            upscale_ratio=mr.UPSCALE_RATIO[li], attn_drop=mr.ATTN_DROP_RATE[li],
            keep_old_scale=mr.KEEP_OLD_SCALE, cross_attend_image=name == "MixResNeighbourXAttn",
            **common)
    raise KeyError(f"unknown cascade-stage backbone {name!r}")


def build_stage_pixel_decoder(cfg, li: int, final: bool, feature_channels: Dict[str, int],
                              ot_predictor: bool = False) -> nn.Module:
    """Stage li's pixel decoder, as its PIXEL_DECODER_NAME entry names it:
    over the last li + 1 feature levels of MR_SEM_SEG_HEAD.IN_FEATURES (all
    of them on the final stage, whose finest ones beyond the transformer
    levels are FPN levels), with the stage's entries of the per-stage lists;
    feature_channels: the width of each level.  The projection decoder and
    the HierUp form have mask features only on the final stage; the
    OracleTeacher form of the deformable one is leaky and has them but where
    the OracleTeacher stage head (``ot_predictor``) runs no decoder; under
    MASK_DECODER_ALL_LEVELS every stage has them."""
    mfr, head = cfg.MODEL.MASK_FINER, cfg.MODEL.MR_SEM_SEG_HEAD
    all_in, all_trans = list(head.IN_FEATURES), list(head.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES)
    name = stage_pixel_decoder_names(cfg, li + 1)[li]
    all_levels = mfr.MASK_DECODER_ALL_LEVELS
    if name == PROJ_PIXEL_DECODER:
        return ProjPixelDecoderMaskFiner(feature_channels, all_in[-(li + 1):],
                                         conv_dim=head.CONVS_DIM[li], mask_dim=mfr.MASK_DIM[li],
                                         mask_features=final or all_levels)
    ot, hierup = name.endswith("OracleTeacher"), name == HIERUP_PIXEL_DECODER
    return MaskFinerPixelDecoder(
        feature_channels, all_in[-(li + 1):],
        all_trans if final else all_trans[len(all_trans) - li - 1:],
        conv_dim=head.CONVS_DIM[li], mask_dim=mfr.MASK_DIM[li], transformer_nheads=head.NHEADS[li],
        transformer_dim_feedforward=int(head.CONVS_DIM[li] * head.MLP_RATIO[li]),
        transformer_enc_layers=head.TRANSFORMER_ENC_LAYERS[li],
        # distances are squared, so halve the configured power
        shepard_power=mfr.SHEPARD_POWER / 2.0, shepard_power_learnable=mfr.SHEPARD_POWER_LEARNABLE,
        activation="lrelu" if ot else "relu", hierup=hierup, dropout=head.DROPOUT,
        mask_features=(final if hierup else final or not (ot and ot_predictor)) or all_levels)


def build_stage_mask_decoder(cfg, li: int, final: bool) -> MaskFinerTransformerDecoder:
    """Stage li's masked transformer decoder; the OracleTeacher decoder name
    gives the dense one (mask features painted on the finest grid), the Cat
    name the one that attends to all levels at once."""
    mfr, head = cfg.MODEL.MASK_FINER, cfg.MODEL.MR_SEM_SEG_HEAD
    return MaskFinerTransformerDecoder(
        in_channels=head.CONVS_DIM[li], num_classes=head.NUM_CLASSES,
        hidden_dim=mfr.HIDDEN_DIM[li], num_queries=mfr.NUM_OBJECT_QUERIES,
        nheads=mfr.NHEADS[li], dim_feedforward=mfr.DIM_FEEDFORWARD[li],
        dec_layers=mfr.DEC_LAYERS[li] - 1, pre_norm=mfr.PRE_NORM, mask_dim=mfr.MASK_DIM[li],
        enforce_input_project=mfr.ENFORCE_INPUT_PROJ, num_feature_levels=mfr.DECODER_LEVELS[li],
        final_layer=final, dense_mask_features=mfr.TRANSFORMER_DECODER_NAME == DENSE_DECODER,
        cat_features="Cat" in mfr.TRANSFORMER_DECODER_NAME)


def build_mask_predictors(cfg) -> List[MaskPredictor]:
    """The cascade's stages (the JAX package's ``maskfiner_from_config``
    loop): per stage li, the pixel decoder over the last li + 1 feature
    levels (all of them on the last stage, whose finest ones are FPN
    levels), the decoder and the MixRes backbone; under the OracleTeacher
    stage head (MR_SEM_SEG_HEAD.NAME) ``MaskPredictorOracleTeacher`` stages,
    with a decoder on the final stage only (on every stage under
    MASK_DECODER_ALL_LEVELS)."""
    _refuse(cfg)
    mr, mfr = cfg.MODEL.MR, cfg.MODEL.MASK_FINER
    n_stages, n_scales = len(mr.NAME), mfr.NUM_RESOLUTION_SCALES
    ot = cfg.MODEL.MR_SEM_SEG_HEAD.NAME == OT_HEAD
    predictors = []
    for li in range(n_stages):
        final = li == n_stages - 1
        # stage li's backbone emits one scale s <= li each, as res{n_scales - s + 1},
        # all of width EMBED_DIM[li]
        channels = {f"res{n_scales - s + 1}": mr.EMBED_DIM[li] for s in range(li + 1)}
        pixel_decoder = build_stage_pixel_decoder(cfg, li, final, channels, ot)
        mask_decoder = (build_stage_mask_decoder(cfg, li, final)
                        if final or not ot or mfr.MASK_DECODER_ALL_LEVELS else None)
        if ot:
            predictors.append(MaskPredictorOracleTeacher(
                build_backbone_indexed(cfg, li), pixel_decoder, mask_decoder,
                cfg.MODEL.MR_SEM_SEG_HEAD.CONVS_DIM[li], final))
        else:
            predictors.append(MaskPredictor(build_backbone_indexed(cfg, li), pixel_decoder,
                                            mask_decoder))
    return predictors


def maskfiner_from_config(cfg) -> MaskFiner:
    """The cascade from a config (the JAX package's CfgNode or the preset
    ``config.maskfiner_mini_cfg``); SOLVER.AMP.ENABLED: bf16 compute."""
    refuse_islands(cfg, "MaskFiner")
    return MaskFiner(build_mask_predictors(cfg), tuple(cfg.MODEL.PIXEL_MEAN),
                     tuple(cfg.MODEL.PIXEL_STD), compute_dtype(cfg))
