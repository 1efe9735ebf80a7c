"""Point-cloud Mask2Former masked transformer decoder.

Counterpart of ``autofocusformermod_tpu/models/transformer_decoder.py``:
learnable queries, rounds of masked cross-attention -> self-attention -> FFN
cycling over 3 feature levels, prediction heads between rounds.  The
attention mask is the current mask logits Shepard-upsampled to the next
level's positions, thresholded at sigmoid < 0.5; fully masked rows are
unmasked.  Attention is a plain matmul + masked softmax.  The Swin variant
resizes the mask logits to each level's grid instead; the layers can be
pre-norm.  Mask features that do not cover the mask canvas (the plain pixel
decoder over an MRML backbone, whose finest level is a part of its grid)
are rasterized by scattering, their other cells 0.  Under mixed precision
the sine embeddings are cast to the features' dtype, and ``f32_mask_head``
(the fp32 island "mask_head") runs the prediction heads in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..geometry.gridnn import grid_shepard_upsample, pos_index_lut
from ..geometry.rasterize import point2img
from ..geometry.shepard import shepard_neighbours
from ..ops.clusten import weighted_gather
from ..dtypes import promoted
from ..ops.gather import take_rows
from .layers import MLP, layer_norm, position_embedding_sine


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention with a packed in-projection (the
    torch.nn.MultiheadAttention state-dict layout) and an optional boolean
    mask (True = blocked)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, attn_mask=None):
        b, nq, c = query.shape
        h = self.nhead
        c_ = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = nn.functional.linear(query, wq, bq).reshape(b, nq, h, c_)
        k = nn.functional.linear(key, wk, bk).reshape(b, key.shape[1], h, c_)
        v = nn.functional.linear(value, wv, bv).reshape(b, value.shape[1], h, c_)
        logits = torch.einsum("bqhc,bkhc->bhqk", q, k) / math.sqrt(c_)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, -1e9)
        attn = torch.softmax(logits, dim=-1)
        return self.out_proj(torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, nq, c))


class SelfAttentionLayer(nn.Module):
    """Self-attention over the queries, post-norm (or pre-norm)."""

    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm = layer_norm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt, query_pos):
        if self.pre_norm:
            t = self.norm(tgt)
            qk = t + query_pos
            return tgt + self.self_attn(qk, qk, t)
        qk = tgt + query_pos
        return self.norm(tgt + self.self_attn(qk, qk, tgt))


class CrossAttentionLayer(nn.Module):
    """Masked cross-attention from the queries to one feature level,
    post-norm (or pre-norm)."""

    def __init__(self, d_model: int, nhead: int, pre_norm: bool = False):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.norm = layer_norm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt, memory, memory_mask, pos, query_pos):
        if self.pre_norm:
            return tgt + self.multihead_attn(self.norm(tgt) + query_pos, memory + pos, memory,
                                             memory_mask)
        return self.norm(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                                   memory_mask))


class FFNLayer(nn.Module):
    """ReLU feed-forward, post-norm (or pre-norm)."""

    def __init__(self, d_model: int, dim_feedforward: int, pre_norm: bool = False):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = layer_norm(d_model)
        self.pre_norm = pre_norm

    def forward(self, tgt):
        if self.pre_norm:
            return tgt + self.linear2(torch.relu(self.linear1(self.norm(tgt))))
        return self.norm(tgt + self.linear2(torch.relu(self.linear1(tgt))))


def grid_attn_mask(mask_logits: torch.Tensor, target_hw) -> torch.Tensor:
    """(b, q, h, w) mask logits bilinearly resized to a level's (h_l, w_l)
    grid -> (b, q, h_l * w_l): jax.image.resize's bilinear, which filters
    with a triangle as wide as the scale when it shrinks (antialiased), where
    upstream Mask2Former's F.interpolate does not."""
    b, q = mask_logits.shape[:2]
    out = nn.functional.interpolate(mask_logits, size=tuple(int(s) for s in target_hw),
                                    mode="bilinear", align_corners=False, antialias=True)
    return out.reshape(b, q, -1)


class MultiScaleMaskedTransformerDecoder(nn.Module):
    """forward(x, pos, mask_features, mf_pos, mask_size, level_shapes=None) ->
    {'pred_logits' (b, q, nc+1), 'pred_masks' (b, q, h, w), 'aux_outputs'}.

    ``grid_attn_mask`` (MultiScaleMaskedTransformerDecoderSwin): the
    attention mask of a level is the mask logits resized to the level's grid
    (``grid_attn_mask``; the levels' (h, w) come as ``level_shapes``), not
    Shepard-upsampled to its positions."""

    def __init__(self, in_channels: int, num_classes: int, hidden_dim: int = 256,
                 num_queries: int = 100, nheads: int = 8, dim_feedforward: int = 2048,
                 dec_layers: int = 9, pre_norm: bool = False, mask_dim: int = 256,
                 enforce_input_project: bool = False, num_feature_levels: int = 3,
                 grid_attn_mask: bool = False, f32_mask_head: bool = False):
        super().__init__()
        self.num_queries, self.nheads = num_queries, nheads
        self.grid_attn_mask, self.f32_mask_head = grid_attn_mask, f32_mask_head
        self.num_feature_levels = num_feature_levels
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.level_embed = nn.Embedding(num_feature_levels, hidden_dim)
        self.has_input_proj = in_channels != hidden_dim or enforce_input_project
        if self.has_input_proj:
            self.input_proj = nn.ModuleList(nn.Linear(in_channels, hidden_dim)
                                            for _ in range(num_feature_levels))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hidden_dim, nheads, pre_norm) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hidden_dim, nheads, pre_norm) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hidden_dim, dim_feedforward, pre_norm) for _ in range(dec_layers))
        self.decoder_norm = layer_norm(hidden_dim)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def _prediction_heads(self, output, mask_features, target_pos, mask_size, target_hw,
                          to_level=None):
        """Mask features raster-ordered (token == cell): the attention mask
        comes from the window KNN with an identity LUT, or from the resize to
        the level's grid ``target_hw``.  Point-cloud mask features: from the
        Shepard neighbours ``to_level`` of the level's tokens among them."""
        if self.f32_mask_head:
            output, mask_features = output.float(), mask_features.float()
        dec = self.decoder_norm(output)
        outputs_class = self.class_embed(dec)
        outputs_mask = torch.einsum("bqc,bnc->bqn", *promoted(self.mask_embed(dec), mask_features))
        if to_level is not None:
            am = weighted_gather(*to_level, outputs_mask.transpose(1, 2)).transpose(1, 2)
        elif self.grid_attn_mask:
            am = grid_attn_mask(outputs_mask.reshape(*outputs_mask.shape[:2], *mask_size),
                                target_hw)
        else:
            am = grid_shepard_upsample(target_pos, outputs_mask.transpose(1, 2),
                                       mask_size[0], mask_size[1]).transpose(1, 2)
        am = torch.sigmoid(am) < 0.5                                   # True = blocked
        attn_mask = am[:, None].expand(am.shape[0], self.nheads, *am.shape[1:])
        return outputs_class, outputs_mask, attn_mask

    def forward(self, x: List, pos: List, mask_features, mf_pos,
                mask_size: Tuple[int, int], level_shapes: Optional[List] = None) -> Dict:
        if self.grid_attn_mask and level_shapes is None:
            raise ValueError("the grid attention mask needs the levels' (h, w): level_shapes")
        b = x[0].shape[0]
        n_levels = self.num_feature_levels

        def level_hw(i):
            return level_shapes[i] if self.grid_attn_mask else None

        src, pos_emb = [], []
        for i in range(self.num_feature_levels):
            pos_emb.append(position_embedding_sine(pos[i], self.query_feat.weight.shape[1] // 2)
                           .to(x[i].dtype))
            s = self.input_proj[i](x[i]) if self.has_input_proj else x[i]
            src.append(s + self.level_embed.weight[i][None, None, :])
        query_embed = self.query_embed.weight[None].expand(b, -1, -1)
        output = self.query_feat.weight[None].expand(b, -1, -1)

        h_m, w_m = int(mask_size[0]), int(mask_size[1])
        if mf_pos.shape[1] == h_m * w_m:
            # mask features cover the whole canvas (the AFF finest level):
            # permute them to raster order once, so rasterizing is a reshape
            # and the window KNN needs no LUT
            mask_features = take_rows(mask_features, pos_index_lut(mf_pos, h_m, w_m))
            to_levels = [None] * n_levels

            def rasterize(m):
                return m.reshape(*m.shape[:2], h_m, w_m)
        else:
            # a point cloud: each level's Shepard neighbours among it, found
            # once for all rounds
            to_levels = [shepard_neighbours(p, mf_pos) for p in pos[:n_levels]]

            def rasterize(m):
                return point2img(m, mf_pos, mask_size)

        preds_class, preds_mask = [], []
        outputs_class, outputs_mask, attn_mask = self._prediction_heads(
            output, mask_features, pos[0], mask_size, level_hw(0), to_levels[0])
        preds_class.append(outputs_class)
        preds_mask.append(rasterize(outputs_mask))
        for i, (cross, self_attn, ffn) in enumerate(zip(
                self.transformer_cross_attention_layers,
                self.transformer_self_attention_layers, self.transformer_ffn_layers)):
            level = i % n_levels
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            output = cross(output, src[level], attn_mask, pos_emb[level], query_embed)
            output = self_attn(output, query_embed)
            output = ffn(output)
            nxt = (i + 1) % n_levels
            outputs_class, outputs_mask, attn_mask = self._prediction_heads(
                output, mask_features, pos[nxt], mask_size, level_hw(nxt), to_levels[nxt])
            preds_class.append(outputs_class)
            preds_mask.append(rasterize(outputs_mask))
        return {
            "pred_logits": preds_class[-1],
            "pred_masks": preds_mask[-1],
            "aux_outputs": tuple({"pred_logits": a, "pred_masks": m}
                                 for a, m in zip(preds_class[:-1], preds_mask[:-1])),
        }


DECODER_NAMES = ("MultiScaleMaskedTransformerDecoder", "MultiScaleMaskedTransformerDecoderSwin")


def transformer_decoder_from_config(cfg, in_channels: int, f32_mask_head: bool = False
                                    ) -> MultiScaleMaskedTransformerDecoder:
    """MODEL.MASK_FORMER's decoder; the name ending in "Swin" selects the grid
    attention mask."""
    mf = cfg.MODEL.MASK_FORMER
    if mf.TRANSFORMER_DECODER_NAME not in DECODER_NAMES:
        raise NotImplementedError(f"transformer decoder {mf.TRANSFORMER_DECODER_NAME} is not "
                                  f"ported; ported: {DECODER_NAMES}")
    return MultiScaleMaskedTransformerDecoder(
        in_channels=in_channels, num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
        hidden_dim=mf.HIDDEN_DIM, num_queries=mf.NUM_OBJECT_QUERIES, nheads=mf.NHEADS,
        dim_feedforward=mf.DIM_FEEDFORWARD, dec_layers=mf.DEC_LAYERS - 1, pre_norm=mf.PRE_NORM,
        mask_dim=cfg.MODEL.SEM_SEG_HEAD.MASK_DIM, enforce_input_project=mf.ENFORCE_INPUT_PROJ,
        grid_attn_mask=mf.TRANSFORMER_DECODER_NAME.endswith("Swin"), f32_mask_head=f32_mask_head)
