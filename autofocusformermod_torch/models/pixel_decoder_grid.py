"""Grid multi-scale deformable-attention pixel decoder of the MaskFormerSwin
baselines (the reference's ``MSDeformAttnPixelDecoder`` over Swin).

Counterpart of ``autofocusformermod_tpu/models/pixel_decoder_grid.py``.  The
JAX package computes it outside any Pallas kernel, so plain PyTorch is the
port: the deformable sampling is 4-tap bilinear interpolation with zero
padding at the predicted locations (``F.grid_sample``, half-pixel centres),
weighted by the softmaxed attention.  Parameter names are the reference's
(``input_proj.{i}.{0,1}``, ``transformer.level_embed``,
``transformer.encoder.layers.{l}``, ``adapter_1`` and ``layer_1`` with their
``norm``, ``mask_features``).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .layers import GN_EPS, grid_positions, layer_norm, position_embedding_sine


def bilinear_sample(value: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """value (b, h, w, c), loc (b, p, 2) as normalized (x, y) in [0, 1] ->
    (b, p, c): bilinear with zero padding outside the map, cell centres at
    (i + 0.5) / size."""
    grid = (2.0 * loc - 1.0)[:, :, None, :]                       # (b, p, 1, 2)
    out = nn.functional.grid_sample(value.permute(0, 3, 1, 2), grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=False)
    return out[..., 0].transpose(1, 2)


class GroupNormConv(nn.Sequential):
    """1x1 conv + GroupNorm(32) on NCHW maps (state-dict names ``0``, ``1``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.Conv2d(in_ch, out_ch, 1), nn.GroupNorm(32, out_ch, eps=GN_EPS))


class ConvNorm(nn.Conv2d):
    """detectron2's Conv2d with a ``norm`` (GroupNorm(32)); biased, as the
    JAX package's convolutions are."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__(in_ch, out_ch, kernel, padding=kernel // 2)
        self.norm = nn.GroupNorm(32, out_ch, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class MSDeformAttnGrid(nn.Module):
    """Deformable attention over grid levels: per (query, head, level,
    point) an offset from the query's reference point and a softmaxed weight
    over the level x point samples."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self._reset_offsets()

    def _reset_offsets(self):
        """Offsets fan out along per-head directions with growing radius."""
        h, l, k = self.n_heads, self.n_levels, self.n_points
        thetas = np.arange(h, dtype=np.float32) * (2.0 * np.pi / h)
        grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
        grid = grid / np.abs(grid).max(-1, keepdims=True)
        grid = np.tile(grid.reshape(h, 1, 1, 2), (1, l, k, 1))
        for i in range(k):
            grid[:, :, i, :] *= i + 1
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(grid.reshape(-1)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query, ref_points, values, spatial_shapes):
        """query (b, nq, c); ref_points (b, nq, l, 2) normalized; values per
        level (b, h_l, w_l, c) -> (b, nq, c)."""
        b, nq, c = query.shape
        h, l, k = self.n_heads, self.n_levels, self.n_points
        c_ = c // h
        offs = self.sampling_offsets(query).reshape(b, nq, h, l, k, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(b, nq, h, l * k), dim=-1)
        attn = attn.reshape(b, nq, h, l, k)
        out = None
        for j in range(l):
            hj, wj = spatial_shapes[j]
            vj = self.value_proj(values[j]).reshape(b, hj, wj, h, c_)
            # offsets in cells of level j (scalars: no copy to the card)
            off = torch.stack([offs[:, :, :, j, :, 0] / wj, offs[:, :, :, j, :, 1] / hj], -1)
            loc = ref_points[:, :, None, j, None, :] + off                     # (b, nq, h, k, 2)
            # heads into the batch: one sampling call per level
            v = vj.permute(0, 3, 1, 2, 4).reshape(b * h, hj, wj, c_)
            sampled = bilinear_sample(v, loc.transpose(1, 2).reshape(b * h, nq * k, 2))
            sampled = sampled.reshape(b, h, nq, k, c_)
            term = torch.einsum("bqhk,bhqkc->bqhc", attn[:, :, :, j], sampled)
            out = term if out is None else out + term
        return self.output_proj(out.reshape(b, nq, c))


class MSDeformAttnEncoderLayerGrid(nn.Module):
    """Post-norm deformable self-attention + ReLU FFN over the flattened levels."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int):
        super().__init__()
        self.self_attn = MSDeformAttnGrid(d_model, n_levels, n_heads, n_points)
        self.norm1 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, x, ref_points, shapes, bounds):
        b, _, c = x.shape
        vals = [x[:, bounds[j]: bounds[j + 1]].reshape(b, *shapes[j], c)
                for j in range(len(shapes))]
        x = self.norm1(x + self.self_attn(x, ref_points, vals, shapes))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


def _grid_pos(hj: int, wj: int, stride: int, b: int, dev) -> torch.Tensor:
    """(b, hj*wj, 2): (x, y) * stride of every cell of an hj x wj grid in raster order."""
    return grid_positions(hj, wj, stride, str(dev)).expand(b, hj * wj, 2)


@functools.lru_cache(maxsize=16)
def _reference_points(shapes: Tuple[Tuple[int, int], ...], device: str) -> torch.Tensor:
    """(sum h*w, 2): every level's cell centres, normalized (x, y) in (0, 1),
    levels concatenated; made once per set of shapes and device."""
    refs = []
    for hj, wj in shapes:
        ys, xs = np.meshgrid((np.arange(hj) + 0.5) / hj, (np.arange(wj) + 0.5) / wj,
                             indexing="ij")
        refs.append(np.stack([xs, ys], 2).reshape(-1, 2))
    return torch.from_numpy(np.concatenate(refs, 0).astype(np.float32)).to(device)


class MSDeformAttnPixelDecoderGrid(nn.Module):
    """forward(features) -> (mask_features, mf_pos, transformer_out[0],
    multi_scale_features, their positions, their (h, w)): a deformable
    encoder over res5, res4, res3 (coarse first) and one FPN level at res2."""

    def __init__(self, feature_channels: Dict[str, int],
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
                 conv_dim: int = 256, mask_dim: int = 256, transformer_nheads: int = 8,
                 transformer_dim_feedforward: int = 1024, transformer_enc_layers: int = 6,
                 n_points: int = 4):
        super().__init__()
        self.in_features = tuple(in_features)
        self.transformer_in_features = tuple(transformer_in_features)
        self.conv_dim = conv_dim
        nl = len(self.transformer_in_features)
        self.input_proj = nn.ModuleList(GroupNormConv(feature_channels[f], conv_dim)
                                        for f in self.transformer_in_features[::-1])
        self.transformer = nn.Module()
        self.transformer.level_embed = nn.Parameter(torch.randn(nl, conv_dim))
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            MSDeformAttnEncoderLayerGrid(conv_dim, transformer_dim_feedforward, nl,
                                         transformer_nheads, n_points)
            for _ in range(transformer_enc_layers))
        self.adapter_1 = ConvNorm(feature_channels[self.in_features[0]], conv_dim, 1)
        self.layer_1 = ConvNorm(conv_dim, conv_dim, 3)
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, 1)

    def forward(self, features: Dict):
        nl = len(self.transformer_in_features)
        srcs, shapes, pe = [], [], []
        for idx, f in enumerate(self.transformer_in_features[::-1]):
            x = features[f]
            canvas = features[f + "_spatial_shape"]
            stride = 2 ** (3 - idx)
            hj, wj = canvas[0] // stride, canvas[1] // stride
            b, _, c = x.shape
            xg = self.input_proj[idx](x.transpose(1, 2).reshape(b, c, hj, wj))
            srcs.append(xg.flatten(2).transpose(1, 2))
            shapes.append((hj, wj))
            pe.append(position_embedding_sine(features[f + "_pos"], self.conv_dim // 2))
        dev = srcs[0].device
        ref_all = _reference_points(tuple(shapes), str(dev))
        ref_all = ref_all[None, :, None, :].expand(b, ref_all.shape[0], nl, 2)

        level_embed = self.transformer.level_embed
        x = torch.cat([s + level_embed[i][None, None] + p
                       for i, (s, p) in enumerate(zip(srcs, pe))], dim=1)
        bounds = np.cumsum([0] + [s.shape[1] for s in srcs])
        for layer in self.transformer.encoder.layers:
            x = layer(x, ref_all, shapes, bounds)
        outs = [x[:, bounds[j]: bounds[j + 1]] for j in range(nl)]

        # FPN at res2: the lateral 1x1 plus the finest encoder level upsampled
        f2 = self.in_features[0]
        h2, w2 = features[f2 + "_spatial_shape"]
        x2 = features[f2]
        lat = self.adapter_1(x2.transpose(1, 2).reshape(b, x2.shape[2], h2, w2))
        fine = outs[-1].transpose(1, 2).reshape(b, self.conv_dim, *shapes[-1])
        up = nn.functional.interpolate(fine, size=(h2, w2), mode="bilinear", align_corners=False)
        y = torch.relu(self.layer_1(lat + up))
        mask_features = self.mask_features(y).flatten(2).transpose(1, 2)
        ms_poss = [_grid_pos(hj, wj, 2 ** (3 - j), b, dev)
                   for j, (hj, wj) in enumerate(shapes[:3])]
        return (mask_features, _grid_pos(h2, w2, 1, b, dev), outs[0], outs[:3], ms_poss,
                shapes[:3])


def grid_pixel_decoder_from_config(cfg, feature_channels: Dict[str, int]
                                   ) -> MSDeformAttnPixelDecoderGrid:
    """The decoder of ``maskformer_swin_from_config`` (in and transformer
    features, the FFN width and the points stay at their defaults, as in the
    JAX package)."""
    h = cfg.MODEL.SEM_SEG_HEAD
    return MSDeformAttnPixelDecoderGrid(
        feature_channels, conv_dim=h.CONVS_DIM, mask_dim=h.MASK_DIM,
        transformer_nheads=cfg.MODEL.MASK_FORMER.NHEADS,
        transformer_enc_layers=h.TRANSFORMER_ENC_LAYERS)
