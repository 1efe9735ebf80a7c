"""ConvNeXtV2: the grid convnet of the MixRes pipelines.

Counterpart of ``autofocusformermod_tpu/models/convnextv2.py``: blocks of a
depthwise 7x7 conv, LayerNorm, a pointwise MLP with global response
normalisation (``GRN``) and DropPath, on NHWC grids.

- ``ConvNeXtV2Stage`` is a MaskFiner cascade stage (MODEL.MR.NAME
  ``ConvNeXtV2``).  The first stage stems the image with the overlapping
  conv patch embedding and adds the sine position embedding after its
  blocks; a later stage takes the incoming token stream (LayerNorm, and a
  Linear from ``in_channels`` where that differs from d_model), which must
  be its full patch grid.  Its outputs are a MixResViT stage's.
- ``ConvNeXtV2`` is the 4-stage backbone with a 4x4 stem and LayerNorm +
  2x2 stride-2 downsampling, emitting the point-cloud feature dict
  (``res{i + 2}``, ``_pos``, ``_spatial_shape``, ``_scale``).  No registry
  entry of either package builds it.

Module names follow the JAX package's, so the weights bridge carries them
over (``engine/convert_checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from .layers import DropPath, layer_norm, position_embedding_sine
from .mixres import (OverlapPatchEmbedding, get_2dpos_of_curr_ps_in_min_ps,
                     single_scale_outputs)


class GRN(nn.Module):
    """Global response normalisation of an NHWC map: each channel's L2 norm
    over the grid, divided by its mean over the channels, scales the input;
    ``gamma`` and ``beta`` start at zero, so the block starts as identity."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        gx = torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    """x + DropPath(pwconv2(GRN(GELU(pwconv1(LN(dwconv7x7(x))))))), NHWC."""

    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = layer_norm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(self.grn(nn.functional.gelu(self.pwconv1(self.norm(y)))))
        return x + self.drop_path(y)


class ConvNeXtV2(nn.Module):
    """The 4-stage backbone.  forward(NHWC image) -> {res{i + 2}: (b, h_i *
    w_i, dims[i]) after ``out_norm_{i}``, _pos: (x, y) * 2^i on the stem's
    grid, _spatial_shape: the stem's grid, _scale: i} for each of
    ``out_indices``.  ``drop_path_rate``: the end of one DropPath ramp over
    every block."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3), in_channels: int = 3):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.stem_conv = nn.Conv2d(in_channels, dims[0], 4, stride=4)
        self.stem_norm = layer_norm(dims[0])
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            if i > 0:
                self.add_module(f"down_norm_{i}", layer_norm(dims[i - 1]))
                self.add_module(f"down_conv_{i}", nn.Conv2d(dims[i - 1], dims[i], 2, stride=2))
            for j in range(depth):
                self.add_module(f"stages_{i}_blocks_{j}",
                                ConvNeXtV2Block(dims[i], float(dpr[sum(depths[:i]) + j])))
            if i in self.out_indices:
                self.add_module(f"out_norm_{i}", layer_norm(dims[i]))

    def forward(self, x) -> Dict:
        b = x.shape[0]
        x = self.stem_norm(self.stem_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        spatial_shape = tuple(x.shape[1:3])
        outs: Dict = {}
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f"down_norm_{i}")(x)
                x = getattr(self, f"down_conv_{i}")(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            for j in range(depth):
                x = getattr(self, f"stages_{i}_blocks_{j}")(x)
            if i in self.out_indices:
                _, h, w, c = x.shape
                ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
                pos = torch.from_numpy(np.stack([xs, ys], 2).reshape(1, -1, 2).astype(np.float32)
                                       * 2 ** i).to(x.device)
                outs[f"res{i + 2}"] = getattr(self, f"out_norm_{i}")(x.reshape(b, h * w, c))
                outs[f"res{i + 2}_pos"] = pos.expand(b, h * w, 2)
                outs[f"res{i + 2}_spatial_shape"] = spatial_shape
                outs[f"res{i + 2}_scale"] = torch.full((b, h * w), float(i), device=x.device)
        return outs


class ConvNeXtV2Stage(nn.Module):
    """A ConvNeXtV2 cascade stage.  forward(im, features, features_pos,
    upsampling_mask, tokens_per_scale, k_split) -> (outs, tokens_per_scale)
    as MixResViT's: {res{n_scales - scale + 1}, _pos, _spatial_shape,
    _scale, min_spatial_shape}.  ``n_layers`` blocks (no DropPath) over the
    patch grid, then LayerNorm (``norm``).  ``k_split`` is accepted and
    ignored.  A later stage raises ValueError where the incoming stream is
    not the full patch grid."""

    def __init__(self, scale: int, n_scales: int, patch_size: int, min_patch_size: int,
                 d_model: int, n_layers: int, in_channels: int = 3, first_layer: bool = True):
        super().__init__()
        self.scale, self.n_scales, self.d_model = scale, n_scales, d_model
        self.patch_size, self.min_patch_size, self.first_layer = (patch_size, min_patch_size,
                                                                  first_layer)
        if first_layer:
            self.stem = OverlapPatchEmbedding(patch_size, d_model)
        else:
            self.token_norm = layer_norm(in_channels)
            self.token_projection = (nn.Linear(in_channels, d_model) if in_channels != d_model
                                     else None)
        self.stage = nn.ModuleList(ConvNeXtV2Block(d_model) for _ in range(n_layers))
        self.norm = layer_norm(d_model)

    def forward(self, im, features=None, features_pos=None, upsampling_mask=None,
                tokens_per_scale=None, k_split=None):
        b, H, W, _ = im.shape
        patched = (H // self.patch_size, W // self.patch_size)
        if self.first_layer:
            x = self.stem(im)
            pos_np = get_2dpos_of_curr_ps_in_min_ps(H, W, self.patch_size, self.min_patch_size,
                                                    self.scale)
            pos = torch.from_numpy(pos_np).to(im.device)[None].expand(b, -1, 3)
            tokens_per_scale = (pos_np.shape[0],)
        else:
            x = self.token_norm(features)
            if self.token_projection is not None:
                x = self.token_projection(x)
            pos = features_pos
            if x.shape[1] != patched[0] * patched[1]:
                raise ValueError(f"a ConvNeXtV2 stage after the first needs the full "
                                 f"{patched[0]} x {patched[1]} patch grid as its token stream, "
                                 f"got {x.shape[1]} tokens")
        grid = x.reshape(b, patched[0], patched[1], self.d_model)
        for blk in self.stage:
            grid = blk(grid)
        x = grid.reshape(b, patched[0] * patched[1], self.d_model)
        if self.first_layer:
            x = x + position_embedding_sine(pos[:, :, 1:], self.d_model // 2).to(x.dtype)
        return single_scale_outputs(self, self.norm(x), pos, patched, H, W), tokens_per_scale
