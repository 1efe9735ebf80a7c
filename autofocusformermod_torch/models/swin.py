"""Swin Transformer backbone of the MaskFormerSwin baselines (the reference's
``D2SwinTransformer``).

Counterpart of ``autofocusformermod_tpu/models/swin.py``, under the
reference's state-dict names (``backbone.patch_embed.proj``,
``backbone.layers.{i}.blocks.{j}.attn.qkv``, ``...downsample.reduction``,
``backbone.norm{i}``).  Each block pads its map at the bottom and right to
whole windows; every second block of a stage rolls the map by half a window
and masks the attention between regions that the roll brought together with
-100.  Outputs follow the point-cloud convention: ``res*`` (b, h*w, c) in
raster order, ``res*_pos`` the cell's (x, y) times 2**stage and
``res*_spatial_shape`` the stride-4 canvas for every level.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .layers import DropPath, Mlp, grid_positions, layer_norm


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(b, h, w, c) -> (b * nw, ws * ws, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int, b: int) -> torch.Tensor:
    """(b * nw, ws * ws, c) -> (b, h, w, c)."""
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) rows of the relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=32)
def _shift_mask(hp: int, wp: int, ws: int, shift: int, device: str) -> torch.Tensor:
    """(nw, ws*ws, ws*ws) additive mask of the shifted windows: -100 between
    tokens of different regions, 0 within one."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), ws)[..., 0]
    mask = torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)
    return mask.to(device)


class WindowAttention(nn.Module):
    """Multi-head self-attention within a window, with a learnt bias per
    relative position."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            0.02 * torch.randn((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(window_size)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bn, n, c = x.shape
        h = self.num_heads
        c_ = c // h
        qkv = self.qkv(x).reshape(bn, n, 3, h, c_).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * c_ ** -0.5, qkv[1], qkv[2]
        attn = torch.einsum("bhic,bhjc->bhij", q, k)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bn // nw, nw, h, n, n) + mask[None, :, None]).reshape(bn, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhij,bhjc->bhic", attn, v).transpose(1, 2).reshape(bn, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual, LN -> MLP -> residual,
    both branches through DropPath."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        ws = self.window_size
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        shift = self.shift if min(hp, wp) > ws else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask(hp, wp, ws, shift, str(x.device))
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, hp, wp, b)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x[:, :h, :w].reshape(b, n, c)
        x = shortcut + self.drop_path(x)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (padded to even sides), LN, Linear 4c -> 2c."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class PatchEmbed(nn.Module):
    """patch x patch conv with stride patch (flax's 'SAME' padding) + LN."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = layer_norm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = x.permute(0, 3, 1, 2)
        pads = []
        for size in (x.shape[3], x.shape[2]):
            total = max((-(-size // p) - 1) * p + p - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = nn.functional.pad(x, pads)
        return self.proj(x)


class SwinTransformer(nn.Module):
    """forward(normalized NHWC images) -> the point-cloud feature dict of
    ``out_indices`` (res2..res5)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.3, patch_size: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        dim = embed_dim
        for i, depth in enumerate(depths):
            layer = nn.Module()
            layer.blocks = nn.ModuleList(
                SwinBlock(dim, num_heads[i], window_size, 0 if j % 2 == 0 else window_size // 2,
                          mlp_ratio, float(dpr[sum(depths[:i]) + j]))
                for j in range(depth))
            if i < len(depths) - 1:
                layer.downsample = PatchMerging(dim)
            self.layers.append(layer)
            if i in self.out_indices:
                self.add_module(f"norm{i}", layer_norm(dim))
            dim *= 2

    def forward(self, x: torch.Tensor) -> Dict:
        x = self.patch_embed(x)
        b, c, h, w = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        canvas = (h, w)
        outs: Dict = {}
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, h, w)
            if i in self.out_indices:
                outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
                outs[f"res{i + 2}_pos"] = grid_positions(h, w, 2 ** i, str(x.device)).expand(
                    b, h * w, 2)
                outs[f"res{i + 2}_spatial_shape"] = canvas
            if hasattr(layer, "downsample"):
                x = layer.downsample(x, h, w)
                h, w = (h + 1) // 2, (w + 1) // 2
        return outs


def swin_from_config(cfg) -> SwinTransformer:
    s = cfg.MODEL.SWIN
    return SwinTransformer(embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS),
                           num_heads=tuple(s.NUM_HEADS), window_size=s.WINDOW_SIZE,
                           mlp_ratio=s.MLP_RATIO, drop_path_rate=s.DROP_PATH_RATE,
                           patch_size=s.PATCH_SIZE)
