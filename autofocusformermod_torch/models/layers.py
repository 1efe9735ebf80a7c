"""Shared layers: relative-position features, MLPs, sine position embedding,
PointConv weight net, flax-convention BatchNorm.  Counterpart of
``autofocusformermod_tpu/models/layers.py``.

Flax's LayerNorm epsilon is 1e-6 (torch's default is 1e-5), so every
LayerNorm here passes ``eps=LN_EPS``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

REL_POS_WIDTH = 2048 // 4 - 1  # 511: relative offsets are clipped to +-511
LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def rel_pos_features(rel_pos: torch.Tensor) -> torch.Tensor:
    """(..., 2) relative offsets -> (..., 5) features (dx, dy, dist, sin, cos);
    (0, 0) maps to all zeros."""
    rel = torch.clamp(rel_pos, -REL_POS_WIDTH, REL_POS_WIDTH).float()
    dx, dy = rel[..., 0], rel[..., 1]
    dist = torch.sqrt(dx * dx + dy * dy)
    pos = dist > 0
    safe = torch.where(pos, dist, torch.ones_like(dist))
    zero = torch.zeros_like(dist)
    sin = torch.where(pos, dy / safe, zero)
    cos = torch.where(pos, dx / safe, zero)
    return torch.stack([dx, dy, dist, sin, cos], dim=-1)


class Mlp(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class MLP(nn.Module):
    """DETR-style n-layer perceptron with ReLU between layers."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def position_embedding_sine(pos: torch.Tensor, num_pos_feats: int,
                            temperature: float = 10000.0, normalize: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Sine/cosine embedding of point positions (b, n, 2) -> (b, n, 2*num_pos_feats).
    Normalizes by the max coordinate over the WHOLE batch, as the reference."""
    if scale is None:
        scale = 2 * math.pi
    y_embed = pos[:, :, 1].float()
    x_embed = pos[:, :, 0].float()
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed.max() + eps) * scale
        x_embed = x_embed / (x_embed.max() + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.cat([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=2)
    pos_y = torch.cat([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=2)
    return torch.cat([pos_x, pos_y], dim=2)


class WeightNet(nn.Sequential):
    """Linear(5 -> inner_ch) + LayerNorm + exact GELU on rel-pos features
    (state-dict names weight_net.0 / weight_net.1, as the reference)."""

    def __init__(self, inner_ch: int = 4):
        super().__init__(nn.Linear(5, inner_ch), layer_norm(inner_ch), nn.GELU())


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax.linen.BatchNorm's training semantics: flax's
    default momentum 0.99 (0.01 in PyTorch's convention, where 0.1 is the
    default), and running statistics that take the biased batch variance
    (PyTorch's BatchNorm2d takes the unbiased one).  Eval mode is plain
    BatchNorm2d."""

    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                        self.eps)
