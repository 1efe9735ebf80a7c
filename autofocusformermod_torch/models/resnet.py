"""ResNet backbone of the R50 baseline configs (detectron2's
``build_resnet_backbone``).

Counterpart of ``autofocusformermod_tpu/models/resnet.py``, under
detectron2's state-dict names (``backbone.stem.conv1``,
``backbone.res2.0.conv1.norm``, ``...shortcut.norm``).  ``FrozenBN`` follows
the JAX package, not detectron2: its scale and bias are parameters that
train, only its mean and variance are constants (buffers).

Outputs follow the port's point-cloud convention: ``res*`` (b, h*w, c) in
raster order, ``res*_pos`` the cell's (x, y) times 2**stage (on the stride-4
canvas) and ``res*_spatial_shape`` the stage's OWN (h, w), where AFF and
Swin give the stride-4 canvas for every level.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .layers import grid_positions

FROZEN_BN_EPS = 1e-5


class FrozenBN(nn.Module):
    """(x - running_mean) / sqrt(running_var + 1e-5) * weight + bias over the
    channels of NCHW input; the statistics never change."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the statistics are read in the activations' dtype (bf16 under AMP)
        mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        scale = self.weight / torch.sqrt(var + FROZEN_BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class Conv2d(nn.Conv2d):
    """detectron2's Conv2d: a bias-free convolution followed by its ``norm``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(in_ch, out_ch, kernel, stride, padding, bias=False)
        self.norm = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BasicStem(nn.Module):
    """7x7/2 conv + FrozenBN + ReLU + 3x3/2 max pool."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.max_pool2d(torch.relu(self.conv1(x)), 3, stride=2, padding=1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a projection shortcut where the width or the
    stride changes (detectron2's BottleneckBlock)."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int, stride: int = 1,
                 stride_in_1x1: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if in_ch != out_ch or stride != 1:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride=stride)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_ch, bottleneck_ch, 1, stride=s1)
        self.conv2 = Conv2d(bottleneck_ch, bottleneck_ch, 3, stride=s3, padding=1)
        self.conv3 = Conv2d(bottleneck_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = torch.relu(self.conv1(x))
        y = torch.relu(self.conv2(y))
        return torch.relu(self.conv3(y) + shortcut)


_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNet(nn.Module):
    """forward(normalized NHWC images) -> the point-cloud feature dict of
    ``out_features``."""

    def __init__(self, depth: int = 50, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, stride_in_1x1: bool = False,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        if depth not in _STAGE_BLOCKS:
            raise NotImplementedError(f"only bottleneck ResNets (50, 101, 152), not depth {depth}")
        self.out_features = tuple(out_features)
        self.stem = BasicStem(stem_out_channels)
        in_ch, out_ch = stem_out_channels, res2_out_channels
        for stage, n_blocks in enumerate(_STAGE_BLOCKS[depth]):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(Bottleneck(in_ch, out_ch, out_ch // 4, stride, stride_in_1x1))
                in_ch = out_ch
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict:
        y = self.stem(x.permute(0, 3, 1, 2))
        b = y.shape[0]
        outs: Dict = {}
        for stage in range(4):
            name = f"res{stage + 2}"
            y = getattr(self, name)(y)
            if name in self.out_features:
                h, w = y.shape[2], y.shape[3]
                outs[name] = y.flatten(2).transpose(1, 2)
                outs[name + "_pos"] = grid_positions(h, w, 2 ** stage, str(y.device)).expand(
                    b, h * w, 2)
                outs[name + "_spatial_shape"] = (h, w)
        return outs


def resnet_from_config(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(depth=r.DEPTH, stem_out_channels=r.STEM_OUT_CHANNELS,
                  res2_out_channels=r.RES2_OUT_CHANNELS, stride_in_1x1=r.STRIDE_IN_1X1,
                  out_features=tuple(r.OUT_FEATURES))
