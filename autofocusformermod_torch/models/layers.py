"""Shared layers: relative-position features, MLPs, Dropout and DropPath, sine position
embedding, PointConv weight net, flax-convention BatchNorm.  Counterpart of
``autofocusformermod_tpu/models/layers.py``.  Under mixed precision the
layers that take fp32 geometry (``dense``, ``WeightNet``) compute in fp32
with the bf16 view of their weights, as flax promotes.

Flax's LayerNorm and GroupNorm epsilon is 1e-6 (torch's default is 1e-5),
so every LayerNorm here passes ``eps=LN_EPS`` and every GroupNorm
``eps=GN_EPS``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..dtypes import promoted
from ..parallel import mesh

REL_POS_WIDTH = 2048 // 4 - 1  # 511: relative offsets are clipped to +-511
LN_EPS = 1e-6
GN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


@functools.lru_cache(maxsize=64)
def grid_positions(h: int, w: int, stride: int, device: str) -> torch.Tensor:
    """(1, h*w, 2) float: (x, y) * stride of every cell of an h x w grid in
    raster order, on ``device``.  Made once per grid and device and shared
    read-only: a copy from the host to the card waits for the card's
    stream, so a forward makes none."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], 2).reshape(1, -1, 2).astype(np.float32) * stride
    return torch.from_numpy(pos).to(device)


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


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in the common dtype of x and the layer's parameters."""
    return nn.functional.linear(*promoted(x, layer.weight, layer.bias))


class Stochastic(nn.Module):
    """A module that, in train mode at a ``rate`` above 0, keeps each element
    of a mask with probability 1 - rate and scales the kept ones by 1 / (1 -
    rate).  The keep decisions come from ``generator`` (a ``torch.Generator``
    on the input's device; None is PyTorch's global one), which
    ``set_dropout_generator`` gives every such module of a model, so a run
    can checkpoint the stream and continue it: one stream, as the JAX
    package's one ``"dropout"`` key.  Under a data axis of several processes
    each draws the global batch's decisions and keeps its own rows
    (``mesh.global_rand``).  ``keep_mask`` is the one place a mask is drawn,
    so a test can replace it."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def keep_mask(self, shape, device) -> torch.Tensor:
        """bool ``shape``: True where the element is kept."""
        return mesh.global_rand(shape, self.generator, device) < 1.0 - self.rate

    def dropped(self, x: torch.Tensor, shape) -> torch.Tensor:
        """x with a mask of ``shape`` (broadcast over x) applied, or x itself
        in eval mode or at rate 0."""
        if self.rate == 0.0 or not self.training:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        mask = self.keep_mask(shape, x.device)
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


class Dropout(Stochastic):
    """``flax.linen.Dropout``: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate) in train mode, the identity in eval mode or
    at rate 0 (and zeros at rate 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropped(x, x.shape)


class DropPath(Stochastic):
    """Stochastic depth: in train mode drop the residual branch of a sample
    with probability ``rate`` and scale the kept ones by 1 / (1 - rate)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropped(x, (x.shape[0],) + (1,) * (x.dim() - 1))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every DropPath and Dropout of ``model`` draws its keep decisions from
    ``generator`` (on the device the model runs on), in forward order."""
    for m in model.modules():
        if isinstance(m, Stochastic):
            m.generator = generator


class Mlp(nn.Module):
    """Linear -> exact GELU -> Dropout -> Linear -> Dropout (both at ``drop``)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop1, self.drop2 = Dropout(drop), Dropout(drop)

    def forward(self, x):
        return self.drop2(self.fc2(self.drop1(nn.functional.gelu(self.fc1(x)))))


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
    Normalizes by the max coordinate over the WHOLE batch, as the reference
    (the global batch's inside a data-parallel step: ``mesh.global_batch``)."""
    if scale is None:
        scale = 2 * math.pi
    y_embed = pos[:, :, 1].float()
    x_embed = pos[:, :, 0].float()
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (mesh.data_max_detached(y_embed.max()) + eps) * scale
        x_embed = x_embed / (mesh.data_max_detached(x_embed.max()) + eps) * scale
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

    def forward(self, rel5: torch.Tensor) -> torch.Tensor:
        """fp32 features through bf16 weights compute in fp32."""
        linear, norm, act = self
        x = dense(linear, rel5)
        x = nn.functional.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                                     norm.bias.to(x.dtype), norm.eps)
        return act(x)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d with flax.linen.BatchNorm's training semantics: flax's
    default momentum 0.99 (0.01 in PyTorch's convention, where 0.1 is the
    default), and running statistics that take the biased batch variance
    (PyTorch's BatchNorm2d takes the unbiased one).  Eval mode is plain
    BatchNorm2d.  Under mixed precision the running statistics stay fp32,
    are updated from fp32 batch statistics and are read in the activations'
    dtype in eval mode (the JAX package casts its batch_stats so).  Training
    takes flax's arithmetic (``_flax_forward``): the per-channel sum, sum of
    squares and count in fp32, summed over the data axis inside the training
    step of several processes (``parallel/mesh.py global_batch``; the
    gradient flows back through the sum to every rank), the variance
    E[x^2] - E[x]^2, the normalisation in fp32 rounded once to the
    activations' dtype, and the running statistics from the global mean and
    variance.  One process and W ranks then compute a batch alike, and the
    statistics are the global batch's, as flax computes them over the batch
    of one program.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=0.01)

    def _flax_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        count = torch.full((1,), xf.numel() / xf.shape[1], dtype=torch.float32, device=x.device)
        sums = mesh.data_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]))
        c = self.num_features
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if x.dtype == self.running_mean.dtype:
                return super().forward(x)
            return nn.functional.batch_norm(x, self.running_mean.to(x.dtype),
                                            self.running_var.to(x.dtype), self.weight, self.bias,
                                            False, 0.0, self.eps)
        return self._flax_forward(x)
