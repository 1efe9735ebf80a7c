"""Point sampling of mask logits: PointRend's ``point_sample`` and
``get_uncertain_point_coords_with_randomness``.

Counterpart of ``autofocusformermod_tpu/losses/point_sample.py``, with the
reference's exact sampler only (the bilinear ranking read; the JAX
package's nearest-tap and stratified variants are not ported).
``point_sample`` matches torch ``grid_sample(align_corners=False,
padding_mode='zeros')`` on coordinates in [0, 1]; ``point_sample_auto``
runs the ``point_sample`` CUDA kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

# draw(shape) -> float32 uniforms in [0, 1) of that shape, on the device
Draw = Callable[[Sequence[int]], torch.Tensor]


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample masks (n, h, w) at coords (n, p, 2) in [0, 1], (x, y)
    order -> (n, p): four flat element taps per point (the kernel's plain
    version)."""
    n, h, w = masks.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    flat = masks.reshape(n * h * w)
    row0 = (torch.arange(n, device=masks.device) * (h * w))[:, None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = torch.clamp(xi, 0, w - 1).long()
        yi_c = torch.clamp(yi, 0, h - 1).long()
        v = flat[(row0 + yi_c * w + xi_c).reshape(-1)].reshape(xi.shape)
        return torch.where(inb, v, torch.zeros_like(v))

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def point_sample_shared_batch(flat_t: torch.Tensor, h: int, w: int,
                              coords: torch.Tensor) -> torch.Tensor:
    """Sample m masks that share their points: flat_t (b, h*w, m) (the masks
    transposed), coords (b, p, 2) -> (b, m, p).  Plain PyTorch, as in the JAX
    package (it has no kernel): each tap gathers p rows of m values."""
    b, hw, m = flat_t.shape
    flat = flat_t.reshape(b * hw, m)
    row0 = (torch.arange(b, device=flat_t.device) * hw)[:, None]
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = torch.clamp(xi, 0, w - 1).long()
        yi_c = torch.clamp(yi, 0, h - 1).long()
        v = flat[(row0 + yi_c * w + xi_c).reshape(-1)].reshape(*xi.shape, m)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return (top * (1 - wy) + bot * wy).transpose(1, 2)


def point_sample_auto(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``point_sample`` through the ``point_sample`` kernel on CUDA tensors."""
    from ..ops.point_sample import point_sample_bilinear

    return point_sample_bilinear(masks, coords)


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """Uncertainty = -|logit|."""
    return -torch.abs(logits)


def get_uncertain_point_coords_with_randomness(
    draw: Draw, mask_logits: torch.Tensor, num_points: int, oversample_ratio: float,
    importance_sample_ratio: float,
) -> torch.Tensor:
    """The most uncertain fraction of an oversampled random pool plus a random
    remainder: mask_logits (n, h, w) -> coords (n, num_points, 2) in [0, 1].

    Draws, in order: the candidates (n, num_points * oversample_ratio, 2),
    then the remainder (n, num_points - num_uncertain, 2).  The ranking read
    runs without gradient."""
    n = mask_logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    coords = draw((n, num_sampled, 2))
    with torch.no_grad():
        unc = calculate_uncertainty(point_sample_auto(mask_logits.detach(), coords))
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    idx = torch.topk(unc, num_uncertain, dim=1).indices
    picked = torch.gather(coords, 1, idx[..., None].expand(n, num_uncertain, 2))
    if num_random > 0:
        picked = torch.cat([picked, draw((n, num_random, 2))], dim=1)
    return picked
