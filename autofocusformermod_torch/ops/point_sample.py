"""Bilinear point sampling of mask logits: the ``point_sample`` CUDA kernels
(``csrc/point_sample.cu``, forward and backward) and the dispatch to their
plain PyTorch version, ``losses.point_sample.point_sample``.

Counterpart of ``autofocusformermod_tpu/ops/pallas/point_sample_kernel.py``
(``point_sample_pallas``): torch ``grid_sample(align_corners=False,
padding_mode='zeros')`` of (n, h, w) masks at (n, p, 2) coordinates in
[0, 1]; on CUDA tensors an autograd Function whose gradient goes to the
masks only.
"""

from __future__ import annotations

import torch

from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel


def point_sample_bilinear(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) f32, coords (n, p, 2) f32 (x, y) in [0, 1] -> (n, p)."""
    if not use_kernel(masks, coords):
        from ..losses.point_sample import point_sample

        return point_sample(masks, coords)
    return _PointSample.apply(masks, coords)


class _PointSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, masks, coords):
        ctx.save_for_backward(coords)
        ctx.mask_shape = tuple(masks.shape)
        return point_sample_forward(masks.contiguous(), coords.detach().contiguous())

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        return point_sample_backward(coords.contiguous(), g.contiguous(), ctx.mask_shape), None


def point_sample_forward(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel -> (n, p)."""
    n, h, w = masks.shape
    p = coords.shape[1]
    require(masks, "masks", torch.float32, (n, h, w))
    require(coords, "coords", torch.float32, (n, p, 2))
    out = torch.empty((n, p), dtype=torch.float32, device=masks.device)
    lib = load_kernels()
    with torch.cuda.device(masks.device):
        err = lib.aff_point_sample(masks.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                   n, p, h, w, stream_of(masks))
    check(err, "aff_point_sample")
    point_sample_bilinear.launches += 1
    return out


point_sample_bilinear.launches = 0


def point_sample_backward(coords: torch.Tensor, g: torch.Tensor, mask_shape) -> torch.Tensor:
    """Launch the backward kernel: g = d out (n, p) -> d masks (n, h, w)."""
    n, h, w = mask_shape
    p = coords.shape[1]
    require(coords, "coords", torch.float32, (n, p, 2))
    require(g, "g", torch.float32, (n, p))
    dmasks = torch.zeros((n, h, w), dtype=torch.float32, device=g.device)
    lib = load_kernels()
    with torch.cuda.device(g.device):
        err = lib.aff_point_sample_bwd(coords.data_ptr(), g.data_ptr(), dmasks.data_ptr(),
                                       n, p, h, w, stream_of(g))
    check(err, "aff_point_sample_bwd")
    point_sample_backward.launches += 1
    return dmasks


point_sample_backward.launches = 0
