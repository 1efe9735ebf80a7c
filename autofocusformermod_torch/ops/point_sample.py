"""Point sampling of mask logits: the CUDA kernels of ``csrc/point_sample.cu``
and the dispatch to their plain PyTorch versions.

Counterpart of ``autofocusformermod_tpu/ops/pallas/point_sample_kernel.py``:

- ``point_sample_bilinear`` (``point_sample_pallas``): torch
  ``grid_sample(align_corners=False, padding_mode='zeros')`` of (n, h, w)
  masks at (n, p, 2) coordinates in [0, 1]; on CUDA tensors an autograd
  Function whose gradient goes to the masks only.  Its plain version is
  ``losses.point_sample.point_sample``.
- ``point_sample_nearest`` (``point_sample_nearest_pallas``) and
  ``point_sample_nearest_rows`` (``point_sample_nearest_rows_pallas``): the
  value of the cell each point falls in, for the uncertainty ranking.  They
  have no gradient and return tensors that require none.  The TPU kernel of
  the first rounds the masks to bf16; both of these read fp32 exactly.
"""

from __future__ import annotations

import torch

from .build import check, load_kernels
from .dispatch import require, stream_of, use_kernel
from .gather import take_scalars


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


def point_sample_nearest_plain(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """out[n, p] = masks[n, clamp(int(y * h)), clamp(int(x * w))] by one flat
    gather: masks (n, h, w), coords (n, p, 2) (x, y) -> (n, p)."""
    n, h, w = masks.shape
    cx = torch.clamp((coords[..., 0] * w).to(torch.int32), 0, w - 1)
    cy = torch.clamp((coords[..., 1] * h).to(torch.int32), 0, h - 1)
    return _gather_cells(masks, cx, cy)


def point_sample_nearest_rows_plain(masks: torch.Tensor, cx: torch.Tensor,
                                    cy: torch.Tensor) -> torch.Tensor:
    """out[n, c, i] = masks[n, cy[n, c, i], cx[n, c, i]] by one flat gather,
    after checking the kernel's contract: 0 <= cx < w, and chunk c's cy in
    {r0, r0 + 1}, r0 = min(c * h // chunks, h - 2) (the kernel checks
    neither)."""
    n, h, w = masks.shape
    chunks = cx.shape[1]
    if bool(((cx < 0) | (cx >= w)).any()):
        raise ValueError("point_sample_nearest_rows: a cx lies outside [0, w)")
    r0 = torch.clamp(torch.arange(chunks, device=cy.device) * h // chunks, max=h - 2)
    off = cy - r0[None, :, None]
    if bool(((off < 0) | (off > 1)).any()):
        raise ValueError("point_sample_nearest_rows: a chunk's cy lies outside its two rows")
    return _gather_cells(masks, cx, cy)


def _gather_cells(masks, cx, cy):
    n, h, w = masks.shape
    return take_scalars(masks.reshape(n, h * w), cy * w + cx)


@torch.no_grad()
def point_sample_nearest(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) f32, coords (n, p, 2) f32 (x, y) -> (n, p), the value of
    the cell each point falls in (cells clamped into the image)."""
    if not use_kernel(masks, coords):
        return point_sample_nearest_plain(masks, coords)
    return point_sample_nearest_forward(masks.contiguous(), coords.contiguous())


def point_sample_nearest_forward(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch the nearest-cell kernel -> (n, p)."""
    n, h, w = masks.shape
    p = coords.shape[1]
    require(masks, "masks", torch.float32, (n, h, w))
    require(coords, "coords", torch.float32, (n, p, 2), align=8)
    out = torch.empty((n, p), dtype=torch.float32, device=masks.device)
    lib = load_kernels()
    with torch.cuda.device(masks.device):
        err = lib.aff_point_sample_nearest(masks.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                           n, p, h, w, stream_of(masks))
    check(err, "aff_point_sample_nearest")
    point_sample_nearest.launches += 1
    return out


point_sample_nearest.launches = 0

ROWS_CHUNK = 128     # candidates per chunk of the row-stratified read
ROWS_MAX_W = 768     # two rows of each of a block's 8 warps fit 48 KB of shared memory


def point_sample_nearest_rows_supported(h: int, w: int, p: int) -> bool:
    """Whether p y-stratified candidates per (h, w) mask can take the
    row-stratified read: whole chunks of 128, and at least as many chunks as
    rows, so that a chunk's sliver spans at most two rows.  (The TPU kernel
    also needs w % 128 == 0, a lane rule; here any w up to 768 goes.)"""
    return p % ROWS_CHUNK == 0 and h >= 2 and p // ROWS_CHUNK >= h and w <= ROWS_MAX_W


@torch.no_grad()
def point_sample_nearest_rows(masks: torch.Tensor, cx: torch.Tensor,
                              cy: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) f32; cx, cy (n, chunks, 128) int32 cells with chunk c's
    cy in {r0, r0 + 1}, r0 = min(c * h // chunks, h - 2) -> (n, chunks, 128)."""
    n, h, w = masks.shape
    chunks = cx.shape[1]
    if not point_sample_nearest_rows_supported(h, w, chunks * cx.shape[2]):
        raise ValueError(f"point_sample_nearest_rows: needs chunks of {ROWS_CHUNK}, chunks >= h "
                         f">= 2 and w <= {ROWS_MAX_W}; got masks {tuple(masks.shape)}, cx "
                         f"{tuple(cx.shape)}")
    if not use_kernel(masks, cx, cy):
        return point_sample_nearest_rows_plain(masks, cx, cy)
    return point_sample_nearest_rows_forward(masks.contiguous(), cx.contiguous(),
                                             cy.contiguous())


def point_sample_nearest_rows_forward(masks: torch.Tensor, cx: torch.Tensor,
                                      cy: torch.Tensor) -> torch.Tensor:
    """Launch the row-stratified kernel -> (n, chunks, 128)."""
    n, h, w = masks.shape
    chunks = cx.shape[1]
    require(masks, "masks", torch.float32, (n, h, w))
    require(cx, "cx", torch.int32, (n, chunks, ROWS_CHUNK), align=16)
    require(cy, "cy", torch.int32, (n, chunks, ROWS_CHUNK), align=16)
    out = torch.empty((n, chunks, ROWS_CHUNK), dtype=torch.float32, device=masks.device)
    lib = load_kernels()
    with torch.cuda.device(masks.device):
        err = lib.aff_point_sample_nearest_rows(masks.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                                                out.data_ptr(), n, chunks, h, w,
                                                stream_of(masks))
    check(err, "aff_point_sample_nearest_rows")
    point_sample_nearest_rows.launches += 1
    return out


point_sample_nearest_rows.launches = 0
