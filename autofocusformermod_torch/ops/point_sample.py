"""Point sampling of mask logits: the CUDA kernels of ``csrc/point_sample.cu``
and the dispatch to their plain PyTorch versions.

Counterpart of ``autofocusformermod_tpu/ops/pallas/point_sample_kernel.py``:

- ``point_sample_bilinear`` (``point_sample_pallas``): torch
  ``grid_sample(align_corners=False, padding_mode='zeros')`` of (n, h, w)
  masks at (n, p, 2) coordinates in [0, 1]; on CUDA tensors an autograd
  Function whose gradient goes to the masks only.  Its plain version is
  ``losses.point_sample.point_sample``.  The kernel, forward and backward,
  has two routes, chosen from the mask's shape alone
  (``point_sample_route``): ``"shared"`` holds one mask in a block's shared
  memory (the backward sums its gradient there and writes it once),
  ``"direct"`` reads the mask where it lies and scatters the gradient with
  global atomics into a zeroed tensor.  ``point_sample_bilinear.launches``
  and ``point_sample_backward.launches`` count both routes,
  ``launches_by_route`` each.
- ``point_sample_nearest`` (``point_sample_nearest_pallas``) and
  ``point_sample_nearest_rows`` (``point_sample_nearest_rows_pallas``): the
  value of the cell each point falls in, for the uncertainty ranking.  They
  have no gradient and return tensors that require none.  The TPU kernel of
  the first rounds the masks to bf16; both of these read fp32 exactly.  The
  first has the two routes of the bilinear sample, chosen from the mask's
  shape alone (``point_sample_nearest_route``) and counted in
  ``point_sample_nearest.launches_by_route``.
"""

from __future__ import annotations

from typing import Optional

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


# the largest mask of the shared route: the 227 KB of shared memory a block
# may use on the H100 (csrc/point_sample.cu kMaxTileBytes)
SHARED_MASK_BYTES = 227 * 1024


def point_sample_route(h: int, w: int) -> str:
    """The kernel route for (h, w) masks, forward and backward: "shared" where
    one mask's fp32 image fits a block's shared memory, else "direct"."""
    return "shared" if h * w * 4 <= SHARED_MASK_BYTES else "direct"


def point_sample_forward(masks: torch.Tensor, coords: torch.Tensor,
                         route: Optional[str] = None) -> torch.Tensor:
    """Launch the forward kernel -> (n, p), on ``route`` (default: the one
    ``point_sample_route`` picks; a forced "shared" must fit)."""
    n, h, w = masks.shape
    p = coords.shape[1]
    route = _route(route, h, w)
    require(masks, "masks", torch.float32, (n, h, w))
    require(coords, "coords", torch.float32, (n, p, 2), align=8)
    out = torch.empty((n, p), dtype=torch.float32, device=masks.device)
    name = "aff_point_sample_shared" if route == "shared" else "aff_point_sample"
    lib = load_kernels()
    with torch.cuda.device(masks.device):
        err = getattr(lib, name)(masks.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                 n, p, h, w, stream_of(masks))
    check(err, name)
    point_sample_bilinear.launches += 1
    point_sample_bilinear.launches_by_route[route] += 1
    return out


point_sample_bilinear.launches = 0
point_sample_bilinear.launches_by_route = {"shared": 0, "direct": 0}


def point_sample_backward(coords: torch.Tensor, g: torch.Tensor, mask_shape,
                          route: Optional[str] = None) -> torch.Tensor:
    """Launch the backward kernel: g = d out (n, p) -> d masks (n, h, w), on
    ``route`` as ``point_sample_forward``.  The shared route writes every
    element; the direct one adds into zeros."""
    n, h, w = mask_shape
    p = coords.shape[1]
    route = _route(route, h, w)
    require(coords, "coords", torch.float32, (n, p, 2), align=8)
    require(g, "g", torch.float32, (n, p))
    alloc = torch.empty if route == "shared" else torch.zeros
    dmasks = alloc((n, h, w), dtype=torch.float32, device=g.device)
    name = "aff_point_sample_bwd_shared" if route == "shared" else "aff_point_sample_bwd"
    lib = load_kernels()
    with torch.cuda.device(g.device):
        err = getattr(lib, name)(coords.data_ptr(), g.data_ptr(), dmasks.data_ptr(),
                                 n, p, h, w, stream_of(g))
    check(err, name)
    point_sample_backward.launches += 1
    point_sample_backward.launches_by_route[route] += 1
    return dmasks


point_sample_backward.launches = 0
point_sample_backward.launches_by_route = {"shared": 0, "direct": 0}


def _route(route: Optional[str], h: int, w: int) -> str:
    if route is None:
        return point_sample_route(h, w)
    if route not in ("shared", "direct") or (route == "shared"
                                              and point_sample_route(h, w) != "shared"):
        raise ValueError(f"point_sample: no route {route!r} for {h}x{w} masks")
    return route


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


def point_sample_nearest_route(h: int, w: int) -> str:
    """K11's route for (h, w) masks, by the bilinear sample's rule: "shared"
    where one mask's fp32 image fits a block's shared memory (the block
    reads its cells there), else "direct" (read where the mask lies)."""
    return point_sample_route(h, w)


@torch.no_grad()
def point_sample_nearest(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) f32, coords (n, p, 2) f32 (x, y) -> (n, p), the value of
    the cell each point falls in (cells clamped into the image)."""
    if not use_kernel(masks, coords):
        return point_sample_nearest_plain(masks, coords)
    _, h, w = masks.shape
    return point_sample_nearest_forward(masks.contiguous(), coords.contiguous(),
                                        point_sample_nearest_route(h, w))


def point_sample_nearest_forward(masks: torch.Tensor, coords: torch.Tensor,
                                 route: Optional[str] = None) -> torch.Tensor:
    """Launch the nearest-cell kernel -> (n, p), on ``route`` (default: the
    one ``point_sample_nearest_route`` picks; a forced "shared" must fit)."""
    n, h, w = masks.shape
    p = coords.shape[1]
    route = _route(route, h, w)
    require(masks, "masks", torch.float32, (n, h, w))
    require(coords, "coords", torch.float32, (n, p, 2), align=8)
    out = torch.empty((n, p), dtype=torch.float32, device=masks.device)
    name = "aff_point_sample_nearest_shared" if route == "shared" else "aff_point_sample_nearest"
    lib = load_kernels()
    with torch.cuda.device(masks.device):
        err = getattr(lib, name)(masks.data_ptr(), coords.data_ptr(), out.data_ptr(),
                                 n, p, h, w, stream_of(masks))
    check(err, name)
    point_sample_nearest.launches += 1
    point_sample_nearest.launches_by_route[route] += 1
    return out


point_sample_nearest.launches = 0
point_sample_nearest.launches_by_route = {"shared": 0, "direct": 0}

ROWS_CHUNK = 128     # candidates per chunk of the row-stratified read
ROWS_MAX_W = 768     # two rows of each of a block's 8 warps fit 48 KB of shared memory


def point_sample_nearest_rows_supported(h: int, w: int, p: int) -> bool:
    """Whether p candidates per (h, w) mask take the y-stratified route: the
    JAX package's rule for its accelerator (``point_sample_kernel.py``
    ``point_sample_nearest_rows_supported``): rows a multiple of 128 wide,
    whole chunks of 128, and at least as many chunks as rows, so that a
    chunk's sliver spans at most two rows.  The rows kernel itself also
    holds at most ROWS_MAX_W columns (``point_sample_nearest_rows``)."""
    return w % ROWS_CHUNK == 0 and h >= 2 and p % ROWS_CHUNK == 0 and p // ROWS_CHUNK >= h


@torch.no_grad()
def point_sample_nearest_rows(masks: torch.Tensor, cx: torch.Tensor,
                              cy: torch.Tensor) -> torch.Tensor:
    """masks (n, h, w) f32, w <= ROWS_MAX_W; cx, cy (n, chunks, 128) int32
    cells with chunk c's cy in {r0, r0 + 1}, r0 = min(c * h // chunks, h -
    2) -> (n, chunks, 128)."""
    n, h, w = masks.shape
    chunks = cx.shape[1]
    if not (cx.shape[2] == ROWS_CHUNK and chunks >= h >= 2 and w <= ROWS_MAX_W):
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
