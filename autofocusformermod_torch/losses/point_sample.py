"""Point sampling of mask logits: PointRend's ``point_sample`` and the two
uncertainty samplers.

Counterpart of ``autofocusformermod_tpu/losses/point_sample.py``.
``point_sample`` matches torch ``grid_sample(align_corners=False,
padding_mode='zeros')`` on coordinates in [0, 1]; ``point_sample_auto``
runs the ``point_sample`` CUDA kernel on CUDA tensors.
``get_uncertain_point_coords_with_randomness`` is the reference's exact
sampler (a bilinear ranking read and a global top-k);
``get_uncertain_point_coords_nn_ranked``, the criterion's default, ranks
counter-hashed candidates by a one-tap nearest read.  As the JAX package
stratifies the candidates only on the accelerator and only at the shapes its
rule allows, this one stratifies them only for CUDA tensors at those shapes
(the row-stratified kernel and a top-k per chunk of 128) and follows the
i.i.d. route with a global top-k elsewhere.
"""

from __future__ import annotations

import functools
from typing import Optional, Protocol, Sequence, Tuple

import torch

from ..ops.gather import topk_indices
from ..parallel import mesh


class Draw(Protocol):
    """The source of a sampler's randomness, on the device of the tensors it
    serves."""

    def __call__(self, shape: Sequence[int]) -> torch.Tensor:
        """float32 uniforms in [0, 1) of that shape."""

    def seeds(self, count: int) -> torch.Tensor:
        """(count,) int64 values in [0, 2**32): seeds of the counter hash."""


# how a sampler's n masks lie over the batch: (groups, images, masks an
# image), flattened in that order
Layout = Tuple[int, int, int]


def draw_rows(draw: Draw, n: int, rest: Sequence[int],
              layout: Optional[Layout] = None) -> torch.Tensor:
    """Uniforms (n, *rest) for n masks laid out as ``layout`` (groups,
    images, per image).  Under a data axis of W processes the draw is the
    global batch's (groups * W * images * per image, *rest), of which this
    rank keeps its own images (``mesh.global_rows``): every rank draws the
    same numbers, and together they draw what one process draws for the
    whole batch.  Without a layout, or alone, the draw is (n, *rest)."""
    if layout is None or mesh.batch_size_factor() == 1:
        return draw((n, *rest))
    groups = layout[0]
    return mesh.global_rows(draw((n * mesh.batch_size_factor(), *rest)), groups)


def global_row_index(layout: Layout, device) -> torch.Tensor:
    """(n,) int32: each local mask's index among the global batch's masks
    laid out as ``layout``, under a data axis."""
    groups, b, per = layout
    w = mesh.batch_size_factor()
    ar = functools.partial(torch.arange, dtype=torch.int32, device=device)
    return (ar(groups)[:, None, None] * (b * w * per)
            + (mesh.axis_index() * b + ar(b))[None, :, None] * per
            + ar(per)[None, None, :]).reshape(-1)


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
    importance_sample_ratio: float, layout: Optional[Layout] = None,
) -> torch.Tensor:
    """The most uncertain fraction of an oversampled random pool plus a random
    remainder: mask_logits (n, h, w) -> coords (n, num_points, 2) in [0, 1].

    Draws, in order: the candidates (n, num_points * oversample_ratio, 2),
    then the remainder (n, num_points - num_uncertain, 2), each the global
    batch's under a data axis (``draw_rows``; ``layout``: how the n masks
    lie over the batch).  The ranking read runs without gradient."""
    n = mask_logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    coords = draw_rows(draw, n, (num_sampled, 2), layout)
    with torch.no_grad():
        unc = calculate_uncertainty(point_sample_auto(mask_logits.detach(), coords))
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    idx = torch.topk(unc, num_uncertain, dim=1).indices
    picked = torch.gather(coords, 1, idx[..., None].expand(n, num_uncertain, 2))
    if num_random > 0:
        picked = torch.cat([picked, draw_rows(draw, n, (num_random, 2), layout)], dim=1)
    return picked


# y-stratified ranking candidates with the row-stratified read, on CUDA
# tensors; off, the candidates are i.i.d. there too and the plain nearest
# kernel reads them.
STRATIFY_RANKING = True

# With stratified candidates, take the top (k / chunks) of each chunk of 128
# instead of one global top-k: 128-wide sorts instead of one over every
# candidate of a mask.  A stratum's winners are capped, which trades a few
# borderline picks for spatial coverage.
STRATIFIED_TOPK = True

_M32 = 1 << 32


def _as_int32(value: int) -> int:
    """The int32 with the bits of a uint32 constant."""
    return value - _M32 if value >= 1 << 31 else value


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _counter_uniform(seed: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Stateless uniform in [0, 1) from a counter (murmur3 finalizer), bit for
    bit the JAX package's uint32 ``_counter_uniform``: a value can be
    recomputed from its index alone, so the top-k's winners are re-derived
    from their indices instead of gathered.

    seed: 0-dim int32 carrying the uint32 seed's bits; ctr: int32 counters
    (uint32 bits).  The arithmetic is int32, whose products and sums wrap to
    the same low 32 bits as uint32's; the shifts are made logical."""
    x = ctr * _as_int32(0x9E3779B9) + seed
    x = x ^ _lshr(x, 16)
    x = x * _as_int32(0x85EBCA6B)
    x = x ^ _lshr(x, 13)
    x = x * _as_int32(0xC2B2AE35)
    x = x ^ _lshr(x, 16)
    return _lshr(x, 8).float() * 2.0 ** -24


def _seed_bits(seeds: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same low 32 bits."""
    return torch.where(seeds >= 1 << 31, seeds - _M32, seeds).to(torch.int32)


@torch.no_grad()
def get_uncertain_point_coords_nn_ranked(
    draw: Draw, mask_logits: torch.Tensor, num_points: int, oversample_ratio: float,
    importance_sample_ratio: float, stratified: Optional[bool] = None,
    layout: Optional[Layout] = None,
) -> torch.Tensor:
    """``get_uncertain_point_coords_with_randomness`` with a cheap ranking
    read: the candidates are continuous uniforms, hashed from counters; only
    the logit that ranks a candidate is read from its nearest cell instead of
    interpolated.  The returned coordinates are the continuous candidates, so
    the supervision at them is unchanged.  mask_logits (n, h, w) -> coords
    (n, num_points, 2) in [0, 1].

    stratified: None takes the y-stratified route on CUDA tensors (where
    STRATIFY_RANKING is on) and the i.i.d. route on CPU tensors; True asks
    for the stratified route, False forces the i.i.d. one.  Either way the
    stratified route runs only where the JAX package's accelerator takes it
    (``ops.point_sample.point_sample_nearest_rows_supported``: rows a
    multiple of 128 wide, at least as many chunks of 128 as rows); elsewhere
    the i.i.d. candidates are read through ``point_sample_nearest``.

    Draws, in order: two seeds, then the remainder (n, num_points -
    num_uncertain, 2).  Under a data axis (``layout``: how the n masks lie
    over the batch) the seeds are the same on every rank, a candidate's
    counter is its index among the global batch's candidates, and the
    remainder is the global batch's (``draw_rows``), so the W ranks pick
    what one process picks for the whole batch."""
    from ..ops.point_sample import (ROWS_CHUNK, ROWS_MAX_W, point_sample_nearest,
                                    point_sample_nearest_rows, point_sample_nearest_rows_supported)

    n, h, w = mask_logits.shape
    num_sampled = int(num_points * oversample_ratio)
    chunks = num_sampled // ROWS_CHUNK
    n_global = n * (mesh.batch_size_factor() if layout is not None else 1)
    if n_global * num_sampled >= 1 << 31:
        raise ValueError(f"{n_global} masks x {num_sampled} candidates overflow the int32 "
                         "counters")
    seeds = _seed_bits(draw.seeds(2))
    dev = mask_logits.device
    if layout is None or mesh.batch_size_factor() == 1:
        ctr = torch.arange(n * num_sampled, dtype=torch.int32, device=dev).reshape(n, num_sampled)
    else:                               # below 2**31, checked above
        ctr = (global_row_index(layout, dev)[:, None] * num_sampled
               + torch.arange(num_sampled, dtype=torch.int32, device=dev))
    ux = _counter_uniform(seeds[0], ctr)
    uy = _counter_uniform(seeds[1], ctr)
    if stratified is None:
        stratified = STRATIFY_RANKING and mask_logits.is_cuda
    stratified = stratified and point_sample_nearest_rows_supported(h, w, num_sampled)
    if stratified and w > ROWS_MAX_W:
        raise ValueError(f"stratified ranking of {w} wide masks: the rows kernel holds at most "
                         f"{ROWS_MAX_W} columns")

    def y_of(u, j):
        """A candidate's y from its uniform and its index within the mask:
        stratified, candidate j lies in the sliver [c / chunks, (c + 1) /
        chunks), c = j // 128 (the marginal stays uniform, and each chunk of
        128 is pinned to two adjacent image rows)."""
        if not stratified:
            return u
        return (torch.div(j, ROWS_CHUNK, rounding_mode="floor").float() + u) * (1.0 / chunks)

    ys = y_of(uy, torch.arange(num_sampled, dtype=torch.int32, device=dev)[None, :])
    if stratified:
        # the values are non-negative, so the truncating cast is floor
        cx = torch.clamp((ux * w).to(torch.int32), 0, w - 1)
        cy = torch.clamp((ys * h).to(torch.int32), 0, h - 1)
        logits = point_sample_nearest_rows(
            mask_logits, cx.reshape(n, chunks, ROWS_CHUNK),
            cy.reshape(n, chunks, ROWS_CHUNK)).reshape(n, num_sampled)
        del cx, cy
    else:
        logits = point_sample_nearest(mask_logits, torch.stack([ux, ys], dim=-1))
    del ux, uy, ys
    unc = calculate_uncertainty(logits)

    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    # two candidates in one cell read the same logit, so equal uncertainties
    # are common: the top-k must break ties as jax.lax.top_k does, because the
    # winners' coordinates are recomputed from their indices
    if STRATIFIED_TOPK and stratified and num_uncertain % chunks == 0:
        k_per = num_uncertain // chunks
        loc = topk_indices(unc.reshape(n * chunks, ROWS_CHUNK), k_per)
        idx = (loc.reshape(n, chunks, k_per)
               + (torch.arange(chunks, device=dev) * ROWS_CHUNK)[None, :, None]
               ).reshape(n, num_uncertain)
    else:
        idx = topk_indices(unc, num_uncertain)
    idx = idx.to(torch.int32)
    ctr_pick = ctr[:, :1] + idx
    picked = torch.stack([_counter_uniform(seeds[0], ctr_pick),
                          y_of(_counter_uniform(seeds[1], ctr_pick), idx)], dim=-1)
    if num_random > 0:
        picked = torch.cat([picked, draw_rows(draw, n, (num_random, 2), layout)], dim=1)
    return picked
